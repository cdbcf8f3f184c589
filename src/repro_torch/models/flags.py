"""Process-wide model flags (the JAX package's `models/flags.py`).

REMAT_POLICY: what a rematerialized layer keeps for backward. "full"
  (`torch.utils.checkpoint`) keeps only the layer's input and recomputes
  the rest; "dots" keeps the outputs of the unbatched matrix products
  (`aten.mm`, `aten.addmm`, and `aten.bmm` of batch 1, which is how
  `torch.einsum` runs the projections) and recomputes everything else,
  the batched attention einsums included: the counterpart of JAX's
  `dots_with_no_batch_dims_saveable`, trading memory for less recompute.
FLASH_CHUNK: when set, the query and key block length of
  `layers.flash_attention` (default 512).
LOSS_CHUNK: when set, the cross-entropy chunk length of `model.loss_fn`
  (default 512).
The JAX package's `MOE_IMPL` has no counterpart: its "gspmd" value
leaves `moe_ffn` to XLA's partitioner, and the port's `moe_ffn` has no
DTensor path on a mesh (`route`'s `aten.searchsorted` has no sharding
rule). The MoE layer always dispatches through `moe.moe_ffn_a2a`, which
is `moe_ffn` off a mesh and at decode, the reference's default.

The JAX package's `UNROLL_SCANS`, `scan_unroll()` and `FLASH_ONE_BLOCK`
exist because XLA's cost analysis counts a while-loop body once, so its
dry-run lowers unrolled probes. The port runs its layers, attention
blocks and loss chunks in Python loops, and the dry-run counts every
iteration as it runs, so they have no counterpart here.
"""
from __future__ import annotations

REMAT_POLICY = "full"
FLASH_CHUNK = None
LOSS_CHUNK = None


def remat_context_fn():
    """The `context_fn` of `torch.utils.checkpoint.checkpoint` under
    REMAT_POLICY: None for "full", a selective-checkpoint policy that
    saves the unbatched matrix products for "dots"."""
    if REMAT_POLICY == "full":
        return None
    if REMAT_POLICY != "dots":
        raise ValueError(f"REMAT_POLICY: want 'full' or 'dots', got "
                         f"{REMAT_POLICY!r}")
    import functools

    import torch
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    aten = torch.ops.aten

    def policy(ctx, op, *args, **kwargs):
        # einsum lowers an unbatched product ("bsd,dnh->bsnh") to a bmm
        # of batch 1; the attention einsums are bmms over B x heads.
        if op in (aten.mm.default, aten.addmm.default) or (
                op is aten.bmm.default and args[0].shape[0] == 1):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return functools.partial(create_selective_checkpoint_contexts, policy)
