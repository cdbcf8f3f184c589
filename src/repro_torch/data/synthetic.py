"""Deterministic, shardable synthetic data (the JAX package's
`data/synthetic.py`, numpy only: its arrays bit for bit).

The batch for step `i` is a pure function of (seed, step, shard):
stateless indexing. After a restart any worker can regenerate any shard
of any step's batch with no data-loader state to checkpoint, and a
straggler's shard can be recomputed by a backup worker. A real corpus
would replace `TokenStream` behind the same `batch_at` contract.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        # Independent stream per (seed, step, shard): counter-based seeding.
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))

    @property
    def shard_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(f"global batch {self.global_batch} does not "
                             f"split into {self.n_shards} shards")
        return self.global_batch // self.n_shards

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Tokens + next-token labels for this shard of step `step`."""
        rng = self._rng(step)
        seq = rng.integers(0, self.vocab, (self.shard_batch, self.seq_len + 1),
                           dtype=np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def embeds_at(self, step: int, d_model: int, key: str = "embeds",
                  dtype=np.float32) -> dict[str, np.ndarray]:
        """Frontend-stub batches (vision/audio): precomputed embeddings."""
        rng = self._rng(step)
        emb = rng.standard_normal(
            (self.shard_batch, self.seq_len, d_model)).astype(dtype)
        labels = rng.integers(0, self.vocab,
                              (self.shard_batch, self.seq_len), dtype=np.int32)
        return {key: emb, "labels": labels}


def batch_for_config(cfg, step: int, global_batch: int, seq_len: int,
                     seed: int = 0) -> dict[str, np.ndarray]:
    """Family-aware batch (the keys of `configs.shapes.input_specs`)."""
    ts = TokenStream(cfg.vocab, global_batch, seq_len, seed)
    if cfg.family == "encdec":
        b = ts.batch_at(step)
        e = ts.embeds_at(step, cfg.d_model, key="enc_embeds")
        return {"enc_embeds": e["enc_embeds"].astype(np.float32),
                "tokens": b["tokens"], "labels": b["labels"]}
    if cfg.frontend != "none":
        return ts.embeds_at(step, cfg.d_model)
    return ts.batch_at(step)
