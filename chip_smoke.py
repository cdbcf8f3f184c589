#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one GPU and check every kernel.

    python3 chip_smoke.py [--seed 0] [--scale 22] [--out record.json]

Needs one CUDA card and the CUDA toolkit; it imports nothing of JAX and
nothing of the JAX package. Phases, in order (any failure ends the run with
a nonzero exit; nothing is caught):

1. Device: the card's name and power limit, then the kernels' build time.
1c. Contracts: for every kernel instance the paths launch (the pull at 1,
   8 and 16 lanes and its lane packer, the push and the fresh entry, the
   packing kernel per lanes_block with the bitmap and without, decode
   attention at the bf16 decode shapes of gemma2-9b, yi-9b, stablelm-3b,
   qwen3-moe (g 16), llama4-maverick (g 5), hymba (g 5, h 64, its
   ring of 1,024 slots), seamless-m4t-medium (g 1, h 64: its self-
   attention over the 4,232-position context and its cross-attention over
   the 4,200-position encoder memory) and internvl2-1b (g 7, h 64)), what
   `cudaFuncGetAttributes` reports through the sources' attribute entry
   points: the contract model's static shared bytes must equal the
   compiler's (and decode's dynamic bytes the source's Layout), registers
   stay within the `__launch_bounds__` cap, threads within the instance's
   maximum, and the launchers' occupancy queries give >= 1 block an SM;
   local (spill) bytes are printed. Then `python -m repro_torch.analysis
   src/repro_torch --kernel-contracts` must exit 0.
2. Each of the ten BFS kernel entries against its plain PyTorch version
   on random inputs (ragged R, V not a multiple of 32, masked lanes,
   degree-0 rows, B in {1, 8}, rows of width 32 to 262,144), bitwise; the
   single-lane kernels on lane 0 of the same inputs; the two pull kernels
   and the push also on cases with RMAT-like skew (most rows of degree
   1-4, a few whose first hit lies deep, B in {1, 8, 16}); the push with
   `keep` on and off, from a `pcand` that already holds ids, and with
   10^5 rows pushing into 16 vertices; the packing kernels with the
   bitmap and without, on their own cases too (B in {1, 3, 8, 16, 40}, V
   from 1 to 2^22 and not a multiple of 32, an empty lane, rows that
   start one byte in with degrees one int32 in, all flags set at V = 2^22,
   nf/mf at the int32 limit and one past it). The decode attention
   kernel against its plain version on random (B, S, K, g, h) cases:
   gemma2-9b's, yi-9b's and stablelm-3b's decode shapes, g = 16, rows not
   16-byte aligned, S not a multiple of the split length, tiny edges; fp32
   and bf16, cap 0 and 50, cache_len 1 (every split of S but the first
   empty), S and random (fp32 within 3e-5; bf16 within one bf16 step,
   rtol 2^-7, atol 1e-5); a second call on the same inputs gives the same
   bits, a third with the log-sum-exp gives the same output unrounded
   and an lse within fp32 3e-5 of the plain one, and cache_len 0 gives
   exact zeros and an lse of -inf. Then each case with q scaled
   by 30, so that scores reach the cap: the cap-50 output matches the
   plain one and is far from the kernel's own cap-0 output (standard
   normal scores sit where the cap changes them by about 1e-4, below any
   tolerance).
2s. Sequence-split decode: gemma2-9b's long_500k attention at every
   published width (batch 1, 524,288 positions, 8 KV heads, g 2, h 256,
   bf16, soft cap 50; 4.3 GB of K and V drawn on the card from --seed)
   cut into 16 sequence shards, as a `data` axis of 16 holds them: the
   kernel with the lse on each shard, with the shard's own cache_len, and
   `models.layers.combine_partials`, held against the kernel on the whole
   cache (bf16: rtol 2^-7, atol 1e-5) with the whole cache valid, the
   last shard part-filled, and shard 3 part-filled with the 12 after it
   empty (zeros and -inf). At each of those, the kernel on the whole
   cache and each shard's output and lse are also held against the plain
   version on the same inputs (outputs bf16, lse fp32 3e-5). Both routes'
   times (CUDA events) beside the bound (the cache's bytes over 3.35
   TB/s) and the card. A record, not a claim; single process.
3. Whole-search parity, `Engine(g, device="cuda")` against
   `Engine(g, device="cpu")` on RMAT scale 16: 8 roots batched and 2 in
   Graph500 mode, heuristics paper and beamer, unsplit and with
   `hub_split=True`; 2 roots through `backend="stepper"`. Parents, levels
   and the per-level rows must be equal. Serving parity (3b): the
   smoke configs of gemma2-9b, yi-9b, qwen3-moe, llama4-maverick, mamba2,
   hymba, internvl2 and seamless-m4t in fp32, the prompt of
   `launch.serve.prompt_inputs` (internvl2's bf16 patch embeddings,
   seamless's tokens and bf16 frame embeddings), prefill and 8 greedy
   decode steps on the card against the same weights on the CPU: equal
   tokens, logits within 1e-4.
4. The paths at full size, through `Engine.bfs` on Graph500 RMAT at
   --scale (generated once, on the host in a process of its own while
   phases 1-3b run, and loaded from its file): unsplit (8 roots batched,
   then 4 in Graph500 mode), hub split (the same), and 2 roots through
   the stepper (each on a fresh bucket warms first, inside the path's
   run), on a session with
   `RuntimeConfig(strict_contracts=True)`: every plan passes the kernel-
   contract gate, no warning. A strict session with a 16 KiB budget then
   refuses the cohort plan (`KernelBudgetError`) before any launch. Launch
   counts are
   reset just before each path and read just after it; each path must
   have launched each of its kernels. Every tree passes a vectorised
   Graph500 check. Then each kernel is held against its plain version on
   the inputs captured at the level where it had the most live rows (2b):
   the push from INT_MAX and from the level's final `pcand`, the fresh
   entries on the push's calls, the packing kernels with the bitmap and
   without, there and on the call with the most set flags.
5. BFS kernel times at those shapes: CUDA events (median), the plain
   version's time and the bound (bytes this call needs / 3.35 TB/s); the
   launch floor (an empty kernel timed the same way); for the push also
   the parent's route on the same call (the fresh entry, `where` and
   `scatter_reduce_`, timed as one); for the packing kernels (timed as
   the paths call them, without the bitmap) also with the bitmap, and
   both again on the call with the most set flags, each beside its
   bound (the degrees counted by 32-byte sector); a profile of one search
   on each path, with the summed device time and calls of each of the
   port's kernels in it and the device ops each wrapper launched (one a
   packing call: no fill).
5s. The partitioned BSP search (`Engine.bfs` with n_parts > 1) on gloo
   ranks that share the card (`repro_torch.parallel.ranks`; NCCL refuses
   two ranks on one GPU), after the BFS tensors are freed; each rank loads
   the graph from a temporary .npz the parent writes. Parity on the
   phase-3 graph: P = 2 and P = 4 ranks each run every case (the three
   strategies at the defaults, then the bitmap exchange, the global
   coordinator and beamer, each as `sharded` and as `stepper`) on a CUDA
   session and on a CPU session over the same group: trees and rows
   equal; rank 0 validates the default case's trees. Full size on the
   --scale graph: P = 4, specialized, 4 roots `sharded` (Graph500 mode), 2
   `stepper` and 1 `stepper` with the bitmap exchange, each rank's session
   strict (its sharded plan passes the contract gate); each rank's launch
   counts are zeroed just before and read just after, and `bottomup`,
   `topdown_push` and `frontier_fused` must each have launched. Rank 0
   holds the trees against the Graph500 check and its captured calls of
   the three kernels against their plain versions bitwise, and times them
   at their largest call. Printed: per-root seconds and TEPS, per-level
   compute_s / exchange_s for psum and bitmap, agg_s, the bytes a level on
   the wire, the group's backend. Then, on the same ranks, sharded
   serving: rank 0 serves through `BFSServer(front=PartitionFront(group))`
   and ranks 1-3 run `partition_front.follow`; 2 clients x 3 queries x 2
   roots, every 3rd query streamed on the partitioned stepper, alternating
   between the psum and the bitmap exchange. Each rank's launch counts are
   zeroed just before the load and read just after: rows 5-7 must launch
   on every rank. Every served tree passes the Graph500 check and equals
   the same root through `Engine.bfs` (sharded) on the same ranks, run
   just before. Then the probes on the phase-3 graph:
   `dispatch[mode=sharded]@0` (a retry, served), `dispatch[mode=stepper,
   level=2]@*` on a streamed query (`FaultInjected`: the card's chain has
   no gather stage) and a cancel at a level boundary (`QueryCancelled`),
   each followed by a served query on the same group; every follower ran
   as many dispatches, and aborted as many, as the front counted.
   Printed: QPS, p50/p99 latency, roots a dispatch, the front's
   agreements and their seconds against a streamed level's exchange_s,
   the served/failed/retried/aborted counters. The times are of P ranks
   sharing one card over gloo, not of a multi-GPU run.
5v. The BFS server (`repro_torch.engine.BFSServer`, `launch.bfs_serve`)
   on the card. Load: two sessions of the --scale graph (plan sharing
   on, the default, so one CSR, one tile set and one cohort plan set
   serve both: checked in each session's `cache_info` and by identity,
   with the peak device memory over the load and the bytes of the one
   CSR and the one tile set),
   `bfs_serve.run_load` with 4 clients x 4 queries x 4 roots,
   every 4th query streamed (the stepper), queue depth 64, 16 in flight a
   client; launch counts zeroed after run_load's warm-ups, just before the
   clients start, and read just after: rows 1-3 (the fused dispatches)
   and 5-7 (the streamed ones) must launch. Served equals submitted (with
   the warm-ups); failed, dispatch failures, degradations and worker
   crashes are 0; every tree passes the Graph500 check, and every root's
   parent and level equal the same root through `Engine.bfs` in the
   gather formulation (`backend_kernels=False`: plain PyTorch, no kernel)
   on the same session, 32 roots a search.
   Printed: QPS, p50/p99 latency (p99 of 32 queries is their maximum),
   aggregate TEPS, roots a dispatch, queue
   high water, each session's `busy_s`, beside the card's name and power
   limit (two sessions share the card: a level's seconds end at a
   device-wide sync). Then 4 roots through the gather formulation
   (`backend_kernels=False`) at --scale: equal to the tiles bit for bit,
   no port kernel launched, its seconds beside the tiles'. Then on the
   phase-3 graph the chain: `worker@0` (a crash, a restart, served),
   `dispatch[mode=batch]@0` (a retry), `dispatch[kernels=tiles]@*` (the
   client gets `FaultInjected`: on the card the chain has no gather stage,
   so `degraded_backend` stays 0), `dispatch[mode=batch]@*`
   (`degraded_scalar`, trees equal the tiles'), `device@*` (a typed
   `DevicePressure`, `failed`),
   the breaker's trip and recovery, and the two cancel probes on a
   512-level path.
5r. The runtime layer (`runtime.artifact_cache`, pre-warm,
   `bfs_serve.run_restart_probe`) on the card: child processes in turn
   on a fresh cache dir, each attaching the --scale graph from the file
   phase 5s saved and timing attach plus its first fused query (one
   root). The cold child compiles the four kernel libraries with nvcc and
   builds its three cohort plans; the warm one must run 0 nvcc compiles,
   load all four libraries from the cache, build 0 cohort plans on its
   query path (its pre-warm loaded all three, 0 failed) and launch rows
   1-3; then the bottom-up library's entry is replaced with garbage and
   a third child must evict it, compile that one source again and load
   the rest. All three children's trees are equal bit for bit, pass the
   Graph500 check and equal the same root through `Engine.bfs` in the
   gather formulation (plain PyTorch, no kernel launched) in this
   process. Then the chaos probe's cache phase
   (`bfs_serve.run_cache_chaos`) on the phase-3 graph: a failed plan
   record load is evicted, built again, and the levels stay bitwise
   equal. Printed: cold and warm start, the cold nvcc seconds, the
   library load seconds, the pre-warm's seconds, the hit rate, and each
   start's session seconds: the kernels made ready, the graph hashed,
   the CSR uploaded, the tiles built.
6. The serving path at gemma2-9b's full width (42 layers, bf16, random
   weights from --seed), after the BFS phases' tensors are freed:
   `launch.serve.serve` (what `main` runs) with batch 4, a 4,200-token
   prompt and 32 greedy tokens. The decode kernel's launch count is reset
   just before and read just after (42 x 31); its calls at the first and
   last decode step on layers 0 (local) and 1 (global) are captured and
   held against the plain version (bf16, one step). Then the kernel's time at
   that shape (cap 50 and cap 0, and cap 50 with the lse) with its split
   count, achieved GB/s and share of the bound, its plain version's
   time, one `F.scaled_dot_product_attention` call at cap 0 as the library
   yardstick, and the host's cost of a launcher call; the kernel and SDPA
   at yi-9b's and stablelm-3b's decode shapes too; a profile of one
   decode step.
6b. The moe, ssm, hybrid and encdec families and the vision frontend
   through the same serve run, each at every published width and freed
   before the next: qwen3-moe-235b-a22b cut to 8 of its 94 layers,
   llama4-maverick-400b-a17b to one dense/MoE pair, mamba2-2.7b,
   hymba-1.5b, seamless-m4t-medium (12 + 12 layers) and internvl2-1b
   whole. For each: weights, prefill and decode seconds, tokens/s, peak
   memory; the decode kernel's launches (reset before, read after: its
   decode-attention calls a step x 31, none for mamba2, two a decoder
   layer for seamless: self and cross) and its captured calls at the
   first and last step, calls 0 and 1 of the step (layers 0 and 1;
   seamless's decoder layer 0's self and cross calls) against the plain
   version; for the MoE models the share of top-k assignments the
   capacity dropped at prefill and at decode (routed again from the
   captured inputs); a profile of one decode step; the kernel's time at
   each of the model's decode shapes (seamless: self and cross) against
   its bound, its plain version and one SDPA call. qwen3-moe is served a
   second time from the same seed, in a fresh process (a bf16
   `index_add_` combine gave the same bits twice in one process and other
   ones across processes): the same tokens, the last logits the same bits
   (its MoE combine sums in a fixed order).
7. Training (no kernel on this path: the JAX training path calls no
   Pallas kernel; every `ops` count must stay 0). 7a: the fp32 smoke
   configs of stablelm-3b, qwen3-moe, mamba2, hymba, seamless-m4t and
   internvl2, the same weights and `data.synthetic` batches, 3 train
   steps (AdamW, warmup 2) on the card and on the CPU: losses within
   1e-4 relative, every final parameter within 1e-3 (relative Frobenius
   norm). 7b: stablelm-3b at every published width and all 32 layers
   (2.67 G parameters, bf16, fp32 moments) through `launch.train.train`,
   seq 4,096 (train_4k's length), global batch cut from 256 to 4 in 2
   micro-batches, 4 steps, every layer and loss chunk recomputed in
   backward: step 0 and the steady step's seconds, tokens/s, peak
   memory, each step's loss and grad norm (finite), the bf16 and fp32
   operation bounds, and one more step profiled. 7c: the launcher at
   smoke size on the card, 4 steps with a checkpoint every 2 into a
   directory under build/, then again to 6: it resumes from step 4, and
   steps 4-5 give an uninterrupted 6-step run's losses within 1e-6.
8. Expert parallelism (no kernel on this path): qwen3-moe-235b-a22b's MoE
   layer at every published width (d 4,096, 128 experts, top-8,
   moe_d_ff 1,536) through `models.moe.moe_ffn_a2a` on P = 4 gloo ranks
   sharing the card, a 2 x 2 (data, model) mesh
   (`launch.mesh.make_debug_mesh`); each rank draws only its own weight
   shards (experts on `model`, d_model on `data`, per-expert seeds),
   all-gathers them over `data` (through the host: gloo's functional
   all-gather crashes its rank on a CUDA tensor) and sends its tokens to
   the experts' owners and back with two all-to-alls. 8a: fp32, batch
   2 x 512, capacity factor 8 (nothing drops): forward and backward; the
   ranks' blocks of y and every gradient against `moe_ffn` on the card
   with the same draws, run after the ranks exit (y and x's gradient
   within rtol = atol = 2e-5, the weights' within 1e-4, all finite). 8b:
   bf16 at the config's capacity factor 1.25, batch 2 x 4,096: the
   seconds of a forward and backward (one step, after 8a, which warms the
   ranks up; a step ends with its slowest rank), each all-to-all's bytes
   a rank, the weights gathered a rank, the share of the dispatch that
   capacity drops on each rank, each rank's peak memory. A record, not a
   claim: the ranks share one card and exchange through the host. The
   first step's blocks of y and x's gradient are held against `moe_ffn`
   on the card run on each rank's own tokens, which takes that rank's
   capacity and drops what it drops (within rtol = atol = 2e-2, bf16).
9. Sequence parallelism (no kernel on this path): hymba-1.5b at every
   published width (d 1,600, 25 query and 5 KV heads, neither dividing 4;
   vocab 32,001, which does not divide 4 either, so the CE takes its
   sequence fallback; the SSD beside the attention), 2 of its 32 layers,
   fp32, on P = 4 gloo ranks sharing the card as a 1 x 4 (data, model)
   mesh, through `launch.dryrun.sharded_forwards` (`on_mesh`): each rank
   builds the model from --seed and keeps its shards. A prefill of 1 x
   4,096 tokens (the sequence on `model` between layers, each rank
   attending for its block of queries over the gathered keys and values,
   the SSD's heads split over `model`): its last logits against the
   unsharded prefill on the card (rtol = atol = 1e-5). One `train_step`
   on the same tokens: its loss within 1e-5 relative, and each
   parameter's gradient (each rank's block, captured where the step
   hands the gradients to AdamW) within max |err| <= 1e-4 x max |grad|,
   of the unsharded train step on the card, run after the ranks exit.
   Printed beside the card: prefill and step seconds (the slowest rank),
   the sequence bytes a rank all-gathers and reduce-scatters in forward
   (backward mirrors them) and the weight bytes it gathers, each rank's
   peak memory. A record, not a claim: the ranks share one card and
   exchange through the host. Then, in the same ranks, the int8 gradient
   compression (no kernel: plain PyTorch, as the JAX package computes it
   in jnp): `parallel.collectives.compressed_psum` of each rank's
   gradient blocks (the `to_local()` of each leaf) over the 4 ranks, from
   --seed, against the exact fp32 mean of the same leaves (a plain SUM
   all-reduce): every element within its leaf's shared scale, each
   leaf's mean signed error within 4 x scale / sqrt(numel). Printed
   beside the card: its seconds and the plain all-reduce's, the int32
   bytes a rank sends, the worst |error| / scale.
10. One JSON line listing the kernels, then the result line.

`--out FILE` also writes the full record (timings, shapes, profiles) as
JSON.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
CUDA_CORE_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
PARITY_SCALE = 16              # GPU-vs-CPU whole-search parity graph
TIMING_REPS = 20               # CUDA-event samples per timed kernel
SLEEP_CYCLES = 200_000_000     # ~0.1 s at 1.98 GHz: the host queues ahead
# name: (CUDA source, the TPU kernel's `pl.pallas_call` line)
BFS_KERNELS = {
    "bottomup_batch": ("src/repro_torch/kernels/csrc/bottomup.cu",
                       "src/repro/kernels/bottomup.py:173"),
    "topdown_batch": ("src/repro_torch/kernels/csrc/topdown.cu",
                      "src/repro/kernels/topdown.py:108"),
    "topdown_push_batch": ("src/repro_torch/kernels/csrc/topdown.cu",
                           "src/repro/kernels/topdown.py:108"),
    "frontier_fused_batch": ("src/repro_torch/kernels/csrc/frontier_fused.cu",
                             "src/repro/kernels/frontier_fused.py:124"),
    "hub_bottomup_batch": ("src/repro_torch/kernels/csrc/bottomup.cu",
                           "src/repro/kernels/hub.py:140"),
    "bottomup": ("src/repro_torch/kernels/csrc/bottomup.cu",
                 "src/repro/kernels/bottomup.py:92"),
    "topdown": ("src/repro_torch/kernels/csrc/topdown.cu",
                "src/repro/kernels/topdown.py:45"),
    "topdown_push": ("src/repro_torch/kernels/csrc/topdown.cu",
                     "src/repro/kernels/topdown.py:45"),
    "frontier_fused": ("src/repro_torch/kernels/csrc/frontier_fused.cu",
                       "src/repro/kernels/frontier_fused.py:61"),
    "hub_bottomup": ("src/repro_torch/kernels/csrc/bottomup.cu",
                     "src/repro/kernels/hub.py:77"),
}
DECODE = ("decode_attention", "src/repro_torch/kernels/csrc/decode_attn.cu",
          "src/repro/kernels/decode_attn.py:90")
# (B, S, K, g, h): the JAX kernel tests' sweep, tiny edges, the decode
# shapes of gemma2-9b, yi-9b and stablelm-3b (context 4,232, not a multiple
# of their split lengths), g = 16 at S = 333 (not a multiple of the 32-
# position split), bf16 rows of 40 bytes (no 16-byte copies).
DECODE_CASES = [(2, 1024, 4, 2, 64), (3, 700, 2, 5, 32), (1, 64, 1, 1, 16),
                (1, 1, 1, 1, 8), (4, 4232, 8, 2, 256), (4, 4232, 4, 8, 128),
                (2, 4232, 32, 1, 80), (1, 333, 2, 16, 256), (3, 77, 2, 3, 20)]
# (rtol, atol) of kernel against plain: fp32 sums in another order; bf16
# one step of the value (both round the same fp32 result, up to its order)
DECODE_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2 ** -7, 1e-5)}
CAP_SCALE = 30.0     # q scale at which the scores reach the soft cap of 50
# SDPA against the plain version: it rounds p to bf16 before p @ v
SDPA_TOL = 1e-2
# Phase 2s: gemma2-9b's long_500k attention (a global layer) at every
# published width: batch 1, 524,288 positions, 8 KV heads, g 2, h 256,
# bf16, soft cap 50, cut into 16 sequence shards (a `data` axis of 16, the
# KV heads whole on each shard, as a mesh whose `model` axis divides them
# holds them); cache_len the whole cache, then the last shard part-filled,
# then shard 3 part-filled and the 12 after it empty.
SEQ_SPLIT = dict(arch="gemma2-9b", shape="long_500k", shards=16)
# The serve run: gemma2-9b at full width, cut from configs/shapes.py's
# decode_32k (B = 128, S = 32,768) to one card.
SERVE = dict(arch="gemma2-9b", batch=4, prompt_len=4200, gen=32)
OTHER_DECODE = ("yi-9b", "stablelm-3b")   # decode kernel timed at their shape
# Phase 6b: the moe, ssm, hybrid and encdec families and the vision
# frontend through the same serve run, at every published width, (arch,
# depth cut): qwen3-moe's 94 layers (~470 GB in bf16) cut to 8 (~41 GB
# with the embedding), llama4's 48 to one dense/MoE pair (its MoE layer
# alone ~32 GB); mamba2, hymba, seamless-m4t (~1.4 GB) and internvl2
# (~1.0 GB) whole.
FAMILY_SERVE = (("qwen3-moe-235b-a22b", dict(n_layers=8)),
                ("llama4-maverick-400b-a17b", dict(n_layers=2)),
                ("mamba2-2-7b", {}), ("hymba-1-5b", {}),
                ("seamless-m4t-medium", {}), ("internvl2-1b", {}))
# Phase 6b decodes this model a second time from the same seed, in a
# process of its own: the same tokens, the last logits the same bits (the
# MoE combine sums in a fixed order)
REPEAT_ARCH = "qwen3-moe-235b-a22b"
# Phase 3b: the smoke configs served alike on the card and the CPU
SERVE_PARITY = ("gemma2-9b", "yi-9b", "qwen3-moe-235b-a22b",
                "llama4-maverick-400b-a17b", "mamba2-2-7b", "hymba-1-5b",
                "internvl2-1b", "seamless-m4t-medium")
# Phase 7a: one fp32 smoke config a family, trained on the card and the
# CPU from the same weights and batches
TRAIN_PARITY = dict(archs=("stablelm-3b", "qwen3-moe-235b-a22b",
                           "mamba2-2-7b", "hymba-1-5b", "seamless-m4t-medium",
                           "internvl2-1b"), batch=2, seq=32, steps=3)
TRAIN_LOSS_RTOL, TRAIN_PARAM_RTOL = 1e-4, 1e-3
# Phase 7b: stablelm-3b at every published width and depth, cut from
# configs/shapes.py's train_4k (global batch 256 at 4,096) to 4 sequences
# in 2 micro-batches, 4 steps
TRAIN_FULL = dict(arch="stablelm-3b", batch=4, seq=4096, accum=2, steps=4)
# Phase 7c: the launcher's restart at smoke size
TRAIN_RESTART = dict(arch="stablelm-3b", batch=2, seq=32, first=4, total=6,
                     every=2)
# Phase 8: qwen3-moe-235b-a22b's MoE layer at every published width
# through `moe_ffn_a2a` on P = 4 gloo ranks sharing the card, a 2 x 2
# (data, model) mesh. 8a: fp32, capacity factor 8 (nothing drops, so the
# ranks' local capacity gives `moe_ffn`'s result); 8b: bf16 at the
# config's capacity factor, timed, and its first step held against
# `moe_ffn` on each rank's own tokens.
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_MESH = (2, 2)
MOE_EQUAL = dict(batch=2, seq=512, capacity_factor=8.0)
MOE_TIMED = dict(batch=2, seq=4096, reps=1)
MOE_TOL = dict(rtol=2e-5, atol=2e-5)        # y and x's gradient
MOE_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)   # the weights' gradients
MOE_BF16_TOL = dict(rtol=2e-2, atol=2e-2)   # 8b: y and x's gradient
MOE_WEIGHTS = ("router", "wg", "wi", "wo")
# Phase 9: hymba-1.5b's sequence-parallel prefill and train step at every
# published width, cut to 2 layers, fp32, on P = 4 gloo ranks sharing the
# card as a 1 x 4 (data, model) mesh.
SEQ_ARCH = "hymba-1-5b"
SEQ_MESH = (1, 4)
SEQ_RUN = dict(layers=2, batch=1, seq=4096)
SEQ_LOGITS_TOL = dict(rtol=1e-5, atol=1e-5)
SEQ_LOSS_RTOL = 1e-5
SEQ_GRAD_TOL = 1e-4                 # of the gradient's largest |entry|
# the compressed mean (int8, stochastic rounding) against the exact fp32
# mean: every element within its leaf's shared scale (the hard bound; the
# slack covers the two means' fp32 rounding), each leaf's mean signed error
# within SEQ_COMPRESS_BIAS * scale / sqrt(numel)
SEQ_COMPRESS_SLACK = 2.0 ** -10
SEQ_COMPRESS_BIAS = 4.0
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
# device ops that are matrix products, by a part of their kernel's name
MATMUL_KEYS = ("gemm", "matmul", "cutlass", "xmma", "cublas", "nvjet")
SDPA_NOTE = ("F.scaled_dot_product_attention (enable_gqa, boolean mask from "
             "cache_len) computes the cap-0 function; no single PyTorch call "
             "computes the soft-capped one the model runs (cap 50)")
# The kernels each full-size path must launch.
PATH_KERNELS = {
    "unsplit": ("bottomup_batch", "topdown_push_batch",
                "frontier_fused_batch"),
    "split": ("hub_bottomup_batch", "bottomup_batch", "topdown_push_batch",
              "frontier_fused_batch"),
    "stepper": ("bottomup", "topdown_push", "frontier_fused"),
}
# The push updates `pcand` (its argument 4) in place.
PUSH = ("topdown_push_batch", "topdown_push")
# The fresh entries leave the paths: each is checked and timed on the
# calls of its push.
FRESH_OF = {"topdown_batch": "topdown_push_batch", "topdown": "topdown_push"}
FRESH_NOTE = ("the TPU kernel's function (fresh uint8[B, C, W]); no path "
              "launches it since the push replaced it with its caller's "
              "scatter-min; checked in phases 2 and 2b and timed on the "
              "push's call")
INT_MAX = 2**31 - 1
HUB_BOTTOMUP_NOTE = (
    "no path of the JAX package calls hub_bottomup_pallas (only "
    "kernels/ops.py); checked in phase 2 and timed on lane 0 of a captured "
    "hub_bottomup_batch call")


def log(msg: str) -> None:
    print(msg, flush=True)


def equal(a, b) -> bool:
    """Bitwise equality of two tensors on any device (uint32 via int32)."""
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def max_abs_err(a, b) -> int:
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.uint32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


# --------------------------------------------------------------- contracts --

# The decode shapes phase 1c asks the compiler about: batch 4 at the serve
# run's context (hymba's ring of its window; seamless's cross call the
# prompt's length), each model's (g, h) in bf16.
CONTRACT_DECODE = ("gemma2-9b", "yi-9b", "stablelm-3b", "qwen3-moe-235b-a22b",
                   "llama4-maverick-400b-a17b", "hymba-1-5b",
                   "seamless-m4t-medium", "internvl2-1b")
# A per-CTA budget below the 8-lane pull instance's static shared memory:
# a strict session under it must refuse the cohort plan before any launch.
TIGHT_SMEM = 16 * 1024


def decode_calls(cfg) -> tuple:
    """The decode-attention calls a layer of `cfg` makes a step: "self",
    and under encdec also "cross" (to the encoder's memory)."""
    return ("self", "cross") if cfg.family == "encdec" else ("self",)


def calls_per_step(cfg) -> int:
    """Decode-attention calls in one decode step: one a layer that attends
    (none for ssm layers), two an encdec decoder layer."""
    from repro_torch.models import model as MODEL
    return sum(0 if MODEL.layer_kind(cfg, i) == "ssm" else
               len(decode_calls(cfg)) for i in range(cfg.n_layers))


def decode_len(cfg, call: str = "self") -> int:
    """The cache length a decode call of `cfg` reads at the serve run's
    context: the whole context, but hymba's ring of `sliding_window`
    slots, and for encdec's cross call the encoder memory (the prompt's
    length)."""
    if call == "cross":
        return SERVE["prompt_len"]
    s = SERVE["prompt_len"] + SERVE["gen"]
    return min(s, cfg.sliding_window) if cfg.family == "hybrid" else s


def attributes(dev, inst) -> dict:
    """What `cudaFuncGetAttributes` reports of a contract's kernel instance,
    through its library's `repro_<lib>_attributes` entry point."""
    import ctypes
    from repro_torch.kernels import _build
    out = (ctypes.c_int * 6)()
    err = _build.function(f"{inst.library}_attributes", dev.index)(
        *inst.selectors, ctypes.addressof(out), dev.index)
    assert err == 0, f"{inst.library}_attributes{inst.selectors}: {err}"
    return dict(zip(("shared", "regs", "local", "max_threads",
                     "max_dynamic", "dynamic"), out))


def contract_instances(dev):
    """(label, instance, blocks an SM holds or None) for every kernel
    instance the paths launch: the pull at 1, 8 and 16 lanes (staged with
    more than one) and the lane packer a packed plan runs first, the push
    and the fresh entry, the packing kernel with the bitmap and without
    per lanes_block, and decode attention at three models' shapes. The
    blocks an SM holds come from the launchers' occupancy queries."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import bottomup, decode_attn, frontier_fused
    from repro_torch.kernels import contracts as KC
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    for lb in (1, 8, 16):
        out.append((f"pull lanes_block {lb}", KC.pull_instance(lb),
                    bottomup.resident_blocks(dev, lb)))
    for lb in (8, 16):
        out.append((f"pull's lane packer {lb}", KC.pack_instance(lb), None))
    for lb in (1, 8, 16):
        out.append((f"push lanes_block {lb}", KC.push_instance(lb), None))
    out.append(("fresh entry", KC.fresh_instance(), None))
    for lb in (1, 2, 4, 8):
        for packed in (False, True):
            out.append((f"packing lanes_block {lb}"
                        f"{' with the bitmap' if packed else ''}",
                        KC.fused_instance(lb, packed),
                        frontier_fused.resident_blocks(dev, lb, packed)))
    for arch in CONTRACT_DECODE:
        cfg = get_config(arch)
        g, h = cfg.n_heads // cfg.n_kv, cfg.head_dim
        res = decode_attn.resident_blocks(dev, torch.bfloat16, g, h)
        for call in decode_calls(cfg):
            b, s = SERVE["batch"], decode_len(cfg, call)
            nsplit, _ = decode_attn.split_plan(b, cfg.n_kv, s, sms, res)
            out.append((f"decode {arch}{' cross' if call == 'cross' else ''}"
                        f" (bf16, g {g}, h {h}, S {s}, {nsplit} splits)",
                        KC.decode_instance("bfloat16", g, h, nsplit), res))
    return out


def phase_contracts(dev, record):
    """Phase 1c: the contract model against the compiler, for every kernel
    instance the paths launch: static shared bytes equal, registers within
    the launch bounds' cap, threads within the instance's maximum, blocks
    an SM holds >= 1, decode's dynamic bytes equal to the source's Layout;
    then the analysis CLI with the kernel-contract gate must exit 0."""
    from repro_torch.analysis import smem
    rows = []
    for label, inst, resident in contract_instances(dev):
        a = attributes(dev, inst)
        rep = smem.smem_report(inst)
        row = dict(label=label, symbol=inst.symbol, threads=inst.threads,
                   model_static=inst.static_bytes,
                   model_dynamic=inst.dynamic_bytes,
                   register_cap=inst.register_cap, resident=resident, **a)
        rows.append(row)
        log(f"  {label}: {inst.symbol}: static shared {a['shared']} B "
            f"(model {inst.static_bytes}), dynamic {a['dynamic']} B "
            f"(model {inst.dynamic_bytes}), {a['regs']} registers (cap "
            f"{inst.register_cap}), local {a['local']} B, max threads "
            f"{a['max_threads']}, max dynamic {a['max_dynamic']} B, "
            f"{'resident ' + str(resident) if resident else 'no query'}")
        assert a["shared"] == inst.static_bytes, (label, a, inst)
        assert a["dynamic"] == inst.dynamic_bytes, (label, a, inst)
        assert a["regs"] <= inst.register_cap, (label, a, inst)
        assert inst.threads <= a["max_threads"], (label, a, inst)
        assert resident is None or resident >= 1, (label, resident)
        assert rep.fits, (label, rep.problems)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
         "--kernel-contracts"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    cli_s = time.perf_counter() - t0
    assert cli.returncode == 0, cli.stdout + cli.stderr
    record["contracts"] = dict(instances=rows, cli_s=cli_s,
                               cli=cli.stdout.strip().splitlines()[-1])
    log(f"phase 1c: {len(rows)} kernel instances on {record['card']}: the "
        f"model's static shared bytes equal the compiler's, registers "
        f"within the launch bounds, no more threads than each takes; "
        f"`python -m repro_torch.analysis src/repro_torch "
        f"--kernel-contracts` exit 0 in {cli_s:.2f} s "
        f"({record['contracts']['cli']})")


# ------------------------------------------------------------ kernel checks --

def plain_fn(name):
    from repro_torch.kernels import bottomup, frontier_fused, hub, topdown
    mod = {"bottomup": bottomup, "topdown": topdown, "topdown_push": topdown,
           "frontier_fused": frontier_fused,
           "hub_bottomup": hub}[name.removesuffix("_batch")]
    return getattr(mod, name + "_plain")


def kernel_vs_plain(name, args, errs, **kw):
    """Run kernel `name` through its ops wrapper (CUDA tensors: the kernel)
    and its plain version on the same tensors and keywords; assert bitwise
    equality (an output both leave out, None, is equal). The push runs each
    side on its own copy of `pcand`."""
    from repro_torch.kernels import ops
    if name in PUSH:
        ka, pa = list(args), list(args)
        ka[4], pa[4] = args[4].clone(), args[4].clone()
        getattr(ops, name)(*ka, **kw)
        plain_fn(name)(*pa, **kw)
        out_k, out_p = ka[4], pa[4]
    else:
        out_k = getattr(ops, name)(*args, **kw)
        out_p = plain_fn(name)(*args, **kw)
    out_k = out_k if isinstance(out_k, tuple) else (out_k,)
    out_p = out_p if isinstance(out_p, tuple) else (out_p,)
    for k, p in zip(out_k, out_p):
        if k is None or p is None:
            assert k is None and p is None, f"{name}: an output is missing"
            continue
        errs[name] = max(errs[name], max_abs_err(k, p))
        assert equal(k, p), f"{name}: kernel != plain version"


def check_frontier(flags, vdeg, errs):
    """The packing kernel with the bitmap and without, batched and on lane
    0."""
    for packed in (True, False):
        kernel_vs_plain("frontier_fused_batch", (flags, vdeg), errs,
                        packed=packed)
        kernel_vs_plain("frontier_fused", (flags[0], vdeg), errs,
                        packed=packed)


def make_case(rng, dev, b, r, w, v, masked, dens):
    """deg int32[B, R] (a quarter degree 0, the last `masked` lanes all 0),
    nbrs int32[R, W] (ids out of range on both sides, clipped), flags
    uint8[B, V] of density `dens`, vertex degrees int32[V]."""
    import torch
    deg = rng.integers(1, w + 1, (b, r)).astype(np.int32)
    deg[rng.random((b, r)) < 0.25] = 0                 # degree-0 rows
    deg[b - masked:] = 0                               # masked lanes
    nbrs = rng.integers(-2, v + 2, (r, w)).astype(np.int32)   # clipped
    flags = (rng.random((b, v)) < dens).astype(np.uint8)
    vdeg = rng.integers(0, 1 << 12, v).astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (deg, nbrs, flags,
                                                       vdeg))


# (B, R, W, V, lanes masked, frontier density)
CASES = [(1, 5, 32, 37, 0, 0.3), (8, 333, 64, 4099, 3, 0.05),
         (8, 1000, 32, 100003, 2, 0.01), (1, 3, 4096, 70001, 0, 0.0005),
         (8, 9, 4096, 50000, 4, 0.001), (8, 20000, 32, 262144, 1, 0.02)]
# Hub widths: sparse frontiers, so that some rows hit deep or not at all.
HUB_CASES = [(8, 3000, 256, 1000003, 2, 0.002), (1, 700, 1024, 500001, 0,
                                                  0.0005),
             (8, 60, 16384, 4194304, 3, 0.0001),
             (8, 6, 262144, 4194304, 1, 0.00001),
             (1, 4, 262144, 4194304, 0, 0.000002)]


def make_skewed_case(rng, dev, b, r, w, v, deep):
    """A pull case with RMAT-like skew: most rows of degree 1-4, a few up
    to W; a frontier of density 0.02 that never holds vertex 0; and a
    fraction `deep` of the rows whose first hit, in every lane, lies at a
    random slot past 3/4 of the degree (the slots before it hold -1, which
    clips to vertex 0). Returns (deg, nbrs, flags) on `dev`."""
    import torch
    small = rng.integers(1, 5, (b, r))
    big = rng.integers(1, w + 1, (b, r))
    deg = np.where(rng.random((b, r)) < 0.9, small, big).astype(np.int32)
    deg[rng.random((b, r)) < 0.2] = 0                  # settled rows
    nbrs = rng.integers(1, v, (r, w)).astype(np.int32)
    flags = (rng.random((b, v)) < 0.02).astype(np.uint8)
    flags[:, 0] = 0
    for i in np.flatnonzero(rng.random(r) < deep):
        d = max(1, int(deg[:, i].max()))
        s = int(rng.integers(d * 3 // 4, d))
        deg[:, i] = np.where(deg[:, i] > 0, d, 0)
        nbrs[i, :s] = -1
        flags[:, nbrs[i, s]] = 1
    return tuple(torch.from_numpy(x).to(dev) for x in (deg, nbrs, flags))


# (B, R, W, V, deep-row fraction): the base bucket's width with 16 and 1
# lanes, a hub width, and wide rows whose first hits lie past the hub
# kernel's warp phase.
SKEWED_CASES = [(16, 300001, 32, 4194304, 0.001), (8, 200003, 32, 1000003,
                                                   0.01),
                (1, 300001, 32, 4194304, 0.001), (16, 5000, 256, 4194304, 0.05),
                (8, 300, 4096, 4194304, 0.2), (16, 40, 65536, 4194304, 0.5)]


# (B, R, W, V, targets): 10^5 rows live in every lane, every slot naming
# one of 16 unvisited vertices (slots past the degree too).
CONTENTION = (8, 100_000, 32, 1 << 20, 16)


def make_contention_case(rng, dev, b, r, w, v, targets):
    """(deg, nbrs, flags) on `dev`: every row live in every lane, ids in
    0 .. targets - 1, those vertices unvisited in every lane."""
    import torch
    deg = np.repeat(rng.integers(1, w + 1, (1, r)), b, 0).astype(np.int32)
    nbrs = rng.integers(0, targets, (r, w)).astype(np.int32)
    flags = (rng.random((b, v)) < 0.5).astype(np.uint8)
    flags[:, :targets] = 0
    return tuple(torch.from_numpy(x).to(dev) for x in (deg, nbrs, flags))


def push_args(rng, deg, nbrs, flags, keep):
    """The push's inputs on a pull case's tensors: distinct row ids, the
    flags as `visited`, a `pcand` that holds ids at 30% of its entries (as
    after earlier buckets of a level), and `keep` (half the vertices) or
    None."""
    import torch
    b, r = deg.shape
    v = flags.shape[1]
    rows = rng.permutation(max(r, v))[:r].astype(np.int32)
    pcand = np.full((b, v), INT_MAX, np.int32)
    some = rng.random((b, v)) < 0.3
    pcand[some] = rng.integers(0, v, int(some.sum()))
    kp = (rng.random(v) < 0.5).astype(np.uint8) if keep else None
    rows, pcand, kp = (None if x is None else torch.from_numpy(x).to(
        deg.device) for x in (rows, pcand, kp))
    return deg, nbrs, rows, flags, pcand, kp


def check_push(rng, deg, nbrs, flags, errs):
    """The push, batched and on lane 0, with `keep` off and on."""
    for keep in (False, True):
        args = push_args(rng, deg, nbrs, flags, keep)
        kernel_vs_plain("topdown_push_batch", args, errs)
        d, n, r, f, pc, kp = args
        kernel_vs_plain("topdown_push", (d[0], n, r, f[0], pc[0], kp), errs)


def phase_kernels(rng, hub_rng, push_rng, dev, errs):
    """Every kernel on random cases; the single-lane ones on lane 0. The
    hub and skewed cases draw from `hub_rng` and the push's own inputs
    from `push_rng`, so `rng` reaches the later phases (and picks the
    scale-22 roots) as it did before they were added."""
    import torch
    n = 0
    for spec in CASES + HUB_CASES:
        deg, nbrs, flags, vdeg = make_case(
            hub_rng if spec in HUB_CASES else rng, dev, *spec)
        d0, f0 = deg[0], flags[0]
        kernel_vs_plain("hub_bottomup_batch", (deg, nbrs, flags), errs)
        kernel_vs_plain("hub_bottomup", (d0, nbrs, f0), errs)
        check_push(push_rng, deg, nbrs, flags, errs)
        if spec in HUB_CASES:
            continue
        kernel_vs_plain("bottomup_batch", (deg, nbrs, flags), errs)
        kernel_vs_plain("topdown_batch", (deg, nbrs, flags), errs)
        check_frontier(flags, vdeg, errs)
        kernel_vs_plain("bottomup", (d0, nbrs, f0), errs)
        kernel_vs_plain("topdown", (d0, nbrs, f0), errs)
        n += 1
    for spec in SKEWED_CASES:
        deg, nbrs, flags = make_skewed_case(hub_rng, dev, *spec)
        for name in ("bottomup", "hub_bottomup"):
            kernel_vs_plain(name + "_batch", (deg, nbrs, flags), errs)
            kernel_vs_plain(name, (deg[0], nbrs, flags[0]), errs)
        check_push(push_rng, deg, nbrs, flags, errs)
    check_push(push_rng, *make_contention_case(push_rng, dev, *CONTENTION),
               errs)
    n_ff = phase_frontier(hub_rng, dev, errs)
    torch.cuda.synchronize()
    return n + 1, n_ff


# The packing kernel's own cases: (B, V, density), an empty last lane;
# each also on a view whose rows start one byte in (an unaligned start, a
# row stride of V + 1) and with degrees one int32 off 16-byte alignment.
FRONTIER_CASES = [(b, v, 0.3) for b in (1, 3, 8, 16, 40)
                  for v in (1, 31, 37, 4096, 10000)] + [
                      (8, 1 << 22, 0.002), (40, 1 << 20, 0.05)]
FRONTIER_WIDE = 1 << 22     # all flags set, B = 1, 8, 16 and 40


def frontier_wrap(dev, b, v, total):
    """Every flag of B lanes set, degrees summing to `total` (mod 2^32, as
    int32) per lane; with more than one lane, the last one's first flag
    clear."""
    import torch
    vdeg = np.full(v, total // v, np.int64)
    vdeg[0] += total - int(vdeg.sum())
    flags = torch.ones((b, v), dtype=torch.uint8, device=dev)
    if b > 1:
        flags[b - 1, 0] = 0
    return flags, torch.from_numpy(vdeg.astype(np.int32)).to(dev)


def phase_frontier(rng, dev, errs):
    """The packing kernel, both stores, on FRONTIER_CASES (plain rows,
    rows that start one byte in, degrees off alignment), all flags set at
    V = 2^22, and nf/mf at the int32 limit and one past it (the wrap).
    Returns the cases run."""
    import torch
    n = 0
    for b, v, dens in FRONTIER_CASES:
        wide = (rng.random((b, v + 1)) < dens).astype(np.uint8)
        wide[b - 1] = 0                               # an empty lane
        wide = torch.from_numpy(wide).to(dev)
        deg = torch.from_numpy(
            rng.integers(0, 1 << 12, v + 1).astype(np.int32)).to(dev)
        for flags, vdeg in ((wide[:, :v].contiguous(), deg[:v]),
                            (wide[:, 1:], deg[1:])):
            check_frontier(flags, vdeg, errs)
            n += 1
    for b in (1, 8, 16, 40):
        flags = torch.ones((b, FRONTIER_WIDE), dtype=torch.uint8, device=dev)
        vdeg = torch.from_numpy(rng.integers(
            0, 1 << 8, FRONTIER_WIDE).astype(np.int32)).to(dev)
        check_frontier(flags, vdeg, errs)
        n += 1
    for total in (2**31 - 1, 2**31):
        for b, v in ((2, 4096), (3, 10000), (1, 37)):
            check_frontier(*frontier_wrap(dev, b, v, total), errs)
            n += 1
    return n


# ---------------------------------------------------------- whole searches --

ROW_KEYS = ("level", "direction", "td_lanes", "bu_lanes", "frontier_size",
            "frontier_edges", "lane_direction", "lane_frontier",
            "lane_hub_direction", "lane_hub_frontier", "hub_td_lanes",
            "hub_bu_lanes", "frontier_hub")
STEPPER_KEYS = ("level", "direction", "frontier_size", "frontier_edges")


def rows_of(res):
    return [tuple(str(r[k]) for k in ROW_KEYS) for r in res.batch_level_stats]


def stepper_rows(res):
    return [[tuple(r[k] for k in STEPPER_KEYS) for r in rows]
            for rows in res.per_level_stats]


def same_trees(a, b, what):
    assert np.array_equal(a.parent, b.parent), f"{what}: parents differ"
    assert np.array_equal(a.level, b.level), f"{what}: levels differ"


def phase_parity(scale, rng):
    from repro_torch.core import graph as G, ref
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.engine import Engine
    g = G.rmat(scale, seed=int(rng.integers(1 << 30)))
    pos = np.flatnonzero(g.degrees > 0)
    roots = rng.choice(pos, 8, replace=False)
    gpu, cpu = Engine(g, device="cuda"), Engine(g, device="cpu")
    for h in ("paper", "beamer"):
        for split in (False, True):
            what = f"{h}{' split' if split else ''}"
            cfg = BFSConfig(heuristic=h, hub_split=split)
            a, b = gpu.bfs(roots, cfg), cpu.bfs(roots, cfg)
            same_trees(a, b, what)
            rows = rows_of(b)
            assert rows_of(a) == rows, what
            a = gpu.bfs(roots[:2], cfg, batched=False)
            same_trees(a, cpu.bfs(roots[:2], cfg, batched=False), what)
            for i, r in enumerate(roots[:2]):
                ref.validate_parents(g, int(r), a.parent[i], a.level[i])
            log(f"  {what}: batched {len(rows)} levels, directions "
                f"{[r[1] for r in rows]}")
    a = gpu.bfs(roots[:2], backend="stepper")
    b = cpu.bfs(roots[:2], backend="stepper")
    same_trees(a, b, "stepper")
    assert stepper_rows(a) == stepper_rows(b), "stepper rows differ"
    log(f"  stepper: directions {[r[1] for r in stepper_rows(a)[0]]}")
    # closing takes the sessions' plans and tiles back from the process's
    # plan registry, so later phases share nothing with these
    gpu.session.close()
    cpu.session.close()
    return g


class Graph500Check:
    """Vectorised Graph500 validation on the card for big graphs."""

    def __init__(self, g, dev):
        import torch
        v = g.num_vertices
        self.v, self.dev = v, dev
        self.src = torch.repeat_interleave(
            torch.arange(v, device=dev, dtype=torch.int32),
            torch.from_numpy(g.degrees).to(dev).to(torch.int64))
        self.dst = torch.from_numpy(g.indices).to(dev)
        self.keys = torch.sort(self.src.to(torch.int64) * v
                               + self.dst.to(torch.int64)).values

    def levels(self, root):
        """Plain level-synchronous BFS over the edge list."""
        import torch
        level = torch.full((self.v,), -1, dtype=torch.int32, device=self.dev)
        level[root] = 0
        frontier = torch.zeros(self.v, dtype=torch.bool, device=self.dev)
        frontier[root] = True
        depth = 0
        while True:
            reached = torch.zeros(self.v, dtype=torch.bool, device=self.dev)
            reached[self.dst[frontier[self.src]].to(torch.int64)] = True
            new = reached & (level < 0)
            if not bool(new.any()):
                return level
            depth += 1
            level[new] = depth
            frontier = new

    def check(self, root, parent, level):
        import torch
        parent = torch.from_numpy(parent).to(self.dev).to(torch.int64)
        level = torch.from_numpy(level).to(self.dev)
        assert torch.equal(level, self.levels(root)), "levels differ"
        assert int(parent[root]) == root, "root is not its own parent"
        assert torch.equal(parent >= 0, level >= 0), "coverage != reached"
        vs = torch.nonzero(level > 0).flatten()
        p = parent[vs]
        key = vs * self.v + p
        pos = torch.searchsorted(self.keys, key).clamp(max=self.keys.numel() - 1)
        assert torch.equal(self.keys[pos], key), "a parent is not a neighbour"
        assert torch.equal(level[p], level[vs] - 1), "a tree edge skips a level"


def install_capture():
    """Record every wrapper call's inputs with the path and the level it
    ran at (a frontier_fused call closes a level). Returns (calls, path,
    restore): set `path[0]` to label the calls that follow."""
    from repro_torch.kernels import ops
    calls, level, path = [], [0], [None]
    saved = {n: getattr(ops, n) for n in BFS_KERNELS if hasattr(ops, n)}

    def wrap(name):
        def fn(*args, **kw):
            if name in PUSH and len(args) == 5:     # keep by default
                calls.append((path[0], level[0], name,
                              args + (kw.get("keep"),)))
            else:
                calls.append((path[0], level[0], name, args))
            if name.startswith("frontier_fused"):
                level[0] += 1
            return saved[name](*args, **kw)
        return fn

    for n in saved:
        setattr(ops, n, wrap(n))

    def restore():
        for n, f in saved.items():
            setattr(ops, n, f)
    return calls, path, restore


def pick_calls(calls):
    """Per kernel, the captured calls of the level where it had the most
    live rows (nonzero degrees); a packing kernel takes the level of its
    path's push kernel (the fresh entry in a checkout older than the
    push)."""
    import torch
    work = {}
    for _, lvl, name, args in calls:
        if not name.startswith("frontier_fused"):
            key = (name, lvl)
            work[key] = work.get(key, 0) + int((args[0] != 0).sum())
    best = {}
    for (name, lvl), w in work.items():
        if w > best.get(name, (-1, 0))[1]:
            best[name] = (lvl, w)
    levels = {n: lvl for n, (lvl, _) in best.items()}
    for fresh, push in FRESH_OF.items():
        src = push if push in levels else fresh
        if src in levels:
            levels["frontier_fused" + fresh.removeprefix("topdown")] = \
                levels[src]
    torch.cuda.synchronize()
    return {name: [c for c in calls if c[2] == name and c[1] == lvl]
            for name, lvl in levels.items()}


def flag_call(calls, name):
    """(level, args) of the captured call of packing kernel `name` with the
    most set flags, on any path and level (the bottom-up levels' wide next
    frontiers, where the kernel reads most of the degrees)."""
    _, lvl, _, cargs = max((c for c in calls if c[2] == name),
                           key=lambda c: int((c[3][0] != 0).sum()))
    return lvl, cargs


# --------------------------------------------------------------- timing --

def time_ms(fn, reps, flush, setup=None):
    """Median device ms of `fn` between two CUDA events, over `reps` runs,
    each after `setup()` (if given; outside the events, for a kernel that
    works in place) and a read of `flush` (larger than the L2, so inputs
    come from device memory; a read leaves no dirty lines for `fn` to
    write back). All runs are queued behind a device-side sleep, so the
    host's time to launch `fn` is not in the events' interval."""
    import torch
    if setup is not None:
        setup()
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for s, e in events:
        if setup is not None:
            setup()
        flush.amax()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


# The port's kernels in a profile, by source: the first symbol (a part of
# the kernel's name) that a device op's name contains. Older checkouts'
# kernels match too (`scripts/time_bfs.py` profiles them): their hub.cu
# kernel's name also contains "bottomup_", so it goes first.
KERNEL_SYMBOLS = (("hub.cu", "::hub_"), ("bottomup.cu", "::bottomup_"),
                  ("bottomup.cu", "::pull_kernel"),
                  ("bottomup.cu", "::pack_kernel"),
                  ("topdown.cu", "::topdown_"),
                  ("topdown.cu", "::push_kernel"),
                  ("frontier_fused.cu", "::frontier_fused_"),
                  ("frontier_fused.cu", "::fused_kernel"),
                  ("decode_attn.cu", "::decode_attn_"))


def kernel_sums(rows):
    """{source: {device_ms, calls}} of the port's kernels among profile
    rows (op, device ms, calls)."""
    sums = {}
    for op, ms, n in rows:
        for source, symbol in KERNEL_SYMBOLS:
            if symbol in op:
                acc = sums.setdefault(source, dict(device_ms=0.0, calls=0))
                acc["device_ms"] += ms
                acc["calls"] += n
                break
    return sums


# CUDA runtime calls that put one op on a stream (kernels, fills, copies)
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemsetAsync",
                "cudaMemcpyAsync")


def range_launches(events) -> dict:
    """{`ops` range name: the CUDA runtime launch calls made inside its
    ranges}, by host time: a kernel launched through ctypes is linked to no
    PyTorch op, so the range's own tree does not hold it, but its runtime
    call lies inside the range (one thread launches)."""
    import bisect
    from torch.autograd import DeviceType
    host = [e for e in events if e.device_type == DeviceType.CPU]
    starts = sorted(e.time_range.start for e in host
                    if e.name.startswith(LAUNCH_CALLS))
    out = {}
    for e in host:           # the device's copy of a range is not counted
        if e.name.startswith("ops."):
            n = (bisect.bisect_left(starts, e.time_range.end)
                 - bisect.bisect_left(starts, e.time_range.start))
            out[e.name[4:]] = out.get(e.name[4:], 0) + n
    return out


def profile_search(search, top=10):
    """One more search (`search()`) under torch.profiler: device time by op
    (self time, ms), the summed device time and calls of each of the port's
    kernels by source (`kernel_sums`) and by `ops` wrapper (each wrapper
    call runs in a `record_function` range named after it: a range's
    device time is that of the kernels linked to it, its device ops the
    runtime launches inside it, `range_launches`), and the device's
    busy share of the search's wall time. Not part of the paths' launch
    counts (read before this runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import ops
    saved = {n: getattr(ops, n) for n in BFS_KERNELS if hasattr(ops, n)}

    def labelled(name):
        def fn(*args, **kw):
            with record_function(f"ops.{name}"):
                return saved[name](*args, **kw)
        return fn
    for n in saved:
        setattr(ops, n, labelled(n))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for n, f in saved.items():
        setattr(ops, n, f)
    rows, wrappers = [], {}
    for evt in prof.key_averages():
        if evt.key.startswith("ops."):   # a range, not a device op
            wrappers[evt.key[4:]] = dict(
                device_ms=getattr(evt, "device_time_total",
                                  getattr(evt, "cuda_time_total", 0)) / 1e3,
                calls=evt.count, device_ops=0)
            continue
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue                      # host ops; kernels are listed alone
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((evt.key, dev_us / 1e3, evt.count))
    for name, n in range_launches(prof.events()).items():
        if name in wrappers:
            wrappers[name]["device_ops"] = n
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return dict(wall_s=wall, device_busy_ms=busy_ms,
                idle_share=max(0.0, 1.0 - busy_ms / 1e3 / wall),
                kernels=kernel_sums(rows), wrappers=wrappers,
                top=[dict(op=k[:80], device_ms=ms, calls=n)
                     for k, ms, n in rows[:top]])


def touched_bytes(table, lanes_idx):
    """Distinct (lane, vertex) bytes a gather reads from a [B, V] table."""
    import torch
    b, v = table.shape
    seen = torch.zeros(b * v, dtype=torch.bool, device=table.device)
    seen[lanes_idx] = True
    return int(seen.sum())


def as_batch(name, args):
    """A single-lane call's inputs with a lane axis of 1 (views)."""
    if name in ("bottomup", "hub_bottomup", "topdown"):
        deg, nbrs, table = args
        return deg[None], nbrs, table[None]
    if name == "topdown_push":
        deg, nbrs, rows, table, pcand, keep = args
        return deg[None], nbrs, rows, table[None], pcand[None], keep
    if name == "frontier_fused":
        flags, deg = args
        return flags[None], deg
    return args


def push_bound(args):
    """(bytes, ops, sector bytes) a push call (batch form) needs: the [B, R]
    degrees; the ids of each row up to its largest live degree and the
    ids of the live rows; one byte of `keep` per vertex those slots name;
    one visited byte per distinct (lane, vertex) of the live slots that
    `keep` lets through; a read and a write of pcand per distinct fresh
    (lane, vertex). The ops are the live (lane, slot) tests. The sector
    bytes count instead 32 bytes (a sector) for every visited gather and
    for every fresh slot's pcand."""
    import torch
    deg, nbrs, rows, table, pcand, keep = args
    b, r = deg.shape
    w = nbrs.shape[1]
    v = table.shape[1]
    live = deg.clamp(0, w).to(torch.int64)                   # [B, R]
    need = live.max(dim=0).values                            # [R]
    cols = torch.arange(w, device=deg.device)
    safe = nbrs.clamp(0, v - 1).to(torch.int64)
    head = 4 * b * r + 4 * int(need.sum()) + 4 * int((need > 0).sum())
    kept = None
    if keep is not None:
        named = safe[cols[None] < need[:, None]]
        head += touched_bytes(keep[None], named)
        kept = keep[safe] != 0
    gathers, fresh = [], []
    for lane in range(b):
        m = cols[None] < live[lane][:, None]                 # [R, W]
        if kept is not None:
            m &= kept
        gathers.append(lane * v + safe[m])
        fresh.append(lane * v + safe[m & (table[lane][safe] == 0)])
    gathers, fresh = torch.cat(gathers), torch.cat(fresh)
    nbytes = (head + touched_bytes(table, gathers)
              + 8 * touched_bytes(pcand, fresh))
    sector = head + 32 * (gathers.numel() + fresh.numel())
    return nbytes, int(live.sum()), sector


def frontier_bound(flags, deg, packed=False):
    """(bytes, ops) a packing call needs: every flag byte; of the degrees,
    each 32-byte sector (at its place in memory) that holds the degree of
    a flag set in some lane; the bitmap if `packed`; nf and mf. One test a
    flag."""
    import torch
    b, v = flags.shape
    first = deg.data_ptr() % 32 // 4               # deg[0]'s slot in a sector
    on = torch.cat([torch.zeros(first, dtype=torch.bool, device=deg.device),
                    (flags != 0).any(dim=0)])
    on = torch.cat([on, on.new_zeros((-on.numel()) % 8)])
    sectors = int(on.view(-1, 8).any(dim=1).sum())
    out = b * ((v + 31) // 32) * 4 if packed else 0
    return b * v + 32 * sectors + out + 8 * b, b * v


def bound(name, args, packed=False):
    """(bytes, ops) this call needs: each input byte it must read once,
    each output byte written once; data-dependent reads counted for these
    inputs (slots up to the first hit, live slots only; for a packing
    kernel the degree sectors its flags name, and the bitmap with
    `packed`)."""
    import torch
    args = as_batch(name, args)
    if name in PUSH:
        return push_bound(args)[:2]
    if name.startswith("frontier_fused"):
        return frontier_bound(*args, packed=packed)
    deg, nbrs, table = args
    b, r = deg.shape
    w = nbrs.shape[1]
    v = table.shape[1]
    live = deg.clamp(max=w).to(torch.int64)                  # [B, R]
    cols = torch.arange(w, device=deg.device)
    if name.removesuffix("_batch") in ("bottomup", "hub_bottomup"):
        # Needed slots stop at the first hit.
        need = torch.zeros_like(live)
        safe = nbrs.clamp(0, v - 1).to(torch.int64)
        for lane in range(b):
            hit = (cols[None] < live[lane][:, None]) & (table[lane][safe] != 0)
            first = hit.to(torch.uint8).argmax(dim=1)
            need[lane] = torch.where(hit.any(dim=1), first + 1, live[lane])
        out_bytes = b * r * 5
    else:
        need = live
        out_bytes = b * r * w
    nbr_bytes = 4 * int(need.max(dim=0).values.sum())
    if name == "topdown":
        # dst = clip(nbrs) for every slot: the whole tile in, int32 out.
        nbr_bytes = 4 * r * w
        out_bytes += 4 * r * w
    idx = []
    for lane in range(b):
        m = cols[None] < need[lane][:, None]
        idx.append(lane * v + nbrs.clamp(0, v - 1).to(torch.int64)[m])
    table_bytes = touched_bytes(table, torch.cat(idx))
    return 4 * b * r + nbr_bytes + table_bytes + out_bytes, int(need.sum())


def timed_call(picked, name):
    """(level, args) of the captured call a kernel is timed on: of the
    calls `pick_calls` chose for it, the one with the largest tile (for a
    packing kernel, the most flags); hub_bottomup on the lane of the timed
    hub_bottomup_batch call with the most live rows; a fresh entry on its
    push's call (deg, nbrs, visited), where the checkout has the push."""
    src_name = "hub_bottomup_batch" if name == "hub_bottomup" else name
    if FRESH_OF.get(name) in picked:
        src_name = FRESH_OF[name]
    _, lvl, _, cargs = max(
        picked[src_name], key=lambda c: c[3][1].numel()
        if not src_name.startswith("frontier_fused")
        else int(c[3][0].sum()))
    if name == "hub_bottomup":
        deg, nbrs, fr = cargs
        lane = int((deg != 0).sum(dim=1).argmax())
        cargs = (deg[lane], nbrs, fr[lane])
    if src_name != name and name in FRESH_OF:
        cargs = (cargs[0], cargs[1], cargs[3])
    return lvl, cargs


def launch_plan(name):
    """The plan of a pull or packing kernel's last launch (empty for the
    others, and for a tree whose kernels record none)."""
    from repro_torch.kernels import bottomup, frontier_fused
    if name.startswith("frontier_fused"):
        return dict(getattr(frontier_fused, "LAST_PLAN", {}))
    if name.removesuffix("_batch") not in ("bottomup", "hub_bottomup"):
        return {}
    return dict(getattr(bottomup, "LAST_PLAN", {}))


def kernel_fn(name, args, packed=False):
    """A call of kernel `name`'s launcher alone on a captured call's inputs,
    as `ops` hands them over (a lane axis of 1 for a single-lane kernel; a
    packing kernel without the bitmap, as the paths call it, unless
    `packed`)."""
    from repro_torch.kernels import bottomup, frontier_fused, hub, topdown
    if name == "topdown":
        deg, nbrs, table = args
        dc = deg.contiguous()
        return lambda: topdown.topdown_cuda(dc, nbrs, table)
    if name.startswith("frontier_fused"):
        flags, deg = as_batch(name, args)
        return lambda: frontier_fused.frontier_fused_batch_cuda(
            flags, deg, packed=packed)
    deg, nbrs, table = as_batch(name, args)
    dc = deg.contiguous()
    launch = {"bottomup": bottomup.bottomup_batch_cuda,
              "topdown": topdown.topdown_batch_cuda,
              "hub_bottomup": hub.hub_bottomup_batch_cuda}[
                  name.removesuffix("_batch")]
    return lambda: launch(dc, nbrs, table)


def parent_route(deg, nbrs, rows, visited, pcand, keep):
    """The top-down route of the checkouts before the push, on one bucket:
    the fresh entry's kernel, the `keep` mask of the destinations, `where`,
    then `scatter_reduce_("amin")` into `pcand`, all on the card."""
    import torch
    from repro_torch.kernels import topdown
    b, v = visited.shape
    fresh = topdown.topdown_batch_cuda(deg, nbrs, visited)
    dst = nbrs.clamp(0, v - 1).reshape(-1).to(torch.int64)
    if keep is not None:
        fresh = fresh & keep[dst].reshape(nbrs.shape)[None]
    src = torch.where(fresh != 0, rows[None, :, None], INT_MAX)
    pcand.scatter_reduce_(1, dst[None].expand(b, -1), src.reshape(b, -1),
                          "amin", include_self=True)


def time_kernel(name, args, reps, flush):
    """(kernel ms, plain ms, route ms) for one captured call: the launcher
    alone (`kernel_fn`), the plain version on the call's own inputs (a
    packing kernel's both without the bitmap, as the paths call them); for
    the push, each from a `pcand` of INT_MAX (refilled before every run,
    outside the timing), and the parent's route (`parent_route`) on the
    same call, which must give the push's bits; None for the others."""
    import torch
    plain = plain_fn(name)
    kw = dict(packed=False) if name.startswith("frontier_fused") else {}
    if name not in PUSH:
        return (time_ms(kernel_fn(name, args), reps, flush),
                time_ms(lambda: plain(*args, **kw), reps, flush), None)
    from repro_torch.kernels import topdown
    deg, nbrs, rows, vis, pc, keep = as_batch(name, args)
    deg = deg.contiguous()
    work = torch.empty_like(pc)

    def setup():
        work.fill_(INT_MAX)
    out = []
    for fn in (topdown.topdown_push_cuda, topdown.topdown_push_batch_plain,
               parent_route):
        out.append(time_ms(lambda: fn(deg, nbrs, rows, vis, work, keep),
                           reps, flush, setup))
        if fn is topdown.topdown_push_cuda:
            pushed = work.clone()
        else:
            assert equal(work, pushed), f"{fn.__name__} != the push"
    return tuple(out)


def frontier_times(name, cargs, flagged, flush, floor_ms):
    """A packing kernel's extra numbers: on phase 5's call (`cargs`) the
    kernel with the bitmap and its bound; on the call with the most set
    flags (`flagged`: level, args) the kernel with and without the bitmap,
    the plain version without, the bounds and the launch plan; the launch
    floor beside them."""
    from repro_torch.kernels import frontier_fused
    plain = plain_fn(name)
    out = dict(ms_packed=time_ms(kernel_fn(name, cargs, packed=True),
                                 TIMING_REPS, flush),
               bound_ms_packed=bound(name, cargs, packed=True)[0]
               / HBM_BYTES_PER_S * 1e3,
               flags_set=int((cargs[0] != 0).sum()), floor_ms=floor_ms)
    lvl, fargs = flagged
    most = dict(level=lvl, flags_set=int((fargs[0] != 0).sum()),
                shapes=[list(a.shape) for a in fargs])
    for key, packed in (("ms", False), ("ms_packed", True)):
        most[key] = time_ms(kernel_fn(name, fargs, packed=packed),
                            TIMING_REPS, flush)
        most["plan"] = dict(frontier_fused.LAST_PLAN)
        nbytes, nops = bound(name, fargs, packed=packed)
        most["bound_ms" + key[2:]] = max(
            nbytes / HBM_BYTES_PER_S, nops / CUDA_CORE_OPS_PER_S) * 1e3
        most["bytes" + key[2:]] = nbytes
    most["plain_ms"] = time_ms(lambda: plain(*fargs, packed=False),
                               TIMING_REPS, flush)
    out["most_flags"] = most
    return out


def trees_ok(check, *results):
    n = 0
    for res in results:
        for i, r in enumerate(res.roots):
            check.check(int(r), res.parent[i], res.level[i])
            n += 1
    return n


def level_rows(res):
    return [dict(level=r["level"], direction=r["direction"],
                 frontier_size=r["frontier_size"], seconds=r["seconds"])
            for r in res]


# ------------------------------------------------------------- serving --

def decode_inputs(rng, dev, dtype, b, s, k, g, h, clen):
    """q [B,K,g,h], k/v caches [B,S,K,h] (standard normal, in `dtype`),
    cache_len int32[B] on the card."""
    import torch
    q, kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dev, dtype) for shape in ((b, k, g, h), (b, s, k, h),
                                                  (b, s, k, h)))
    return q, kc, vc, torch.as_tensor(np.asarray(clen, np.int32), device=dev)


def decode_vs_plain(args, cap, out=None):
    """The kernel's output on `args` (or `out`, captured from a run)
    against the plain version on the same tensors, within the dtype's
    tolerance; returns max |kernel - plain| in fp32."""
    import torch
    from repro_torch.kernels import decode_attn, ops
    if out is None:
        out = ops.decode_attention(*args, logit_cap=cap)
    want = decode_attn.decode_attention_plain(*args, logit_cap=cap)
    rtol, atol = DECODE_TOL[str(args[0].dtype).removeprefix("torch.")]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    return float((out.float() - want.float()).abs().max())


def lse_vs_plain(args, cap, lse, out=None):
    """The kernel's log-sum-exp `lse` [B, K, g] on `args` against the plain
    version's, within the fp32 tolerance (-inf, where cache_len is 0, must
    be -inf on both); with `out`, the kernel's fp32 output of the same
    call, that too against the plain one, within q's dtype's tolerance.
    Returns max |kernel - plain| over the finite lse (and `out`)."""
    import torch
    from repro_torch.kernels import decode_attn
    want_out, want = decode_attn.decode_attention_plain(
        *args, logit_cap=cap, return_lse=True)
    err = 0.0
    if out is not None:
        rtol, atol = DECODE_TOL[str(args[0].dtype).removeprefix("torch.")]
        torch.testing.assert_close(out, want_out, rtol=rtol, atol=atol)
        err = float((out - want_out).abs().max())
    empty = (args[3] <= 0)[:, None, None].expand_as(want)
    assert bool(torch.isneginf(lse[empty]).all()) and bool(
        torch.isneginf(want[empty]).all()), "cache_len 0: lse is not -inf"
    tol = DECODE_TOL["float32"]
    torch.testing.assert_close(lse[~empty], want[~empty], rtol=tol[0],
                               atol=tol[1])
    if bool((~empty).any()):
        err = max(err, float((lse[~empty] - want[~empty]).abs().max()))
    return err


def phase_decode_kernel(rng, dev):
    """Every case in fp32 and bf16, cap 0 and 50, cache_len all 1, all S
    and random, each call made twice and equal bit for bit, and a third
    time with the log-sum-exp: the same output, and the lse against the
    plain version's within the fp32 tolerance; then cache_len 0 must give
    exact zeros and an lse of -inf; then (S > 1) q scaled by CAP_SCALE at
    cache_len S: the cap-50 output matches the plain one and differs from
    the kernel's cap-0 output by more than 1000 x the fp32 tolerance.
    Returns (calls, max |kernel - plain|, the least cap-50 vs cap-0 gap,
    max |lse - plain lse|)."""
    import torch
    from repro_torch.kernels import ops
    err, n, gap, lse_err = 0.0, 0, float("inf"), 0.0
    for b, s, k, g, h in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for clen in ([1] * b, [s] * b, rng.integers(1, s + 1, b)):
                args = decode_inputs(rng, dev, dtype, b, s, k, g, h, clen)
                for cap in (0.0, 50.0):
                    out = ops.decode_attention(*args, logit_cap=cap)
                    again = ops.decode_attention(*args, logit_cap=cap)
                    assert torch.equal(out, again), \
                        f"{(b, s, k, g, h)} {dtype}: two calls differ"
                    err = max(err, decode_vs_plain(args, cap, out))
                    with_lse, lse = ops.decode_attention(
                        *args, logit_cap=cap, return_lse=True)
                    assert with_lse.dtype == torch.float32 and \
                        torch.equal(with_lse.to(dtype), out), \
                        f"{(b, s, k, g, h)} {dtype}: with the lse, the " \
                        f"output is not the same fp32 value"
                    lse_err = max(lse_err, lse_vs_plain(args, cap, lse))
                    n += 3
            args = decode_inputs(rng, dev, dtype, b, s, k, g, h, [0] * b)
            zero = ops.decode_attention(*args, logit_cap=50.0)
            assert not bool(zero.any()), "cache_len 0: output is not zeros"
            zero, lse = ops.decode_attention(*args, logit_cap=50.0,
                                             return_lse=True)
            assert not bool(zero.any()), "cache_len 0: output is not zeros"
            lse_vs_plain(args, 50.0, lse)
            n += 1
            if s == 1:
                continue
            q, kc, vc, clen = decode_inputs(rng, dev, dtype, b, s, k, g, h,
                                            [s] * b)
            args = (q * CAP_SCALE, kc, vc, clen)
            capped = ops.decode_attention(*args, logit_cap=50.0)
            err = max(err, decode_vs_plain(args, 50.0, capped))
            uncapped = ops.decode_attention(*args, logit_cap=0.0)
            n += 2
            case_gap = float((capped.float() - uncapped.float()).abs().max())
            assert case_gap > 1000 * DECODE_TOL["float32"][1], \
                f"{(b, s, k, g, h)} {dtype}: the soft cap moves the output " \
                f"by only {case_gap}"
            gap = min(gap, case_gap)
    torch.cuda.synchronize()
    return n, err, gap, lse_err


def seq_split_phase(args, dev, record) -> dict:
    """Phase 2s: gemma2-9b's long_500k attention at every published width
    (`SEQ_SPLIT`), the random cache drawn on the card from --seed. The
    cache is cut into 16 sequence shards; the kernel runs with the lse on
    each shard, with the shard's own cache_len (0 past the position), and
    `layers.combine_partials` combines them. At three cache_lens the
    result is held against the kernel on the whole cache (bf16: rtol
    2^-7, atol 1e-5), an empty shard gives zeros and an lse of -inf, and
    the kernel on the whole cache and on each shard (output and lse) is
    held against the plain version on the same inputs.
    Then both routes' times (CUDA events) at the whole cache against the
    bound (its bytes over 3.35 TB/s). A record, not a claim."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.kernels import decode_attn, ops
    from repro_torch.models import layers as L
    cfg = get_config(SEQ_SPLIT["arch"])
    cell = SHAPES[SEQ_SPLIT["shape"]]
    b, s, n = cell.global_batch, cell.seq_len, SEQ_SPLIT["shards"]
    kk, g, h = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim
    cap, per = cfg.attn_logit_softcap, s // n
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    q = torch.randn((b, kk, g, h), generator=gen, device=dev).to(
        torch.bfloat16)
    kc = torch.empty((b, s, kk, h), dtype=torch.bfloat16, device=dev)
    vc = torch.empty_like(kc)
    for c in (kc, vc):            # in shards: no 4.3 GB fp32 temporary
        for i in range(n):
            c[:, i * per:(i + 1) * per] = torch.randn(
                (b, per, kk, h), generator=gen, device=dev)
    shards = [(kc[:, i * per:(i + 1) * per], vc[:, i * per:(i + 1) * per])
              for i in range(n)]

    def split(clen):
        parts = [ops.decode_attention(
            q, k_i, v_i, (clen - i * per).clamp(0, per).to(torch.int32),
            logit_cap=cap, return_lse=True)
            for i, (k_i, v_i) in enumerate(shards)]
        return (L.combine_partials(torch.stack([o for o, _ in parts]),
                                   torch.stack([x for _, x in parts]),
                                   q.dtype), parts)

    rtol, atol = DECODE_TOL["bfloat16"]
    lens = (s, s - 1000, 3 * per + 777)
    errs, whole_errs, shard_errs = [], [], []
    for length in lens:
        clen = torch.full((b,), length, dtype=torch.int32, device=dev)
        got, parts = split(clen)
        want = ops.decode_attention(q, kc, vc, clen, logit_cap=cap)
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        errs.append(float((got.float() - want.float()).abs().max()))
        whole_errs.append(decode_vs_plain((q, kc, vc, clen), cap, want))
        shard_errs.append(max(lse_vs_plain(
            (q, k_i, v_i, (clen - i * per).clamp(0, per).to(torch.int32)),
            cap, lse, out=o) for i, ((k_i, v_i), (o, lse)) in enumerate(
                zip(shards, parts))))
        gc.collect()
        torch.cuda.empty_cache()
        for i, (o, lse) in enumerate(parts):
            if i * per >= length:
                assert not bool(o.any()) and bool(torch.isneginf(lse).all()), \
                    f"shard {i} past cache_len {length}: not empty"
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    full = torch.full((b,), s, dtype=torch.int32, device=dev)
    whole_ms = time_ms(lambda: decode_attn.decode_attention_cuda(
        q, kc, vc, full, logit_cap=cap), TIMING_REPS, flush)
    split_ms = time_ms(lambda: split(full), TIMING_REPS, flush)
    nbytes, _ = decode_bound(q, kc, full)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = dict(arch=cfg.name, shape=[list(q.shape), list(kc.shape)],
               shards=n, shard_len=per, cap=cap, cache_lens=list(lens),
               max_abs_err=errs, whole_vs_plain=whole_errs,
               shards_vs_plain=shard_errs, whole_ms=whole_ms,
               split_ms=split_ms,
               bound_ms=bound_ms, bytes=nbytes, card=record["card"])
    record["seq_split"] = out
    log(f"phase 2s: sequence-split decode, {cfg.name} long_500k at full "
        f"width: q {list(q.shape)}, caches {list(kc.shape)} bf16, cap "
        f"{cap:g}, {n} shards of {per}; the combine of the shards' kernel "
        f"outputs by their lse equals the kernel on the whole cache at "
        f"cache_len {', '.join(map(str, lens))} (max |err| "
        f"{', '.join(f'{e:.3g}' for e in errs)}), empty shards give zeros "
        f"and -inf; against the plain version on the same inputs, the "
        f"kernel on the whole cache within "
        f"{', '.join(f'{e:.3g}' for e in whole_errs)} and the shards' "
        f"outputs and lse within {', '.join(f'{e:.3g}' for e in shard_errs)}"
        f"; whole cache {whole_ms:.4f} ms, 16 shards + combine "
        f"{split_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} bytes) on "
        f"{record['card']}")
    del q, kc, vc, shards, flush
    return out


def phase_serve_parity(seed, dev):
    """Smoke configs in fp32 (matmuls in full fp32): the same weights and
    prompt (`launch.serve.prompt_inputs`: tokens, or the frontend stubs'
    bf16 embeddings) on the card and on the CPU, prefill and 8 greedy
    steps."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs.base import smoke_config
    from repro_torch.launch.serve import prompt_inputs
    from repro_torch.models import decode as D, model as M
    from repro_torch.train.serve_step import decode_loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = 0.0
    b, s, steps = 2, 24, 8
    for arch in SERVE_PARITY:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        cpu = M.init_params(cfg, torch.Generator().manual_seed(seed))
        gpu = copy.deepcopy(cpu).to(dev)
        inputs = prompt_inputs(cfg, b, s, seed, "cpu")
        runs = []
        for params, device in ((cpu, "cpu"), (gpu, dev)):
            logits, cache = D.prefill(
                cfg, params, {k: v.to(device) for k, v in inputs.items()},
                s + steps + 1)
            tokens = decode_loop(cfg, params, logits, cache, s, steps)[0]
            runs.append((logits.cpu(), tokens.cpu()))
        (lc, tc), (lg, tg) = runs
        worst = max(worst, float((lg - lc).abs().max()))
        assert worst <= 1e-4, f"{arch}: prefill logits differ by {worst}"
        assert torch.equal(tg, tc), f"{arch}: greedy tokens differ"
    return worst


def install_decode_capture(n_calls, steps):
    """Wrap `ops.decode_attention`: call c is decode step c // n_calls,
    call c % n_calls of the step (its layer, where a layer makes one
    call); the first and last step's calls 0 and 1 (gemma2's local layer
    0 and global layer 1; an encdec decoder layer 0's self and cross
    calls) are kept with clones of their inputs (the caches change in
    place) and their outputs. Returns (kept, restore)."""
    from repro_torch.kernels import ops
    saved, kept, count = ops.decode_attention, [], [0]

    def fn(*args, **kw):
        step, layer = divmod(count[0], n_calls)
        count[0] += 1
        out = saved(*args, **kw)
        if step in (0, steps - 1) and layer in (0, 1):
            kept.append((step, layer, tuple(a.clone() for a in args),
                         kw["logit_cap"], out))
        return out

    ops.decode_attention = fn

    def restore():
        ops.decode_attention = saved
    return kept, restore


def decode_bound(q, kc, clen):
    """(bytes, ops) one decode-attention call needs: K and V rows up to
    cache_len, q and the output once; a multiply-add each for q.k and
    p.v per element of those rows and query heads."""
    b, kk, g, h = q.shape
    n = int(clen.clamp(0, kc.shape[1]).sum())
    esize = q.element_size()
    nbytes = 2 * n * kk * h * esize + 2 * q.numel() * esize + 4 * b
    return nbytes, 4 * n * kk * g * h


def time_decode(q, kc, vc, clen, flush, plain=True):
    """Kernel ms at cap 50 and cap 0, plain ms at both (with `plain`), the
    kernel's ms at cap 50 with the lse written too, SDPA ms at cap 0 (the
    library call, checked against the plain cap-0 output), and the host's
    microseconds per launcher call (200 calls queued back to back, no sync
    between)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attn
    b, kk, g, h = q.shape
    s = kc.shape[1]
    out = {}
    for cap in (50.0, 0.0):
        out[f"ms_cap{cap:g}"] = time_ms(
            lambda: decode_attn.decode_attention_cuda(q, kc, vc, clen,
                                                      logit_cap=cap),
            TIMING_REPS, flush)
        if plain:
            out[f"plain_ms_cap{cap:g}"] = time_ms(
                lambda: decode_attn.decode_attention_plain(
                    q, kc, vc, clen, logit_cap=cap), TIMING_REPS, flush)
    out["ms_lse_cap50"] = time_ms(
        lambda: decode_attn.decode_attention_cuda(q, kc, vc, clen,
                                                  logit_cap=50.0,
                                                  return_lse=True),
        TIMING_REPS, flush)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        decode_attn.decode_attention_cuda(q, kc, vc, clen, logit_cap=50.0)
    out["host_us_per_call"] = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    qs = q.reshape(b, kk * g, 1, h)
    ks, vs = kc.transpose(1, 2), vc.transpose(1, 2)       # [B, K, S, h]
    mask = (torch.arange(s, device=q.device)[None] < clen[:, None])[
        :, None, None]                                     # [B, 1, 1, S]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)
    got = sdpa().reshape(b, kk, g, h)
    want = decode_attn.decode_attention_plain(q, kc, vc, clen)
    torch.testing.assert_close(got.float(), want.float(), rtol=SDPA_TOL,
                               atol=SDPA_TOL)
    out["library_ms_cap0"] = time_ms(sdpa, TIMING_REPS, flush)
    return out


def profile_decode_step(step):
    """One decode step under torch.profiler: top device ops, and the
    decode kernel's and the matrix products' shares of device time."""
    prof = profile_search(step, top=1 << 20)
    busy = prof["device_busy_ms"]

    def share(*keys):
        return sum(r["device_ms"] for r in prof["top"]
                   if any(k in r["op"].lower() for k in keys)) / busy
    prof["decode_attn_share"] = share("decode_attn")
    prof["matmul_share"] = share(*MATMUL_KEYS)
    prof["top"] = prof["top"][:12]
    return prof


def profile_device(fn, top=12):
    """`fn()` under torch.profiler with device activity only, read from the
    raw kineto events (a full-width train step runs ~10^5 kernels, and
    building the profiler's event tree for them takes minutes): the wall,
    the device's busy ms (its ops' summed durations) and idle share, the
    matrix products' share of device time, and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sums = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms, n = sums.get(evt.name(), (0.0, 0))
        sums[evt.name()] = (ms + evt.duration_ns() / 1e6, n + 1)
    busy = sum(ms for ms, _ in sums.values())
    rows = sorted(sums.items(), key=lambda r: -r[1][0])
    matmul = sum(ms for name, (ms, _) in rows
                 if any(k in name.lower() for k in MATMUL_KEYS))
    return dict(wall_s=wall, device_busy_ms=busy,
                idle_share=max(0.0, 1.0 - busy / 1e3 / wall),
                matmul_share=matmul / busy if busy else 0.0,
                device_ops=sum(n for _, n in sums.values()),
                top=[dict(op=k[:80], device_ms=ms, calls=n)
                     for k, (ms, n) in rows[:top]])


def generate_graph(scale: int, seed: int, path: str) -> float:
    """Phase 4's Graph500 RMAT graph, generated on the host in a process of
    its own (while phases 1-3b run) and saved to `path`: its seconds."""
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.core import graph as G
    t0 = time.perf_counter()
    save_graph(G.rmat(scale, seed=seed), path)
    return time.perf_counter() - t0


def bfs_paths(args, rng, dev, record, errs, graph):
    """Phases 4, 2b and 5: the BFS paths on Graph500 RMAT at --scale, from
    `graph` (the future of `generate_graph` and its file). Returns the
    kernels line's entries of the ten BFS kernel entries and the graph
    (host arrays only)."""
    import warnings

    import torch
    from repro_torch.core import graph as G
    from repro_torch.engine import Engine
    from repro_torch.kernels import ops
    from repro_torch.kernels.contracts import (KernelBudgetError,
                                               KernelContractWarning)
    from repro_torch.core import ell as ELL
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.runtime import RuntimeConfig
    t0 = time.perf_counter()
    future, path = graph
    record["graph_s"] = future.result()
    record["graph_wait_s"] = time.perf_counter() - t0
    g = load_graph(path)
    record["graph_load_s"] = time.perf_counter() - t0 - record["graph_wait_s"]
    # strict: a plan whose kernels fail their contract would raise
    engine = Engine(g, runtime=RuntimeConfig(strict_contracts=True))
    t1 = time.perf_counter()
    engine.session.device_graph()
    ell = engine.session.ell_tiles()
    torch.cuda.synchronize()
    record["session_s"] = time.perf_counter() - t1
    split_cfg = BFSConfig(hub_split=True)
    _, hub_tiles = ELL.split_tiles(ell, split_cfg.hub_deg)
    record["graph"] = dict(
        V=g.num_vertices, E_directed=g.num_directed_edges,
        ell_buckets=[list(t.nbrs.shape) for t in ell],
        hub_floor=ELL.hub_degree_floor(split_cfg.hub_deg),
        hub_rows=sum(int(t.nbrs.shape[0]) for t in hub_tiles),
        hub_buckets=[list(t.nbrs.shape) for t in hub_tiles])
    log(f"phase 4: RMAT scale {args.scale}: V={g.num_vertices} "
        f"E={g.num_directed_edges} directed; generation "
        f"{record['graph_s']:.1f} s beside phases 1-3b (waited "
        f"{record['graph_wait_s']:.1f} s, loaded in "
        f"{record['graph_load_s']:.1f} s), device graph + ELL "
        f"{record['session_s']:.1f} s; hub (degree > "
        f"{record['graph']['hub_floor']}): {record['graph']['hub_rows']} "
        f"rows in buckets {record['graph']['hub_buckets']}")
    pos = np.flatnonzero(g.degrees > 0)
    roots = rng.choice(pos, 12, replace=False)
    calls, path, restore = install_capture()
    launches = {n: 0 for n in BFS_KERNELS}
    runs = {}

    def drive(name, label, fn):
        """One path's run: counts zeroed just before, read just after; a
        contract warning is an error."""
        path[0] = name
        ops.reset_launches()
        t = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("error", KernelContractWarning)
            res = fn()
        wall = time.perf_counter() - t
        got = {k: ops.LAUNCHES[k] for k in BFS_KERNELS}
        for k in PATH_KERNELS[name]:
            assert got[k] > 0, f"{k} never launched on the {name} path"
        for k, c in got.items():
            launches[k] += c
        runs[label] = dict(path=name, launches=got, wall_s=wall)
        log(f"  {label}: {wall:.3f} s, launches "
            f"{ {k: c for k, c in got.items() if c} }")
        return res

    batched = drive("unsplit", "unsplit batch of 8",
                    lambda: engine.bfs(roots[:8]))
    g500 = drive("unsplit", "unsplit Graph500 mode, 4 roots",
                 lambda: engine.bfs(roots[8:], batched=False))
    split_b = drive("split", "split batch of 8",
                    lambda: engine.bfs(roots[:8], split_cfg))
    split_g = drive("split", "split Graph500 mode, 4 roots",
                    lambda: engine.bfs(roots[8:], split_cfg, batched=False))
    stepper = drive("stepper", "stepper, 2 roots",
                    lambda: engine.bfs(roots[:2], backend="stepper"))
    restore()
    record["runs"] = runs
    record["launches"] = launches
    gated = sorted(engine.session._contract_checked, key=repr)
    assert gated, "the strict session gated no plan"
    # what the gate costs a new plan key: its report again on each key
    from repro_torch.analysis.kernel_contracts import contract_report
    t = time.perf_counter()
    for key in gated:
        assert contract_report(key, engine.session._graph_shape).feasible
    gate_ms = (time.perf_counter() - t) / len(gated) * 1e3
    # a strict session under a budget below the 8-lane pull's static
    # shared memory refuses the cohort plan before any build or launch
    tight = Engine(g, runtime=RuntimeConfig(strict_contracts=True,
                                            smem_budget_bytes=TIGHT_SMEM))
    before = dict(ops.LAUNCHES)
    try:
        tight.bfs(roots[:8])
    except KernelBudgetError as e:
        refusal = str(e)
    else:
        raise AssertionError("the under-budget strict session built its "
                             "cohort plan")
    assert dict(ops.LAUNCHES) == before, "launches across the refusal"
    assert not tight.session._executables
    tight.session.close()
    record["gate"] = dict(plans=len(gated), ms_per_key=gate_ms,
                          refusal=refusal[:300])
    log(f"phase 4: the strict session's gate passed {len(gated)} plans "
        f"({gate_ms:.3f} ms a key, once per key); under a {TIGHT_SMEM} B "
        f"budget the cohort plan is refused before any launch: "
        f"{refusal[:160]}")
    check = Graph500Check(g, dev)
    n_trees = trees_ok(check, batched, g500, split_b, split_g, stepper)
    for key, res in (("batched", batched), ("split", split_b)):
        record[f"teps_{key}"] = res.teps
        record[f"seconds_{key}"] = res.seconds
        record[f"levels_{key}"] = level_rows(res.batch_level_stats)
    for key, res in (("g500", g500), ("split_g500", split_g),
                     ("stepper", stepper)):
        record[f"teps_hmean_{key}"] = res.teps_hmean
        record[f"per_root_seconds_{key}"] = res.per_root_seconds.tolist()
    record["levels_stepper"] = [level_rows(s) for s in stepper.per_level_stats]
    log(f"  {n_trees} trees pass the Graph500 check. Batch of 8: unsplit "
        f"{batched.seconds:.4f} s, {batched.teps / 1e9:.3f} GTEPS; split "
        f"{split_b.seconds:.4f} s, {split_b.teps / 1e9:.3f} GTEPS. Graph500 "
        f"mode harmonic mean: unsplit {g500.teps_hmean / 1e9:.3f}, split "
        f"{split_g.teps_hmean / 1e9:.3f}, stepper "
        f"{stepper.teps_hmean / 1e9:.3f} GTEPS")
    picked = pick_calls(calls)
    n_checked = 0
    fresh_of_push = {push: fresh for fresh, push in FRESH_OF.items()}
    flagged = {n: flag_call(calls, n) for n in BFS_KERNELS
               if n.startswith("frontier_fused")}
    for name, mine in picked.items():
        for _, _, _, cargs in mine + ([(None, None, None, flagged[name][1])]
                                      if name in flagged else []):
            if name in flagged:
                for packed in (True, False):
                    kernel_vs_plain(name, cargs, errs, packed=packed)
                n_checked += 2
                continue
            if name not in PUSH:
                kernel_vs_plain(name, cargs, errs)
                n_checked += 1
                continue
            # The captured pcand is the level's final one (the push
            # updated it in place after the capture): from it, and from
            # INT_MAX as the level's first bucket saw it.
            deg, nbrs, rows, vis, pcand, keep = cargs
            for start in (torch.full_like(pcand, INT_MAX), pcand):
                kernel_vs_plain(name, (deg, nbrs, rows, vis, start, keep),
                                errs)
            kernel_vs_plain(fresh_of_push[name], (deg, nbrs, vis), errs)
            n_checked += 3
    # hub_bottomup: lane 0 of every checked hub_bottomup_batch call
    for _, _, _, (deg, nbrs, fr) in picked["hub_bottomup_batch"]:
        kernel_vs_plain("hub_bottomup", (deg[0], nbrs, fr[0]), errs)
    torch.cuda.synchronize()
    log(f"phase 2b: {n_checked} captured calls bitwise equal, at levels "
        f"{ {n: c[0][1] for n, c in picked.items()} }")

    # 5. kernel times at the captured full-size shapes
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    floor_ms = time_ms(lambda: torch.cuda._sleep(0), TIMING_REPS, flush)
    record["launch_floor_ms"] = floor_ms
    log(f"phase 5: launch floor (torch.cuda._sleep(0), a one-thread kernel "
        f"that returns at once, timed as the kernels are): {floor_ms:.4f} ms")
    entries = []
    for name, (source, replaces) in BFS_KERNELS.items():
        lvl, cargs = timed_call(picked, name)
        ms, plain_ms, route_ms = time_kernel(name, cargs, TIMING_REPS,
                                             flush)
        plan = launch_plan(name)
        nbytes, nops = bound(name, cargs)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None)
        extra = ""
        if name == "hub_bottomup":
            entry["note"] = HUB_BOTTOMUP_NOTE
        if name in FRESH_OF:
            entry["note"] = FRESH_NOTE
        if name in PUSH:
            sector = push_bound(as_batch(name, cargs))[2]
            entry.update(parent_route_ms=route_ms,
                         sector_bound_ms=sector / HBM_BYTES_PER_S * 1e3)
            extra = (f"; the parent's route {route_ms:.4f} ms; bound with a "
                     f"sector a gather {entry['sector_bound_ms']:.4f} ms")
        if name in flagged:
            entry.update(frontier_times(name, cargs, flagged[name], flush,
                                        floor_ms))
            extra = (f"; with the bitmap {entry['ms_packed']:.4f} ms (bound "
                     f"{entry['bound_ms_packed']:.4f}); {entry['flags_set']} "
                     f"flags set; at the call with the most flags ("
                     f"{entry['most_flags']['flags_set']}, level "
                     f"{entry['most_flags']['level']}) "
                     f"{entry['most_flags']['ms']:.4f} ms, with the bitmap "
                     f"{entry['most_flags']['ms_packed']:.4f}, plain "
                     f"{entry['most_flags']['plain_ms']:.4f}, bound "
                     f"{entry['most_flags']['bound_ms']:.4f} (with the bitmap "
                     f"{entry['most_flags']['bound_ms_packed']:.4f}); launch "
                     f"floor {floor_ms:.4f}; plan "
                     f"{entry['most_flags']['plan']}")
        entries.append(entry)
        record.setdefault("timed_calls", []).append(dict(
            name=name, level=lvl,
            shapes=[None if a is None else list(a.shape) for a in cargs],
            bytes=nbytes, ops=nops, plan=plan,
            live_rows=int((cargs[0] != 0).any(dim=0).sum())
            if cargs[0].dim() == 2 else int((cargs[0] != 0).sum())))
        log(f"phase 5: {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{max(t_bytes, t_ops):.4f} ms by {entry['bound_by']}{extra}) "
            f"at {[None if a is None else list(a.shape) for a in cargs]}"
            + (f", plan {plan}" if plan else ""))
    record["kernels"] = entries
    record["profiles"] = {}
    for label, fn in (
            ("unsplit batch of 8", lambda: engine.bfs(roots[:8])),
            ("split batch of 8", lambda: engine.bfs(roots[:8], split_cfg)),
            ("stepper, 1 root",
             lambda: engine.bfs(roots[:1], backend="stepper"))):
        prof = profile_search(fn)
        record["profiles"][label] = prof
        for n, w in prof["wrappers"].items():
            if n in flagged:
                assert w["device_ops"] <= w["calls"], \
                    f"{label}: {n} launched {w['device_ops']} device ops in " \
                    f"{w['calls']} calls"
        log(f"phase 5: profiled {label}: wall {prof['wall_s']:.3f} s, "
            f"device busy {prof['device_busy_ms']:.1f} ms (idle share "
            f"{prof['idle_share']:.3f}); the port's kernels: "
            + ", ".join(f"{src} {k['device_ms']:.3f} ms in {k['calls']} calls"
                        for src, k in sorted(prof["kernels"].items()))
            + "; by wrapper: "
            + ", ".join(f"{n} {k['device_ms']:.3f} ms in {k['calls']} calls, "
                        f"{k['device_ops']} device ops"
                        for n, k in sorted(prof["wrappers"].items()))
            + "; top device time:")
        for row in prof["top"]:
            log(f"    {row['device_ms']:10.2f} ms {row['calls']:6d}x "
                f"{row['op']}")
    engine.session.close()      # its plans and tiles leave the registry
    return entries, g


# -------------------------------------------------------------- sharded --

SHARDED_PARTS = (2, 4)            # phase 5s parity: ranks at PARITY_SCALE
SHARDED_FULL = (4, "specialized")  # phase 5s at full size: ranks, strategy
SHARDED_KERNELS = ("bottomup", "topdown_push", "frontier_fused")
SHARDED_NOTE = ("P ranks time-share one H100 and exchange through gloo "
                "(host memory); not a multi-GPU figure")
RANK_TIMEOUT = 900                # seconds a spawn of ranks may take
# Phase 5s's served load on the full-size ranks: rank 0 is the front
# (`BFSServer(front=PartitionFront(group))`), ranks 1-3 `follow`; 2 clients
# x 3 queries x 2 roots, every 3rd query streamed on the partitioned
# stepper, the queries alternating between the psum and the bitmap
# exchange (two plans, so coalescing is keyed by plan).
SHARDED_LOAD = dict(clients=2, queries_per_client=3, batch=2, stream_every=3)
# The probes on the phase-3 graph, each followed by a served query:
# (name, fault schedule, the query is streamed, the front's outcome).
SHARDED_PROBES = (
    ("retry", "dispatch[mode=sharded]@0", False, "served"),
    ("stepper fault", "dispatch[mode=stepper,level=2]@*", True,
     "FaultInjected"),
    ("cancel", "straggler@*:delay=50ms", True, "QueryCancelled"),
)


def save_graph(g, path):
    np.savez(path, v=g.num_vertices, indptr=g.indptr, indices=g.indices,
             degrees=g.degrees)


def load_graph(path):
    from repro_torch.interop import graph_from_arrays
    with np.load(path) as z:
        return graph_from_arrays(int(z["v"]), z["indptr"], z["indices"],
                                 z["degrees"])


def sharded_cases():
    """(label, strategy, HybridConfig): each strategy at the defaults, then
    the bitmap exchange, the global coordinator and beamer."""
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.core.hybrid_bfs import HybridConfig
    cases = [(s, s, HybridConfig()) for s in ("random", "hub0", "specialized")]
    return cases + [
        ("specialized bitmap", "specialized", HybridConfig(exchange="bitmap")),
        ("specialized global", "specialized",
         HybridConfig(coordinator="global")),
        ("specialized beamer", "specialized",
         HybridConfig(bfs=BFSConfig(heuristic="beamer")))]


def sharded_parity_rank(rank, group, device, graph_path, roots):
    """Phase 5s parity on one rank: every case through `Engine.bfs` as
    `sharded` and as `stepper`, once on a CUDA session (the kernels) and
    once on a CPU session (the plain versions), over the same group;
    trees and rows must be equal. Rank 0 validates the default case's
    trees with `ref.validate_parents`."""
    import torch.distributed as dist
    from repro_torch.core import ref
    from repro_torch.engine import Engine
    g = load_graph(graph_path)
    n = dist.get_world_size(group)
    gpu, cpu = Engine(g, device=device), Engine(g, device="cpu")
    out = []
    for label, strategy, hcfg in sharded_cases():
        for backend in ("sharded", "stepper"):
            what = f"P={n} {label} {backend}"
            a = gpu.bfs(roots, hcfg, backend=backend, n_parts=n,
                        strategy=strategy)
            b = cpu.bfs(roots, hcfg, backend=backend, n_parts=n,
                        strategy=strategy)
            same_trees(a, b, what)
            assert (a.backend, a.n_parts) == (backend, n), what
            if backend == "stepper":
                assert stepper_rows(a) == stepper_rows(b), f"{what}: rows"
                out.append(dict(case=what, directions=[
                    r[1] for r in stepper_rows(a)[0]]))
            if rank == 0 and label == "specialized":
                for i, r in enumerate(roots):
                    ref.validate_parents(g, int(r), b.parent[i], b.level[i])
    return out


def sharded_full_rank(rank, group, device, graph_path, roots, path16,
                      serve_roots):
    """Phase 5s at full size on one rank: `Engine.bfs` over the partitioned
    graph (4 roots `sharded` in Graph500 mode, 2 `stepper` with the psum
    exchange, 1 with the bitmap), launch counts zeroed just before and read
    just after. Rank 0 also holds the trees against the Graph500 check,
    every sharded kernel's captured calls (the level with the most live
    rows) against their plain versions, and times them. Then the served
    load on the same ranks (`sharded_served`) and the probes on the
    phase-3 graph (`sharded_probes`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.hybrid_bfs import HybridConfig
    from repro_torch.engine import Engine
    from repro_torch.engine.level_loop import fence
    from repro_torch.kernels import ops
    from repro_torch.runtime import RuntimeConfig
    n, strategy = SHARDED_FULL
    assert dist.get_world_size(group) == n
    t0 = time.perf_counter()
    g = load_graph(graph_path)
    # strict: the partitioned plan passes its contract gate or raises
    eng = Engine(g, device=device, default_strategy=strategy,
                 runtime=RuntimeConfig(strict_contracts=True))
    plan, pg = eng.session.partitioned(n)
    ell = eng.session.hybrid_ell(n)
    fence(device)
    out = dict(rank=rank, setup_s=time.perf_counter() - t0,
               backend=str(dist.get_backend(group)), v_pad=plan.v_pad,
               hub_count=plan.hub_count, local_rows=pg.num_local_rows,
               buckets=[list(b.nbrs.shape) for b in ell],
               padding_rows=sum(int((b.rows == plan.v_pad).sum())
                                for b in ell))
    if rank == 0:
        calls, path, restore = install_capture()
        path[0] = "sharded"
    dist.barrier(group)
    ops.reset_launches()
    t1 = time.perf_counter()
    sharded = eng.bfs(roots[:4], backend="sharded", n_parts=n,
                      batched=False)
    stepper = eng.bfs(roots[4:6], backend="stepper", n_parts=n)
    bitmap = eng.bfs(roots[6:7], HybridConfig(exchange="bitmap"),
                     backend="stepper", n_parts=n)
    out["wall_s"] = time.perf_counter() - t1
    out["launches"] = {k: c for k, c in ops.LAUNCHES.items() if c}
    out["gated"] = sorted(k[0] for k in eng.session._contract_checked)
    assert "sharded" in out["gated"], f"rank {rank}: sharded plan not gated"
    for k in SHARDED_KERNELS:
        assert ops.LAUNCHES[k] > 0, f"rank {rank}: {k} never launched"
    out.update(
        per_root_s=sharded.per_root_seconds.tolist(),
        teps=sharded.teps_per_root.tolist(),
        levels=[int(x) for x in sharded.num_levels],
        stepper_per_root_s=stepper.per_root_seconds.tolist(),
        bitmap_per_root_s=bitmap.per_root_seconds.tolist(),
        stepper_teps=stepper.teps_per_root.tolist(),
        psum_rows=[[dict(level=r["level"], direction=r["direction"],
                         frontier_size=r["frontier_size"],
                         compute_s=r["compute_s"], exchange_s=r["exchange_s"])
                    for r in rows] for rows in stepper.per_level_stats],
        bitmap_rows=[[dict(level=r["level"], direction=r["direction"],
                           frontier_size=r["frontier_size"],
                           compute_s=r["compute_s"],
                           exchange_s=r["exchange_s"])
                      for r in rows] for rows in bitmap.per_level_stats],
        timings=stepper.timings + bitmap.timings)
    if rank == 0:
        restore()
        check = Graph500Check(g, device)
        out["trees"] = trees_ok(check, sharded, stepper, bitmap)
        del check
        out.update(sharded_kernel_checks(calls, device))
        del calls
    t1 = time.perf_counter()
    out["served"] = sharded_served(rank, group, device, eng, g, serve_roots)
    t2 = time.perf_counter()
    out["probes"] = sharded_probes(rank, group, device, path16)
    out.update(served_s=t2 - t1, probes_s=time.perf_counter() - t2)
    dist.barrier(group)
    return out


def served_queries(roots):
    """The served load's queries, (client, index, exchange, roots,
    streamed), from `SHARDED_LOAD`; every rank derives the same list."""
    L = SHARDED_LOAD
    out = []
    for c in range(L["clients"]):
        for q in range(L["queries_per_client"]):
            k = c * L["queries_per_client"] + q
            out.append((c, k, ("psum", "bitmap")[k % 2],
                        roots[k * L["batch"]:(k + 1) * L["batch"]],
                        (k + 1) % L["stream_every"] == 0))
    return out


def sharded_served(rank, group, device, eng, g, roots):
    """The served load on the full-size ranks. Every rank first runs the
    load's roots through `Engine.bfs` (sharded, batched, one call an
    exchange), then serves: rank 0 through `BFSServer(front=...)` with 4
    client threads, the others in `follow`. Each rank's launch counts are
    zeroed just before the load and read just after; rank 0 holds every
    served tree against the Graph500 check and against the same root's
    `Engine.bfs` tree."""
    import threading
    import torch.distributed as dist
    from repro_torch.core.hybrid_bfs import HybridConfig
    from repro_torch.engine import BFSServer, PartitionFront, follow
    from repro_torch.kernels import ops
    n = dist.get_world_size(group)
    plans = {"psum": HybridConfig(), "bitmap": HybridConfig(exchange="bitmap")}
    queries = served_queries(roots)
    direct = {}
    t0 = time.perf_counter()
    for label, hcfg in plans.items():
        rs = np.concatenate([q[3] for q in queries if q[2] == label])
        direct[label] = eng.bfs(rs, hcfg, backend="sharded", n_parts=n)
    direct_s = time.perf_counter() - t0
    sessions = {"g22": eng.session}
    dist.barrier(group)
    ops.reset_launches()
    if rank != 0:
        counts = follow(sessions, group)
        return dict(follow=counts, launches={
            k: c for k, c in ops.LAUNCHES.items() if c})
    server = BFSServer(sessions, front=PartitionFront(group))
    results, errors = {}, []

    def client(c):
        try:
            for cc, k, label, rs, stream in queries:
                if cc != c:
                    continue
                h = server.submit(
                    "g22", rs, plans[label],
                    backend="stepper" if stream else "sharded", n_parts=n,
                    stream=stream, client=f"client{c}")
                rows = list(h.stream(RANK_TIMEOUT)) if stream else []
                results[k] = (h.result(RANK_TIMEOUT), rows, h.latency_s)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SHARDED_LOAD["clients"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(RANK_TIMEOUT)
    wall = time.perf_counter() - t0
    server.close()
    launches = {k: c for k, c in ops.LAUNCHES.items() if c}
    assert not errors, errors
    assert len(results) == len(queries)
    st = server.stats()
    totals, front = st["totals"], st["front"]
    check = Graph500Check(g, device)
    offsets = {label: 0 for label in plans}
    for _c, k, label, rs, _stream in queries:
        res = results[k][0]
        want = direct[label]
        i = offsets[label]
        offsets[label] += len(rs)
        assert np.array_equal(res.parent, want.parent[i:i + len(rs)]), k
        assert np.array_equal(res.level, want.level[i:i + len(rs)]), k
    trees = trees_ok(check, *[r[0] for r in results.values()])
    del check
    lat = np.array([r[2] for r in results.values()])
    rows = [row for r in results.values() for row in r[1]]
    exchange_s = [row["exchange_s"] for row in rows]
    levels = sum(len(r[1]) for r in results.values())
    return dict(
        queries=len(queries), roots=int(totals["roots"]), trees=trees,
        wall_s=wall, qps=len(queries) / wall,
        latency_p50_s=float(np.percentile(lat, 50)),
        latency_p99_s=float(np.percentile(lat, 99)),
        roots_per_dispatch=totals["roots"] / max(totals["batches"], 1),
        direct_s=direct_s, launches=launches, front=front,
        counters={k: totals[k] for k in (
            "served", "failed", "retries", "dispatch_failures",
            "cancelled", "expired", "batches")},
        stream_levels=levels,
        exchange_s_mean=float(np.mean(exchange_s)) if exchange_s else None,
        compute_s_mean=float(np.mean([row["compute_s"] for row in rows]))
        if rows else None)


def sharded_probes(rank, group, device, path16):
    """The front's probes on the phase-3 graph (`SHARDED_PROBES`), one
    server over the same ranks: each probe must end with its typed outcome
    at the front, and the next query (sharded, 2 roots) must be served and
    pass the oracle's check. Followers return their counts."""
    import torch.distributed as dist
    from repro_torch.engine import (BFSServer, GraphSession, PartitionFront,
                                    follow)
    from repro_torch.runtime import faults
    n = dist.get_world_size(group)
    g16 = load_graph(path16)
    sessions = {"g16": GraphSession(g16, device)}
    if rank != 0:
        return dict(follow=follow(sessions, group))
    roots = [int(r) for r in np.argsort(g16.degrees)[::-1][:2]]
    server = BFSServer(sessions, front=PartitionFront(group))
    outcomes = {}
    try:
        for name, schedule, stream, want in SHARDED_PROBES:
            with faults.fault_scope(schedule):
                h = server.submit(
                    "g16", roots, backend="stepper" if stream else "sharded",
                    n_parts=n, stream=stream)
                try:
                    if stream:
                        for _row in h.stream(RANK_TIMEOUT):
                            if name == "cancel":
                                h.cancel()
                    h.result(RANK_TIMEOUT).validate(g16)
                    got = "served"
                except (faults.FaultInjected, RuntimeError) as e:
                    got = type(e).__name__
            assert got == want, (name, got, want)
            nxt = server.submit("g16", roots, backend="sharded", n_parts=n)
            nxt.result(RANK_TIMEOUT).validate(g16)
            outcomes[name] = got
    finally:
        server.close()
    st = server.stats()
    return dict(outcomes=outcomes, front=st["front"], counters={
        k: st["totals"][k] for k in ("served", "failed", "retries",
                                     "cancelled")})


def sharded_kernel_checks(calls, device):
    """Rank 0's captured sharded calls: each kernel of the level with the
    most live rows against its plain version, bitwise (the push from
    INT_MAX and from the level's final `pcand`; the packing kernel with the
    bitmap and without, there and at the call with the most set flags),
    then timed on its largest call beside its plain version and bound."""
    import torch
    picked = {k: v for k, v in pick_calls(calls).items()
              if k in SHARDED_KERNELS}
    flagged = flag_call(calls, "frontier_fused")[1]
    errs = {k: 0 for k in SHARDED_KERNELS}
    n_checked = 0
    for name, mine in picked.items():
        for _, _, _, cargs in mine:
            if name == "frontier_fused":
                for args in (cargs, flagged):
                    for packed in (True, False):
                        kernel_vs_plain(name, args, errs, packed=packed)
                        n_checked += 1
            elif name in PUSH:
                deg, nbrs, rows, vis, pcand, keep = cargs
                for start in (torch.full_like(pcand, INT_MAX), pcand):
                    kernel_vs_plain(name, (deg, nbrs, rows, vis, start, keep),
                                    errs)
                    n_checked += 1
            else:
                kernel_vs_plain(name, cargs, errs)
                n_checked += 1
    torch.cuda.synchronize(device)
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=device)
    times = {}
    for name in SHARDED_KERNELS:
        lvl, cargs = timed_call(picked, name)
        ms, plain_ms, _ = time_kernel(name, cargs, TIMING_REPS, flush)
        nbytes, nops = bound(name, cargs)
        times[name] = dict(
            level=lvl, ms=ms, plain_ms=plain_ms,
            bound_ms=max(nbytes / HBM_BYTES_PER_S, nops / CUDA_CORE_OPS_PER_S)
            * 1e3, shapes=[None if a is None else list(a.shape)
                           for a in cargs])
    return dict(checked=n_checked, errs=errs, kernel_times=times,
                levels_checked={k: v[0][1] for k, v in picked.items()})


def sharded_phase(args, g16, g22, rng, record, entries, path22):
    """Phase 5s: the partitioned BSP search on gloo ranks that share the
    card. Parity at PARITY_SCALE (P = 2 and 4, CUDA ranks against CPU
    ranks), then the full-size run (P = 4, specialized) on the --scale
    graph saved to `path22` (phase 5r attaches it too) with the served
    load and the front's probes on the same ranks; the sharded kernels'
    counts (searches and served load), errors and times join their
    `entries`."""
    import tempfile
    from repro_torch.parallel import ranks
    record["sharded"] = rec = dict(note=SHARDED_NOTE)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        path16 = os.path.join(tmp, "parity.npz")
        save_graph(g16, path16)
        roots16 = rng.choice(np.flatnonzero(g16.degrees > 0), 2,
                             replace=False)
        for p in SHARDED_PARTS:
            t0 = time.perf_counter()
            out = ranks.run_ranks(sharded_parity_rank, p, tmp,
                                  args=(path16, roots16), backend="gloo",
                                  timeout=RANK_TIMEOUT)
            rec[f"parity_p{p}_s"] = time.perf_counter() - t0
            rec[f"parity_p{p}"] = out[0]
            log(f"phase 5s: scale-{PARITY_SCALE} parity, P = {p} gloo ranks "
                f"on one card: {len(sharded_cases())} cases x (sharded, "
                f"stepper) equal on cuda and cpu, trees and rows, every rank "
                f"({rec[f'parity_p{p}_s']:.1f} s); stepper directions "
                + "; ".join(f"{c['case']}: {''.join(d[0] for d in c['directions'])}"
                            for c in out[0][:3]))
        t0 = time.perf_counter()
        save_graph(g22, path22)
        rec["save_s"] = time.perf_counter() - t0
        roots22 = rng.choice(np.flatnonzero(g22.degrees > 0), 7,
                             replace=False)
        L = SHARDED_LOAD
        serve_roots = np.random.default_rng([args.seed, 21]).choice(
            np.flatnonzero(g22.degrees > 0),
            L["clients"] * L["queries_per_client"] * L["batch"],
            replace=False)
        n, strategy = SHARDED_FULL
        t0 = time.perf_counter()
        outs = ranks.run_ranks(sharded_full_rank, n, tmp,
                               args=(path22, roots22, path16, serve_roots),
                               backend="gloo", timeout=RANK_TIMEOUT)
        rec["full_s"] = time.perf_counter() - t0
    r0 = outs[0]
    rec["full"] = outs
    v_pad = r0["v_pad"]
    wire = dict(psum=4 * v_pad, bitmap=4 * ((v_pad + 31) // 32))
    rec["wire_bytes_per_level"] = wire
    log(f"phase 5s: RMAT scale {args.scale}, P = {n} "
        f"{strategy}, {r0['backend']} ranks: {SHARDED_NOTE}. v_pad {v_pad}, "
        f"{r0['hub_count']} delegated hubs, {r0['local_rows']} rows a rank, "
        f"setup (load, partition, tiles) {max(o['setup_s'] for o in outs):.1f}"
        f" s, spawn to exit {rec['full_s']:.1f} s; rank 0's buckets "
        f"{r0['buckets']} ({r0['padding_rows']} padding rows)")
    log(f"  {r0['trees']} trees pass the Graph500 check; wire a level: psum "
        f"{wire['psum']} bytes, bitmap {wire['bitmap']} bytes a rank")
    for i, (s, t) in enumerate(zip(r0["per_root_s"], r0["teps"])):
        log(f"  sharded root {i}: {s:.4f} s, {t / 1e9:.4f} GTEPS, "
            f"{r0['levels'][i]} levels")
    for label, key in (("psum", "psum_rows"), ("bitmap", "bitmap_rows")):
        for i, rows in enumerate(r0[key]):
            log(f"  stepper {label} root {i} (compute_s / exchange_s a "
                f"level, ms): " + ", ".join(
                    f"{r['direction']} {r['compute_s'] * 1e3:.2f}/"
                    f"{r['exchange_s'] * 1e3:.2f}" for r in rows))
    log("  agg_s (the min all-reduce, the copy and the mapping back): "
        + ", ".join(f"{t['agg_s']:.4f}" for t in r0["timings"]))
    log(f"  launches by rank: "
        + "; ".join(f"rank {o['rank']} {o['launches']}" for o in outs))
    log(f"  rank 0: {r0['checked']} captured sharded calls bitwise equal to "
        f"the plain versions at levels {r0['levels_checked']}; at their "
        f"largest call: " + ", ".join(
            f"{k} {t['ms']:.4f} ms (plain {t['plain_ms']:.4f}, bound "
            f"{t['bound_ms']:.4f}) at {t['shapes']}"
            for k, t in r0["kernel_times"].items()))
    sv = r0["served"]
    served_launches = [o["served"]["launches"] for o in outs]
    for rank, got in enumerate(served_launches):
        for k in SHARDED_KERNELS:
            assert got.get(k, 0) > 0, f"served: rank {rank}: {k} not launched"
    front = sv["front"]
    for o in outs[1:]:
        for part, f in (("served", front), ("probes", r0["probes"]["front"])):
            got = o[part]["follow"]
            assert (got["runs"], got["aborts"]) == (
                f["dispatches"], f["agreed_aborts"]), (o["rank"], part, got)
    c = sv["counters"]
    assert (c["served"], c["failed"]) == (sv["queries"], 0), c
    rec["served"] = dict(sv, follower_launches=served_launches[1:],
                         probes=r0["probes"])
    log(f"  served (sharded serving, {record['card']}): {sv['queries']} "
        f"queries ({SHARDED_LOAD['clients']} clients x "
        f"{SHARDED_LOAD['queries_per_client']} x {SHARDED_LOAD['batch']} "
        f"roots, every {SHARDED_LOAD['stream_every']}rd streamed, psum and "
        f"bitmap) on P = {n} ranks, front rank 0: {sv['qps']:.3f} QPS, p50 "
        f"{sv['latency_p50_s']:.3f} s, p99 {sv['latency_p99_s']:.3f} s, "
        f"{sv['roots_per_dispatch']:.2f} roots a dispatch, {sv['trees']} "
        f"trees pass the Graph500 check and equal Engine.bfs on the same "
        f"ranks ({sv['direct_s']:.1f} s); the served part {r0['served_s']:.1f}"
        f" s, the probes {r0['probes_s']:.1f} s")
    log(f"  served counters: {c}; front: {front['dispatches']} dispatches, "
        f"{front['agreements']} agreements, {front['agreed_aborts']} agreed "
        f"aborts, {front['agreement_s'] * 1e3:.2f} ms in agreements "
        f"({front['agreement_s_mean'] * 1e3:.3f} ms each) against "
        f"exchange_s {sv['exchange_s_mean'] * 1e3:.2f} ms and compute_s "
        f"{sv['compute_s_mean'] * 1e3:.2f} ms a streamed level")
    log(f"  served launches by rank: "
        + "; ".join(f"rank {r} {got}" for r, got in enumerate(
            served_launches)))
    pr = r0["probes"]
    log(f"  probes on the scale-{PARITY_SCALE} graph: {pr['outcomes']}, each "
        f"followed by a served query; counters {pr['counters']}; front "
        f"{pr['front']['agreed_aborts']} agreed aborts, followers back in "
        f"their loop")
    for entry in entries:
        name = entry["name"]
        if name not in SHARDED_KERNELS:
            continue
        per_rank = [o["launches"].get(name, 0) for o in outs]
        served = [got.get(name, 0) for got in served_launches]
        t = r0["kernel_times"][name]
        entry.update(
            launches=entry["launches"] + sum(per_rank) + sum(served),
            sharded_launches=per_rank, served_launches=served,
            max_abs_err=max(entry["max_abs_err"], r0["errs"][name]),
            sharded_ms=t["ms"], sharded_plain_ms=t["plain_ms"],
            sharded_bound_ms=t["bound_ms"])


# ------------------------------------------------------------ the server --

# Phase 5v's load: two sessions ("replicas" of the --scale graph, sharing
# one CSR, one tile set and one plan set), 4 clients x 4 queries x 4
# roots, every 4th query streamed, queue depth 64, 16 queries in flight a
# client.
SERVER_LOAD = dict(clients=4, queries_per_client=4, batch=4, stream_every=4)
SERVER_CAPS = dict(max_queue_depth=64, max_inflight_per_client=16)
SERVER_KERNELS = {"batch": ("bottomup_batch", "topdown_push_batch",
                            "frontier_fused_batch"),
                  "stream": ("bottomup", "topdown_push", "frontier_fused")}
SERVER_NOTE = ("two sessions share one H100: a level's seconds end at a "
               "device-wide sync, so they hold the other session's queued "
               "work too; not solo numbers")
CANCEL_LEVELS = 512               # the cancel probes' path length
RECHECK_ROOTS = 32                # roots a gather search in the recheck


def plan_sharing(server, graphs, dev) -> dict:
    """Where each session's cohort plans came from, which session built
    the tiles, the bytes of the CSR and the tile set, and the peak device
    memory so far. With sharing on, each plan was built by one session
    (whichever asked first) and shared by the other, one session built
    the tiles, and both read one CSR."""
    import torch
    info = {n: server.engine(n).session.cache_info() for n in graphs}
    sources = {n: dict(i["plan_sources"]) for n, i in info.items()}
    for key in {k for src in sources.values() for k in src}:
        got = sorted(src[key] for src in sources.values() if key in src)
        assert got.count("built") == 1 and set(got) <= {"built", "shared"}, \
            (key, got)
    holders = [n for n, i in info.items() if i["builds"].get("ell")]
    assert len(holders) == 1 and info[holders[0]]["builds"]["ell"] == 1, \
        {n: i["builds"] for n, i in info.items()}
    tiles = server.engine(holders[0]).session.ell_tiles()
    assert all(server.engine(n).session.ell_tiles() is tiles for n in graphs)
    tile_bytes = sum(t.numel() * t.element_size() for b in tiles for t in b)
    dg = server.engine(holders[0]).session.device_graph()
    assert all(server.engine(n).session.device_graph() is dg
               for n in graphs), "the sessions hold two CSRs"
    csr_bytes = sum(t.numel() * t.element_size()
                    for t in (dg.indptr, dg.indices, dg.deg_ext))
    counts = {n: {s: list(src.values()).count(s) for s in set(src.values())}
              for n, src in sources.items()}
    return dict(sources=counts, tile_holders=holders, tile_bytes=tile_bytes,
                csr_bytes=csr_bytes,
                peak_bytes=torch.cuda.max_memory_allocated(dev))


def server_phase(args, g16, g22, rng, record, dev, entries):
    """Phase 5v: `BFSServer` on the card. The load over two scale-22
    sessions (every tree checked, every root equal to the same root
    through `Engine.bfs` in the gather formulation on the same session,
    plain PyTorch and independent of the kernels; rows 1-3 and 5-7
    launched in the measured window), one gather query at scale 22 against
    the tiles, and the degradation chain (no gather stage on the card),
    the breaker and the cancel probes on the phase-3 graph."""
    import torch
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.engine import BFSServer, RetryPolicy, SessionUnavailable
    from repro_torch.kernels import ops
    from repro_torch.launch import bfs_serve
    from repro_torch.runtime.faults import (DevicePressure, FaultInjected,
                                            fault_scope)
    rec = record["server"] = dict(note=SERVER_NOTE, card=record["card"])
    t_phase = time.perf_counter()

    # the load on two sessions of the --scale graph, after the same load
    # on one of them (how far the two workers overlap); both sessions are
    # warm first, so neither window holds a build or a warm-up search
    graphs = {"replica-0": g22, "replica-1": g22}
    torch.cuda.reset_peak_memory_stats(dev)
    server = BFSServer(graphs, **SERVER_CAPS)
    cand = np.flatnonzero(g22.degrees > 0)
    for name in graphs:
        server.submit(name, cand[:4], client="warm").result(600)
        server.submit(name, cand[:1], client="warm",
                      stream=True).result(600)
    one = bfs_serve.run_load(server, {"replica-0": g22}, seed=args.seed,
                             validate=0, **SERVER_LOAD)
    # a worker counts a served query just after it wakes the client: wait
    # for the last count (2 x 2 warm-ups, run_load's 2, the load's)
    want = 2 * len(graphs) + 2 + one["queries"]
    deadline = time.monotonic() + 60
    while server.stats()["totals"]["served"] < want:
        assert time.monotonic() < deadline, "the one-session load's counts"
        time.sleep(0.01)
    before = server.stats()
    # the counts start after run_load's warm-ups: the measured window only
    m = bfs_serve.run_load(server, graphs, seed=args.seed, validate=0,
                           keep_results=True,
                           before_clients=ops.reset_launches, **SERVER_LOAD)
    launches = {k: ops.LAUNCHES[k] for k in BFS_KERNELS}
    rec["sharing"] = sharing = plan_sharing(server, graphs, dev)
    results = m.pop("results")
    submitted = SERVER_LOAD["clients"] * SERVER_LOAD["queries_per_client"]
    assert m["queries"] == submitted
    for kind, names in SERVER_KERNELS.items():
        for k in names:
            assert launches[k] > 0, f"{k} never launched under the load"
    n_stream = sum(r.backend == "stepper" for _, r in results)
    assert n_stream == submitted // SERVER_LOAD["stream_every"], n_stream
    check = Graph500Check(g22, dev)
    t0 = time.perf_counter()
    n_trees = sum(trees_ok(check, res) for _, res in results)
    # every served root against the gather formulation on its session,
    # RECHECK_ROOTS roots a search; no port kernel may launch in it
    gcfg = BFSConfig(backend_kernels=False)
    ops.reset_launches()
    n_roots = 0
    for name in graphs:
        rows = [(res, j) for n, res in results if n == name
                for j in range(len(res.roots))]
        for i in range(0, len(rows), RECHECK_ROOTS):
            part = rows[i:i + RECHECK_ROOTS]
            ref = server.engine(name).bfs(
                np.asarray([r.roots[j] for r, j in part]), gcfg)
            for k, (r, j) in enumerate(part):
                assert np.array_equal(r.parent[j], ref.parent[k]), \
                    f"{name} root {r.roots[j]}: parent differs from gather"
                assert np.array_equal(r.level[j], ref.level[k]), \
                    f"{name} root {r.roots[j]}: level differs from gather"
            n_roots += len(part)
    assert n_roots == submitted * SERVER_LOAD["batch"], n_roots
    assert sum(ops.LAUNCHES.values()) == 0, dict(ops.LAUNCHES)
    rec["recheck_s"] = time.perf_counter() - t0
    del check, results
    # read after the recheck, which bypasses the server: by now every
    # worker has counted its last query (it counts just after the wake)
    stats = server.stats()
    tot = {k: v - before["totals"][k] for k, v in stats["totals"].items()}
    for k in ("failed", "dispatch_failures", "degraded_backend",
              "degraded_scalar", "worker_crashes"):
        assert stats["totals"][k] == 0, f"server {k} under the load"
    warm = len(graphs) * 2        # run_load's warm-up queries
    assert tot["served"] == submitted + warm, (tot["served"], submitted)
    # `launches` covers the clients' queries alone; served, batches and
    # roots a dispatch hold run_load's warm-ups too
    sess = stats["sessions"]
    busy = {n: sess[n]["busy_s"] - before["sessions"][n]["busy_s"]
            for n in graphs}
    rec["load"] = dict(
        m, submitted=submitted, served=tot["served"],
        batches=tot["batches"], roots_per_dispatch=tot["roots"]
        / max(tot["batches"], 1), launches=launches,
        high_water={n: sess[n]["queue_high_water"] for n in graphs},
        busy_s=busy, busy_over_wall=sum(busy.values()) / m["wall_s"],
        runtime={n: sess[n]["runtime"] for n in graphs})
    rec["one_session"] = one
    L = rec["load"]
    log(f"phase 5v: BFSServer on {record['card']}, 2 sessions of RMAT scale "
        f"{args.scale}, {SERVER_LOAD['clients']} clients x "
        f"{SERVER_LOAD['queries_per_client']} queries x "
        f"{SERVER_LOAD['batch']} roots, every "
        f"{SERVER_LOAD['stream_every']}th streamed ({SERVER_NOTE}): "
        f"{L['qps']:.3f} QPS, p50 {L['latency_p50_ms']:.1f} ms, p99 "
        f"{L['latency_p99_ms']:.1f} ms, {L['teps_sustained'] / 1e9:.4f} "
        f"GTEPS aggregate (p99 of {m['queries']} queries is their "
        f"maximum), {L['roots_per_dispatch']:.2f} roots a dispatch "
        f"({tot['served']} queries in {tot['batches']} dispatches, "
        f"run_load's 4 warm-ups included), queue high water (both loads) "
        f"{L['high_water']}, busy_s "
        + ", ".join(f"{n} {s:.3f}" for n, s in L["busy_s"].items())
        + f" (sum / wall {L['busy_over_wall']:.2f}); the same load on one "
        f"session: {one['qps']:.3f} QPS, p50 {one['latency_p50_ms']:.1f} "
        f"ms, {one['teps_sustained'] / 1e9:.4f} GTEPS (two sessions / one: "
        f"{L['qps'] / one['qps']:.2f}x QPS)")
    log(f"  plan sharing (on): {sharing['sources']}; tiles held by "
        f"{sharing['tile_holders']} ({sharing['tile_bytes'] / 2**30:.3f} "
        f"GiB, one set), one CSR ({sharing['csr_bytes'] / 2**30:.3f} GiB) "
        f"for both; peak device memory over both loads "
        f"{sharing['peak_bytes'] / 2**30:.3f} GiB on {record['card']} (a "
        f"session with its own would add "
        f"{(sharing['tile_bytes'] + sharing['csr_bytes']) / 2**30:.3f} "
        f"GiB)")
    log(f"  {n_trees} trees pass the Graph500 check and each of their "
        f"{n_roots} roots equals Engine.bfs in the gather formulation on the "
        f"same session ({rec['recheck_s']:.1f} s); 0 failed, 0 "
        f"degraded, 0 crashes; launches under the load (warm-ups excluded) "
        f"{ {k: c for k, c in launches.items() if c} }")

    # the gather formulation at full size, against the tiles
    eng = server.engine("replica-0")
    roots = rng.choice(np.flatnonzero(g22.degrees > 0), 4, replace=False)
    tiles = eng.bfs(roots)
    ops.reset_launches()
    t0 = time.perf_counter()
    gather = eng.bfs(roots, BFSConfig(backend_kernels=False))
    gather_wall = time.perf_counter() - t0
    assert sum(ops.LAUNCHES.values()) == 0, dict(ops.LAUNCHES)
    assert np.array_equal(gather.parent, tiles.parent), "gather parent"
    assert np.array_equal(gather.level, tiles.level), "gather level"
    rec["gather"] = dict(roots=roots.tolist(), seconds=gather.seconds,
                         wall_with_warm_s=gather_wall,
                         tiles_seconds=tiles.seconds,
                         levels=level_rows(gather.batch_level_stats))
    log(f"  gather formulation, 4 roots at scale {args.scale}: "
        f"{gather.seconds:.3f} s (first query with its warm-up "
        f"{gather_wall:.1f} s) against the tiles' {tiles.seconds:.3f} s; "
        f"equal bit for bit, no port kernel launched; per level "
        + ", ".join(f"{r['direction']} {r['seconds'] * 1e3:.0f} ms"
                    for r in rec["gather"]["levels"]))
    server.close()
    del server, eng, tiles, gather
    gc.collect()
    torch.cuda.empty_cache()

    # the chain, the breaker and the cancel probes on the phase-3 graph
    roots = rng.choice(np.flatnonzero(g16.degrees > 0), 4, replace=False)
    chain = rec["chain"] = {}

    def counters(srv):
        srv.close()               # joins the workers: the counts are final
        return srv.stats()["sessions"]["g"]

    for sched, want in (("worker@0", dict(worker_crashes=1,
                                          worker_restarts=1, served=1)),
                        ("dispatch[mode=batch]@0", dict(retries=1,
                                                        served=1))):
        srv = BFSServer({"g": g16})
        with fault_scope(sched, seed=args.seed):
            srv.submit("g", roots, client="c").result(600)
        c = counters(srv)
        assert all(c[k] == v for k, v in want.items()), (sched, c)
        chain[sched] = {k: c[k] for k in want}
    srv = BFSServer({"g": g16}, retry=RetryPolicy(max_retries=0),
                    breaker_threshold=100)
    kcfg = BFSConfig(backend_kernels=True)
    oracle = srv.submit("g", roots, kcfg, client="o").result(600)
    # on the card the chain has no gather stage: every tiles dispatch
    # fails here, the batch and then the scalar stage, and the client gets
    # the fault itself
    with fault_scope("dispatch[kernels=tiles]@*", seed=args.seed):
        try:
            srv.submit("g", roots, kcfg, client="d").result(600)
            raise AssertionError("dispatch[kernels=tiles]@* was served")
        except FaultInjected:
            pass
    with fault_scope("dispatch[mode=batch]@*", seed=args.seed):
        got = srv.submit("g", roots, client="d").result(600)
    assert np.array_equal(got.parent, oracle.parent)
    assert np.array_equal(got.level, oracle.level)
    with fault_scope("device@*", seed=args.seed):
        try:
            srv.submit("g", roots, client="p").result(600)
            raise AssertionError("device@* served a query")
        except DevicePressure:
            pass
    c = counters(srv)
    # dispatch failures: tiles@* batch + scalar, batch@* batch, device@*
    # batch + scalar; none of them ran a gather stage
    assert (c["degraded_backend"], c["degraded_scalar"], c["failed"],
            c["retries"], c["dispatch_failures"]) == (0, 1, 2, 0, 5), c
    chain["degrade"] = {k: c[k] for k in ("degraded_backend",
                                          "degraded_scalar", "failed",
                                          "dispatch_failures", "retries")}
    srv = BFSServer({"g": g16}, retry=RetryPolicy(max_retries=0),
                    breaker_threshold=2, breaker_reset_s=0.25)
    gcfg = BFSConfig(backend_kernels=False)
    srv.submit("g", roots, gcfg, client="w").result(600)
    with fault_scope("dispatch@*:limit=2", seed=args.seed):
        try:
            srv.submit("g", roots, gcfg, client="v").result(600)
            raise AssertionError("the tripping query was served")
        except FaultInjected:
            pass
        try:
            srv.submit("g", roots, gcfg, client="v")
            raise AssertionError("an open breaker admitted a query")
        except SessionUnavailable:
            pass
    time.sleep(0.3)
    srv.submit("g", roots, gcfg, client="probe").result(600)
    c = counters(srv)
    assert c["breaker"]["state"] == "closed" and c["breaker"]["trips"] == 1
    chain["breaker"] = dict(c["breaker"], breaker_rejected=c[
        "breaker_rejected"])
    srv = BFSServer({"g": g16})
    probe = bfs_serve.run_cancel_probe(srv, levels=CANCEL_LEVELS)
    fused = bfs_serve.run_fused_cancel_probe(srv, levels=CANCEL_LEVELS)
    srv.close()
    assert probe["cancelled"] == probe["served"] == probe["queries"] // 2
    assert probe["inflight_after"] == 0 and probe["worker_alive"]
    assert fused["cancelled"] and fused["inflight_after"] == 0
    assert fused["levels_before_abort"] < CANCEL_LEVELS
    chain["cancel_probe"] = probe
    chain["fused_cancel_probe"] = fused
    log(f"  chain on the scale-{PARITY_SCALE} graph: worker@0 "
        f"{chain['worker@0']}; dispatch[mode=batch]@0 "
        f"{chain['dispatch[mode=batch]@0']}; tiles@* -> FaultInjected (no "
        f"gather stage on the card), batch -> scalar (trees equal the "
        f"tiles'), device@* -> DevicePressure {chain['degrade']}; breaker "
        f"{chain['breaker']}; cancel probe "
        f"{probe['cancelled']} cancelled / {probe['served']} served, wall "
        f"ratio {probe['wall_ratio']:.2f}; fused cancel after "
        f"{fused['levels_before_abort']} of {CANCEL_LEVELS} levels")
    for entry in entries:
        if entry["name"] in SERVER_KERNELS["batch"] + SERVER_KERNELS["stream"]:
            entry["server_launches"] = launches[entry["name"]]
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 5v: {rec['seconds']:.1f} s")


RESTART_ROWS = ("bottomup_batch", "topdown_push_batch",
                "frontier_fused_batch")


def restart_phase(args, g16, g22, rng, record, dev, entries, path22):
    """Phase 5r: the artifact cache and pre-warm across real restarts
    (`bfs_serve.run_restart_probe` on the --scale graph file, a fresh
    cache dir, a garbage library for the third child), then the chaos
    probe's cache phase on the phase-3 graph. The children's trees are
    held against the same root through `Engine.bfs` in the gather
    formulation here (plain PyTorch, no kernel launched), so a cached
    library that is loadable but wrong cannot pass by agreeing with
    itself. Rows 1-3's launches in the warm child join their
    `entries`."""
    import tempfile
    from repro_torch.core.bfs import BFSConfig
    from repro_torch.engine import Engine, GraphSession
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import bfs_serve
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cache_") as cache:
        out = bfs_serve.run_restart_probe(cache, graph_path=path22,
                                          device="cuda",
                                          corrupt_library=True,
                                          timeout=RANK_TIMEOUT)
    trees = out.pop("trees")
    ch = out["children"]
    n_lib = len(_build.SOURCES)
    assert out["cold_compiles"] == n_lib, out["cold_compiles"]
    assert out["warm_compiles"] == 0, out["warm_compiles"]
    assert ch["warm"]["kernels"]["sources"] == \
        {n: "cache" for n in _build.SOURCES}, ch["warm"]["kernels"]
    assert out["cold_builds"] == 3 and out["warm_builds"] == 0, \
        (out["cold_builds"], out["warm_builds"])
    pw = out["prewarm"]
    assert pw["loaded"] == out["cold_builds"] and pw["failed"] == 0 \
        and pw["error"] is None, pw
    assert out["warm_loads"] == out["cold_builds"]
    for k in RESTART_ROWS:
        assert out["warm_launches"].get(k, 0) > 0, (k, out["warm_launches"])
    assert out["repair_compiles"] == 1 and \
        out["repair_corrupt_evictions"] >= 1, ch["repair"]
    assert ch["repair"]["kernels"]["sources"]["bottomup"] == "compiled"
    assert out["same_trees"] and out["repair_same_trees"]
    check = Graph500Check(g22, dev)
    for phase, (root, parent, level) in trees.items():
        check.check(root, parent[0], level[0])
    del check
    sess = GraphSession(g22, dev, prewarm=False)
    ops.reset_launches()
    t0 = time.perf_counter()
    ref = Engine(sess).bfs([out["root"]], BFSConfig(backend_kernels=False))
    out["plain_check_s"] = time.perf_counter() - t0
    assert sum(ops.LAUNCHES.values()) == 0, dict(ops.LAUNCHES)
    for phase, (root, parent, level) in trees.items():
        assert root == out["root"], (phase, root)
        assert np.array_equal(parent, ref.parent), f"{phase} parent vs plain"
        assert np.array_equal(level, ref.level), f"{phase} level vs plain"
    sess.close()
    del sess, ref
    roots = rng.choice(np.flatnonzero(g16.degrees > 0), 4, replace=False)
    chaos = bfs_serve.run_cache_chaos(g16, roots, seed=args.seed,
                                      device="cuda")
    assert chaos["ok"], chaos
    out["cache_chaos"] = chaos
    out["seconds"] = time.perf_counter() - t_phase
    record["restart"] = out
    log(f"phase 5r: restart probe on {record['card']}, RMAT scale "
        f"{args.scale} from phase 5s's file, one root {out['root']}: "
        f"cold_start_s {out['cold_start_s']:.3f} ({out['cold_compiles']} "
        f"nvcc in {out['cold_compile_s']:.3f} s, {out['cold_builds']} "
        f"cohort plans built), warm_start_s {out['warm_start_s']:.3f} "
        f"({out['warm_compiles']} nvcc, {out['warm_library_loads']} "
        f"libraries loaded in {out['warm_library_load_s']:.4f} s, "
        f"{out['warm_builds']} plans built on the query path, pre-warm "
        f"loaded {pw['loaded']} in {pw['seconds']:.3f} s, hit rate "
        f"{out['hit_rate']:.3f}); speedup {out['speedup']:.2f}x; "
        f"graph load {ch['cold']['setup_s']:.1f} / "
        f"{ch['warm']['setup_s']:.1f} s, process "
        f"{ch['cold']['process_s']:.1f} / {ch['warm']['process_s']:.1f} s")
    parts = "; ".join(
        f"{k[:-2]} " + " / ".join(f"{out[w + '_parts'][k]:.3f}"
                                  for w in ("cold", "warm"))
        for k in bfs_serve.RESTART_PARTS)
    log(f"  session seconds, cold / warm start (the warm start's in its "
        f"pre-warm): {parts}")
    log(f"  warm child's launches {out['warm_launches']}; repair child "
        f"(bottomup's entry garbage): {out['repair_compiles']} nvcc, "
        f"{out['repair_corrupt_evictions']} corrupt eviction, start "
        f"{ch['repair']['first_query_s']:.3f} s; 3 trees equal, pass "
        f"the Graph500 check and equal the gather formulation here "
        f"({out['plain_check_s']:.2f} s, no kernel launched); cache chaos "
        f"on scale {PARITY_SCALE}: "
        f"{chaos['corrupt_evictions']} eviction, {chaos['rebuilds']} "
        f"rebuild, bitwise {chaos['bitwise']} ({out['seconds']:.1f} s)")
    for entry in entries:
        if entry["name"] in RESTART_ROWS:
            n = out["warm_launches"][entry["name"]]
            entry.update(launches=entry["launches"] + n, restart_launches=n)


def serve_phase(args, dev, record, dec_err):
    """Phase 6: gemma2-9b at full width through `launch.serve.serve`, its
    captured decode calls against the plain version, the kernel's times
    and a profile of one decode step; the kernels line's entry of the
    decode kernel."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attn, ops
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    cfg = get_config(SERVE["arch"])
    b, s0, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    steps = gen - 1
    kept, restore = install_decode_capture(cfg.n_layers, steps)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    run = serve.serve(cfg, batch=b, prompt_len=s0, gen=gen, seed=args.seed,
                      device=dev)
    launches = ops.LAUNCHES["decode_attention"]
    restore()
    peak = torch.cuda.max_memory_allocated(dev)
    assert launches == cfg.n_layers * steps, \
        f"decode_attention launched {launches} times, not {cfg.n_layers} x " \
        f"{steps}"
    assert run.tokens.shape == (b, gen), run.tokens.shape
    assert tuple(run.logits.shape) == (b, cfg.vocab)
    assert bool(torch.isfinite(run.logits).all()), "non-finite logits"
    assert sorted((st, ly) for st, ly, *_ in kept) == [
        (0, 0), (0, 1), (steps - 1, 0), (steps - 1, 1)], "capture missed"
    err = dec_err
    for _, _, cargs, cap, out in kept:
        err = max(err, decode_vs_plain(cargs, cap, out))
    torch.cuda.synchronize()
    record["serve"] = dict(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, kv_heads=cfg.n_kv, head_dim=cfg.head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=cfg.dtype, batch=b,
        prompt_len=s0, gen=gen, decode_steps=steps, launches=launches,
        init_s=run.init_s, prefill_s=run.prefill_s,
        decode_ms_per_step=run.decode_s / steps * 1e3,
        tokens_per_s=steps * b / run.decode_s, peak_bytes=peak,
        tokens_head=run.tokens[:, :8].tolist())
    log(f"phase 6: {cfg.name} at full width ({cfg.n_layers} layers, "
        f"{cfg.dtype}), batch {b}, prompt {s0}, {gen} greedy tokens: weights "
        f"{run.init_s:.1f} s, prefill {run.prefill_s:.3f} s, decode "
        f"{run.decode_s / steps * 1e3:.2f} ms/step "
        f"({steps * b / run.decode_s:.1f} tokens/s), peak memory "
        f"{peak / 2**30:.2f} GiB; decode_attention launched {launches} = "
        f"{cfg.n_layers} x {steps}; its calls at steps 0 and {steps - 1} on "
        f"layers 0 and 1 equal the plain version (max |kernel - plain| "
        f"{err:.3g}); tokens[0] {run.tokens[0, :8].tolist()}")

    # the kernel's time at the serve shape, cache_len = the whole context
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    s = s0 + gen
    q, kc, vc, clen = decode_inputs(
        np.random.default_rng([args.seed, 3]), dev, torch.bfloat16, b, s,
        cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim, [s] * b)
    t = time_decode(q, kc, vc, clen, flush)
    nbytes, nops = decode_bound(q, kc, clen)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
    plan = dict(decode_attn.LAST_PLAN)     # of the launches just timed
    nsplit, split_len = plan["nsplit"], plan["split_len"]
    for cap in ("50", "0"):
        t[f"gb_per_s_cap{cap}"] = nbytes / t[f"ms_cap{cap}"] / 1e6
        t[f"bound_share_cap{cap}"] = max(t_bytes, t_ops) / t[f"ms_cap{cap}"]
    t.update(plan)
    record["decode_timing"] = dict(t, shape=[list(q.shape), list(kc.shape)],
                                   bytes=nbytes, ops=nops)
    log(f"phase 6: decode_attention at q {list(q.shape)}, caches "
        f"{list(kc.shape)} bf16, cache_len {s}, {nsplit} splits of "
        f"{split_len} ({t['blocks']} blocks, {t['resident']} per SM "
        f"resident): {t['ms_cap50']:.4f} ms at "
        f"cap 50 ({t['gb_per_s_cap50']:.0f} GB/s, "
        f"{t['bound_share_cap50']:.3f} of the bound), {t['ms_cap0']:.4f} ms "
        f"at cap 0 ({t['gb_per_s_cap0']:.0f} GB/s, "
        f"{t['bound_share_cap0']:.3f}); plain {t['plain_ms_cap50']:.4f} / "
        f"{t['plain_ms_cap0']:.4f} ms; with the lse {t['ms_lse_cap50']:.4f}"
        f" ms at cap 50; SDPA at cap 0 "
        f"{t['library_ms_cap0']:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
        f"({nbytes} bytes); host {t['host_us_per_call']:.1f} us a call")
    del q, kc, vc

    # the same at the decode shapes of the other dense configs the port
    # serves (not driven end to end here)
    record["decode_timing_other"] = {}
    for arch in OTHER_DECODE:
        oc = get_config(arch)
        q, kc, vc, clen = decode_inputs(
            np.random.default_rng([args.seed, 4]), dev, torch.bfloat16, b, s,
            oc.n_kv, oc.n_heads // oc.n_kv, oc.head_dim, [s] * b)
        o = time_decode(q, kc, vc, clen, flush, plain=False)
        nb, _ = decode_bound(q, kc, clen)
        o.update(decode_attn.LAST_PLAN, shape=[list(q.shape),
                                               list(kc.shape)],
                 bytes=nb, bound_ms=nb / HBM_BYTES_PER_S * 1e3)
        record["decode_timing_other"][arch] = o
        log(f"phase 6: decode_attention, {arch}'s shape q {list(q.shape)}: "
            f"{o['ms_cap50']:.4f} ms at cap 50, {o['ms_cap0']:.4f} at cap 0 "
            f"({o['nsplit']} splits, {o['resident']} per SM resident), SDPA "
            f"{o['library_ms_cap0']:.4f} ms, bound {o['bound_ms']:.4f} ms")
        del q, kc, vc
    del flush

    # one more decode step (position s - 1) under the profiler
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    tok = torch.from_numpy(run.tokens[:, -1:].astype(np.int32)).to(dev)
    prof = profile_decode_step(
        lambda: D.decode_step(cfg, run.params, run.cache, tok, pos))
    record["decode_profile"] = prof
    log(f"phase 6: profiled one decode step: wall {prof['wall_s'] * 1e3:.2f} "
        f"ms, device busy {prof['device_busy_ms']:.2f} ms (idle share "
        f"{prof['idle_share']:.3f}); decode_attention "
        f"{prof['decode_attn_share']:.3f} of device time, matrix products "
        f"{prof['matmul_share']:.3f}; top device time:")
    for row in prof["top"]:
        log(f"    {row['device_ms']:10.3f} ms {row['calls']:6d}x {row['op']}")
    return dict(
        name=DECODE[0], route="cuda", source=DECODE[1], replaces=DECODE[2],
        launches=launches, max_abs_err=err, ms=t["ms_cap50"],
        plain_ms=t["plain_ms_cap50"], bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=t["library_ms_cap0"], ms_cap0=t["ms_cap0"],
        plain_ms_cap0=t["plain_ms_cap0"], ms_lse=t["ms_lse_cap50"],
        nsplit=nsplit,
        gb_per_s=t["gb_per_s_cap50"], bound_share=t["bound_share_cap50"],
        library_note=SDPA_NOTE)


def install_moe_capture():
    """Wrap `models.moe.moe_ffn` to read the routing of every MoE call:
    at prefill (S > 1) its dropped and total top-k assignments are summed
    on the device as the call runs (no sync); a decode call's input is
    kept (B x D) and routed after the run. Returns (counts, decode inputs,
    restore)."""
    from repro_torch.models import moe as MOE
    saved, counts, decode_in = MOE.moe_ffn, {}, []

    def fn(params, x, cfg):
        if x.shape[1] > 1:
            keep = MOE.route(params, x.reshape(-1, x.shape[-1]), cfg)[-1]
            counts["dropped"] = counts.get("dropped", 0) + (~keep).sum()
            counts["assignments"] = counts.get("assignments", 0) + keep.numel()
        else:
            decode_in.append((params, x))
        return saved(params, x, cfg)

    MOE.moe_ffn = fn

    def restore():
        MOE.moe_ffn = saved
    return counts, decode_in, restore


def moe_drops(cfg, counts, decode_in):
    """The share of top-k assignments the capacity dropped, at prefill and
    at decode, with each's capacity a call."""
    from repro_torch.models import moe as MOE
    dropped = sum(int((~MOE.route(p, x.reshape(-1, x.shape[-1]), cfg)[-1])
                      .sum()) for p, x in decode_in)
    total = sum(x.shape[0] * x.shape[1] * cfg.top_k for _, x in decode_in)
    b, s0 = SERVE["batch"], SERVE["prompt_len"]
    pre = dict(dropped=int(counts["dropped"]),
               assignments=int(counts["assignments"]),
               capacity=MOE.capacity(cfg, b * s0))
    dec = dict(dropped=dropped, assignments=total,
               capacity=MOE.capacity(cfg, b))
    for d in (pre, dec):
        d["share"] = d["dropped"] / d["assignments"]
    return dict(prefill=pre, decode=dec)


def family_phase(args, dev, record, entry):
    """Phase 6b: qwen3-moe (8 of 94 layers), llama4-maverick (one dense/MoE
    pair), mamba2-2.7b, hymba-1.5b, seamless-m4t-medium and internvl2-1b
    at every published width through `launch.serve.serve`, one after
    another, each freed before the next. For each: the seconds, tokens/s
    and peak memory, the decode kernel's launches (its calls a step x 31;
    none for mamba2, self and cross for seamless) and its captured calls
    against the plain version, the MoE models' dropped share of top-k
    assignments at prefill and at decode, one decode step under the
    profiler, and the kernel's time at each of the model's decode shapes
    against its bound and one SDPA call. Adds the launches and the worst
    error to the kernels line's decode entry."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attn, ops
    from repro_torch.launch import serve
    from repro_torch.models import decode as D
    b, s0, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    steps = gen - 1
    flush = torch.empty(1 << 27, dtype=torch.uint8, device=dev)
    fams = record["families"] = {}
    t_phase = time.perf_counter()
    for arch, cut in FAMILY_SERVE:
        cfg = dataclasses.replace(get_config(arch), **cut)
        n_attn = calls_per_step(cfg)
        kept, restore_dec = install_decode_capture(n_attn or 1, steps)
        counts, decode_in, restore_moe = install_moe_capture()
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launches()
        try:
            run = serve.serve(cfg, batch=b, prompt_len=s0, gen=gen,
                              seed=args.seed, device=dev)
            launches = ops.LAUNCHES["decode_attention"]
        finally:
            restore_dec()
            restore_moe()
        peak = torch.cuda.max_memory_allocated(dev)
        assert launches == n_attn * steps, \
            f"{arch}: decode_attention launched {launches} times, not " \
            f"{n_attn} x {steps}"
        assert run.tokens.shape == (b, gen), run.tokens.shape
        assert tuple(run.logits.shape) == (b, cfg.vocab)
        assert bool(torch.isfinite(run.logits).all()), f"{arch}: non-finite"
        err = 0.0
        if n_attn:
            assert sorted((st, ly) for st, ly, *_ in kept) == [
                (0, 0), (0, 1), (steps - 1, 0), (steps - 1, 1)], \
                f"{arch}: capture missed"
            for _, _, cargs, cap, out in kept:
                err = max(err, decode_vs_plain(cargs, cap, out))
        del kept
        drops = moe_drops(cfg, counts, decode_in) if counts else None
        del decode_in
        rec = fams[cfg.name] = dict(
            arch=arch, family=cfg.family, layers=cfg.n_layers,
            published_layers=get_config(arch).n_layers,
            enc_layers=cfg.n_enc_layers, frontend=cfg.frontend,
            decode_calls_per_step=n_attn, d_model=cfg.d_model,
            heads=cfg.n_heads,
            kv_heads=cfg.n_kv, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
            experts=cfg.n_experts, top_k=cfg.top_k, moe_d_ff=cfg.moe_d_ff,
            ssm_heads=cfg.ssm_heads, ssm_state=cfg.ssm_state,
            window=cfg.sliding_window, vocab=cfg.vocab, dtype=cfg.dtype,
            params=sum(p.numel() for p in run.params.parameters()),
            batch=b, prompt_len=s0, gen=gen, launches=launches,
            max_abs_err=err, init_s=run.init_s, prefill_s=run.prefill_s,
            decode_ms_per_step=run.decode_s / steps * 1e3,
            tokens_per_s=steps * b / run.decode_s, peak_bytes=peak,
            moe_drops=drops, tokens_head=run.tokens[:, :8].tolist())
        drop_note = "" if drops is None else (
            f"; capacity dropped {drops['prefill']['share']:.4f} of the "
            f"top-{cfg.top_k} assignments at prefill (capacity "
            f"{drops['prefill']['capacity']} a call) and "
            f"{drops['decode']['share']:.4f} at decode (capacity "
            f"{drops['decode']['capacity']})")
        log(f"phase 6b: {cfg.name} ({cfg.family}, "
            + (f"{cfg.n_enc_layers} encoder + " if cfg.n_enc_layers else "")
            + f"{cfg.n_layers} of {rec['published_layers']} layers, "
            + (f"{cfg.frontend} stub, " if cfg.frontend != "none" else "")
            + f"{rec['params'] / 1e9:.2f} G "
            f"parameters, {cfg.dtype}), batch {b}, prompt {s0}, {gen} greedy "
            f"tokens: weights {run.init_s:.1f} s, prefill "
            f"{run.prefill_s:.3f} s, decode {rec['decode_ms_per_step']:.2f} "
            f"ms/step ({rec['tokens_per_s']:.1f} tokens/s), peak memory "
            f"{peak / 2**30:.2f} GiB; decode_attention launched {launches} = "
            f"{n_attn} x {steps}"
            + (f", its calls at steps 0 and {steps - 1} on "
               + ("decoder layer 0 (self and cross)"
                  if cfg.family == "encdec" else "layers 0 and 1")
               + f" equal the plain version (max |kernel - plain| "
               f"{err:.3g})" if n_attn else "") + drop_note
            + f"; tokens[0] {run.tokens[0, :8].tolist()}")

        first = (run.tokens.copy(), run.logits.cpu())
        # one more decode step (the context's last position), profiled
        pos = torch.full((b,), s0 + gen - 1, dtype=torch.int32, device=dev)
        tok = torch.from_numpy(run.tokens[:, -1:].astype(np.int32)).to(dev)
        prof = profile_decode_step(
            lambda: D.decode_step(cfg, run.params, run.cache, tok, pos))
        rec["decode_profile"] = prof
        log(f"phase 6b: {cfg.name}: one decode step: wall "
            f"{prof['wall_s'] * 1e3:.2f} ms, device busy "
            f"{prof['device_busy_ms']:.2f} ms (idle share "
            f"{prof['idle_share']:.3f}); decode_attention "
            f"{prof['decode_attn_share']:.3f} of device time, matrix "
            f"products {prof['matmul_share']:.3f}; top: "
            + "; ".join(f"{r['op'][:40]} {r['device_ms']:.3f} ms x "
                        f"{r['calls']}" for r in prof["top"][:4]))
        del run, tok, pos
        gc.collect()
        torch.cuda.empty_cache()
        if arch == REPEAT_ARCH:
            t0 = time.perf_counter()
            again = serve_elsewhere(arch, args.seed)
            same = (bool(np.array_equal(again["tokens"].numpy(), first[0])),
                    bool(torch.equal(again["logits"], first[1])))
            del again
            rec["repeat"] = dict(tokens_equal=same[0],
                                 logits_bitwise_equal=same[1],
                                 s=time.perf_counter() - t0)
            log(f"phase 6b: {cfg.name} served again from seed {args.seed} "
                f"in a fresh process: "
                f"tokens equal {same[0]}, last logits equal bit for bit "
                f"{same[1]} ({rec['repeat']['s']:.1f} s)")
            assert all(same), f"{arch}: a second run from the same seed " \
                f"gave other tokens or logits"
        del first

        # the decode kernel at each of this model's shapes, cache_len =
        # the cache
        for call in decode_calls(cfg) if n_attn else ():
            s = decode_len(cfg, call)
            g = cfg.n_heads // cfg.n_kv
            q, kc, vc, clen = decode_inputs(
                np.random.default_rng([args.seed, 6]), dev, torch.bfloat16,
                b, s, cfg.n_kv, g, cfg.head_dim, [s] * b)
            t = time_decode(q, kc, vc, clen, flush)
            nbytes, nops = decode_bound(q, kc, clen)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / CUDA_CORE_OPS_PER_S * 1e3
            t.update(decode_attn.LAST_PLAN, shape=[list(q.shape),
                                                   list(kc.shape)],
                     bytes=nbytes, ops=nops, bound_ms=max(t_bytes, t_ops),
                     group_instance=decode_attn.group_instance(g))
            for cap in ("50", "0"):
                t[f"bound_share_cap{cap}"] = t["bound_ms"] / t[f"ms_cap{cap}"]
            label = cfg.name + (" cross" if call == "cross" else "")
            rec["decode_timing" + ("_cross" if call == "cross" else "")] = t
            log(f"phase 6b: decode_attention at {label}'s shape q "
                f"{list(q.shape)} (g {g} on the GM = {t['group_instance']} "
                f"instance), caches {list(kc.shape)} bf16, cache_len {s}, "
                f"{t['nsplit']} splits of {t['split_len']} ({t['blocks']} "
                f"blocks, {t['resident']} per SM resident): "
                f"{t['ms_cap0']:.4f} ms at cap 0 ({t['bound_share_cap0']:.3f} "
                f"of the bound), {t['ms_cap50']:.4f} ms at cap 50; plain "
                f"{t['plain_ms_cap0']:.4f} ms; SDPA {t['library_ms_cap0']:.4f}"
                f" ms; bound {t['bound_ms']:.4f} ms ({nbytes} bytes)")
            del q, kc, vc
            entry.setdefault("family_shapes", {})[label] = {
                k: t[k] for k in ("ms_cap0", "plain_ms_cap0",
                                  "library_ms_cap0", "bound_ms", "nsplit",
                                  "shape")}
        entry["launches"] += launches
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry.setdefault("family_launches", {})[cfg.name] = launches
    del flush
    record["families_s"] = time.perf_counter() - t_phase
    log(f"phase 6b: {record['families_s']:.1f} s")


def serve_elsewhere(arch, seed) -> dict:
    """`arch` at its `FAMILY_SERVE` cut served from `seed` by a fresh
    Python process on the card (`serve_to_file`, the kernels loaded from
    the build directory): its tokens [B, gen] and last logits, on the
    CPU."""
    import tempfile
    import torch
    with tempfile.TemporaryDirectory(prefix="chip_smoke_repeat_") as tmp:
        path = os.path.join(tmp, "run.pt")
        child = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke."
             f"serve_to_file({arch!r}, {seed}, {path!r})"], cwd=REPO,
            capture_output=True, text=True, timeout=RANK_TIMEOUT,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [REPO, os.path.join(REPO, "src")])))
        assert child.returncode == 0, child.stdout + child.stderr
        return torch.load(path)


def serve_to_file(arch, seed, path) -> None:
    """The child of `serve_elsewhere`: serve and save the tokens and the
    last logits to `path`."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import serve
    cfg = dataclasses.replace(get_config(arch), **dict(FAMILY_SERVE)[arch])
    run = serve.serve(cfg, batch=SERVE["batch"],
                      prompt_len=SERVE["prompt_len"], gen=SERVE["gen"],
                      seed=seed, device=torch.device("cuda", 0))
    torch.save(dict(tokens=torch.from_numpy(run.tokens),
                    logits=run.logits.cpu()), path)


# ------------------------------------------------------------- training --

def train_parity_phase(args, dev, record):
    """Phase 7a: one fp32 smoke config a family, the same weights (drawn on
    the CPU, copied to the card) and batches, `TRAIN_PARITY["steps"]` train
    steps on the card and on the CPU. Losses within TRAIN_LOSS_RTOL, each
    final parameter within TRAIN_PARAM_RTOL of the CPU's (relative
    Frobenius norm); no `ops` wrapper launched a kernel."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs.base import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import device_batch
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    ocfg = OptConfig(warmup_steps=2, decay_steps=10)
    b, s, steps = (TRAIN_PARITY[k] for k in ("batch", "seq", "steps"))
    rows = record["train_parity"] = {}
    t0 = time.perf_counter()
    ops.reset_launches()
    for arch in TRAIN_PARITY["archs"]:
        cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        cpu = M.init_params(cfg, torch.Generator().manual_seed(args.seed))
        sides = [(cpu, torch.device("cpu")),
                 (copy.deepcopy(cpu).to(dev), dev)]
        fn = make_train_step(cfg, ocfg)
        losses = [[], []]
        for i, (params, device) in enumerate(sides):
            state = init_opt_state(params, ocfg)
            for step in range(steps):
                inputs = device_batch(cfg, step, b, s, args.seed, device)
                params, state, m = fn(params, state, inputs)
                losses[i].append(float(m["loss"]))
        (lc, lg), (pc, pg) = losses, (sides[0][0], sides[1][0])
        loss_err = max(abs(g - c) / abs(c) for c, g in zip(lc, lg))
        with torch.no_grad():
            param_err = max(
                float((q.cpu() - p).norm() / p.norm().clamp_min(1e-30))
                for p, q in zip(pc.parameters(), pg.parameters()))
        rows[cfg.name] = dict(losses_cpu=lc, losses_gpu=lg,
                              loss_rel_err=loss_err, param_rel_err=param_err,
                              params=sum(p.numel() for p in pc.parameters()))
        assert all(np.isfinite(lg)), f"{arch}: non-finite loss {lg}"
        assert loss_err <= TRAIN_LOSS_RTOL, \
            f"{arch}: losses {lg} on the card, {lc} on the CPU"
        assert param_err <= TRAIN_PARAM_RTOL, \
            f"{arch}: a parameter differs by {param_err} (relative)"
        del sides, pc, pg
    launched = sum(ops.LAUNCHES.values())
    record["train_parity_launches"] = launched
    assert launched == 0, f"the training path launched {dict(ops.LAUNCHES)}"
    log(f"phase 7a: {', '.join(rows)} (fp32) train {steps} steps of "
        f"{b} x {s} alike on cuda and cpu: losses within "
        f"{max(r['loss_rel_err'] for r in rows.values()):.2g} (relative), "
        f"parameters within "
        f"{max(r['param_rel_err'] for r in rows.values()):.2g}; no kernel "
        f"launched ({time.perf_counter() - t0:.1f} s)")


def train_flops(cfg, batch: int, seq: int) -> dict:
    """The operations one train step needs (matmul multiply-adds x 2):
    bf16 weight products (every layer's and the unembedding's forward run
    twice, under activation checkpointing, plus a backward of twice the
    forward) and the fp32 attention products (QK^T and PV over the key
    blocks the chunked attention visits, also x 4)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hq, hk, h = cfg.n_heads, cfg.n_kv, cfg.head_dim
    per_token = cfg.n_layers * (d * (hq + 2 * hk) * h + hq * h * d
                                + 3 * d * f) + d * v
    blocks = -(-seq // 512)
    visited = blocks * (blocks + 1) // 2 * 512 * 512       # causal blocks
    attn = cfg.n_layers * batch * hq * h * visited * 2 * 2
    return dict(bf16=4 * 2 * per_token * batch * seq, fp32=4 * attn)


def train_full_phase(args, dev, record):
    """Phase 7b: stablelm-3b at every published width and depth through
    `launch.train.train`: TRAIN_FULL's steps at seq 4,096 (train_4k's
    length), the global batch cut from 256 to 4 in 2 micro-batches, no
    checkpoint. Step 0 (first calls) apart from the rest; the loss and
    grad norm of each step (finite), peak memory, tokens/s; then one more
    step profiled (device-busy ms against its wall)."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as LT
    cfg = get_config(TRAIN_FULL["arch"])
    b, s, accum, steps = (TRAIN_FULL[k]
                          for k in ("batch", "seq", "accum", "steps"))
    torch.cuda.synchronize(dev)          # the context, before its stats
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    run = LT.train(cfg, steps=steps, batch=b, seq=s, device=dev,
                   accum=accum, seed=args.seed,
                   log=lambda msg: log(f"phase 7b: {msg}"))
    peak = torch.cuda.max_memory_allocated(dev)
    launched = sum(ops.LAUNCHES.values())
    assert len(run.losses) == steps
    assert all(np.isfinite(run.losses)) and all(np.isfinite(run.grad_norms)), \
        (run.losses, run.grad_norms)
    assert launched == 0, f"the training path launched {dict(ops.LAUNCHES)}"
    steady = float(np.mean(run.step_s[1:]))
    n_params = sum(p.numel() for p in run.params.parameters())
    flops = train_flops(cfg, b, s)
    bound_ms = dict(bf16=flops["bf16"] / BF16_TENSOR_OPS_PER_S * 1e3,
                    fp32=flops["fp32"] / CUDA_CORE_OPS_PER_S * 1e3)
    inputs = LT.device_batch(cfg, steps, b, s, args.seed, dev)
    prof = profile_device(
        lambda: run.step_fn(run.params, run.opt_state, inputs))
    rec = record["train_full"] = dict(
        arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab, dtype=cfg.dtype,
        params=n_params, seq=s, global_batch=b, accum=accum, steps=steps,
        reduced=["global batch 256 -> 4 (2 micro-batches of 2): train_4k "
                 "at 256 x 4,096 is 64x the tokens a step",
                 f"{steps} steps, no checkpoint"],
        losses=run.losses, grad_norms=run.grad_norms, step_s=run.step_s,
        first_step_s=run.step_s[0], steady_step_s=steady,
        tokens_per_s=b * s / steady, peak_bytes=peak, init_s=run.init_s,
        flops=flops, bound_ms=bound_ms,
        bf16_mfu=flops["bf16"] / BF16_TENSOR_OPS_PER_S / steady,
        launches=launched, profile=prof)
    log(f"phase 7b: {cfg.name} at full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {n_params / 1e9:.3f} G parameters, {cfg.dtype}), "
        f"global batch {b} x {s} in {accum} micro-batches: weights "
        f"{run.init_s:.1f} s, step 0 {run.step_s[0]:.3f} s, steps 1-"
        f"{steps - 1} {steady:.3f} s each ({rec['tokens_per_s']:.0f} "
        f"tokens/s), peak memory {peak / 2**30:.2f} GiB; losses "
        f"{[round(x, 4) for x in run.losses]}, grad norms "
        f"{[round(x, 4) for x in run.grad_norms]}; bounds: bf16 products "
        f"{bound_ms['bf16']:.0f} ms ({flops['bf16']:.3g} operations), fp32 "
        f"attention {bound_ms['fp32']:.0f} ms ({flops['fp32']:.3g}); one "
        f"more step profiled: wall {prof['wall_s']:.3f} s, device busy "
        f"{prof['device_busy_ms']:.1f} ms over {prof['device_ops']} device "
        f"ops (idle share {prof['idle_share']:.3f}), matrix products "
        f"{prof['matmul_share']:.3f} of device time; top: "
        + "; ".join(f"{r['op'][:40]} {r['device_ms']:.1f} ms x "
                    f"{r['calls']}" for r in prof["top"][:5]))
    del run, inputs


def train_restart_phase(args, dev, record):
    """Phase 7c: the launcher (`launch.train.main`, --device cuda) at smoke
    size, TRAIN_RESTART["first"] steps with a checkpoint every
    TRAIN_RESTART["every"] into a directory under build/, then the same
    command up to TRAIN_RESTART["total"]: it resumes from the last
    checkpoint, and its steps give an uninterrupted run's losses within
    1e-6 (relative)."""
    import contextlib
    import io
    import shutil
    import tempfile
    from repro_torch.launch import train as LT
    first, total, every = (TRAIN_RESTART[k]
                           for k in ("first", "total", "every"))
    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=build)
    try:
        base = ["--arch", TRAIN_RESTART["arch"], "--smoke", "--batch",
                str(TRAIN_RESTART["batch"]), "--seq",
                str(TRAIN_RESTART["seq"]), "--ckpt-every", str(every),
                "--seed", str(args.seed), "--device", "cuda"]
        whole = LT.main(base + ["--steps", str(total), "--ckpt",
                                os.path.join(root, "whole")])
        cut = os.path.join(root, "cut")
        head = LT.main(base + ["--steps", str(first), "--ckpt", cut])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tail = LT.main(base + ["--steps", str(total), "--ckpt", cut])
        text = out.getvalue()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert f"[train] resumed from step {first}" in text, text
    assert len(tail) == total - first, tail
    err = max(abs(a - b) / abs(b) for a, b in zip(tail, whole[first:]))
    record["train_restart"] = dict(whole=whole, head=head, tail=tail,
                                   rel_err=err,
                                   head_bitwise=head == whole[:first])
    assert err <= 1e-6, f"resumed losses {tail}, uninterrupted {whole}"
    log(f"phase 7c: {TRAIN_RESTART['arch']} smoke on cuda: {first} steps "
        f"with a checkpoint every {every}, then resumed from step {first} "
        f"to {total}: losses {[round(x, 6) for x in tail]} equal the "
        f"uninterrupted run's within {err:.2g} (its first {first} steps "
        f"{'bit for bit' if head == whole[:first] else 'within rounding'})")


# ------------------------------------------------------------------ main --

# ------------------------------------------------------- expert parallel --

def moe_expert(seed: int, name: str, e: int, cfg, dev):
    """Expert e's fp32 [D, F] (wg, wi) or [F, D] (wo), or the [D, E]
    router for e = -1, each from its own seed: a rank draws only its own
    experts, the parent all of them, with the same values."""
    import torch
    d, f = cfg.d_model, cfg.moe_d_ff
    j = MOE_WEIGHTS.index(name)
    g = torch.Generator(device=dev).manual_seed(seed * 1_000_003 + 4 * e + j)
    if name == "router":
        shape, std = (d, cfg.n_experts), d ** -0.5
    else:
        shape, std = ((f, d), f ** -0.5) if name == "wo" else ((d, f),
                                                              d ** -0.5)
    return torch.randn(shape, generator=g, device=dev).mul_(std)


def moe_block(seed: int, name: str, cfg, dev, dtype, experts, rows):
    """Weight `name` for `experts`, its D dim cut to `rows` (dim 1 of wg
    and wi, dim 2 of wo, dim 0 of the router, which stays fp32), in
    `dtype`."""
    import torch
    if name == "router":
        return moe_expert(seed, name, -1, cfg, dev)[rows]
    out = [moe_expert(seed, name, e, cfg, dev) for e in experts]
    out = [w[:, rows] if name == "wo" else w[rows] for w in out]
    return torch.stack(out).to(dtype)


def moe_inputs(seed: int, cfg, b: int, s: int, dev, dtype):
    """x and the cotangent r [B, S, D] of a run, from the seed."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed * 7 + s)
    x = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
    r = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
    return x.to(dtype), r.to(dtype)


def moe_rank_layer(seed: int, cfg, mesh, dev, dtype, b: int, s: int):
    """This rank's MoE layer (its weight shards as DTensors that require
    grad) and x, r as DTensors of their spec; the rules."""
    import torch
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import sharding as SH
    from torch.distributed.tensor import DTensor
    rules = SH.AxisRules(batch_axes=("data",), fsdp_axes=("data",))
    di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    e_loc = cfg.n_experts // mesh.size(1)
    d_loc = cfg.d_model // mesh.size(0)
    experts = range(mi * e_loc, (mi + 1) * e_loc)
    rows = slice(di * d_loc, (di + 1) * d_loc)
    shapes = {"router": (cfg.d_model, cfg.n_experts),
              "wg": (cfg.n_experts, cfg.d_model, cfg.moe_d_ff),
              "wi": (cfg.n_experts, cfg.d_model, cfg.moe_d_ff),
              "wo": (cfg.n_experts, cfg.moe_d_ff, cfg.d_model)}
    specs = SH.param_specs(cfg, shapes, mesh, rules)
    # The router comes replicated, as `moe_ffn_a2a` takes it: DTensor would
    # gather an fsdp-sharded one through gloo's functional all-gather,
    # which crashes on a CUDA tensor.
    specs["router"] = (None, None)
    layer = MOE.init_moe(cfg, dtype, device="meta")
    for name in MOE_WEIGHTS:
        local = moe_block(seed, name, cfg, dev, dtype, experts,
                          slice(None) if name == "router" else rows)
        setattr(layer, name, torch.nn.Parameter(DTensor.from_local(
            local, mesh, SH.placements(specs[name], mesh), run_check=False,
            shape=shapes[name], stride=torch.empty(
                shapes[name], device="meta").stride())))
    x, r = moe_inputs(seed, cfg, b, s, dev, dtype)
    xs = ("data", "model", None)
    xd = SH.distribute(x, mesh, xs).requires_grad_(True)
    return layer, xd, SH.distribute(r, mesh, xs), rules


def moe_rank(rank, group, device, seed, tmp):
    """Phase 8 on one rank: 8a's output and gradient blocks, saved to
    `tmp` (rank<r>.npz), and 8b's step seconds, all-to-all bytes and drop
    share; the seconds of each part."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import sharding as SH

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = MESH.make_debug_mesh(*MOE_MESH, device_type=device.type)
    out = {"coords": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}
    # 8a: equality, fp32, nothing dropped
    cfg = dataclasses.replace(get_config(MOE_ARCH), dtype="float32",
                              capacity_factor=MOE_EQUAL["capacity_factor"])
    t0 = time.perf_counter()
    layer, xd, rd, rules = moe_rank_layer(
        seed, cfg, mesh, device, torch.float32, MOE_EQUAL["batch"],
        MOE_EQUAL["seq"])
    sync()
    t1 = time.perf_counter()
    with SH.activate(mesh, rules):
        y = MOE.moe_ffn_a2a(layer, xd, cfg)
    sync()
    t2 = time.perf_counter()
    (y * rd).sum().backward()
    sync()
    t3 = time.perf_counter()
    blocks = {"y": y.to_local().detach(), "x": xd.grad.to_local()}
    for name in MOE_WEIGHTS:
        g = getattr(layer, name).grad
        blocks[name] = g.full_tensor() if name == "router" else g.to_local()
    out["path"] = os.path.join(tmp, f"rank{rank}")
    for k, v in blocks.items():
        np.save(f"{out['path']}.{k}.npy", v.cpu().numpy())
    out["equal_s"] = dict(layer=t1 - t0, forward=t2 - t1, backward=t3 - t2,
                          save=time.perf_counter() - t3)
    del layer, xd, rd, y, g, blocks
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # 8b: timing, bf16, the config's capacity factor
    cfg = get_config(MOE_ARCH)
    b, s = MOE_TIMED["batch"], MOE_TIMED["seq"]
    layer, xd, rd, rules = moe_rank_layer(seed, cfg, mesh, device,
                                          torch.bfloat16, b, s)
    t_loc = xd.to_local().shape[0] * xd.to_local().shape[1]
    cap = int(cfg.capacity_factor * t_loc * cfg.top_k / cfg.n_experts) + 1
    keep = MOE._route(layer.router.to_local(),
                      xd.to_local().reshape(t_loc, -1), cfg, cap)[-1]
    out["drop_share"] = 1.0 - float(keep.float().mean())
    out["a2a_bytes"] = cfg.n_experts * cap * cfg.d_model * 2
    out["cap"] = cap
    times = []
    for rep in range(MOE_TIMED["reps"]):
        for p in (*layer.parameters(), xd):
            p.grad = None
        sync()
        t0 = time.perf_counter()
        with SH.activate(mesh, rules):
            y = MOE.moe_ffn_a2a(layer, xd, cfg)
        (y * rd).sum().backward()
        sync()
        times.append(time.perf_counter() - t0)
        if rep == 0:        # the first step's blocks, for the drop check
            for k, v in (("y", y.to_local().detach()),
                         ("x", xd.grad.to_local())):
                np.save(f"{out['path']}.timed.{k}.npy",
                        v.float().cpu().numpy())
        del y
    out["step_s"] = times
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    return out


def moe_drop_check(args, dev, outs) -> dict:
    """8b's first step against `moe_ffn` on the card, run on each rank's
    own tokens with the same bf16 draws: `moe_ffn` then takes the capacity
    of the rank's token count and drops what the rank drops, so y and x's
    gradient blocks must agree within MOE_BF16_TOL (the expert products
    run at other shapes, and the combine sums in bf16). The max |err| of
    each."""
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as MOE
    cfg = get_config(MOE_ARCH)
    b, s = MOE_TIMED["batch"], MOE_TIMED["seq"]
    layer = MOE.init_moe(cfg, torch.bfloat16, device="meta")
    for name in MOE_WEIGHTS:
        setattr(layer, name, torch.nn.Parameter(moe_block(
            args.seed, name, cfg, dev, torch.bfloat16,
            range(cfg.n_experts), slice(None)), requires_grad=False))
    x, r = moe_inputs(args.seed, cfg, b, s, dev, torch.bfloat16)
    b_loc, s_loc = b // MOE_MESH[0], s // MOE_MESH[1]
    errs = {}
    for o in outs:
        di, mi = o["coords"]
        tok = (slice(di * b_loc, (di + 1) * b_loc),
               slice(mi * s_loc, (mi + 1) * s_loc))
        xb = x[tok].clone().requires_grad_(True)
        y = MOE.moe_ffn(layer, xb, cfg)
        (y * r[tok]).sum().backward()
        for key, ref in (("y", y.detach()), ("x", xb.grad)):
            ref = ref.float()
            got = torch.from_numpy(np.load(
                f"{o['path']}.timed.{key}.npy")).to(dev)
            err = (got - ref).abs()
            assert bool(torch.isfinite(got).all()), \
                f"phase 8b: {key} not finite on rank {di, mi}"
            assert bool((err <= MOE_BF16_TOL["atol"] + MOE_BF16_TOL["rtol"]
                         * ref.abs()).all()), (
                f"phase 8b: {key} on rank {di, mi} against moe_ffn on its "
                f"own tokens: max |err| {float(err.max())}")
            errs[key] = max(errs.get(key, 0.0), float(err.max()))
    del layer, x, r, xb, y
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def moe_phase(args, dev, record):
    """Phase 8: `moe_ffn_a2a` at qwen3-moe's full width on P = 4 gloo
    ranks sharing the card (8a equal to `moe_ffn` run on the card after
    the ranks exit, 8b timed)."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.parallel import ranks
    n = MOE_MESH[0] * MOE_MESH[1]
    rec = record["moe_a2a"] = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_moe_") as tmp:
        outs = ranks.run_ranks(moe_rank, n, tmp, args=(args.seed, tmp),
                               backend="gloo", device=dev.type,
                               timeout=RANK_TIMEOUT)
        rec["ranks_s"] = time.perf_counter() - t0
        # 8a: moe_ffn on the card, all experts, the same draws
        t0 = time.perf_counter()
        cfg = dataclasses.replace(
            get_config(MOE_ARCH), dtype="float32",
            capacity_factor=MOE_EQUAL["capacity_factor"])
        b, s = MOE_EQUAL["batch"], MOE_EQUAL["seq"]
        layer = MOE.init_moe(cfg, torch.float32, device="meta")
        for name in MOE_WEIGHTS:
            setattr(layer, name, torch.nn.Parameter(moe_block(
                args.seed, name, cfg, dev, torch.float32,
                range(cfg.n_experts), slice(None))))
        x, r = moe_inputs(args.seed, cfg, b, s, dev, torch.float32)
        x.requires_grad_(True)
        y = MOE.moe_ffn(layer, x, cfg)
        (y * r).sum().backward()
        want = {"y": y.detach(), "x": x.grad,
                **{k: getattr(layer, k).grad for k in MOE_WEIGHTS}}
        del layer, x, r, y
        e_loc = cfg.n_experts // MOE_MESH[1]
        d_loc = cfg.d_model // MOE_MESH[0]
        b_loc, s_loc = b // MOE_MESH[0], s // MOE_MESH[1]
        errs = {}
        for o in outs:
            di, mi = o["coords"]
            ex = slice(mi * e_loc, (mi + 1) * e_loc)
            rows = slice(di * d_loc, (di + 1) * d_loc)
            tok = (slice(di * b_loc, (di + 1) * b_loc),
                   slice(mi * s_loc, (mi + 1) * s_loc))
            refs = {"y": want["y"][tok], "x": want["x"][tok],
                    "router": want["router"], "wg": want["wg"][ex, rows],
                    "wi": want["wi"][ex, rows],
                    "wo": want["wo"][ex, :, rows]}
            for key, ref in refs.items():
                g = torch.from_numpy(np.load(f"{o['path']}.{key}.npy",
                                             mmap_mode="r")).to(dev)
                tol = MOE_TOL if key in ("y", "x") else MOE_GRAD_TOL
                err = (g - ref).abs()
                assert bool(torch.isfinite(g).all()), \
                    f"phase 8a: {key} not finite on rank {di, mi}"
                assert bool((err <= tol["atol"] + tol["rtol"] *
                             ref.abs()).all()), (
                    f"phase 8a: {key} on rank {di, mi}: max |err| "
                    f"{float(err.max())}")
                errs[key] = max(errs.get(key, 0.0), float(err.max()))
        del want
        gc.collect()
        torch.cuda.empty_cache()
        rec["check_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        drop_errs = moe_drop_check(args, dev, outs)
        rec["drop_check_s"] = time.perf_counter() - t0
    rec["equal"] = dict(max_abs_err=errs, rank_s=[o["equal_s"]
                                                   for o in outs],
                        batch=b, seq=s, dtype="float32",
                        capacity_factor=cfg.capacity_factor)
    log(f"phase 8a: {MOE_ARCH}'s MoE layer (d {cfg.d_model}, "
        f"{cfg.n_experts} experts, top-{cfg.top_k}, moe_d_ff "
        f"{cfg.moe_d_ff}), fp32, batch {b} x {s}, forward and backward "
        f"through moe_ffn_a2a on {n} gloo ranks sharing the card "
        f"({MOE_MESH[0]} x {MOE_MESH[1]} data x model) equal moe_ffn on the "
        f"card: max |err| " + ", ".join(f"{k} {v:.3g}" for k, v in
                                        errs.items())
        + f" (y and x's gradient within {MOE_TOL['rtol']}, the weights' "
        f"within {MOE_GRAD_TOL['rtol']}); rank 0: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in outs[0]["equal_s"].items())
        + f"; ranks {rec['ranks_s']:.1f} s, check {rec['check_s']:.1f} s")
    # 8b: the timed bf16 steps (8a warmed each rank's collectives and
    # products up); a step ends when its slowest rank does
    cfg = get_config(MOE_ARCH)
    steps = [max(o["step_s"][i] for o in outs)
             for i in range(MOE_TIMED["reps"])]
    e_loc = cfg.n_experts // MOE_MESH[1]
    gathered = 3 * e_loc * cfg.d_model * cfg.moe_d_ff * 2
    timed = rec["timed"] = dict(
        batch=MOE_TIMED["batch"], seq=MOE_TIMED["seq"], dtype="bfloat16",
        capacity_factor=cfg.capacity_factor, capacity=outs[0]["cap"],
        step_s=steps, step_s_median=float(np.median(steps)),
        a2a_bytes_per_rank=outs[0]["a2a_bytes"], a2a_per_step=4,
        weight_gather_bytes_per_rank=gathered,
        drop_share=[o["drop_share"] for o in outs],
        max_abs_err_vs_local_moe_ffn=drop_errs,
        peak_bytes=[o["peak_bytes"] for o in outs], card=record["card"],
        note="gloo ranks sharing one card: the all-to-alls and the "
             "host-staged weight all-gathers go through the host")
    log(f"phase 8b: the same layer in bf16 at capacity factor "
        f"{cfg.capacity_factor} (capacity {timed['capacity']} a rank), "
        f"batch {timed['batch']} x {timed['seq']}: forward and backward "
        f"median {timed['step_s_median']:.3f} s over {len(steps)} steps "
        f"({', '.join(f'{t:.3f}' for t in steps)}); each all-to-all "
        f"{timed['a2a_bytes_per_rank']} B a rank (4 a step), weights "
        f"gathered {gathered} B a rank; capacity drops "
        + ", ".join(f"{d:.4f}" for d in timed["drop_share"])
        + " of the dispatch by rank; the first step equal to moe_ffn on "
        f"each rank's own tokens (its capacity, its drops): max |err| y "
        f"{drop_errs['y']:.3g}, x's gradient {drop_errs['x']:.3g} (within "
        f"{MOE_BF16_TOL['rtol']}); peak "
        f"{max(timed['peak_bytes']) / 2**30:.2f} GiB a rank "
        f"[{record['card']}; {n} gloo ranks on one card, a record, not a "
        f"claim]")


def seq_model(seed: int, dev):
    """Phase 9's config (fp32, SEQ_RUN's layers) and its model on `dev`,
    drawn from `seed` there (the same weights in every process)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as MODEL
    cfg = dataclasses.replace(get_config(SEQ_ARCH), dtype="float32",
                              n_layers=SEQ_RUN["layers"])
    g = torch.Generator(device=dev).manual_seed(seed)
    return cfg, MODEL.init_params(cfg, g, device=dev)


def seq_batch(seed: int, cfg, dev) -> dict:
    """Phase 9's tokens and labels [B, S] (int32), from `seed`."""
    import torch
    from repro_torch.data import synthetic as SYN
    b = SYN.batch_for_config(cfg, 0, SEQ_RUN["batch"], SEQ_RUN["seq"], seed)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def seq_steps(cfg, model, batch, dev, ctx=None) -> dict:
    """The prefill's last logits and one train step's loss and gradients
    (captured where `train_step` hands them to `apply_updates`), with
    their seconds, under `ctx` (the mesh's, or none)."""
    import contextlib
    import torch
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.serve_step import make_prefill_step
    ctx = ctx or contextlib.nullcontext
    prompt = {k: v for k, v in batch.items() if k != "labels"}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    sync()
    t0 = time.perf_counter()
    with ctx():
        logits, _ = make_prefill_step(cfg, ctx_len=SEQ_RUN["seq"])(
            model, prompt)
    sync()
    t1 = time.perf_counter()
    grads = {}
    real = TS.apply_updates

    def capture(params, g, state, ocfg):
        grads.update(g)
        return real(params, g, state, ocfg)
    TS.apply_updates = capture
    try:
        ocfg = OptConfig()
        opt = init_opt_state(model, ocfg)
        sync()
        t2 = time.perf_counter()
        with ctx():
            _, _, metrics = TS.make_train_step(cfg, ocfg)(model, opt, batch)
        sync()
        t3 = time.perf_counter()
    finally:
        TS.apply_updates = real
    return dict(logits=logits, loss=metrics["loss"], grads=grads,
                prefill_s=t1 - t0, step_s=t3 - t2)


def seq_rank(rank, group, device, seed, tmp):
    """Phase 9 on one rank: the sharded prefill and train step; rank 0
    saves the logits and loss, every rank its blocks of the gradients
    (with their specs), to `tmp`."""
    import torch
    from torch.distributed.tensor import Replicate
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel import sharding as SH
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = MESH.make_debug_mesh(*SEQ_MESH, device_type=device.type)
    rules = SH.AxisRules()
    cfg, model = seq_model(seed, device)
    specs = SH.param_specs(cfg, {n: tuple(p.shape) for n, p in
                                 model.named_parameters()}, mesh, rules)
    model = DR.shard_model(model, cfg, mesh, rules)
    batch = DR.shard_batch(seq_batch(seed, cfg, device), mesh, rules)
    moved = {"seq_gathered": 0, "seq_scattered": 0, "weights_gathered": 0}
    real = {k: getattr(C, k) for k in ("gather_seq", "reduce_scatter_seq")}

    def gather(t, dim, group):
        out = real["gather_seq"](t, dim, group)
        key = "seq_gathered" if t.ndim >= 3 else "weights_gathered"
        moved[key] += out.numel() * out.element_size()
        return out

    def scatter(t, dim, group):
        moved["seq_scattered"] += t.numel() * t.element_size()
        return real["reduce_scatter_seq"](t, dim, group)
    C.gather_seq, C.reduce_scatter_seq = gather, scatter
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    try:
        res = seq_steps(cfg, model, batch, device,
                        lambda: DR.on_mesh(mesh, rules))
    finally:
        C.gather_seq = real["gather_seq"]
        C.reduce_scatter_seq = real["reduce_scatter_seq"]
    compressed = seq_compressed_mean(
        {name: g.to_local().detach() for name, g in res["grads"].items()},
        group, seed, device)
    path = os.path.join(tmp, f"seq{rank}")
    if rank == 0:
        np.save(f"{path}.logits.npy", res["logits"].to_local().cpu().numpy())
    names = []
    for i, (name, g) in enumerate(res["grads"].items()):
        # a gradient left a partial sum (a replicated weight's) is summed
        # over the ranks here (an all-reduce); shards stay as they are
        g = g.redistribute(g.device_mesh, [Replicate() if p.is_partial()
                                           else p for p in g.placements])
        np.save(f"{path}.g{i}.npy", g.to_local().detach().cpu().numpy())
        names.append((name, specs[name]))
    return dict(path=path, grads=names, model_rank=mesh.get_local_rank(
        "model"), loss=float(res["loss"].to_local()),
        prefill_s=res["prefill_s"], step_s=res["step_s"], moved=moved,
        peak_bytes=torch.cuda.max_memory_allocated(device) if on_card else 0,
        compressed=compressed)


def seq_compressed_mean(leaves: dict, group, seed: int, device) -> dict:
    """Phase 9's int8 gradient compression on one rank: `compressed_psum`
    of this rank's gradient blocks over the group, from `seed`, held
    against the exact fp32 mean (a plain SUM all-reduce of the same
    leaves): every element within its leaf's shared scale, each leaf's
    mean signed error within SEQ_COMPRESS_BIAS * scale / sqrt(numel).
    Raises on a miss; returns the seconds, the payload bytes and the
    worst |error| / scale."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel import collectives as C

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    n = dist.get_world_size(group)
    sync()
    t0 = time.perf_counter()
    got = C.compressed_psum(leaves, group, seed=seed)
    sync()
    t1 = time.perf_counter()
    exact = {}
    for name, leaf in leaves.items():
        s = leaf.to(torch.float32).clone()
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        exact[name] = s / n
    sync()
    t2 = time.perf_counter()
    worst, worst_bias = 0.0, 0.0
    for name, leaf in leaves.items():
        scale = C.int8_scale(leaf)
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
        scale = float(scale)
        err = got[name].to(torch.float32) - exact[name]
        e = float(err.abs().max())
        bias = abs(float(err.double().mean()))
        assert e <= scale * (1 + SEQ_COMPRESS_SLACK), (
            f"phase 9: compressed mean of {name}: max |err| {e} over its "
            f"shared scale {scale}")
        assert bias <= SEQ_COMPRESS_BIAS * scale / math.sqrt(leaf.numel()), (
            f"phase 9: compressed mean of {name}: mean signed error {bias} "
            f"(scale {scale}, {leaf.numel()} elements)")
        worst = max(worst, e / scale)
        worst_bias = max(worst_bias,
                         bias * math.sqrt(leaf.numel()) / scale)
    numel = sum(leaf.numel() for leaf in leaves.values())
    return dict(seconds=t1 - t0, fp32_allreduce_s=t2 - t1,
                leaves=len(leaves), elements=numel,
                int32_bytes=4 * numel, scale_bytes=4 * len(leaves),
                max_err_over_scale=worst,
                max_bias_sqrt_numel_over_scale=worst_bias)


def seq_block(t, spec, model_rank: int, n: int):
    """The block of the whole tensor `t` that `spec` gives the rank at
    `model_rank` of a `model` axis of n (the `data` axis is 1)."""
    for dim, ax in enumerate(spec):
        if ax == "model" or (isinstance(ax, tuple) and "model" in ax):
            t = t.chunk(n, dim)[model_rank]
    return t


def seq_phase(args, dev, record):
    """Phase 9: hymba-1.5b's sequence-parallel prefill and train step on
    gloo ranks sharing the card, held against the unsharded steps run on
    the card after the ranks exit."""
    import tempfile
    import torch
    from repro_torch.parallel import ranks
    n = SEQ_MESH[0] * SEQ_MESH[1]
    rec = record["seq_parallel"] = dict(mesh=list(SEQ_MESH), **SEQ_RUN,
                                        card=record["card"])
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as tmp:
            outs = ranks.run_ranks(seq_rank, n, tmp, args=(args.seed, tmp),
                                   backend="gloo", device=dev.type,
                                   timeout=RANK_TIMEOUT)
            rec["ranks_s"] = time.perf_counter() - t0
            t1 = time.perf_counter()
            cfg, model = seq_model(args.seed, dev)
            want = seq_steps(cfg, model, seq_batch(args.seed, cfg, dev), dev)
            logits = torch.from_numpy(np.load(
                f"{outs[0]['path']}.logits.npy")).to(dev)
            err = (logits - want["logits"]).abs()
            assert bool(torch.isfinite(logits).all()), \
                "phase 9: prefill logits not finite"
            assert bool((err <= SEQ_LOGITS_TOL["atol"] + SEQ_LOGITS_TOL[
                "rtol"] * want["logits"].abs()).all()), (
                f"phase 9: prefill logits: max |err| {float(err.max())}")
            rec["logits_max_abs_err"] = float(err.max())
            loss = float(want["loss"])
            rec["loss"], rec["loss_unsharded"] = outs[0]["loss"], loss
            assert abs(outs[0]["loss"] - loss) <= SEQ_LOSS_RTOL * abs(loss), \
                f"phase 9: loss {outs[0]['loss']} against {loss}"
            worst = 0.0
            for o in outs:
                assert len(o["grads"]) == len(want["grads"]), \
                    "phase 9: a gradient is missing"
                for i, (name, spec) in enumerate(o["grads"]):
                    ref = want["grads"][name]
                    top = float(ref.abs().max())
                    got = torch.from_numpy(np.load(
                        f"{o['path']}.g{i}.npy")).to(dev)
                    blk = seq_block(ref, spec, o["model_rank"], n)
                    assert got.shape == blk.shape, (name, got.shape)
                    e = float((got - blk).abs().max())
                    assert np.isfinite(e) and e <= SEQ_GRAD_TOL * top, (
                        f"phase 9: {name}'s gradient on rank "
                        f"{o['model_rank']}: max |err| {e} of max |grad| "
                        f"{top}")
                    worst = max(worst, e / top if top else 0.0)
            rec["grad_max_rel_err"] = worst
            rec["unsharded"] = dict(prefill_s=want["prefill_s"],
                                    step_s=want["step_s"])
            del model, want
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            rec["check_s"] = time.perf_counter() - t1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    rec["prefill_s"] = max(o["prefill_s"] for o in outs)
    rec["step_s"] = max(o["step_s"] for o in outs)
    rec["moved_bytes_per_rank"] = outs[0]["moved"]
    rec["peak_bytes"] = [o["peak_bytes"] for o in outs]
    mv = outs[0]["moved"]
    log(f"phase 9: {cfg.name} sequence parallel ({cfg.n_layers} of 32 "
        f"layers at every published width: d {cfg.d_model}, {cfg.n_heads} "
        f"query and {cfg.n_kv} KV heads, vocab {cfg.vocab}, fp32), batch "
        f"{SEQ_RUN['batch']} x {SEQ_RUN['seq']} on {n} gloo ranks sharing "
        f"the card ({SEQ_MESH[0]} x {SEQ_MESH[1]} data x model): prefill "
        f"{rec['prefill_s']:.3f} s (unsharded "
        f"{rec['unsharded']['prefill_s']:.3f} s), train step "
        f"{rec['step_s']:.3f} s (unsharded {rec['unsharded']['step_s']:.3f} "
        f"s); the last logits within "
        f"{rec['logits_max_abs_err']:.3g} of the unsharded prefill's, loss "
        f"{rec['loss']:.6f} against {rec['loss_unsharded']:.6f}, every "
        f"gradient within {rec['grad_max_rel_err']:.3g} of its max |grad|; "
        f"a rank all-gathers {mv['seq_gathered']} B of sequence and "
        f"reduce-scatters {mv['seq_scattered']} B in forward (prefill and "
        f"step; backward mirrors them), gathers {mv['weights_gathered']} B "
        f"of weights; peak "
        + ", ".join(f"{b / 2**30:.2f}" for b in rec["peak_bytes"])
        + f" GiB by rank [{record['card']}; {n} gloo ranks on one card, a "
        f"record, not a claim]; ranks {rec['ranks_s']:.1f} s, check "
        f"{rec['check_s']:.1f} s")
    cm = rec["compressed_mean"] = dict(
        outs[0]["compressed"],
        seconds=max(o["compressed"]["seconds"] for o in outs),
        fp32_allreduce_s=max(o["compressed"]["fp32_allreduce_s"]
                             for o in outs),
        max_err_over_scale=max(o["compressed"]["max_err_over_scale"]
                               for o in outs),
        max_bias_sqrt_numel_over_scale=max(
            o["compressed"]["max_bias_sqrt_numel_over_scale"] for o in outs))
    log(f"phase 9: int8 compressed gradient mean (compressed_psum, seed "
        f"{args.seed}) of each rank's {cm['leaves']} gradient blocks "
        f"({cm['elements']} elements) over {n} gloo ranks: "
        f"{cm['seconds']:.3f} s (the plain fp32 SUM all-reduce of the same "
        f"leaves {cm['fp32_allreduce_s']:.3f} s); a rank sends "
        f"{cm['int32_bytes']} B of int32 codes (the fp32 payload's bytes) "
        f"and {cm['scale_bytes']} B of scales; worst |err| / scale "
        f"{cm['max_err_over_scale']:.4f} (bound 1), worst mean signed error "
        f"x sqrt(numel) / scale {cm['max_bias_sqrt_numel_over_scale']:.4f} "
        f"(bound {SEQ_COMPRESS_BIAS:g}) [{record['card']}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--out", default=None,
                    help="also write the full record as JSON to this file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(REPO, "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    record = dict(seed=args.seed, scale=args.scale)
    # phase 4's graph, generated on the host while phases 1-3b run
    import concurrent.futures
    import multiprocessing
    import tempfile
    gdir = tempfile.TemporaryDirectory(prefix="chip_smoke_graph_")
    graph_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    graph_future = graph_pool.submit(generate_graph, args.scale, args.seed,
                                     os.path.join(gdir.name, "full.npz"))

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    record["card"] = smi
    record["torch"] = torch.__version__
    build_s = _build.build_all()
    record["build_s"] = build_s
    log(f"phase 1: built {len(_build.SOURCES)} kernel sources in "
        f"{build_s:.3f} s ({_build.BUILD_DIR})")

    # 1c. the kernel contracts against the compiler, the analysis gate
    phase_contracts(dev, record)

    # 2. kernels against their plain versions, random inputs
    errs = {n: 0 for n in BFS_KERNELS}
    t0 = time.perf_counter()
    n_cases, n_ff = phase_kernels(
        rng, np.random.default_rng([args.seed, 1]),
        np.random.default_rng([args.seed, 5]), dev, errs)
    log(f"phase 2: {n_cases} random cases per kernel, {len(HUB_CASES)} more "
        f"wide ones per hub kernel and push, {len(SKEWED_CASES)} skewed ones "
        f"per pull kernel and push, the push with keep off and on and on "
        f"{CONTENTION[1]} rows into {CONTENTION[4]} vertices, {n_ff} more "
        f"per packing kernel with the bitmap and without (B up to 40, V not "
        f"a multiple of 32, rows starting one byte in, all flags set at V = "
        f"{FRONTIER_WIDE}, nf/mf at the int32 limit and past it), bitwise "
        f"equal ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    n_dec, dec_err, cap_gap, lse_err = phase_decode_kernel(
        np.random.default_rng([args.seed, 2]), dev)
    record["decode_cases"] = dict(calls=n_dec, max_abs_err=dec_err,
                                  cap_gap=cap_gap, lse_max_abs_err=lse_err,
                                  s=time.perf_counter() - t0)
    log(f"phase 2: decode_attention: {n_dec} random calls within tolerance "
        f"(max |kernel - plain| {dec_err:.3g}; the lse within "
        f"{lse_err:.3g} of the plain one), exact zeros and an lse of -inf "
        f"at cache_len 0, soft cap moves every scaled case by >= "
        f"{cap_gap:.3g} ({time.perf_counter() - t0:.1f} s)")

    # 2s. the sequence-split decode at gemma2-9b's long_500k width
    t0 = time.perf_counter()
    seq_split = seq_split_phase(args, dev, record)
    gc.collect()
    torch.cuda.empty_cache()
    seq_split["s"] = time.perf_counter() - t0
    log(f"phase 2s: {seq_split['s']:.1f} s")

    # 3. whole-search parity, GPU against CPU
    t0 = time.perf_counter()
    g16 = phase_parity(PARITY_SCALE, rng)
    record["parity_s"] = time.perf_counter() - t0
    log(f"phase 3: scale-{PARITY_SCALE} searches equal on cuda and cpu "
        f"({record['parity_s']:.1f} s)")

    # 3b. the serving path: smoke configs on the card against the CPU
    t0 = time.perf_counter()
    worst = phase_serve_parity(args.seed, dev)
    log(f"phase 3b: {', '.join(SERVE_PARITY)} smoke (fp32) serve alike on "
        f"cuda and cpu: prefill logits within {worst:.2g}, 9 greedy tokens "
        f"equal ({time.perf_counter() - t0:.1f} s)")

    # 4, 2b, 5: the BFS paths at full size (their tensors are freed on
    # return, before the ranks and the serving path need the card's memory)
    entries, g22 = bfs_paths(args, rng, dev, record, errs,
                             (graph_future, os.path.join(gdir.name,
                                                         "full.npz")))
    graph_pool.shutdown()
    gc.collect()
    torch.cuda.empty_cache()

    with gdir:
        # 5s. the partitioned BSP search on gloo ranks sharing the card
        path22 = os.path.join(gdir.name, "full.npz")
        t0 = time.perf_counter()
        sharded_phase(args, g16, g22, rng, record, entries, path22)
        record["sharded_s"] = time.perf_counter() - t0
        log(f"phase 5s: {record['sharded_s']:.1f} s")

        # 5v. the BFS server on the card
        server_phase(args, g16, g22, rng, record, dev, entries)
        gc.collect()
        torch.cuda.empty_cache()

        # 5r. the artifact cache and pre-warm across restarts
        restart_phase(args, g16, g22, rng, record, dev, entries, path22)
    del g16, g22
    gc.collect()
    torch.cuda.empty_cache()

    # 6. the serving path at full width
    entries.append(serve_phase(args, dev, record, dec_err))
    entries[-1]["seq_split"] = {k: seq_split[k] for k in (
        "whole_ms", "split_ms", "bound_ms", "max_abs_err")}
    gc.collect()
    torch.cuda.empty_cache()

    # 6b. the moe, ssm, hybrid and encdec families and the vision frontend
    # at full width
    family_phase(args, dev, record, entries[-1])
    gc.collect()
    torch.cuda.empty_cache()

    # 7. training: parity with the CPU, stablelm-3b at full width, restart
    t0 = time.perf_counter()
    train_parity_phase(args, dev, record)
    train_full_phase(args, dev, record)
    gc.collect()
    torch.cuda.empty_cache()
    train_restart_phase(args, dev, record)
    record["train_s"] = time.perf_counter() - t0
    log(f"phase 7: {record['train_s']:.1f} s")

    # 8. qwen3-moe's expert-parallel MoE layer on gloo ranks sharing the
    # card
    t0 = time.perf_counter()
    moe_phase(args, dev, record)
    record["moe_s"] = time.perf_counter() - t0
    log(f"phase 8: {record['moe_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # 9. hymba-1.5b's sequence-parallel prefill and train step on gloo
    # ranks sharing the card
    t0 = time.perf_counter()
    seq_phase(args, dev, record)
    record["seq_s"] = time.perf_counter() - t0
    log(f"phase 9: {record['seq_s']:.1f} s")
    record["total_s"] = time.perf_counter() - t_start
    log(f"total {record['total_s']:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    # 10. the kernels line, then the result line
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
