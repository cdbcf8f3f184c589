"""gemma2-9b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]. Layer 2i attends within a sliding window (a ring
cache of the window), layer 2i+1 globally."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense", n_layers=42, d_model=3584,
    n_heads=16, n_kv=8, d_head=256, d_ff=14336, vocab=256000,
    sliding_window=4096, alt_local_global=True,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    sub_quadratic=True,
    source="[arXiv:2408.00118; hf]")

SMOKE = dataclasses.replace(
    CONFIG, name="gemma2-9b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv=2, d_head=16, d_ff=128, vocab=256, sliding_window=16)
