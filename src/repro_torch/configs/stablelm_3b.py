"""stablelm-3b [dense] — [hf:stabilityai/stablelm-2-1_6b; unverified]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv=32, d_ff=6912, vocab=50304,
    source="[hf:stabilityai/stablelm-2-1_6b; unverified]")

SMOKE = dataclasses.replace(
    CONFIG, name="stablelm-3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv=4, d_ff=128, vocab=256)
