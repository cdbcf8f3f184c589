"""yi-34b [dense] — llama-arch GQA [arXiv:2403.04652; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv=8, d_ff=20480, vocab=64000,
    source="[arXiv:2403.04652; hf]")

SMOKE = dataclasses.replace(
    CONFIG, name="yi-34b-smoke", n_layers=2, d_model=64, n_heads=8, n_kv=2,
    d_ff=128, vocab=256)
