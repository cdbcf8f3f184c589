"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652; hf]."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense", n_layers=48, d_model=4096,
    n_heads=32, n_kv=4, d_ff=11008, vocab=64000,
    source="[arXiv:2403.04652; hf]")

SMOKE = dataclasses.replace(
    CONFIG, name="yi-9b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
    d_ff=128, vocab=256)
