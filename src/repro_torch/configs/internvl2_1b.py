"""internvl2-1b [vlm] — InternViT + InternLM2 backbone
[arXiv:2404.16821; hf]. The vision frontend is a stub: the prompt
supplies precomputed patch embeddings [B, S, d_model] (`embeds`) in place
of token ids; decoding then feeds tokens."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="dense", n_layers=24, d_model=896,
    n_heads=14, n_kv=2, d_ff=4864, vocab=151655, frontend="vision",
    source="[arXiv:2404.16821; hf]")

SMOKE = dataclasses.replace(
    CONFIG, name="internvl2-1b-smoke", n_layers=2, d_model=56, n_heads=2,
    n_kv=1, d_ff=128, vocab=256)
