"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676; hf].
Sliding-window attention + SSM state; runs long_500k (windowed KV + O(1)
SSM state)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv=5, d_head=64, d_ff=5504, vocab=32001,
    ssm_state=16, ssm_head_dim=50, ssm_expand=2, hybrid=True,
    sliding_window=1024, sub_quadratic=True,
    source="[arXiv:2411.13676; hf]")

SMOKE = dataclasses.replace(
    CONFIG, name="hymba-1.5b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv=2, d_head=16, d_ff=128, vocab=256, ssm_state=8, ssm_head_dim=16,
    sliding_window=16)
