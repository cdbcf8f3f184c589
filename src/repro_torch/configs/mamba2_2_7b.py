"""mamba2-2.7b [ssm] — SSD (state-space duality) [arXiv:2405.21060;
unverified]. Attention-free; long_500k decode is O(1)/token on a fixed
recurrent state."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    n_heads=0, n_kv=0, d_ff=0, vocab=50280, ssm_state=128,
    ssm_head_dim=64, ssm_expand=2, conv_width=4, sub_quadratic=True,
    source="[arXiv:2405.21060; unverified]")

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-2.7b-smoke", n_layers=2, d_model=64, ssm_state=16,
    ssm_head_dim=16, vocab=256)
