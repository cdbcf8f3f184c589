"""Model configuration dataclass and registry (the JAX package's
`configs/base.py`, field for field).

`ARCHS` lists every architecture the JAX package registers, and the port
has a config for each (the dense, moe, ssm, hybrid and encdec families,
the vision and audio frontend stubs). An unknown name raises `KeyError`.
"""
from __future__ import annotations

import dataclasses
import importlib


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    sliding_window: int = 0        # >0: local layers use this window
    alt_local_global: bool = False  # gemma2-style local/global alternation
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    alt_dense_moe: bool = False    # llama4-style dense/MoE alternation
    # ssm (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssd_chunk: int = 256
    # hybrid (hymba): parallel attention + SSM heads in every layer
    hybrid: bool = False
    # encoder-decoder
    n_enc_layers: int = 0
    # modality frontend stub: "none" | "vision" | "audio"
    frontend: str = "none"
    tie_embeddings: bool = True
    # numerics
    dtype: str = "bfloat16"
    # shape-cell support
    sub_quadratic: bool = False    # eligible for long_500k
    source: str = ""               # provenance note [source; tier]

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:      # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0


# Registry ------------------------------------------------------------------

ARCHS = (
    "stablelm_3b", "yi_9b", "yi_34b", "gemma2_9b", "internvl2_1b",
    "mamba2_2_7b", "qwen3_moe_235b_a22b", "llama4_maverick_400b_a17b",
    "hymba_1_5b", "seamless_m4t_medium",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}


def _module(name: str):
    key = _ALIASES.get(name, name).replace("-", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE
