"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B;
hf]. Every layer MoE (d_ff=1536 per expert)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv=4, d_head=128, d_ff=0, vocab=151936,
    n_experts=128, top_k=8, moe_d_ff=1536,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]")

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv=2, d_head=16, vocab=256, n_experts=8, top_k=2, moe_d_ff=32)
