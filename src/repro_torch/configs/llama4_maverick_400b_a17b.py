"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]. Alternating dense/MoE
FFN layers (the published interleave pattern) reproduce the 400B-total /
17B-active split with the brief's d_ff=8192."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv=8, d_head=128, d_ff=8192,
    vocab=202048, n_experts=128, top_k=1, moe_d_ff=8192,
    alt_dense_moe=True,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]")

SMOKE = dataclasses.replace(
    CONFIG, name="llama4-maverick-smoke", n_layers=2, d_model=64,
    n_heads=4, n_kv=2, d_head=16, d_ff=128, vocab=256, n_experts=8,
    top_k=1, moe_d_ff=128)
