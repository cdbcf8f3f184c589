"""The LLM serving path's models: layers, the dense, moe, ssm and hybrid
families (`model`, `moe`, `mamba2`), decode."""
