"""The LLM serving path's models: layers, the dense, moe, ssm, hybrid and
encdec families (`model`, `moe`, `mamba2`), decode."""
