"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596;
hf]. Transformer backbone only; the audio frontend is a stub: the prompt
supplies precomputed frame embeddings [B, S, d_model] for the encoder
(`enc_embeds`) beside the decoder's token ids."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=12,
    n_enc_layers=12, d_model=1024, n_heads=16, n_kv=16, d_ff=4096,
    vocab=256206, frontend="audio",
    source="[arXiv:2308.11596; hf]")

SMOKE = dataclasses.replace(
    CONFIG, name="seamless-m4t-smoke", n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256)
