"""llama-3.2-vision-11b — decoder LM with gated cross-attention image
layers every 5th layer [hf:meta-llama/Llama-3.2-11B-Vision; unverified].
Patch-embedding frontend is a STUB (input_specs provides embeddings).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, cross_attn_every=5, n_image_tokens=1600,
    rope_theta=5e5, microbatch=8, optimizer="adamw",
)

SMOKE = ModelConfig(
    arch="llama-vision-smoke", family="vlm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=256, cross_attn_every=2, n_image_tokens=8, remat=False,
)
