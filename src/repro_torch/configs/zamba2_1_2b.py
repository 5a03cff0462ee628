"""zamba2-1.2b — Mamba2 blocks + one shared attention block applied
every 6 layers [arXiv:2411.15242; hf].  ssm_state=64.  Hybrid =>
runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=128,
    shared_attn_every=6, microbatch=8, optimizer="adamw",
)

SMOKE = ModelConfig(
    arch="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256, ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_conv=4,
    ssm_chunk=16, shared_attn_every=2, remat=False,
)
