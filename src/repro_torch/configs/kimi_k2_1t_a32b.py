"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2; unverified paper-table config].

Adafactor optimizer: fp32 Adam states at 1T params exceed per-chip HBM
on 512 chips even fully sharded (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, expert_d_ff=2048, n_shared_experts=1,
    moe_dispatch="a2a", rope_theta=5e4, fsdp=True, grad_acc_dtype="bfloat16", microbatch=8, optimizer="adafactor", logit_chunk=1024,
)

SMOKE = ModelConfig(
    arch="kimi-k2-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256,
    n_experts=8, top_k=2, expert_d_ff=64, n_shared_experts=1, remat=False,
)
