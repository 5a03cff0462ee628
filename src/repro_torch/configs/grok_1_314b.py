"""grok-1-314b — 8-expert top-2 MoE [hf:xai-org/grok-1; unverified].

8 experts < 16 model shards: the sharding planner falls back to
TP-sharding the expert ffn dim (DESIGN.md §5).  Adafactor (314B params).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, top_k=2, expert_d_ff=32768,
    rope_theta=1e4, fsdp=True, grad_acc_dtype="bfloat16", microbatch=8, optimizer="adafactor", logit_chunk=1024,
)

SMOKE = ModelConfig(
    arch="grok-1-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    n_experts=4, top_k=2, expert_d_ff=128, remat=False,
)
