"""granite-3-2b — dense GQA [hf:ibm-granite/granite-3.0-2b-base; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155, rope_theta=1e4, microbatch=8, optimizer="adamw",
)

SMOKE = ModelConfig(
    arch="granite-3-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab_size=256, remat=False,
)
