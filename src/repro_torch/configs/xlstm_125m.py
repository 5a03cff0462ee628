"""xlstm-125m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

d_ff=0: xLSTM blocks carry their own up/down projections
(proj_factor=2).  Every 4th block is sLSTM, the rest mLSTM.
Attention-free => runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304, slstm_every=4, xlstm_proj_factor=2.0,
    ssm_chunk=256, microbatch=2, optimizer="adamw",
)

SMOKE = ModelConfig(
    arch="xlstm-125m-smoke", family="ssm",
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
    d_ff=0, vocab_size=256, slstm_every=2, xlstm_proj_factor=2.0,
    ssm_chunk=16, remat=False,
)
