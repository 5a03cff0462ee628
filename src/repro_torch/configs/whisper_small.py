"""whisper-small — enc-dec audio backbone [arXiv:2212.04356; unverified].

12L (12 enc + 12 dec) d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865.
Conv frontend is a STUB: input_specs provides precomputed frame embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-small", family="encdec",
    n_layers=12, n_encoder_layers=12,
    d_model=768, n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072,
    vocab_size=51865, norm="ln", act="gelu", pos="learned",
    n_audio_frames=1500, microbatch=2, optimizer="adamw",
)

SMOKE = ModelConfig(
    arch="whisper-small-smoke", family="encdec",
    n_layers=2, n_encoder_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256, norm="ln", act="gelu", pos="learned",
    n_audio_frames=24, remat=False,
)
