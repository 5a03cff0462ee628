"""Unified model configuration covering every assigned architecture family.

Copy of ``src/repro/models/config.py``.  One dataclass; family-specific
fields are ignored by other families.  Derived fields handle the fixed
16-way "model" mesh axis:
  * padded_vocab — vocab rounded up to a multiple of 128 (also covers
    the 16-way mesh divisibility).
  * padded_heads — query heads rounded up to a multiple of 16 where
    needed (whisper 12→16, qwen2-7b 28→32, phi4 24→32).  The padded
    heads are real heads of the model: ``init_params`` draws their
    ``wq`` columns and ``wo`` rows like every other weight, as the
    reference's does (its docstring's "zero rows" is not what its code
    does; ROADMAP C6).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOCAB_ALIGN = 128
HEAD_ALIGN = 16  # production model-axis size


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # attention / block details
    qkv_bias: bool = False
    norm: str = "rms"                # rms | ln
    act: str = "swiglu"              # swiglu | gelu
    pos: str = "rope"                # rope | learned | sinusoidal
    rope_theta: float = 1e6
    attn_impl: str = "chunked"       # chunked | flash | naive
    attn_chunk: int = 512

    # moe
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_dispatch: str = "replicated"   # replicated (1,3J-style) | a2a (2,3J-style)

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # xlstm
    slstm_every: int = 0             # 0 = no sLSTM blocks
    xlstm_proj_factor: float = 2.0

    # hybrid (zamba): shared attention block every k mamba layers
    shared_attn_every: int = 0

    # enc-dec (whisper)
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500

    # vlm
    cross_attn_every: int = 0
    n_image_tokens: int = 1600

    # training
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots (save matmul/collective results)
    logit_chunk: int = 0             # 0 = unchunked loss
    optimizer: str = "adamw"
    microbatch: int = 1              # gradient-accumulation splits per step
    fsdp: bool = False               # 2-D weight sharding (embed dim -> data)
    seq_shard_activations: bool = False  # Megatron-SP: residual stream sharded
                                         # over (seq x model) between blocks
    grad_acc_dtype: str = "float32"  # microbatch grad accumulator dtype

    # -- derived ------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, VOCAB_ALIGN)

    @property
    def padded_heads(self) -> int:
        if self.n_heads % HEAD_ALIGN == 0 or self.n_heads < HEAD_ALIGN:
            return self.n_heads
        return _round_up(self.n_heads, HEAD_ALIGN)

    @property
    def q_dim(self) -> int:
        return self.padded_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing -> runs the long_500k shape."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_params_analytic(self) -> float:
        """Approximate parameter count (for 6·N·D roofline bookkeeping)."""
        d, L = self.d_model, self.n_layers
        emb = self.padded_vocab * d
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "moe" and self.n_experts:
            ffn = self.n_experts * 3 * d * self.expert_d_ff
            ffn += self.n_shared_experts * 3 * d * self.expert_d_ff
        elif self.act == "swiglu":
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.family == "ssm":
            d_in = d * self.ssm_expand
            attn = 0
            ffn = 2 * d * d_in + d_in * d  # in/out projections (approx)
        per_layer = attn + ffn + 2 * d
        total = emb * 2 + L * per_layer
        if self.family == "encdec":
            total += self.n_encoder_layers * per_layer
        return float(total)

    @property
    def n_active_params_analytic(self) -> float:
        """Active params per token (MoE: only top-k experts count)."""
        if self.family != "moe" or not self.n_experts:
            return self.n_params_analytic
        d, L = self.d_model, self.n_layers
        emb = self.padded_vocab * d
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ffn = (self.top_k + self.n_shared_experts) * 3 * d * self.expert_d_ff
        return float(emb * 2 + L * (attn + ffn + 2 * d))


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    def applicable(self, cfg: ModelConfig) -> Tuple[bool, str]:
        if self.name == "long_500k" and not cfg.supports_long_context:
            return False, ("pure full-attention arch: O(S²) prefill at 524288 "
                           "is infeasible — skipped per assignment note")
        return True, ""


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
