"""State-space sequence mixing: Mamba2 (SSD) and the shared chunked scan.

Port of ``src/repro/models/ssm.py``.  The chunked-parallel SSD form
(Dao & Gu 2024) is implemented once and reused by the Mamba2 blocks
(zamba2) and xLSTM's mLSTM cells (the same linear recurrence:
state_t = exp(a_t)·state_{t-1} + b_t⊗u_t, y_t = c_t·state_t).

Within a chunk the terms are dense (L×L) products; across chunks the
reference's ``lax.scan`` is a Python loop carrying the (B, G, Hg, P, N)
state, O(S/L) steps.  The arithmetic is the reference's, term for term:
``exp`` of the within-chunk decays before the causal mask zeroes the
upper triangle.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import Planner
from .config import ModelConfig
from .params import ParamDef


def ssd_chunked(u: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear recurrence  st_t = exp(a_t)·st_{t-1} + b_t ⊗ u_t,
                          y_t  = c_t · st_t.

    u: (B,S,G,Hg,P) payload; a: (B,S,G,Hg) log-decay;
    b, c: (B,S,G,N) (G groups share b/c across Hg heads-per-group).
    Returns (y (B,S,G,Hg,P) in u's dtype, final_state (B,G,Hg,P,N)
    float32).
    """
    Bsz, S, G, Hg, P = u.shape
    N = b.shape[-1]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        u = F.pad(u, (0, 0, 0, 0, 0, 0, 0, pad))
        a, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (a, b, c))
    nc = (S + pad) // L

    uf = u.float().reshape(Bsz, nc, L, G, Hg, P)
    af = a.float().reshape(Bsz, nc, L, G, Hg)
    bf = b.float().reshape(Bsz, nc, L, G, N)
    cf = c.float().reshape(Bsz, nc, L, G, N)

    cum = torch.cumsum(af, dim=2)                     # (B,nc,L,G,Hg)
    # intra-chunk: y_i += sum_{j<=i} exp(cum_i - cum_j) (c_i·b_j) u_j
    gmat = torch.einsum("bnigk,bnjgk->bnijg", cf, bf)  # (B,nc,L,L,G)
    delta = cum[:, :, :, None] - cum[:, :, None]      # (B,nc,L,L,G,Hg)
    tri = torch.ones((L, L), dtype=torch.bool, device=u.device).tril()
    m = torch.where(tri[None, None, :, :, None, None], torch.exp(delta), 0.0)
    y_intra = torch.einsum("bnijg,bnijgh,bnjghp->bnighp", gmat, m, uf)

    # chunk states: sum_j exp(cum_last - cum_j) u_j ⊗ b_j
    decay_tail = torch.exp(cum[:, :, -1:] - cum)     # (B,nc,L,G,Hg)
    cstate = torch.einsum("bnjgh,bnjghp,bnjgk->bnghpk", decay_tail, uf, bf)

    # inter-chunk recurrence: the state BEFORE each chunk
    total = torch.exp(cum[:, :, -1])                  # (B,nc,G,Hg)
    st = (torch.zeros((Bsz, G, Hg, P, N), dtype=torch.float32,
                      device=u.device)
          if init_state is None else init_state.float())
    prev = []
    for i in range(nc):
        prev.append(st)
        st = total[:, i][..., None, None] * st + cstate[:, i]
    prev_states = torch.stack(prev, dim=1)            # (B,nc,G,Hg,P,N)

    y_inter = torch.einsum("bnigk,bnigh,bnghpk->bnighp",
                           cf, torch.exp(cum), prev_states)
    y = (y_intra + y_inter).reshape(Bsz, nc * L, G, Hg, P)[:, :S]
    return y.to(u.dtype), st


def ssd_decode_step(u, a, b, c, state):
    """One-token recurrence.  u: (B,G,Hg,P); a: (B,G,Hg); b/c: (B,G,N);
    state: (B,G,Hg,P,N).  Returns (y (B,G,Hg,P), new state float32)."""
    st = torch.exp(a.float())[..., None, None] * state \
        + torch.einsum("bghp,bgk->bghpk", u.float(), b.float())
    y = torch.einsum("bgk,bghpk->bghp", c.float(), st)
    return y.to(u.dtype), st


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba_dims(cfg: ModelConfig):
    d_in = cfg.d_model * cfg.ssm_expand
    heads = d_in // cfg.ssm_head_dim
    conv_dim = d_in + 2 * cfg.ssm_state
    return d_in, heads, conv_dim


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    d_in, H, conv_dim = mamba_dims(cfg)
    N, W = cfg.ssm_state, cfg.ssm_conv
    return {
        "in_proj": ParamDef((d, 2 * d_in + 2 * N + H), ("embed", "ff")),
        "conv_w": ParamDef((W, conv_dim), ("conv_width", "ff"), scale=0.5),
        "conv_b": ParamDef((conv_dim,), ("ff",), init="zeros"),
        "a_log": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef((H,), ("ssm_heads",), init="ones"),
        "norm": ParamDef((d_in,), ("ff",), init="ones"),
        "out_proj": ParamDef((d_in, d), ("ff", "embed")),
    }


def _split_in_proj(h, cfg: ModelConfig):
    d_in, H, _ = mamba_dims(cfg)
    N = cfg.ssm_state
    return torch.split(h, [d_in, d_in, N, N, H], dim=-1)  # z, xs, b, c, dt


def _causal_conv(seq, w, bias):
    """Depthwise causal conv.  seq: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    padded = F.pad(seq, (0, 0, W - 1, 0))
    out = sum(padded[:, i:i + seq.shape[1]] * w[i] for i in range(W))
    return out + bias


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def gated_rms_norm(y, z, scale, dtype):
    """RMSNorm of ``y * silu(z)`` (float32 inside), cast to ``dtype``."""
    g = (y * F.silu(z)).float()
    ms = g.square().mean(-1, keepdim=True)
    return (g * torch.rsqrt(ms + 1e-6) * scale.float()).to(dtype)


def mamba_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  planner: Optional[Planner] = None,
                  state: Optional[Dict] = None,
                  ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence Mamba2 mixing.  x: (B,S,d).  Returns (y, new_state)
    where state carries {ssd: (B,1,H,P,N), conv: (B,W-1,conv_dim)}."""
    Bsz, S, d = x.shape
    d_in, H, conv_dim = mamba_dims(cfg)
    N, P, W = cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_conv

    h = x @ p["in_proj"]
    z, xs, bb, cc, dt = _split_in_proj(h, cfg)
    conv_in = torch.cat([xs, bb, cc], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, bb, cc = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"].float())         # (B,S,H)
    a = -torch.exp(p["a_log"].float())                         # (H,)
    log_decay = dt * a                                         # (B,S,H)

    u = (xs.reshape(Bsz, S, H, P).float()
         * dt[..., None]).reshape(Bsz, S, 1, H, P)
    y, final = ssd_chunked(
        u, log_decay.reshape(Bsz, S, 1, H),
        bb.reshape(Bsz, S, 1, N), cc.reshape(Bsz, S, 1, N),
        cfg.ssm_chunk,
        init_state=None if state is None else state["ssd"])
    y = y.reshape(Bsz, S, H, P)
    y = y + xs.reshape(Bsz, S, H, P) \
        * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, d_in)

    # gated RMSNorm then out-projection
    out = gated_rms_norm(y, z, p["norm"], x.dtype) @ p["out_proj"]
    conv = conv_in[:, -(W - 1):] if S >= W - 1 else \
        F.pad(conv_in, (0, 0, W - 1 - S, 0))
    return out, {"ssd": final, "conv": conv}


def mamba_decode_step(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      state: Dict) -> Tuple[torch.Tensor, Dict]:
    """x: (B,1,d); state: {ssd (B,1,H,P,N), conv (B,W-1,conv_dim)}."""
    Bsz, _, d = x.shape
    d_in, H, conv_dim = mamba_dims(cfg)
    N, P = cfg.ssm_state, cfg.ssm_head_dim

    h = x @ p["in_proj"]
    z, xs, bb, cc, dt = _split_in_proj(h, cfg)
    conv_in = torch.cat([xs, bb, cc], dim=-1)                  # (B,1,conv)
    window = torch.cat([state["conv"], conv_in], dim=1)        # (B,W,conv)
    conv_out = F.silu((window * p["conv_w"][None]).sum(1, keepdim=True)
                      + p["conv_b"])
    xs, bb, cc = torch.split(conv_out, [d_in, N, N], dim=-1)

    dt = _softplus(dt[:, 0].float() + p["dt_bias"].float())   # (B,H)
    a = -torch.exp(p["a_log"].float())
    u = (xs[:, 0].reshape(Bsz, H, P).float()
         * dt[..., None]).reshape(Bsz, 1, H, P)
    y, st = ssd_decode_step(u, (dt * a).reshape(Bsz, 1, H),
                            bb[:, 0].reshape(Bsz, 1, N),
                            cc[:, 0].reshape(Bsz, 1, N), state["ssd"])
    y = y.reshape(Bsz, H, P) + xs[:, 0].reshape(Bsz, H, P) \
        * p["d_skip"].to(x.dtype)[None, :, None]
    y = y.reshape(Bsz, 1, d_in)
    out = gated_rms_norm(y, z, p["norm"], x.dtype) @ p["out_proj"]
    return out, {"ssd": st, "conv": window[:, 1:]}
