"""Shared neural layers: norms, RoPE, attention (self, cached, cross), MLPs,
the loss.

Port of ``src/repro/models/layers.py``.  Functions are pure except that
a KV cache is written in place; parameters are plain dicts built from
ParamDef trees, activations keep the reference's layouts ((B, S, d);
attention heads as (B, S, H, D)).

Attention (:func:`multihead_attention`) has two backends, picked by
``kernels._build.resolve`` as every port kernel is:

  * the kernel — ``kernels.flash_attention.flash_attention``, the CUDA
    port of the TPU kernel whose blocking the reference's layers mirror
    in jnp.  It aligns the causal diagonal to the end of the kv axis,
    which is the reference's mask exactly when the queries are the last
    positions seen: ``q_offset + Sq == kv_len`` (prefill and decode over
    a cache), or no cache, ``q_offset == 0`` and ``Sq == Skv``.  Any
    other causal call raises on this path rather than fall back.  Under
    autograd its gradient is the ``flash_attention_bwd`` kernel
    (``FlashAttentionFn``); the slices, transposes and casts around it
    are ordinary differentiable ops, so every weight that reaches the
    loss through attention gets its gradient.
  * the plain version — the reference's ``_sdpa_block`` with its chunked
    and naive branches, the same ``-1e30`` mask, float32 inside.  It
    runs on CPU tensors ("auto") and with ``backend="ref"``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import Planner
from ..kernels import _build
from ..kernels.flash_attention import flash_attention
from .config import ModelConfig
from .params import ParamDef


# ---------------------------------------------------------------------------
# Norms / embeddings / positions
# ---------------------------------------------------------------------------

def norm_defs(cfg: ModelConfig, d: int | None = None) -> Dict[str, ParamDef]:
    d = d or cfg.d_model
    out = {"scale": ParamDef((d,), ("embed",), init="ones")}
    if cfg.norm == "ln":
        out["bias"] = ParamDef((d,), ("embed",), init="zeros")
    return out


def apply_norm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # LayerNorm
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, unbiased=False, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # RMSNorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope_angles(positions: torch.Tensor, d: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (B, S, 1, D/2) float32, of RoPE at ``positions``
    (B, S): what :func:`rope` applies.  A decoder computes them once a
    step and hands them to every layer (two rotations a layer would
    otherwise recompute them: ~20 launches each on the host-bound decode
    step)."""
    exps = -torch.arange(0, d, 2, dtype=torch.float32,
                         device=positions.device) / d
    freqs = torch.pow(float(theta), exps)   # a scalar base: no host copy
    ang = positions[..., None].float() * freqs            # (B, S, D/2)
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         angles: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
         ) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int.  Split halves.  ``angles``:
    :func:`rope_angles` of these positions, if already computed."""
    cos, sin = angles if angles is not None else \
        rope_angles(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig, cross: bool = False
                   ) -> Dict[str, ParamDef]:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    out = {
        "wq": ParamDef((d, qd), ("embed", "q_features")),
        "wk": ParamDef((d, kvd), ("embed", "kv_features")),
        "wv": ParamDef((d, kvd), ("embed", "kv_features")),
        "wo": ParamDef((qd, d), ("q_features", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamDef((qd,), ("q_features",), init="zeros")
        out["bk"] = ParamDef((kvd,), ("kv_features",), init="zeros")
        out["bv"] = ParamDef((kvd,), ("kv_features",), init="zeros")
    return out


def _sdpa_block(q, k, v, mask, scale):
    """q: (B,Hkv,G,Cq,D); k/v: (B,Hkv,Skv,D); mask: (Cq,Skv) or None."""
    logits = torch.einsum("bhgqd,bhkd->bhgqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())


def _attention_plain(q, k, v, causal, q_offset, kv_len, cfg):
    """The reference's blocked jnp attention, op for op."""
    B, Sq, H, D = q.shape
    _, Skv, Hkv, _ = k.shape
    G = H // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D).permute(0, 2, 3, 1, 4)  # (B,Hkv,G,Sq,D)
    kt = k.transpose(1, 2)                                   # (B,Hkv,Skv,D)
    vt = v.transpose(1, 2)

    kpos = torch.arange(Skv, device=q.device)

    def mask_for(q_lo, cq):
        qpos = q_lo + torch.arange(cq, device=q.device)[:, None] + q_offset
        m = torch.ones((cq, Skv), dtype=torch.bool, device=q.device)
        if causal:
            m &= qpos >= kpos[None, :]
        if kv_len is not None:
            m &= kpos[None, :] < kv_len
        return m

    chunk = cfg.attn_chunk
    if cfg.attn_impl == "naive" or Sq <= chunk:
        out = _sdpa_block(qg, kt, vt, mask_for(0, Sq), scale)
    else:
        pad = -Sq % chunk
        qp = F.pad(qg, (0, 0, 0, pad))
        out = torch.cat([
            _sdpa_block(qp[:, :, :, lo:lo + chunk], kt, vt,
                        mask_for(lo, chunk), scale)
            for lo in range(0, Sq + pad, chunk)], dim=3)[:, :, :, :Sq]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


def _attention_kernel(q, k, v, causal, q_offset, kv_len):
    """The CUDA ``flash_attention`` over the valid prefix of the keys.

    Each call copies ``k[:, :kv_len]`` and ``v[:, :kv_len]`` into
    contiguous (B, Hkv, kv_len, D) tensors: one copy of the valid cache
    a layer a step.  A kernel reading the cache's strides and a
    device-side ``kv_len`` (what graph capture would need) is later
    work."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    q_offset = int(q_offset)
    n = Skv if kv_len is None else int(kv_len)
    if causal:
        aligned = (q_offset == 0 and Sq == Skv) if kv_len is None \
            else q_offset + Sq == n
        if not aligned:
            raise ValueError(
                f"flash_attention aligns the causal diagonal to the end of "
                f"the keys: needs q_offset + Sq == kv_len (or no cache, "
                f"q_offset 0 and Sq == Skv); got q_offset {q_offset}, Sq "
                f"{Sq}, kv_len {kv_len}, Skv {Skv}")
    if not 0 <= n <= Skv:
        raise ValueError(f"kv_len {n} outside the {Skv} cached keys")
    # The cache is bfloat16 by default: with float32 activations the keys
    # are the rounded values, cast to q's dtype (the kernel takes one).
    kt = k[:, :n].transpose(1, 2).to(q.dtype)
    vt = v[:, :n].transpose(1, 2).to(q.dtype)
    out = flash_attention(q.transpose(1, 2), kt, vt, causal=causal,
                          scale=D ** -0.5, backend="kernel")
    return out.transpose(1, 2)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, q_offset, kv_len,
                        cfg: ModelConfig, backend: str = "auto"
                        ) -> torch.Tensor:
    """q: (B,Sq,H,D); k/v: (B,Skv,Hkv,D).  Returns (B,Sq,H,D) in q.dtype.

    q_offset: absolute position of q[0] (an int; causal alignment).
    kv_len:   valid kv length (an int; masks the cache tail), or None.
    backend:  "auto" (the kernel on CUDA tensors, the plain version on
              CPU ones), "kernel" or "ref".
    """
    if _build.resolve(backend, q) == "ref":
        return _attention_plain(q, k, v, causal, q_offset, kv_len, cfg)
    return _attention_kernel(q, k, v, causal, q_offset, kv_len)


def _linear(x, w, b=None):
    y = x @ w
    return y if b is None else y + b


def attention_forward(p: Dict, x: torch.Tensor, *, cfg: ModelConfig,
                      planner: Planner, positions: torch.Tensor,
                      causal: bool = True, is_cross: bool = False,
                      kv_src: Optional[torch.Tensor] = None,
                      cache: Optional[Dict[str, torch.Tensor]] = None,
                      cache_pos=None, backend: str = "auto",
                      angles: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None,
                      ) -> Tuple[torch.Tensor,
                                 Optional[Dict[str, torch.Tensor]]]:
    """Self- or cross-attention with an optional static KV cache.

    x: (B, S, d).  kv_src: encoder/image states for cross-attention
    (is_cross=True); at decode time kv_src may be None and the
    precomputed cross cache is reused.
    cache: {"k","v": (B, Smax, Hkv, D)}; cache_pos: write offset (int).
    angles: :func:`rope_angles` of ``positions`` (computed here if None).
    A self-attention cache is written in place at ``cache_pos`` — the
    new keys and values rounded to the cache's dtype, and attention
    reads the rounded values, as the reference's does — and returned.
    Returns (output (B,S,d), the cache or None).
    """
    B, S, d = x.shape
    H, Hkv, D = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim

    q = _linear(x, p["wq"], p.get("bq")).reshape(B, S, H, D)

    if is_cross and kv_src is None:
        # Cross-attention at decode time: reuse the precomputed cross cache
        # (at prefill kv_src is provided and the cache is recomputed).
        if cache is None:
            raise ValueError("cross-attention decode needs a cache")
        k, v, new_cache, kv_len = cache["k"], cache["v"], cache, None
    else:
        kv_in = x if kv_src is None else kv_src
        k = _linear(kv_in, p["wk"], p.get("bk")).reshape(B, -1, Hkv, D)
        v = _linear(kv_in, p["wv"], p.get("bv")).reshape(B, -1, Hkv, D)
        if cfg.pos == "rope" and not is_cross:
            if angles is None:
                angles = rope_angles(positions, D, cfg.rope_theta)
            q = rope(q, positions, cfg.rope_theta, angles)
            k = rope(k, positions, cfg.rope_theta, angles)
        if is_cross:
            # Fresh cross cache (prefill/train): REPLACES any cache given.
            new_cache = {"k": k.to(torch.bfloat16),
                         "v": v.to(torch.bfloat16)}
            kv_len = None
        elif cache is not None:
            # Self-attention decode: append new kv at cache_pos, in place.
            ck, cv = cache["k"], cache["v"]
            ck[:, cache_pos:cache_pos + S] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + S] = v.to(cv.dtype)
            new_cache = cache
            k, v = ck, cv
            kv_len = cache_pos + S
        else:
            new_cache, kv_len = None, None

    q = planner.constrain(q, ("batch", None, "act_heads", None))
    out = multihead_attention(
        q, k, v, causal=causal,
        q_offset=(cache_pos if cache_pos is not None else 0),
        kv_len=kv_len, cfg=cfg, backend=backend)
    out = out.reshape(B, S, H * D) @ p["wo"]
    return out.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> Dict[str, ParamDef]:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"wg": ParamDef((d, f), ("embed", "ff")),
                "wu": ParamDef((d, f), ("embed", "ff")),
                "wd": ParamDef((f, d), ("ff", "embed"))}
    return {"wu": ParamDef((d, f), ("embed", "ff")),
            "bu": ParamDef((f,), ("ff",), init="zeros"),
            "wd": ParamDef((f, d), ("ff", "embed")),
            "bd": ParamDef((d,), ("embed",), init="zeros")}


def mlp_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                planner: Planner) -> torch.Tensor:
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
        h = planner.constrain(h, ("batch", None, "act_ff"))
        return (h @ p["wd"]).to(x.dtype)
    # jax.nn.gelu's default is the tanh approximation.
    h = F.gelu((x @ p["wu"] + p["bu"]).float(), approximate="tanh"
               ).to(x.dtype)
    h = planner.constrain(h, ("batch", None, "act_ff"))
    return (h @ p["wd"] + p["bd"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Loss (forward)
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (..., V) float32-accumulated stable CE; targets int."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.take_along_dim(lf, targets[..., None].long(), dim=-1)[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def lm_loss(h: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor], cfg: ModelConfig,
            planner: Planner) -> torch.Tensor:
    """Final-hidden -> CE loss, optionally chunked over the sequence so the
    (B,S,V) logits tensor is never materialized whole."""
    if not cfg.logit_chunk or h.shape[1] <= cfg.logit_chunk:
        logits = h @ head
        logits = planner.constrain(logits, ("batch", None, "act_vocab"))
        return cross_entropy(logits, targets, mask)

    C = cfg.logit_chunk
    S = h.shape[1]
    pad = -S % C
    hp = F.pad(h, (0, 0, 0, pad))
    tp = F.pad(targets, (0, pad))
    mp = F.pad(mask if mask is not None
               else torch.ones(targets.shape, dtype=torch.float32,
                               device=targets.device), (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for lo in range(0, S + pad, C):
        lf = (hp[:, lo:lo + C] @ head).float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.take_along_dim(
            lf, tp[:, lo:lo + C, None].long(), dim=-1)[..., 0]
        mc = mp[:, lo:lo + C]
        tot = tot + ((lse - gold) * mc).sum()
        cnt = cnt + mc.sum()
    return tot / torch.clamp(cnt, min=1.0)
