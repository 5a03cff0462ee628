"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel must
reproduce, batched over any leading axes.  The wrappers run these on
CPU tensors, or on any tensor when the caller passes ``backend="ref"``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``values`` (..., N) into (..., num_segments) buckets by sorted
    or unsorted ``segment_ids``; ids outside [0, num_segments) are
    dropped."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(valid, segment_ids, num_segments).to(torch.int64)
    v = torch.where(valid, values, 0)
    out = values.new_zeros(*values.shape[:-1], num_segments + 1)
    out.scatter_add_(-1, ids, v)
    return out[..., :num_segments]


def probe_counts(queries: torch.Tensor, sorted_keys: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` int32 run bounds of every query in its row of a
    sorted key column: ``lo = #{r < q}``, ``hi = #{r <= q}`` —
    ``searchsorted`` left/right, clamped to the key count."""
    nr = sorted_keys.shape[-1]
    lo = torch.searchsorted(sorted_keys, queries, side="left", out_int32=True)
    hi = torch.searchsorted(sorted_keys, queries, side="right", out_int32=True)
    return lo.clamp_(max=nr), hi.clamp_(max=nr)


def histogram_block(n: int, block: int) -> int:
    """Rows per histogram block for ``n`` keys: the JAX kernel's rule,
    ``min(block, max(128, next_pow2(n)))``."""
    return min(block, max(128, 1 << (max(n, 1) - 1).bit_length()))


def hash_histogram(keys: torch.Tensor, valid: torch.Tensor, n_buckets: int,
                   salt: int = 0, block: int = 1024) -> torch.Tensor:
    """Per-block histogram of ``bucket_hash(keys)`` over valid rows:
    keys/valid (..., N) -> (..., ceil(N / b), n_buckets) int32 with
    ``b = histogram_block(N, block)``; the tail of the last block counts
    nowhere."""
    from ..core.hashing import bucket_hash
    n = keys.shape[-1]
    b = histogram_block(n, block)
    n_blocks = -(-n // b)
    lead = keys.shape[:-1]
    batch = int(np.prod(lead, dtype=np.int64))
    bucket = bucket_hash(keys, n_buckets, salt=salt).to(torch.int64)
    blk = torch.arange(n, device=keys.device) // b
    cell = blk * n_buckets + bucket
    size = n_blocks * n_buckets
    base = torch.arange(batch, device=keys.device).view(*lead, 1) * size
    flat = torch.where(valid, cell + base, batch * size)   # sink slot
    out = torch.zeros(batch * size + 1, dtype=torch.int32,
                      device=keys.device)
    out.scatter_add_(0, flat.reshape(-1),
                     torch.ones(flat.numel(), dtype=torch.int32,
                                device=keys.device))
    return out[:batch * size].view(*lead, n_blocks, n_buckets)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None
              ) -> torch.Tensor:
    """Attention over q (B, Hq, Sq, D) and k/v (B, Hkv, Skv, D), Hq a
    multiple of Hkv (GQA: query head h reads kv head h // (Hq/Hkv)).
    The causal diagonal is aligned to the end of the kv axis (queries
    are the last Sq positions).  Computed in float32, returned in
    q.dtype; a query row that sees no key gives zeros, as the kernels
    do."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    scale = scale if scale is not None else float(d) ** -0.5
    kf = k.to(torch.float32).repeat_interleave(hq // hkv, dim=1)
    vf = v.to(torch.float32).repeat_interleave(hq // hkv, dim=1)
    logits = torch.matmul(q.to(torch.float32) * scale, kf.transpose(-1, -2))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        seen = qpos >= torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~seen, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        probs = torch.where(seen.any(-1)[:, None], probs, 0.0)
    else:
        probs = torch.softmax(logits, dim=-1)
    return torch.matmul(probs, vf).to(q.dtype)


def attention_lse(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """Each query row's log-sum-exp, as the attention kernels store it:
    float32 (B, Hq, Sq), in base 2 of the scaled scores,
    ``log2 sum_j 2^(scale * log2(e) * q_i . k_j)`` over the keys the row
    sees (:func:`attention`'s mask), +inf for a row that sees none."""
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    scale = scale if scale is not None else float(d) ** -0.5
    kf = k.to(torch.float32).repeat_interleave(hq // hkv, dim=1)
    logits = torch.matmul(q.to(torch.float32) * scale, kf.transpose(-1, -2))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        seen = qpos >= torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~seen, float("-inf"))
    lse = torch.logsumexp(logits, dim=-1) / math.log(2.0)
    return torch.where(torch.isfinite(lse), lse, math.inf)


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, causal: bool = True,
                       scale: float | None = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)``: the gradient of :func:`attention` at (q, k, v)
    for the output cotangent ``dout`` (B, Hq, Sq, D), computed in float32
    with the same end-aligned causal mask and returned in the dtypes of
    q, k and v.  dk and dv are summed over the Hq/Hkv query heads of each
    kv head; a query row that sees no key gets, and gives, zero."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    g = hq // hkv
    scale = scale if scale is not None else float(d) ** -0.5
    qf = q.to(torch.float32)
    kf = k.to(torch.float32).repeat_interleave(g, dim=1)
    vf = v.to(torch.float32).repeat_interleave(g, dim=1)
    dof = dout.to(torch.float32)
    logits = torch.matmul(qf * scale, kf.transpose(-1, -2))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        seen = qpos >= torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~seen, float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        probs = torch.where(seen.any(-1)[:, None], probs, 0.0)
    else:
        probs = torch.softmax(logits, dim=-1)
    dv = torch.matmul(probs.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.view(b, hkv, g, skv, d).sum(2)
    dv = dv.view(b, hkv, g, skv, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
