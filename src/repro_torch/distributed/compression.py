"""Error-feedback int8 gradient compression for the cross-pod hop.

Port of ``src/repro/distributed/compression.py``: per-block int8
quantization (blocks of :data:`BLOCK` values, one float32 scale each)
with an error-feedback residual added back on the next step.
``torch.round`` rounds half to even, as ``jnp.round`` does, so the int8
codes are the reference's.

Usage: ``state = ef_init(grads); grads_c, state = ef_compress(grads,
state)`` in the train step, before clipping.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..models.params import tree_map, tree_map2

BLOCK = 256  # quantization group size (per-block scales bound error)


def _quant_block(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., BLOCK) float -> int8 codes + per-block scale."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = -flat.shape[0] % BLOCK
    flat = F.pad(flat, (0, pad))
    q, scale = _quant_block(flat.reshape(-1, BLOCK))
    return q, scale, pad


def dequantize(q: torch.Tensor, scale: torch.Tensor, pad: int, shape,
               dtype: torch.dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def ef_init(grads):
    """Zero error-feedback residuals, one per gradient leaf."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def ef_compress(grads, residuals):
    """Quantize (grad + residual); return the dequantized grads (what the
    collective will see) and the new residuals (what quantization
    lost), as two trees of the grads' structure."""
    lost = []

    def one(g, r):
        target = g.to(torch.float32) + r
        q, scale, pad = quantize(target)
        deq = dequantize(q, scale, pad, g.shape, torch.float32)
        lost.append(target - deq)
        return deq.to(g.dtype)

    grads_c = tree_map2(one, grads, residuals)
    it = iter(lost)        # tree_map walks the leaves in tree_map2's order
    return grads_c, tree_map(lambda _: next(it), grads_c)


def compression_ratio() -> float:
    """Bytes on the wire vs bf16: int8 codes + f32 scale per BLOCK."""
    return (BLOCK * 1 + 4) / (BLOCK * 2)
