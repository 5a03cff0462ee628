"""Bucket hash functions h and g used by the join algorithms.

Salted multiplicative (Fibonacci) hashing on uint32, bit for bit the
JAX package's ``bucket_hash``.  torch has no usable uint32 shift or
modulo on the CPU, so the arithmetic runs in int64 holding uint32
values: every product is split so that no intermediate leaves
[0, 2^63), and the result is masked back to 32 bits.
"""

from __future__ import annotations

import torch

_KNUTH = 2654435761  # 2^32 / phi
_SALTS = (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F)
_MASK = 0xFFFFFFFF


def _mul32(u: torch.Tensor, k: int) -> torch.Tensor:
    """``(u * k) mod 2^32`` for int64 ``u`` in [0, 2^32) and a 32-bit
    constant ``k``, without int64 overflow: ``u·k_lo`` stays below
    2^48, and only the low 16 bits of ``u·k_hi`` survive the shift."""
    lo, hi = k & 0xFFFF, k >> 16
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & _MASK


def bucket_hash(x: torch.Tensor, n_buckets: int, salt: int = 0) -> torch.Tensor:
    """Hash int keys into [0, n_buckets) with a salted multiplicative
    hash; returns int32.  64-bit keys fold high xor low word first (the
    arithmetic shift differs from a logical one only in bits the mask
    drops)."""
    if x.dtype == torch.int64:
        u = (x ^ (x >> 32)) & _MASK
    else:
        u = x.to(torch.int64) & _MASK
    u = _mul32(u ^ _SALTS[salt % len(_SALTS)], _KNUTH)
    u = u ^ (u >> 15)
    u = _mul32(u, 0x846CA68B)
    u = u ^ (u >> 13)
    return (u % n_buckets).to(torch.int32)


def h(x: torch.Tensor, k1: int) -> torch.Tensor:
    """The paper's ``h`` — buckets attribute B into k1 reducer rows."""
    return bucket_hash(x, k1, salt=0)


def g(x: torch.Tensor, k2: int) -> torch.Tensor:
    """The paper's ``g`` — buckets attribute C into k2 reducer columns."""
    return bucket_hash(x, k2, salt=1)
