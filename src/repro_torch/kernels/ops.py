"""Dispatch over the port's kernels.

Backend policy (the JAX package's ``repro/kernels/ops.py``, for CUDA):
  * "kernel" — the hand-written CUDA kernel; raises unless the tensors
               are on a CUDA device.
  * "ref"    — the plain PyTorch version, on any device.
  * "auto"   — the kernel on a CUDA tensor, the plain version on a CPU
               tensor.  There is no fallback: a kernel that fails to
               build or launch raises.

:data:`LAUNCHES` counts each kernel's launches (see ``_build``).
"""

from __future__ import annotations

import torch

from . import ref
from . import segment_sum as _ss
from ._build import LAUNCHES

__all__ = ["LAUNCHES", "resolve", "reset_launches", "segment_sum"]

BACKENDS = ("auto", "kernel", "ref")


def resolve(backend: str, t: torch.Tensor) -> str:
    """``"kernel"`` or ``"ref"`` for a call on tensor ``t``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "auto":
        return "kernel" if t.is_cuda else "ref"
    return backend


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, backend: str = "auto") -> torch.Tensor:
    """Per-segment float32 sums over the trailing axis (any leading
    axes).  Values are cast to float32, as the reference does; the
    kernel takes int32 ids (a narrowing cast could alias an
    out-of-range id onto a real segment, so it raises instead)."""
    values = values.to(torch.float32)
    if resolve(backend, values) == "ref":
        return ref.segment_sum(values, segment_ids, num_segments)
    return _ss.segment_sum(values.contiguous(), segment_ids.contiguous(),
                           num_segments)
