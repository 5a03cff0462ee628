"""CUDA kernel: segment sum — the paper's aggregation hot spot.

Port of ``src/repro/kernels/segment_sum.py::segment_sum`` (TPU: a
one-hot MXU product per segment tile × input block).  The H100 kernel
(``csrc/segment_sum.cu``) is a block-wide segmented scan with one
float atomic per run end: it reads each (id, value) pair once, so it is
bound by device-memory bytes; see the source for the design.

:func:`segment_sum` launches it on CUDA tensors; ``ref.segment_sum`` is
the plain version on the same contract, and ``ops.segment_sum``
dispatches between them.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ["segment_sum"]


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment sums of ``values`` (..., N) float32 by ``segment_ids``
    (..., N) int32 into (..., num_segments) float32, on the GPU.  Ids
    outside [0, num_segments) are dropped.  Raises on anything the
    kernel does not take — it never falls back to the plain version."""
    if not (values.is_cuda and segment_ids.is_cuda):
        raise ValueError("segment_sum kernel needs CUDA tensors")
    if values.device != segment_ids.device:
        raise ValueError("values and segment_ids are on different devices")
    if values.dtype != torch.float32 or segment_ids.dtype != torch.int32:
        raise TypeError(f"segment_sum kernel takes float32 values and int32 "
                        f"ids, got {values.dtype} / {segment_ids.dtype}")
    if values.shape != segment_ids.shape or values.dim() < 1:
        raise ValueError(f"values {tuple(values.shape)} and ids "
                         f"{tuple(segment_ids.shape)} must share one shape")
    if not (values.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("segment_sum kernel needs contiguous inputs")
    if not 0 <= num_segments < 2 ** 31:
        raise ValueError(f"num_segments out of range: {num_segments}")
    lead = values.shape[:-1]
    n = values.shape[-1]
    batch = values.numel() // n if n else 0
    if batch > 65535:
        raise ValueError(f"segment_sum kernel takes at most 65535 rows, "
                         f"got {batch}")
    out = torch.zeros(*lead, num_segments, dtype=torch.float32,
                      device=values.device)
    if batch == 0 or n == 0:
        return out                      # nothing to add: no launch
    lib = _build.library("segment_sum")
    rc = lib.segment_sum_f32(
        values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(), batch, n,
        num_segments, torch.cuda.current_stream(values.device).cuda_stream)
    _build.check(lib, "segment_sum", rc)
    _build.LAUNCHES["segment_sum"] += 1
    return out
