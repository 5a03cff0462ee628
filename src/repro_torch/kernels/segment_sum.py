"""CUDA kernel: segment sum — the paper's aggregation hot spot.

Port of ``src/repro/kernels/segment_sum.py::segment_sum`` (TPU: a
one-hot MXU product per segment tile × input block).  The H100 kernel
(``csrc/segment_sum.cu``) runs two passes: per tile of ``TILE`` rows a
segmented scan that adds each run inside the tile once and leaves the
tile's first and last run in a carry buffer, then a fix-up that sums
the runs crossing tiles in tile order.  On sorted ids every segment
gets one addend, so its sums are bit-identical from launch to launch.
It reads each (id, value) pair once, so it is bound by device-memory
bytes; see the source for the design.

:func:`segment_sum` launches it on CUDA tensors and runs the plain
version ``ref.segment_sum`` on CPU tensors or with ``backend="ref"``.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["segment_sum"]

#: Rows per tile of the kernel's first pass, and the int32 words of one
#: tile's carry record (head id, head sum, tail id, tail sum, flag, pad).
TILE = 2048
CARRY_WORDS = 8


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, backend: str = "auto") -> torch.Tensor:
    """Per-segment float32 sums of ``values`` (..., N) by ``segment_ids``
    (..., N) into (..., num_segments), over any leading axes; ids
    outside [0, num_segments) are dropped.  The plain version casts the
    values to float32, as the reference does; the kernel takes float32
    values and int32 ids (a narrowing cast could alias an out-of-range
    id onto a real segment, so it raises instead)."""
    if _build.resolve(backend, values) == "ref":
        return ref.segment_sum(values.to(torch.float32), segment_ids,
                               num_segments)
    return _segment_sum_cuda(values, segment_ids, num_segments)


def _segment_sum_cuda(values: torch.Tensor, segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """The CUDA kernel.  Raises on anything the kernel does not take —
    it never falls back to the plain version."""
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
    out = torch.zeros(*lead, num_segments, dtype=torch.float32,
                      device=values.device)
    if batch == 0 or n == 0:
        return out                      # nothing to add: no launch
    carries = torch.empty(batch * -(-n // TILE) * CARRY_WORDS,
                          dtype=torch.int32, device=values.device)
    lib = _build.library("segment_sum")
    rc = lib.segment_sum_f32(
        values.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
        carries.data_ptr(), batch, n, num_segments,
        torch.cuda.current_stream(values.device).cuda_stream)
    _build.check(lib, "segment_sum", rc)
    _build.count_launch("segment_sum")
    return out
