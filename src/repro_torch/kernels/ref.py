"""Plain PyTorch versions of the port's kernels.

Each function is the semantic ground truth its CUDA kernel must
reproduce, batched over any leading axes.  The wrappers run these on
CPU tensors, or on any tensor when the caller passes ``backend="ref"``.
"""

from __future__ import annotations

from typing import Tuple

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
