"""The fused partition → sort → probe join pipeline (``join_impl="fused"``).

Port of ``src/repro/kernels/fused_join.py``:

* :func:`stable_key_order` — the stable argsort by ``(validity, key)``
  by rank packing: sort the key values, dense-rank every row with
  ``searchsorted``, sort the packed words ``rank·n + row``, unpack the
  rows.  Bit-identical to the staged ``core.local._sorted_by_key``.
  The packed word is int64 at every size; the JAX package needs an
  int32 fallback past 2^15 rows only because it lacks int64 without
  x64.
* :func:`partition_order` — the same packing for the map-phase hash
  partition (buckets are already dense ranks).
* :func:`probe_counts` — the merge-probe run bounds ``lo = #{r < q}``,
  ``hi = #{r <= q}``.  On CUDA tensors it launches the kernel of
  ``csrc/probe_counts.cu`` (port of the TPU kernel
  ``probe_counts_pallas``); on CPU tensors, or with ``backend="ref"``,
  it runs the plain version (``torch.searchsorted``).

Everything is batched over leading axes; orders are int64 indices.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build, ref

__all__ = ["stable_key_order", "partition_order", "probe_counts"]


def _packed_stable_argsort(rank: torch.Tensor, n_ranks: int) -> torch.Tensor:
    """Stable argsort of a dense-rank vector (values in [0, n_ranks))
    along the last axis via one value sort of the distinct packed words
    ``rank·n + row``."""
    n = rank.shape[-1]
    if n_ranks * n >= 2 ** 63:
        raise ValueError(f"packed word overflows int64: {n_ranks} x {n}")
    row = torch.arange(n, device=rank.device)
    packed = rank.to(torch.int64) * n + row
    return torch.sort(packed, dim=-1).values % max(n, 1)


def stable_key_order(key: torch.Tensor, valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort order by (validity, key) — bit-identical to
    ``core.local._sorted_by_key`` — via rank packing.  Returns
    ``(order, masked)``: the stable permutation (valid rows first in
    ascending key order) and the sorted keys with the invalid tail
    replaced by the dtype's max."""
    n = key.shape[-1]
    n_valid = valid.sum(-1, keepdim=True)
    sentinel = torch.iinfo(key.dtype).max
    skey = torch.sort(key, dim=-1).values
    rk = torch.searchsorted(skey, key, side="left")
    rank = (~valid).to(torch.int64) * n + rk      # dense (validity, key) rank
    order = _packed_stable_argsort(rank, 2 * n)
    sorted_key = key.gather(-1, order)
    idx = torch.arange(n, device=key.device)
    return order, torch.where(idx < n_valid, sorted_key, sentinel)


def partition_order(bucket_key: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Stable argsort of a dense bucket-key vector (values in
    [0, n_buckets], invalid rows already mapped to ``n_buckets``)."""
    return _packed_stable_argsort(bucket_key, n_buckets + 1)


def _probe_counts_cuda(queries: torch.Tensor, sorted_keys: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel: int32 ``(lo, hi)`` of every query of row b in row
    b of ``sorted_keys``.  Raises on anything the kernel does not
    take — it never falls back to the plain version."""
    if not (queries.is_cuda and sorted_keys.is_cuda):
        raise ValueError("probe_counts kernel needs CUDA tensors")
    if queries.device != sorted_keys.device:
        raise ValueError("queries and sorted_keys are on different devices")
    if queries.dtype != sorted_keys.dtype or queries.dtype not in (
            torch.int32, torch.int64):
        raise TypeError(f"probe_counts kernel takes int32 or int64 keys of "
                        f"one dtype, got {queries.dtype} / {sorted_keys.dtype}")
    if queries.dim() < 1 or queries.shape[:-1] != sorted_keys.shape[:-1]:
        raise ValueError(f"queries {tuple(queries.shape)} and keys "
                         f"{tuple(sorted_keys.shape)} need the same leading "
                         f"axes")
    if not (queries.is_contiguous() and sorted_keys.is_contiguous()):
        raise ValueError("probe_counts kernel needs contiguous inputs")
    nq, nr = queries.shape[-1], sorted_keys.shape[-1]
    if nr >= 2 ** 31:
        raise ValueError(f"int32 counts cannot hold {nr} keys")
    batch = queries.numel() // nq if nq else 0
    lo = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    hi = torch.empty_like(lo)
    if batch == 0 or nq == 0:
        return lo, hi                   # nothing to probe: no launch
    lib = _build.library("probe_counts")
    fn = lib.probe_counts_i32 if queries.dtype == torch.int32 \
        else lib.probe_counts_i64
    rc = fn(queries.data_ptr(), sorted_keys.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), batch, nq, nr,
            torch.cuda.current_stream(queries.device).cuda_stream)
    _build.check(lib, "probe_counts", rc)
    _build.count_launch("probe_counts")
    return lo, hi


def probe_counts(queries: torch.Tensor, sorted_keys: torch.Tensor, *,
                 backend: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatching wrapper (``_build.resolve``): the kernel on a
    CUDA tensor, the plain version on a CPU tensor or with
    ``backend="ref"``.  Both return int32 counts, equal as integers."""
    if _build.resolve(backend, queries) == "ref":
        return ref.probe_counts(queries, sorted_keys)
    return _probe_counts_cuda(queries, sorted_keys)
