"""Fused hash + per-block bucket histogram — the map phase's counting pass.

Port of ``src/repro/kernels/hash_partition.py``:

* :func:`hash_histogram` — per-block bucket counts of the valid keys.
  On CUDA tensors it launches the kernel of ``csrc/hash_histogram.cu``
  (port of the TPU kernel ``hash_histogram``); on CPU tensors, or with
  ``backend="ref"``, it runs the plain version ``ref.hash_histogram``.
* :func:`bucket_counts` — the global bucket-load histogram of one
  shuffle hop (the executor's skew diagnostic and the heavy-hitter
  detector's candidate filter): the per-block counts summed.  On CUDA
  tensors it is one launch of the same source's totals kernel, which
  never forms the per-block counts; the plain version sums
  ``ref.hash_histogram`` over blocks.
* :func:`partition_offsets` — the exclusive scan that turns per-block
  counts into the send-buffer write offsets.

One hash everywhere: the kernel, the plain version and every router
use ``core.hashing.bucket_hash`` (int64 keys fold high xor low word).
The JAX package's kernel drops the high word of int64 keys instead
(its ``_bucket_hash``); the two agree on int32 keys and on
non-negative int64 keys below 2^32.  Everything is batched over
leading axes.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["hash_histogram", "bucket_counts", "partition_offsets"]

#: Buckets the kernels' shared-memory histogram holds (48 KB of ints,
#: the default dynamic shared-memory limit of a block); past it they
#: count with global atomics into a zeroed output.
SHARED_BUCKETS = 12288
#: The most buckets the kernels take, as the reference does: an int32.
MAX_BUCKETS = 2 ** 31 - 1


def _salt_constant(salt: int) -> int:
    from ..core.hashing import _SALTS
    return _SALTS[salt % len(_SALTS)]


def _check_cuda_inputs(keys: torch.Tensor, valid: torch.Tensor,
                       n_buckets: int) -> None:
    """Raise on anything the kernels do not take — they never fall back
    to the plain version."""
    if not (keys.is_cuda and valid.is_cuda):
        raise ValueError("hash_histogram kernel needs CUDA tensors")
    if keys.device != valid.device:
        raise ValueError("keys and valid are on different devices")
    if keys.dtype not in (torch.int32, torch.int64) or \
            valid.dtype != torch.bool:
        raise TypeError(f"hash_histogram kernel takes int32 or int64 keys "
                        f"and a bool mask, got {keys.dtype} / {valid.dtype}")
    if keys.dim() < 1 or keys.shape != valid.shape:
        raise ValueError(f"keys {tuple(keys.shape)} and valid "
                         f"{tuple(valid.shape)} must share one shape")
    if not (keys.is_contiguous() and valid.is_contiguous()):
        raise ValueError("hash_histogram kernel needs contiguous inputs")
    if not 1 <= n_buckets <= MAX_BUCKETS:
        raise ValueError(f"hash_histogram kernel takes 1..{MAX_BUCKETS} "
                         f"buckets, got {n_buckets}")


def _output(shape, n_buckets: int, device) -> torch.Tensor:
    """The kernels' output: zeroed where they count into it with global
    atomics (more buckets than a shared histogram holds)."""
    alloc = torch.zeros if n_buckets > SHARED_BUCKETS else torch.empty
    return alloc(*shape, dtype=torch.int32, device=device)


def _hash_histogram_cuda(keys: torch.Tensor, valid: torch.Tensor,
                         n_buckets: int, salt: int, block: int
                         ) -> torch.Tensor:
    """The per-block kernel: (..., N) keys -> (..., n_blocks, n_buckets)
    int32."""
    _check_cuda_inputs(keys, valid, n_buckets)
    n = keys.shape[-1]
    b = ref.histogram_block(n, block)
    n_blocks = -(-n // b)
    batch = keys.numel() // n if n else 0
    if n_blocks >= 2 ** 31:
        raise ValueError(f"hash_histogram kernel grid too large: {batch} "
                         f"rows x {n_blocks} blocks")
    out = _output((*keys.shape[:-1], n_blocks, n_buckets), n_buckets,
                  keys.device)
    if batch == 0 or n_blocks == 0:
        return out                      # nothing to count: no launch
    lib = _build.library("hash_histogram")
    fn = lib.hash_histogram_i32 if keys.dtype == torch.int32 \
        else lib.hash_histogram_i64
    rc = fn(keys.data_ptr(), valid.data_ptr(), out.data_ptr(), batch, n, b,
            n_blocks, n_buckets, _salt_constant(salt),
            torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(lib, "hash_histogram", rc)
    _build.count_launch("hash_histogram")
    return out


def _bucket_counts_cuda(keys: torch.Tensor, valid: torch.Tensor,
                        n_buckets: int, salt: int) -> torch.Tensor:
    """The totals kernel: (..., N) keys -> (..., n_buckets) int32 in one
    launch (the C side zeroes the output first where several CTAs add
    into one row)."""
    _check_cuda_inputs(keys, valid, n_buckets)
    n = keys.shape[-1]
    batch = keys.numel() // n if n else 0
    if batch == 0:                      # nothing to count: no launch
        return torch.zeros(*keys.shape[:-1], n_buckets, dtype=torch.int32,
                           device=keys.device)
    out = _output((*keys.shape[:-1], n_buckets), n_buckets, keys.device)
    lib = _build.library("hash_histogram")
    fn = lib.bucket_counts_i32 if keys.dtype == torch.int32 \
        else lib.bucket_counts_i64
    rc = fn(keys.data_ptr(), valid.data_ptr(), out.data_ptr(), batch, n,
            n_buckets, _salt_constant(salt),
            torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(lib, "hash_histogram", rc)
    _build.count_launch("hash_histogram")
    return out


def hash_histogram(keys: torch.Tensor, valid: torch.Tensor, n_buckets: int,
                   *, salt: int = 0, block: int = 1024,
                   backend: str = "auto") -> torch.Tensor:
    """Fused ``bucket_hash`` + per-block histogram: keys/valid (..., N)
    -> (..., ceil(N / b), n_buckets) int32, ``b`` the JAX kernel's block
    rule (``ref.histogram_block``).  Column j of block i counts the
    valid block-i keys hashing to bucket j."""
    if _build.resolve(backend, keys) == "ref":
        return ref.hash_histogram(keys, valid, n_buckets, salt=salt,
                                  block=block)
    return _hash_histogram_cuda(keys.contiguous(), valid.contiguous(),
                                n_buckets, salt, block)


def bucket_counts(keys: torch.Tensor, valid: torch.Tensor, n_buckets: int,
                  *, salt: int = 0, block: int = 1024,
                  backend: str = "auto") -> torch.Tensor:
    """Global bucket-load histogram of one map-phase shuffle hop:
    (..., N) -> (..., n_buckets) int32.  Its max is the most-loaded
    reducer.  ``block`` shapes only the plain version's per-block
    intermediate; the sums do not depend on it."""
    if _build.resolve(backend, keys) == "ref":
        return ref.hash_histogram(keys, valid, n_buckets, salt=salt,
                                  block=block).sum(-2, dtype=torch.int32)
    return _bucket_counts_cuda(keys.contiguous(), valid.contiguous(),
                               n_buckets, salt)


def partition_offsets(histogram: torch.Tensor) -> torch.Tensor:
    """Exclusive scan over (..., blocks, buckets) histograms -> the
    global write offset of each (block, bucket) run, bucket-major (the
    shuffle send-buffer plan), int32 as in the JAX package."""
    per_bucket = torch.cumsum(histogram.sum(-2, dtype=torch.int32), -1,
                              dtype=torch.int32)
    bucket_base = per_bucket - histogram.sum(-2, dtype=torch.int32)
    within = torch.cumsum(histogram, -2, dtype=torch.int32) - histogram
    return bucket_base.unsqueeze(-2) + within
