"""Distributed two-way hash join — the building block of the 2,3J cascade.

Port of ``src/repro/core/two_way.py``, the staged and the overlapped
schedule.  The map phase emits ``(h(b), tuple)`` — a local hash
partition plus a shuffle to the device owning bucket ``h(b)`` — and the
reduce phase is the per-device ``local_join``.  Each round charges the
tuples read by the mappers plus the tuples shuffled to reducers, as the
paper does.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import hashing
from .local import local_join
from .relation import Relation
from .shuffle import (Grid, compact_to, concat_rows, shuffle_by_bucket,
                      split_rows)


def flat_grid_bucket(grid: Grid, key: torch.Tensor, salt: int = 0
                     ) -> Tuple[torch.Tensor, ...]:
    """Hash a key column into one bucket index per grid axis, such that
    the flattened bucket enumerates all k = prod(grid.shape) devices."""
    k_total = 1
    for s in grid.shape:
        k_total *= s
    rem = hashing.bucket_hash(key, k_total, salt=salt)
    idxs = []
    for s in reversed(grid.shape):
        idxs.append(rem % s)
        rem = rem // s
    return tuple(reversed(idxs))


def shuffle_to_device(grid: Grid, rel: Relation, key: str, recv_capacity: int,
                      salt: int = 0, local_capacity: int | None = None):
    """Route every tuple to the unique device owning hash(key) — one hop
    per grid axis, the receive buffers compacted to ``local_capacity``
    after each hop."""
    overflow = torch.zeros(rel.valid.shape[:grid.lead], dtype=torch.bool,
                           device=rel.device)
    cur = rel
    for axis in range(len(grid.shape)):
        bucket = flat_grid_bucket(grid, cur.col(key), salt=salt)[axis]
        cur, ovf, _ = shuffle_by_bucket(grid, cur, bucket, axis, recv_capacity,
                                        local_capacity=local_capacity)
        overflow = overflow | ovf
    return cur, overflow


def two_way_join(grid: Grid, left: Relation, right: Relation,
                 left_key: str, right_key: str, *,
                 recv_capacity: int, out_capacity: int,
                 local_capacity: int | None = None,
                 prefix_l: str = "", prefix_r: str = "",
                 salt: int = 0, join_impl: str = "sort_merge",
                 overlap_chunks: int = 1,
                 ) -> Tuple[Relation, Dict[str, torch.Tensor], torch.Tensor]:
    """R ⋈ S on left_key == right_key across the whole grid.

    Returns (per-device join shards, stats, overflow); ``stats`` counts
    ``read`` (map input) and ``shuffled`` (map output received by
    reducers) in tuples, as float32 device scalars.  ``join_impl``
    selects the reduce-side join (``sort_merge``, ``fused``,
    ``all_pairs``).

    ``overlap_chunks > 1`` selects the overlapped schedule: the right
    side is split into that many row blocks (:func:`~repro_torch.core.
    shuffle.split_rows`), each shuffled at the full ``recv_capacity``
    and joined against the resident left shard at ``out_capacity``, one
    block after another on the current stream.  The blocks
    partition the rows, so ``stats`` and the overflow condition are the
    staged schedule's; the output is the chunks' results concatenated
    in order and compacted to ``out_capacity``, the JAX package's
    overlapped output array for array.
    """
    n_left = grid.reduce_sum(left.count())
    n_right = grid.reduce_sum(right.count())
    left_s, ovf_l = shuffle_to_device(grid, left, left_key, recv_capacity,
                                      salt, local_capacity)

    def join(right_s: Relation):
        return local_join(left_s, right_s, left_key, right_key,
                          out_capacity, prefix_l=prefix_l,
                          prefix_r=prefix_r, impl=join_impl)

    received = grid.reduce_sum(left_s.count())
    if overlap_chunks <= 1:
        right_s, ovf_r = shuffle_to_device(grid, right, right_key,
                                           recv_capacity, salt,
                                           local_capacity)
        joined, ovf_j = join(right_s)
        overflow = ovf_l | ovf_r | grid.reduce_any(ovf_j)
        received = received + grid.reduce_sum(right_s.count())
    else:
        overflow = ovf_l
        parts = []
        for chunk in split_rows(right, overlap_chunks):
            chunk_s, ovf_c = shuffle_to_device(grid, chunk, right_key,
                                               recv_capacity, salt,
                                               local_capacity)
            received = received + grid.reduce_sum(chunk_s.count())
            out_c, ovf_j = join(chunk_s)
            overflow = overflow | ovf_c | grid.reduce_any(ovf_j)
            parts.append(out_c)
        # Per-chunk matches are a subset of the full hop's, so the chunk
        # joins at out_capacity cannot overflow unless the staged hop
        # would; the final compaction reimposes the staged capacity and
        # its overflow condition (total matches > out_capacity).
        joined, ovf_cc = compact_to(grid, concat_rows(parts), out_capacity)
        overflow = overflow | ovf_cc
    stats = {
        "read": (n_left + n_right).to(torch.float32),
        "shuffled": received.to(torch.float32),
    }
    return joined, stats, overflow
