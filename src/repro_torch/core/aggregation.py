"""Distributed group-by aggregation (paper §V).

Port of ``src/repro/core/aggregation.py``.  The aggregator is itself a
MapReduce round: map emits ``((group keys), p)``, the shuffle routes
groups to their owning reducer, reduce sums.  Charged: read |input| +
shuffle |input| (the paper's ``2·|input|``), unless the combiner
(``local_combine``, a beyond-paper option) shrinks the shuffled side.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from . import hashing
from .local import groupby_sum
from .relation import Relation
from .shuffle import Grid, shuffle_by_bucket


def distributed_groupby_sum(grid: Grid, rel: Relation, keys: Sequence[str],
                            value: str, *, recv_capacity: int,
                            out_capacity: int, local_capacity: int | None = None,
                            local_combine: bool = False,
                            ) -> Tuple[Relation, Dict[str, torch.Tensor],
                                       torch.Tensor]:
    """SUM(value) GROUP BY keys across the grid: groups are routed by
    hashing the key tuple, one hop per grid axis, then every device
    aggregates its complete groups with the single-pass
    :func:`repro_torch.core.local.groupby_sum`."""
    keys = tuple(keys)
    n_in = grid.reduce_sum(rel.count())
    overflow = torch.zeros(rel.valid.shape[:grid.lead], dtype=torch.bool,
                           device=rel.device)

    cur = rel
    if local_combine:
        cur, ovf_c = groupby_sum(cur, keys, value)
        overflow = overflow | grid.reduce_any(ovf_c)

    def key_bucket(r: Relation, n_buckets: int, salt: int) -> torch.Tensor:
        mixed = r.col(keys[0])
        for i, k in enumerate(keys[1:]):
            mixed = mixed ^ hashing.bucket_hash(r.col(k), 1 << 30, salt=2 + i)
        return hashing.bucket_hash(mixed, n_buckets, salt=salt)

    for axis in range(len(grid.shape)):
        if grid.shape[axis] == 1:
            continue  # clamped axis: a single owner, the hop is a no-op
        bucket = key_bucket(cur, grid.shape[axis], salt=axis)
        cur, ovf, _ = shuffle_by_bucket(grid, cur, bucket, axis, recv_capacity,
                                        local_capacity=local_capacity)
        overflow = overflow | ovf

    shuffled = grid.reduce_sum(cur.count())
    agg, ovf_a = groupby_sum(cur, keys, value, out_capacity)
    overflow = overflow | grid.reduce_any(ovf_a)
    stats = {
        "read": n_in.to(torch.float32),
        "shuffled": shuffled.to(torch.float32),
    }
    return agg, stats, overflow


def project_product(grid: Grid, rel: Relation, keys: Sequence[str],
                    value_cols: Sequence[str], out_name: str = "p") -> Relation:
    """Map phase of the aggregator: emit (keys, prod(value_cols)) —
    e.g. ((a,c), v·w) for matrix multiplication."""
    del grid  # per-device work: the same on every device
    p = torch.ones_like(rel.col(value_cols[0]), dtype=torch.float32)
    for vc in value_cols:
        p = p * rel.col(vc).to(torch.float32)
    cols = {k: rel.col(k) for k in keys}
    cols[out_name] = p
    return Relation(cols, rel.valid)
