"""1,3J — the Afrati–Ullman one-round three-way join on a k1×k2 grid.

Port of ``src/repro/core/one_round.py``.  R(A,B,V) ⋈ S(B,C,W) ⋈ T(C,D,X):

* S tuples go to the single device ``(h(b), g(c))``           (cost s)
* R tuples go to the whole row    ``(h(b), *)``               (cost k2·r)
* T tuples go to the whole column ``(*, g(c))``               (cost k1·t)

Total paper cost: (r+s+t) reads + (s + k1·t + k2·r) shuffled; minimized
at k1=√(kr/t), k2=√(kt/r) giving r+2s+t+2√(k·r·t).

This module is the N=3 entry point into the chain-join engine:
:func:`repro_torch.core.executor.one_round_chain` runs the same
placement for any chain length on a hypercube of rank N−1; here the
paper's query shape and capacity conventions are pinned.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .executor import ChainCaps, one_round_chain
from .plan import ChainQuery
from .relation import Relation
from .shuffle import Grid


def one_round_three_way(grid: Grid, R: Relation, S: Relation, T: Relation, *,
                        recv_capacity: int, mid_capacity: int,
                        out_capacity: int,
                        local_capacity: int | None = None,
                        join_impl: str = "sort_merge",
                        ) -> Tuple[Relation, Dict[str, torch.Tensor],
                                   torch.Tensor]:
    """Compute the three-way join in one round on a 2-D grid.

    recv_capacity:  per-(device,source) slot capacity for each shuffle hop.
    local_capacity: per-device reducer memory budget — each relation's
                    resident shard (S at one device; R replicated per row;
                    T per column) is compacted to this size.
    mid_capacity:   capacity of the per-device R'⋈S' intermediate.
    out_capacity:   capacity of the per-device three-way output shard.
    join_impl:      the reduce-side join (``"sort_merge"``, ``"fused"``
                    or the ``"all_pairs"`` oracle), as in
                    :func:`~repro_torch.core.executor.execute_chain`.
    """
    if len(grid.shape) != 2:
        raise ValueError("1,3J requires a 2-D (k1, k2) grid")
    return one_round_chain(
        grid, ChainQuery.three_way(), (R, S, T),
        caps=ChainCaps(recv=recv_capacity, mid=mid_capacity,
                       out=out_capacity, local=local_capacity),
        join_impl=join_impl)
