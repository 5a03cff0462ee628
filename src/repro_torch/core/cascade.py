"""2,3J and 2,3JA — the cascade of two-way joins (paper §IV–V).

Port of ``src/repro/core/cascade.py``.

2,3J:  J1 = R ⋈ S (round 1), then J1 ⋈ T (round 2).
2,3JA: J1 = R ⋈ S, AGG1 = Γ_{a,c; sum v·w}(J1)  ← aggregation *pushdown*,
       J2 = AGG1 ⋈ T, (final aggregation Γ_{a,d; sum p·x}).

The pushdown is the paper's key practical finding: because join and
group-by commute here (sum of products distributes over the join on c),
aggregating the intermediate result shrinks everything downstream.

Cost accounting (paper-faithful): every round charges read+shuffle; the
*final* output (and, matching the paper's formula 6r+2r'+2r'', the final
aggregator of 2,3JA) is not charged unless ``include_final_agg=True``.

These are the N=3 entry points into the chain-join engine
(:mod:`repro_torch.core.executor`); here the paper's query shape and
capacities are pinned.  ``join_impl`` selects the reduce-side join, as
in :func:`~repro_torch.core.executor.execute_chain`.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .executor import ChainCaps, cascade_chain, one_round_chain
from .plan import ChainQuery
from .relation import Relation
from .shuffle import Grid

Result = Tuple[Relation, Dict[str, torch.Tensor], torch.Tensor]


def cascade_three_way(grid: Grid, R: Relation, S: Relation, T: Relation, *,
                      recv_capacity: int, mid_capacity: int, out_capacity: int,
                      local_capacity: int | None = None,
                      join_impl: str = "sort_merge") -> Result:
    """2,3J: plain cascade, enumerating the raw three-way join."""
    return cascade_chain(
        grid, ChainQuery.three_way(), (R, S, T),
        caps=ChainCaps(recv=recv_capacity, mid=mid_capacity,
                       out=out_capacity, local=local_capacity),
        pushdown=False, join_impl=join_impl)


def cascade_three_way_agg(grid: Grid, R: Relation, S: Relation, T: Relation, *,
                          recv_capacity: int, mid_capacity: int,
                          agg_capacity: int, out_capacity: int,
                          local_capacity: int | None = None,
                          local_combine: bool = False,
                          include_final_agg: bool = False,
                          join_impl: str = "sort_merge") -> Result:
    """2,3JA: cascade with aggregation pushed into the intermediate result.

    Computes  Γ_{a,d; SUM}( R ⋈ S ⋈ T )  with value product v·w·x —
    join-based matrix multiplication A·B·C restricted to the tuples
    present (paper §II).  Returns the aggregated relation (a, d, p).
    """
    return cascade_chain(
        grid, ChainQuery.three_way(aggregate=True), (R, S, T),
        caps=ChainCaps(recv=recv_capacity, mid=mid_capacity,
                       out=out_capacity, local=local_capacity,
                       agg=agg_capacity),
        pushdown=True, local_combine=local_combine,
        include_final_agg=include_final_agg, join_impl=join_impl)


def one_round_three_way_agg(grid: Grid, R: Relation, S: Relation, T: Relation,
                            *, recv_capacity: int, mid_capacity: int,
                            join_capacity: int, out_capacity: int,
                            local_capacity: int | None = None,
                            join_impl: str = "sort_merge") -> Result:
    """1,3JA: the one-round join followed by a (charged) aggregation round.

    The paper's point: 1,3J must materialize the FULL raw join (size
    r''') and ship it to the aggregator — cost +2·r''' — whereas 2,3JA
    shrank the data before round 2.
    """
    return one_round_chain(
        grid, ChainQuery.three_way(aggregate=True), (R, S, T),
        caps=ChainCaps(recv=recv_capacity, mid=mid_capacity,
                       out=out_capacity, local=local_capacity,
                       join=join_capacity),
        join_impl=join_impl)
