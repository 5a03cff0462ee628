"""Join-based sparse matrix multiplication and graph analytics (paper §II).

Port of ``src/repro/core/matmul.py``.  A sparse matrix is a relation
M(row, col, val).  One join + group-by = one matmul; the three-way
self-join + aggregation = A³ restricted to listed entries —
friend-of-friend path counts; its diagonal / 3 is the triangle count.

Triangle counting is *a query, not an algorithm*: the primary path
(:func:`triangle_count_cycle`) plans and executes ``JoinQuery.triangle()``
— the cyclic R(a,b) ⋈ S(b,c) ⋈ T(c,a) — through the general engine.
The chain+filter path (enumerate the full 3-chain via :func:`a_cubed`,
then keep the ``a == d`` diagonal with :func:`triangle_count_from_a3`,
wrapped as :func:`triangle_count_chain_filter`) is kept as the
engine-level oracle the cycle path is checked against, alongside the
host-side :func:`oracle_triangles`.

Tensors are built on the GPU unless the caller passes ``device``.
:func:`triangle_count_cycle` and :func:`triangle_count_chain_filter`
return a Python float, as the JAX package does: they run whole
workloads, never inside a captured plan, and are the only functions of
``core/`` besides ``partition.verify_partition_layout`` that wait on
the device.  :func:`triangle_count_from_a3` stays a device tensor.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

import numpy as np
import torch

from .. import config
from .aggregation import distributed_groupby_sum, project_product
from .relation import Relation
from .shuffle import Grid
from .two_way import two_way_join

Result = Tuple[Relation, Dict[str, torch.Tensor], torch.Tensor]


def edge_relation(src, dst, val=None, capacity=None,
                  names=("a", "b", "v"), key_dtype=None,
                  device=None) -> Relation:
    """Edge list -> relation with attribute names (a, b, v) by default, on
    ``device`` (default: the GPU).  ``key_dtype`` defaults to the
    configured key dtype."""
    device = config.resolve_device(device)
    key_dtype = config.default_key_dtype() if key_dtype is None else key_dtype
    src = torch.as_tensor(np.asarray(src), dtype=key_dtype, device=device)
    dst = torch.as_tensor(np.asarray(dst), dtype=key_dtype, device=device)
    v = (torch.ones_like(src, dtype=torch.float32) if val is None else
         torch.as_tensor(np.asarray(val), dtype=torch.float32, device=device))
    return Relation.from_arrays(capacity,
                                **{names[0]: src, names[1]: dst, names[2]: v})


def spmm(grid: Grid, A: Relation, B: Relation, *, recv_capacity: int,
         mid_capacity: int, out_capacity: int,
         local_capacity: int | None = None,
         join_impl: str = "sort_merge") -> Result:
    """C = A·B via join + aggregation.  A has cols (a,b,v); B (b,c,w).
    Output relation (a, c, p) with p = Σ_b v·w, on the inputs' device."""
    j, st, ovf = two_way_join(grid, A, B, "b", "b",
                              recv_capacity=recv_capacity,
                              out_capacity=mid_capacity,
                              local_capacity=local_capacity,
                              join_impl=join_impl)
    proj = project_product(grid, j, keys=("a", "c"), value_cols=("v", "w"))
    out, st_a, ovf_a = distributed_groupby_sum(
        grid, proj, keys=("a", "c"), value="p",
        recv_capacity=mid_capacity, out_capacity=out_capacity,
        local_capacity=mid_capacity)
    stats = {k: st[k] + st_a[k] for k in st}
    return out, stats, ovf | ovf_a


def a_cubed(grid: Grid, src, dst, *, algorithm: str, caps: Dict[str, int],
            join_impl: str = "sort_merge", device=None) -> Result:
    """Path-counting A³ over edge list A via the chosen algorithm
    ("2,3JA" cascade-with-pushdown or "1,3JA" one-round), on ``device``
    (default: the GPU)."""
    from .cascade import cascade_three_way_agg, one_round_three_way_agg
    from .executor import scatter_to_grid

    cap_in = caps["input"]
    R, S, T = (scatter_to_grid(edge_relation(src, dst, capacity=cap_in,
                                             names=names, device=device),
                               grid.shape)
               for names in (("a", "b", "v"), ("b", "c", "w"),
                             ("c", "d", "x")))
    local = caps.get("local")
    if algorithm == "2,3JA":
        return cascade_three_way_agg(
            grid, R, S, T, recv_capacity=caps["recv"],
            mid_capacity=caps["mid"], agg_capacity=caps["agg"],
            out_capacity=caps["out"], local_capacity=local,
            join_impl=join_impl)
    if algorithm == "1,3JA":
        return one_round_three_way_agg(
            grid, R, S, T, recv_capacity=caps["recv"],
            mid_capacity=caps["mid"], join_capacity=caps["join"],
            out_capacity=caps["out"], local_capacity=local,
            join_impl=join_impl)
    raise ValueError(f"unknown algorithm {algorithm!r}")


def triangle_count_from_a3(a3: Relation) -> torch.Tensor:
    """#triangles = Σ_{a=d} p(a,d) / 3 for a directed cycle count — the
    paper's diagonal rule (each directed 3-cycle is counted at each of
    its 3 starting nodes).  A float32 device scalar, summed over every
    leading axis.  With :func:`a_cubed` this is the chain+filter path,
    the engine-level oracle of :func:`triangle_count_cycle`."""
    diag = (a3.col("a") == a3.col("d")) & a3.valid
    return torch.where(diag, a3.col("p"), 0.0).sum() / 3.0


def triangle_count_cycle(src, dst, *, k: int = 8,
                         strategy: "str | None" = None,
                         caps_slack: int = 6, join_impl: str = "sort_merge",
                         device=None):
    """Count directed 3-cycles by *running the triangle query*: plan
    ``JoinQuery.triangle()`` over three copies of the edge list, execute
    the planner's strategy on a :class:`SimGrid` on ``device`` (default:
    the GPU), and divide the result tuple count by 3 (each cycle appears
    once per rotation).

    ``strategy`` overrides the planner's choice (``"one_round"`` runs
    the cycle-Shares hypercube with its integer shares; ``"cascade"``
    the two-round cascade with the closing ``a ==`` filter at the
    second hop).

    Returns ``(count, plan, stats, overflow)`` — count as a Python float
    (a host sync), the :class:`~repro_torch.core.planner.QueryPlan`, the
    measured communication stats and the overflow flag (callers should
    assert it is False; capacities come from ``default_query_caps``
    with ``caps_slack``).
    """
    from .executor import default_query_caps, execute_query, query_table_inputs
    from .plan import JoinQuery
    from .planner import plan_query, query_stats_exact
    from .shuffle import SimGrid

    query = JoinQuery.triangle()
    tables = [(src, dst)] * 3
    stats = query_stats_exact(query, tables)
    plan = plan_query(query, stats, k)
    strategy = strategy or plan.strategy
    grid_shape = plan.grid_shape if strategy == "one_round" else (max(k, 1),)
    rels = query_table_inputs(query, tables, grid_shape, device=device)
    caps = default_query_caps(query, stats, grid_shape, slack=caps_slack)
    out, st, ovf = execute_query(SimGrid(grid_shape), query, rels,
                                 strategy=strategy, caps=caps,
                                 join_order=plan.join_order,
                                 join_impl=join_impl)
    count = float(out.valid.sum()) / 3.0
    return count, plan, st, ovf


def triangle_count_chain_filter(grid: Grid, src, dst, *,
                                algorithm: str = "2,3JA",
                                caps: Dict[str, int],
                                join_impl: str = "sort_merge", device=None):
    """The chain+filter oracle path: compute A³'s listed entries with
    the chosen three-way algorithm, then take the diagonal / 3 (a host
    sync).  Returns (count, stats, overflow)."""
    a3, stats, ovf = a_cubed(grid, src, dst, algorithm=algorithm, caps=caps,
                             join_impl=join_impl, device=device)
    return float(triangle_count_from_a3(a3)), stats, ovf


# ---------------------------------------------------------------------------
# Host-side oracles (tests / planner ground truth)
# ---------------------------------------------------------------------------

def oracle_a3(src, dst) -> Dict[Tuple[int, int], float]:
    """Dense-dict A³ on the host."""
    adj = defaultdict(list)
    for s_, d_ in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
        adj[s_].append(d_)
    out: Dict[Tuple[int, int], float] = defaultdict(float)
    for a, bs in adj.items():
        for b in bs:
            for c in adj.get(b, ()):
                for d in adj.get(c, ()):
                    out[(a, d)] += 1.0
    return dict(out)


def oracle_triangles(src, dst) -> float:
    a3 = oracle_a3(src, dst)
    return sum(v for (a, d), v in a3.items() if a == d) / 3.0
