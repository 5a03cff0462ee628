"""Physical executor: lower a :class:`JoinQuery` onto a reducer grid.

Port of ``src/repro/core/executor.py`` for this slice:

* :func:`mapside_cascade_chain` — the zero-shuffle cascade over the
  partitioned store (MS,NJ[A]): stored partitions merge-join in place,
  and only unproven hops move tuples;
* :func:`one_round_query` — the Afrati–Ullman *Shares* join on a
  hypercube with one dimension per join attribute (1,NJ; with an
  aggregate, 1,NJA adds a charged aggregation round);
* :func:`cascade_query` / :func:`cascade_chain` — left-deep cascades of
  two-way rounds, the chain form with the paper's aggregation pushdown
  (N−1,NJ and N−1,NJA);
* :func:`shares_skew_chain` — the skew-aware *SharesSkew* union: one
  Shares sub-join per heavy/residual combination of the join
  attributes, each on the plain hypercube with its heavy dims clamped
  to share 1, driven by a :class:`~repro_torch.core.skew.SkewSplitPlan`;
* :func:`execute_chain` / :func:`execute_query` — the entry points, and
  :func:`jit_execute_chain` / :func:`jit_execute_query` — the whole plan
  as one cached executable (a CUDA graph on the GPU);
* input placement (:func:`chain_edge_inputs`, :func:`query_table_inputs`)
  and capacity sizing (``default_*_caps``).

Cost accounting is the paper's: each round charges read + shuffled
tuples, as float32 device scalars; the final aggregator of a pushdown
cascade is uncharged unless ``include_final_agg=True``.
``measure_skew=True`` adds ``stats["max_bucket_load"]``, the
most-loaded reducer of any map-phase hop, from the ``hash_histogram``
kernel.  ``overlap_chunks > 1`` selects the overlapped shuffle schedule
on every strategy: the incoming relation of each round streams through
its shuffle in row chunks, with the staged schedule's stats and
overflow and the JAX package's overlapped output array for array.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..kernels.hash_partition import bucket_counts
from . import hashing
from .aggregation import distributed_groupby_sum, project_product
from .cost_model import ChainStats, chain_replications
from .local import groupby_sum, local_join
from .partition import PartitionedRelation
from .plan import ChainQuery, JoinQuery
from .relation import Relation, concat
from .shuffle import (Grid, ShardGrid, SimGrid, broadcast_along, compact_to,
                      concat_rows, shuffle_by_bucket, split_rows)
from .two_way import two_way_join

Stats = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ChainCaps:
    """Static buffer budgets for one chain-query execution.

    recv:  per-(device, source) slot capacity of every shuffle hop.
    mid:   capacity of each intermediate join result.
    out:   capacity of the final result shard.
    local: per-device resident-shard budget after placement.
    agg:   capacity of each pushed-down aggregate (cascade + pushdown).
    join:  capacity of the raw N-way join when the one-round plan must
           materialize it before aggregating (the paper's r''' term).
    """

    recv: int
    mid: int
    out: int
    local: Optional[int] = None
    agg: Optional[int] = None
    join: Optional[int] = None


def merge_stats(*stats: Stats) -> Stats:
    """Sum read/shuffled across rounds (float32, in round order);
    ``max_bucket_load`` maxes."""
    out: Stats = {}
    for s in stats:
        for k, v in s.items():
            if k == "total":
                continue
            if k not in out:
                out[k] = v
            elif k == "max_bucket_load":
                out[k] = torch.maximum(out[k], v)
            else:
                out[k] = out[k] + v
    out["total"] = out.get("read", 0.0) + out.get("shuffled", 0.0)
    return out


def _count(grid: Grid, rel: Relation) -> torch.Tensor:
    return grid.reduce_sum(rel.count())


def _false(rel: Relation, lead: int = 0) -> torch.Tensor:
    """An overflow flag before any reduction: a scalar, or one per lane
    (``lead = grid.lead``), so a stat that lost its lane axis fails on
    shape instead of standing for every lane."""
    return torch.zeros(rel.valid.shape[:lead], dtype=torch.bool,
                       device=rel.device)


def _zero(rel: Relation, lead: int = 0) -> torch.Tensor:
    """A float32 counter before any reduction, shaped as :func:`_false`."""
    return torch.zeros(rel.valid.shape[:lead], dtype=torch.float32,
                       device=rel.device)


def _hop_load(grid: Grid, rel: Relation, key: str, n_buckets: int,
              salt: int) -> torch.Tensor:
    """Peak per-reducer load of one map-phase hop (the skew diagnostic):
    the global bucket histogram of this hop's hash — per-device
    ``bucket_counts`` (the ``hash_histogram`` kernel on a GPU) summed
    over the grid — and its max (per lane), as float32."""
    hist = bucket_counts(rel.col(key), rel.valid, n_buckets, salt=salt)
    return grid.reduce_sum(hist).amax(-1).to(torch.float32)


# ---------------------------------------------------------------------------
# One-round Shares join on the join-attribute hypercube
# ---------------------------------------------------------------------------

_CLOSE = "_cc_"        # rename prefix for cycle-closing duplicate attrs


def _close_cycle(acc: Relation, extras: Sequence[str]) -> Relation:
    """Apply the closing hop's extra equalities (`attr == _cc_attr`) and
    drop the renamed duplicates."""
    mask = torch.ones_like(acc.valid)
    for a in extras:
        mask = mask & (acc.col(a) == acc.col(_CLOSE + a))
    cols = {n: c for n, c in acc.cols.items()
            if n not in {_CLOSE + a for a in extras}}
    return Relation(cols, acc.valid & mask)


def place_relation(grid: Grid, query: JoinQuery, j: int, rel: Relation, *,
                   caps: ChainCaps, measure_skew: bool = False,
                   ) -> Tuple[Relation, torch.Tensor, torch.Tensor]:
    """The map/placement phase of one relation on the Shares hypercube:
    route to the pinned dims (one shuffle hop per hashed dim), replicate
    over the rest.  Returns (placed shard, overflow, peak bucket load —
    0 unless ``measure_skew``)."""
    overflow = _false(rel, grid.lead)
    skew = _zero(rel, grid.lead)
    cur = rel
    hashed = query.hashed_dims(j)
    for d in hashed:                     # route to the pinned dims
        if grid.shape[d] == 1:
            continue                     # clamped dim: one bucket, no hop
        attr = query.dim_attr(d)
        if measure_skew:
            skew = torch.maximum(
                skew, _hop_load(grid, cur, attr, grid.shape[d], salt=d))
        bucket = hashing.bucket_hash(cur.col(attr), grid.shape[d], salt=d)
        cur, ovf, _ = shuffle_by_bucket(grid, cur, bucket, d, caps.recv,
                                        local_capacity=caps.local)
        overflow = overflow | ovf
    for d in range(query.n_dims):        # replicate over the rest
        if d in hashed or grid.shape[d] == 1:
            continue
        cur, ovf = broadcast_along(grid, cur, d, caps.local)
        overflow = overflow | ovf
    return cur, overflow, skew


def _join_chain(acc: Relation, steps, shard, out_caps: Sequence[int],
                join_impl: str) -> Tuple[Relation, torch.Tensor]:
    """Local joins of ``acc`` along ``steps`` (``(j, key, extras)``; the
    right side of step i is ``shard(j)``, its output at ``out_caps[i]``),
    cycle-closing filters applied at their hop.  Returns (result,
    overflow per device)."""
    ovf = torch.zeros_like(acc.valid[..., 0])
    for i, (j, key, extras) in enumerate(steps):
        right = shard(j)
        if extras:
            right = right.rename({a: _CLOSE + a for a in extras})
        acc, o = local_join(acc, right, key, key, out_caps[i],
                            impl=join_impl)
        ovf = ovf | o
        if extras:
            acc = _close_cycle(acc, extras)
    return acc, ovf


def _reduce_caps(query: JoinQuery, caps: ChainCaps) -> List[int]:
    """Output capacity of each hop of the reduce-side chain: ``mid``,
    then ``out`` (``join`` when an aggregated query must materialize
    the raw join)."""
    n = query.n_relations
    return [caps.mid] * (n - 2) + [caps.join if (query.aggregate and
                                                 caps.join) else caps.out]


def reduce_side_fn(query: JoinQuery, order: Sequence[int], *,
                   caps: ChainCaps, join_impl: str = "sort_merge"):
    """The per-device reduce function of a one-round join: the left-deep
    chain of local joins along ``order``, cycle-closing filters applied
    at their hop.  Returns ``reduce(*shards) -> (acc, overflow)``, with
    the overflow per device."""
    steps = query.join_steps(tuple(order))
    out_caps = _reduce_caps(query, caps)

    def reduce_side(*shards: Relation):
        return _join_chain(shards[order[0]], steps, shards.__getitem__,
                           out_caps, join_impl)

    return reduce_side


def _reduce_split_fns(query: JoinQuery, order: Sequence[int], *,
                      caps: ChainCaps, join_impl: str = "sort_merge"):
    """:func:`reduce_side_fn` split at its last hop, for the overlapped
    one-round schedule: ``head`` runs the chain over every relation but
    ``order[-1]`` (computed once), ``tail(acc, shard)`` applies the
    final join and closing filters (run per placement chunk).  Returns
    ``(js_head, head, tail, final_cap)``, ``js_head`` the relation
    indices ``head`` consumes, in ascending order."""
    steps = query.join_steps(tuple(order))
    out_caps = _reduce_caps(query, caps)
    js_head = tuple(j for j in range(query.n_relations) if j != steps[-1][0])

    def head(*shards: Relation):
        sh = dict(zip(js_head, shards))
        return _join_chain(sh[order[0]], steps[:-1], sh.__getitem__,
                           out_caps, join_impl)

    def tail(acc: Relation, shard: Relation):
        return _join_chain(acc, steps[-1:], lambda _: shard, out_caps[-1:],
                           join_impl)

    return js_head, head, tail, out_caps[-1]


def one_round_query(grid: Grid, query: JoinQuery, rels: Sequence[Relation], *,
                    caps: ChainCaps, join_order: Optional[Sequence[int]] = None,
                    measure_skew: bool = False,
                    join_impl: str = "sort_merge",
                    overlap_chunks: int = 1,
                    ) -> Tuple[Relation, Stats, torch.Tensor]:
    """One MapReduce round: place every relation on the join-attribute
    hypercube, then join locally along ``join_order`` (default: the
    query's greedy connected order).  Shuffled cost is Σ_j r_j · K /
    (∏ shares R_j pins), measured exactly.  An aggregated query ships
    the raw join to the aggregators in one more, charged, round.

    ``overlap_chunks > 1`` selects the overlapped schedule: the last
    relation in the join order streams through placement in that many
    row chunks, each placed and joined against the head of the chain
    (computed once) before the next.  Accounting,
    skew measurement and the overflow condition are the staged
    schedule's; the output is the JAX package's overlapped one."""
    n = query.n_relations
    query.check_relations(rels)
    if len(grid.shape) != query.n_dims:
        raise ValueError(f"a {n}-relation query needs a rank-{query.n_dims} "
                         f"grid, got shape {grid.shape}")

    read = sum(_count(grid, r) for r in rels)
    overflow = _false(rels[0], grid.lead)
    order = tuple(join_order) if join_order is not None \
        else query.default_join_order()

    skew = _zero(rels[0], grid.lead)
    if overlap_chunks <= 1 or n < 2:
        placed: List[Relation] = []
        for j, rel in enumerate(rels):
            cur, ovf, sk = place_relation(grid, query, j, rel, caps=caps,
                                          measure_skew=measure_skew)
            overflow = overflow | ovf
            skew = torch.maximum(skew, sk)
            placed.append(cur)
        # Measured shuffle = tuples resident at reducers after placement
        # (each relation counted with its replication factor).
        received = sum(_count(grid, p) for p in placed)

        reduce_side = reduce_side_fn(query, order, caps=caps,
                                     join_impl=join_impl)
        joined, ovf_j = reduce_side(*placed)
        del placed
        overflow = overflow | grid.reduce_any(ovf_j)
    else:
        # Place every relation but the last in the join order, run the
        # head chain once, then stream the last relation through in row
        # chunks: chunk b+1's placement has no dependency on chunk b's
        # join.  The chunks partition the rows, so received counts and
        # the overflow condition equal the staged schedule's.
        js_head, head, tail, final_cap = _reduce_split_fns(
            query, order, caps=caps, join_impl=join_impl)
        last = order[-1]
        placed_head: Dict[int, Relation] = {}
        for j in js_head:
            cur, ovf, sk = place_relation(grid, query, j, rels[j], caps=caps,
                                          measure_skew=measure_skew)
            overflow = overflow | ovf
            skew = torch.maximum(skew, sk)
            placed_head[j] = cur
        if measure_skew:
            # The last relation's hop histograms, measured on the full
            # input (the staged measurement; a chunk's sees a subset).
            for d in query.hashed_dims(last):
                if grid.shape[d] == 1:
                    continue
                skew = torch.maximum(skew, _hop_load(
                    grid, rels[last], query.dim_attr(d), grid.shape[d],
                    salt=d))
        acc, ovf_h = head(*[placed_head[j] for j in js_head])
        overflow = overflow | grid.reduce_any(ovf_h)
        received = sum(_count(grid, p) for p in placed_head.values())
        del placed_head

        parts: List[Relation] = []
        for chunk in split_rows(rels[last], overlap_chunks):
            pc, ovf_c, _ = place_relation(grid, query, last, chunk, caps=caps)
            received = received + _count(grid, pc)
            out_c, ovf_t = tail(acc, pc)
            overflow = overflow | ovf_c | grid.reduce_any(ovf_t)
            parts.append(out_c)
        del acc
        # Chunk matches are subsets of the staged hop's, so the chunk
        # joins at final_cap cannot overflow unless the staged join
        # would; the compaction reimposes the staged capacity and its
        # overflow condition.
        joined, ovf_cc = compact_to(grid, concat_rows(parts), final_cap)
        del parts
        overflow = overflow | ovf_cc
    stats: Stats = {
        "read": read.to(torch.float32),
        "shuffled": received.to(torch.float32),
    }
    if measure_skew:
        stats["max_bucket_load"] = skew
    if query.aggregate is None:
        return joined, stats, overflow

    # 1,NJA: the raw join (size r''') must be shipped to the aggregator —
    # a charged round, the cost the pushdown cascade avoids.
    agg = query.aggregate
    join_cap = caps.join if caps.join else caps.out
    proj = project_product(grid, joined, keys=agg.keys,
                           value_cols=[v for v in query.values], out_name=agg.out)
    del joined
    out, st_a, ovf_a = distributed_groupby_sum(
        grid, proj, keys=agg.keys, value=agg.out,
        recv_capacity=join_cap, out_capacity=caps.out,
        local_capacity=join_cap)
    return out, merge_stats(stats, st_a), overflow | ovf_a


def one_round_chain(grid: Grid, query: ChainQuery, rels: Sequence[Relation], *,
                    caps: ChainCaps, measure_skew: bool = False,
                    join_impl: str = "sort_merge",
                    overlap_chunks: int = 1,
                    ) -> Tuple[Relation, Stats, torch.Tensor]:
    """The chain instance of :func:`one_round_query` (default join order
    ``0..N−1`` on the rank-(N−1) grid)."""
    return one_round_query(grid, query, rels, caps=caps,
                           measure_skew=measure_skew, join_impl=join_impl,
                           overlap_chunks=overlap_chunks)


# ---------------------------------------------------------------------------
# Left-deep cascade: general queries (cycle-closing filters), then chains
# (with the paper's aggregation pushdown)
# ---------------------------------------------------------------------------

def _final_aggregate(grid: Grid, query: JoinQuery, left: Relation,
                     value_cols: Sequence[str], caps: ChainCaps,
                     local_combine: bool):
    """Γ_{keys; SUM ∏ values} of the cascade's result, every buffer at
    ``caps.out``."""
    agg = query.aggregate
    proj = project_product(grid, left, keys=tuple(agg.keys),
                           value_cols=value_cols, out_name=agg.out)
    return distributed_groupby_sum(
        grid, proj, keys=tuple(agg.keys), value=agg.out,
        recv_capacity=caps.out, out_capacity=caps.out,
        local_capacity=caps.out, local_combine=local_combine)


def cascade_hop(grid: Grid, left: Relation, right: Relation, key: str,
                extras: Sequence[str], *, i: int, last: bool,
                left_cap: Optional[int], caps: ChainCaps,
                join_impl: str = "sort_merge", overlap_chunks: int = 1,
                ) -> Tuple[Relation, Stats, torch.Tensor, int]:
    """Round ``i`` of :func:`cascade_query`: ``left ⋈ right`` on ``key``
    with the round's salt, receive and local buffers grown to the
    previous round's output capacity ``left_cap`` (None in the first
    round), then the cycle-closing filters on ``extras``.  Returns
    (result, stats, overflow, the result's capacity: ``caps.out`` in the
    ``last`` round, else ``caps.mid``).  ``overlap_chunks`` selects the
    round's shuffle schedule (:func:`two_way_join`)."""
    if extras:
        right = right.rename({a: _CLOSE + a for a in extras})
    recv = caps.recv if left_cap is None else max(left_cap, caps.recv)
    local = caps.local if left_cap is None else max(left_cap, caps.recv)
    out_cap = caps.out if last else caps.mid
    out, st, ovf = two_way_join(
        grid, left, right, key, key, recv_capacity=recv,
        out_capacity=out_cap, local_capacity=local, salt=i,
        join_impl=join_impl, overlap_chunks=overlap_chunks)
    if extras:
        out = _close_cycle(out, extras)
    return out, st, ovf, out_cap


def cascade_query(grid: Grid, query: JoinQuery, rels: Sequence[Relation], *,
                  caps: ChainCaps, join_order: Optional[Sequence[int]] = None,
                  local_combine: bool = False, measure_skew: bool = False,
                  join_impl: str = "sort_merge", overlap_chunks: int = 1,
                  ) -> Tuple[Relation, Stats, torch.Tensor]:
    """N−1 rounds of two-way joins along a connected left-deep
    ``join_order`` (default: the query's greedy order).  Further shared
    attributes — the cycle-closing predicates — filter per device at
    their hop; aggregated queries run one final *charged* aggregation
    round.  The measured total equals
    :func:`~repro_torch.core.cost_model.cost_query_cascade` exactly.
    ``overlap_chunks > 1`` runs every round on the overlapped schedule
    (:func:`two_way_join`), with identical accounting and overflow."""
    n = query.n_relations
    query.check_relations(rels)
    order = tuple(join_order) if join_order is not None \
        else query.default_join_order()
    steps = query.join_steps(order)
    k_flat = int(np.prod(grid.shape, dtype=np.int64))

    all_stats: List[Stats] = []
    overflow = _false(rels[0], grid.lead)
    skew = _zero(rels[0], grid.lead)
    left = rels[order[0]]
    left_cap = None                       # None => first round uses caps.recv
    value_cols: List[str] = \
        [query.values[order[0]]] if query.values[order[0]] else []

    for i, (j, key, extras) in enumerate(steps):
        if measure_skew:
            skew = torch.maximum(skew, _hop_load(grid, left, key, k_flat,
                                                 salt=i))
            skew = torch.maximum(skew, _hop_load(grid, rels[j], key, k_flat,
                                                 salt=i))
        left, st, ovf, left_cap = cascade_hop(
            grid, left, rels[j], key, extras, i=i, last=i == n - 2,
            left_cap=left_cap, caps=caps, join_impl=join_impl,
            overlap_chunks=overlap_chunks)
        all_stats.append(st)
        overflow = overflow | ovf
        if query.values[j]:
            value_cols.append(query.values[j])

    if query.aggregate is not None:
        # Final Γ — a charged aggregation round (the 2·|result| term).
        left, st_f, ovf_f = _final_aggregate(grid, query, left, value_cols,
                                             caps, local_combine)
        overflow = overflow | ovf_f
        all_stats.append(st_f)
    stats = merge_stats(*all_stats)
    if measure_skew:
        stats["max_bucket_load"] = skew
    return left, stats, overflow


def cascade_chain(grid: Grid, query: ChainQuery, rels: Sequence[Relation], *,
                  caps: ChainCaps, pushdown: bool = True,
                  local_combine: bool = False, measure_skew: bool = False,
                  include_final_agg: bool = False,
                  join_impl: str = "sort_merge", overlap_chunks: int = 1,
                  ) -> Tuple[Relation, Stats, torch.Tensor]:
    """N−1 rounds of two-way joins, left-deep in query order.

    With an aggregation and ``pushdown=True``, every non-final round is
    followed by Γ_{A_1, A_{j+2}; SUM} of the running value product — the
    paper's 2,3JA generalized; the final aggregator is uncharged unless
    ``include_final_agg=True``.  Without pushdown the aggregation runs
    once at the end and is charged.  ``overlap_chunks`` selects every
    round's shuffle schedule (:func:`two_way_join`).
    """
    n = query.n_relations
    query.check_relations(rels)
    agg = query.aggregate
    if agg is None:
        pushdown = False
    k_flat = int(np.prod(grid.shape, dtype=np.int64))

    all_stats: List[Stats] = []
    overflow = _false(rels[0], grid.lead)
    skew = _zero(rels[0], grid.lead)
    left = rels[0]
    left_cap = None                       # None => first round uses caps.recv
    value_cols: List[str] = [query.values[0]] if query.values[0] else []

    for j in range(1, n):
        key = query.attrs[j]
        recv = caps.recv if left_cap is None else max(left_cap, caps.recv)
        local = caps.local if left_cap is None else max(left_cap, caps.recv)
        out_cap = caps.out if j == n - 1 else caps.mid
        if measure_skew:
            skew = torch.maximum(skew, _hop_load(grid, left, key, k_flat,
                                                 salt=j - 1))
            skew = torch.maximum(skew, _hop_load(grid, rels[j], key, k_flat,
                                                 salt=j - 1))
        left, st, ovf = two_way_join(
            grid, left, rels[j], key, key, recv_capacity=recv,
            out_capacity=out_cap, local_capacity=local, salt=j - 1,
            join_impl=join_impl, overlap_chunks=overlap_chunks)
        all_stats.append(st)
        overflow = overflow | ovf
        left_cap = out_cap
        if query.values[j]:
            value_cols.append(query.values[j])

        if pushdown and j < n - 1:
            # Γ_{A_1, A_{j+2}; SUM prod} — the pushdown round (charged).
            keys = (query.attrs[0], query.attrs[j + 1])
            proj = project_product(grid, left, keys=keys,
                                   value_cols=value_cols, out_name=agg.out)
            agg_cap = caps.agg if caps.agg else caps.mid
            left, st_a, ovf_a = distributed_groupby_sum(
                grid, proj, keys=keys, value=agg.out,
                recv_capacity=left_cap, out_capacity=agg_cap,
                local_capacity=left_cap, local_combine=local_combine)
            all_stats.append(st_a)
            overflow = overflow | ovf_a
            left_cap = agg_cap
            value_cols = [agg.out]

    if agg is not None:
        # Final Γ_{A_1, A_{N+1}; SUM}: the paper's uncharged final
        # aggregator under pushdown (formula 6r+2r'+2r''), the charged
        # round without it or with ``include_final_agg``.
        left, st_f, ovf_f = _final_aggregate(grid, query, left, value_cols,
                                             caps, local_combine)
        overflow = overflow | ovf_f
        if include_final_agg or not pushdown:
            all_stats.append(st_f)
    stats = merge_stats(*all_stats)
    if measure_skew:
        stats["max_bucket_load"] = skew
    return left, stats, overflow


# ---------------------------------------------------------------------------
# SkewSplit lowering: the SharesSkew union of per-combination sub-joins
# ---------------------------------------------------------------------------

def _heavy_member(col: torch.Tensor, heavy) -> torch.Tensor:
    """Membership of a key column in a (small, host-side) heavy set."""
    heavy = np.asarray(heavy)
    if heavy.size == 0:
        return torch.zeros(col.shape, dtype=torch.bool, device=col.device)
    # Compare in the column's own dtype: an int32 cast here would
    # truncate int64 heavy keys and misclassify their tuples.
    hv = torch.as_tensor(heavy, device=col.device).to(col.dtype)
    return torch.isin(col, hv)


def _combo_filter(query: ChainQuery, plan, combo, j: int,
                  rel: Relation) -> Relation:
    """Relation j's part for one combination: keep a tuple iff, for each
    of the relation's own join attributes, its heavy/residual status
    matches the combination's choice for that dim."""
    mask = torch.ones_like(rel.valid)
    for d in query.hashed_dims(j):
        member = _heavy_member(rel.col(query.dim_attr(d)), plan.heavy[d])
        mask = mask & (member if combo.heavy_dims[d] else ~member)
    return rel.filter(mask)


def _flatten_grid(rel: Relation) -> Relation:
    """Collapse the leading grid axes into one flat buffer."""
    return rel.map(lambda c: c.reshape(-1))


def _empty_skew_result(query: ChainQuery, rels: Sequence[Relation],
                       measure_skew: bool):
    """The result of a plan with no combinations: every combination lost
    an input part, which proves the join empty — an empty relation at
    zero cost, keyed in the inputs' own dtypes."""
    zero = _zero(rels[0])
    stats: Stats = {"read": zero, "shuffled": zero, "total": zero}
    if measure_skew:
        stats["max_bucket_load"] = zero
    key_dt: dict = {}
    for j, rel in enumerate(rels):
        for a in query.relations[j]:
            key_dt.setdefault(a, rel.col(a).dtype)
    if query.aggregate is not None:
        schema = {k: key_dt.get(k, config.default_key_dtype())
                  for k in query.aggregate.keys}
        schema[query.aggregate.out] = torch.float32
    else:
        schema = {a: key_dt.get(a, config.default_key_dtype())
                  for a in query.attrs}
        for j, v in enumerate(query.values):
            if v is not None:
                schema[v] = rels[j].col(v).dtype
    return (Relation.empty(1, schema, rels[0].device), stats,
            _false(rels[0]))


def shares_skew_chain(query: ChainQuery, rels: Sequence[Relation], plan, *,
                      caps, measure_skew: bool = False,
                      join_impl: str = "sort_merge", overlap_chunks: int = 1,
                      ) -> Tuple[Relation, Stats, torch.Tensor]:
    """SkewSplit lowering (SharesSkew, 1,NJS): one Shares sub-join per
    heavy/residual combination, unioned.

    ``rels`` are *flat* (unscattered) relations in query order; ``plan``
    is a :class:`~repro_torch.core.skew.SkewSplitPlan`.  Each combination
    filters every relation to its part, scatters the parts onto its own
    ``SimGrid(combo.grid_shape)`` (the plain integer-share hypercube
    with heavy dims clamped to share 1 — heavy tuples are replicated
    over the surviving dims) and runs :func:`one_round_chain`.  ``caps``
    is a :class:`ChainCaps` for every combination, or a callable
    ``combo -> ChainCaps``.

    Results union disjointly across combinations; an aggregated query's
    partial sums merge in a final local group-by, uncharged like the
    paper's final aggregator.  Stats sum across combinations
    (``max_bucket_load`` maxes), so the measured total equals
    ``plan.cost()`` for enumeration and ``plan.cost() + 2·|full join|``
    for aggregated queries.  A plan with no combinations proves the
    join empty: an empty relation at zero cost.  ``overlap_chunks``
    selects each sub-join's schedule (:func:`one_round_query`).
    """
    query.check_relations(rels)
    if not plan.combos:
        return _empty_skew_result(query, rels, measure_skew)
    all_stats: List[Stats] = []
    parts: List[Relation] = []
    overflow = _false(rels[0])
    for combo in plan.combos:
        sub = [scatter_to_grid(_combo_filter(query, plan, combo, j, rel),
                               combo.grid_shape)
               for j, rel in enumerate(rels)]
        combo_caps = caps(combo) if callable(caps) else caps
        out, st, ovf = one_round_chain(SimGrid(combo.grid_shape), query, sub,
                                       caps=combo_caps,
                                       measure_skew=measure_skew,
                                       join_impl=join_impl,
                                       overlap_chunks=overlap_chunks)
        del sub
        parts.append(_flatten_grid(out))
        all_stats.append(st)
        overflow = overflow | ovf

    result = concat(parts)
    del parts
    if query.aggregate is not None:
        agg = query.aggregate
        result, ovf_m = groupby_sum(result, tuple(agg.keys), agg.out)
        overflow = overflow | ovf_m
    return result, merge_stats(*all_stats), overflow


# ---------------------------------------------------------------------------
# Map-side cascade: merge-join stored partitions, shuffle only when unproven
# ---------------------------------------------------------------------------

def _device_layout(rel) -> Tuple[Relation, bool]:
    """Per-device form of a cascade input: a
    :class:`~repro_torch.core.partition.PartitionedRelation`'s ``parts``
    ARE its placement (partition p lives on device p) and are known
    sorted; a plain grid-scattered :class:`Relation` is used as-is,
    unsorted."""
    if isinstance(rel, PartitionedRelation):
        return rel.parts, rel.spec.sorted
    return rel, False


def _place_on_partitions(grid: Grid, rel: Relation, key: str, P: int,
                         salt: int, recv: int, local: int):
    """Repartition ``rel`` by the stored hash ``bucket_hash(key, P,
    salt)`` onto the partition grid.  Returns (relation, overflow)."""
    bucket = hashing.bucket_hash(rel.col(key), P, salt=salt)
    out, ovf, _ = shuffle_by_bucket(grid, rel, bucket, 0, recv,
                                    local_capacity=local)
    return out, ovf


def mapside_cascade_chain(grid: Grid, query: ChainQuery, rels, *,
                          caps: ChainCaps, partitioning, hop_modes,
                          place_output: bool = False,
                          measure_skew: bool = False,
                          join_impl: str = "sort_merge",
                          overlap_chunks: int = 1,
                          ) -> Tuple[Relation, Stats, torch.Tensor]:
    """The zero-shuffle cascade over the partitioned store (MS,NJ[A]).

    ``rels`` mixes :class:`~repro_torch.core.partition.PartitionedRelation`
    inputs (stored hash-partitioned and key-sorted: their ``parts`` feed
    the grid with no placement hop) and grid-scattered plain
    :class:`Relation` inputs, in query order.  ``partitioning`` is the
    :class:`~repro_torch.core.cost_model.ChainPartitioning` certificate
    and ``hop_modes`` the planner's per-hop choice
    (:func:`~repro_torch.core.cost_model.chain_mapside_modes`):

    * ``"mapside"`` — relation j is proven co-partitioned on the hop
      key: the running intermediate repartitions by the *stored* hash
      onto the partition grid — or moves nothing on hop 1 when relation
      0 is pre-partitioned on the first join key (``left0_proven``) —
      and every device merge-joins against its resident partition with
      the stored side's sort skipped (``presorted_r``).  The stored
      relation ships zero tuples.
    * ``"broadcast"`` — relation j replicates to all P devices (charged
      P·|r_j|); the intermediate does not move.
    * ``"shuffle"`` — the ordinary :func:`two_way_join` hop.

    With ``place_output`` each hop's result is repartitioned onto the
    next hop's join key at birth whenever the next hop is proven, so
    every proven hop shuffles exactly zero tuples; that movement is
    reported as ``"placed"`` / ``"hop_placed"`` and charged into
    ``total``.  Shuffled + placed is the same with or without placement.

    Runs on the 1-D partition grid (``grid.shape == (P,)``; a lane axis
    may stand ahead of it).  Stats are read + shuffled per hop, plus
    ``"hop_shuffled"`` (against
    :func:`~repro_torch.core.cost_model.chain_mapside_shuffles`) and
    ``"hop_placed"`` (against
    :func:`~repro_torch.core.cost_model.chain_mapside_placed`), one
    entry per hop on the last axis.  Aggregated queries run one final
    charged Γ round (no pushdown on this path).  ``overlap_chunks``
    selects the shuffled hops' schedule (:func:`two_way_join`); the
    map-side and broadcast hops move no chunked relation.
    """
    n = query.n_relations
    P = partitioning.num_partitions
    if len(grid.shape) != 1 or grid.shape[0] != P:
        raise ValueError(f"map-side cascade needs the 1-D partition grid "
                         f"({P},), got {grid.shape}")
    if len(hop_modes) != n - 1:
        raise ValueError(f"{n - 1} hops need {n - 1} modes, got "
                         f"{len(hop_modes)}")
    for j, mode in enumerate(hop_modes):
        if mode == "mapside" and not partitioning.right_proven[j]:
            raise ValueError(f"hop {j + 1} is not proven co-partitioned; "
                             f"mode 'mapside' would be unsound")
    if (partitioning.key_dtype is not None
            and partitioning.key_dtype != config.key_dtype_name()):
        raise ValueError(
            f"partitioning certificate was minted over "
            f"{partitioning.key_dtype} keys but the current configuration "
            f"uses {config.key_dtype_name()}; the partition hash folds "
            f"64-bit keys, so the stored layout proves nothing here — "
            f"repartition under the current dtype")

    left, left_sorted = _device_layout(rels[0])
    all_stats: List[Stats] = []
    hop_shuffled: List[torch.Tensor] = []
    hop_placed: List[torch.Tensor] = []
    overflow = _false(left, grid.lead)
    skew = _zero(left, grid.lead)
    zero = _zero(left, grid.lead)
    left_on_key = bool(partitioning.left0_proven)
    left_cap = None                       # None => first hop uses caps.recv
    value_cols: List[str] = [query.values[0]] if query.values[0] else []

    for j in range(1, n):
        key = query.attrs[j]
        mode = hop_modes[j - 1]
        right, right_sorted = _device_layout(rels[j])
        recv = caps.recv if left_cap is None else max(left_cap, caps.recv)
        local = caps.local if left_cap is None else max(left_cap, caps.recv)
        out_cap = caps.out if j == n - 1 else caps.mid

        if mode == "shuffle":
            if measure_skew:
                skew = torch.maximum(skew, _hop_load(grid, left, key, P,
                                                     salt=j - 1))
                skew = torch.maximum(skew, _hop_load(grid, right, key, P,
                                                     salt=j - 1))
            left, st, ovf = two_way_join(
                grid, left, right, key, key, recv_capacity=recv,
                out_capacity=out_cap, local_capacity=local, salt=j - 1,
                join_impl=join_impl, overlap_chunks=overlap_chunks)
            all_stats.append(st)
            hop_shuffled.append(st["shuffled"])
            overflow = overflow | ovf
        else:
            read = (_count(grid, left) + _count(grid, right)
                    ).to(torch.float32)
            if mode == "broadcast":
                right, ovf_b = broadcast_along(grid, right, 0, local)
                overflow = overflow | ovf_b
                shuffled = _count(grid, right).to(torch.float32)
                pre_l, pre_r = False, False   # the gather interleaves runs
            else:                             # mapside
                if left_on_key:
                    shuffled = zero           # both sides already in place
                    pre_l = left_sorted
                else:
                    if measure_skew:
                        skew = torch.maximum(skew, _hop_load(
                            grid, left, key, P, salt=partitioning.salt))
                    left, ovf_s = _place_on_partitions(
                        grid, left, key, P, partitioning.salt, recv, local)
                    overflow = overflow | ovf_s
                    shuffled = _count(grid, left).to(torch.float32)
                    pre_l = False
                pre_r = right_sorted
            left, ovf_j = local_join(left, right, key, key, out_cap,
                                     impl=join_impl, presorted_l=pre_l,
                                     presorted_r=pre_r)
            overflow = overflow | grid.reduce_any(ovf_j)
            all_stats.append({"read": read, "shuffled": shuffled})
            hop_shuffled.append(shuffled)

        left_sorted = False
        left_on_key = False
        if place_output and j < n - 1 and hop_modes[j] == "mapside":
            # Land the intermediate already partitioned on the next hop's
            # key (the stored hash) — its one move, made at birth.  Each
            # (dest, source) slot carries ~1/P of a device's share, so
            # out_cap/P-sized slots with the same slack hold it.
            slot = -(-out_cap // P) + 256
            left, ovf_p = _place_on_partitions(
                grid, left, query.attrs[j + 1], P, partitioning.salt, slot,
                out_cap)
            overflow = overflow | ovf_p
            hop_placed.append(_count(grid, left).to(torch.float32))
            left_on_key = True
        else:
            hop_placed.append(zero)
        left_cap = out_cap
        if query.values[j]:
            value_cols.append(query.values[j])

    if query.aggregate is not None:
        left, st_f, ovf_f = _final_aggregate(grid, query, left, value_cols,
                                             caps, local_combine=False)
        overflow = overflow | ovf_f
        all_stats.append(st_f)

    stats = merge_stats(*all_stats)
    stats["hop_shuffled"] = torch.stack(hop_shuffled, -1)
    stats["hop_placed"] = torch.stack(hop_placed, -1)
    stats["placed"] = sum(hop_placed, zero)
    stats["total"] = stats["total"] + stats["placed"]
    if measure_skew:
        stats["max_bucket_load"] = skew
    return left, stats, overflow


# ---------------------------------------------------------------------------
# Entry points: run a logical plan
# ---------------------------------------------------------------------------

def execute_chain(grid: Grid, query: ChainQuery, rels: Sequence[Relation], *,
                  strategy: str, caps: ChainCaps,
                  measure_skew: bool = False, local_combine: bool = False,
                  include_final_agg: bool = False,
                  join_impl: str = "sort_merge",
                  overlap_chunks: int = 1,
                  partitioning=None, hop_modes=None,
                  place_output: bool = False,
                  ) -> Tuple[Relation, Stats, torch.Tensor]:
    """Execute ``query`` with a planner-chosen strategy:

    * ``"one_round"``        — Shares hypercube (1,NJ / 1,NJA)
    * ``"cascade"``          — plain left-deep cascade (N−1,NJ)
    * ``"cascade_pushdown"`` — cascade with aggregation pushdown (N−1,NJA)
    * ``"mapside"``          — merge-join the partitioned store (MS,NJ[A]);
      needs ``partitioning`` (the
      :class:`~repro_torch.core.cost_model.ChainPartitioning`
      certificate) and ``hop_modes`` (``plan.hop_modes``), runs on the
      1-D grid of ``num_partitions`` devices, and takes
      :class:`~repro_torch.core.partition.PartitionedRelation` inputs on
      every proven position (:func:`mapside_cascade_chain`);
      ``place_output`` lands each intermediate on the next proven
      hop's partitions.

    ``join_impl`` selects the reduce-side join for every strategy:
    ``"sort_merge"`` (default), ``"fused"`` (rank-packed sorts and the
    ``probe_counts`` kernel) or the ``"all_pairs"`` oracle — identical
    tuple sets, stats and overflow flags.  ``overlap_chunks > 1``
    selects the overlapped shuffle schedule on every strategy: identical
    accounting and overflow, per-device row order the JAX package's
    overlapped one.  ``measure_skew=True`` adds
    ``stats["max_bucket_load"]``; ``include_final_agg=True`` charges the
    pushdown cascade's final Γ.  Returns ``(result, stats,
    overflow)``; everything stays on the inputs' device.  On a laned
    :class:`SimGrid` the stats and the flag are ``(lanes,)``.

    The skew-aware strategy ``"shares_skew"`` (1,NJS) cannot run on a
    single pre-scattered grid — its sub-joins each use their own clamped
    grid — so it has its own entry point, :func:`shares_skew_chain`,
    taking flat relations plus a ``SkewSplitPlan``.
    """
    if strategy == "mapside":
        if partitioning is None or hop_modes is None:
            raise ValueError("mapside needs partitioning and hop_modes "
                             "(plan with plan_chain(partitioning=...))")
        return mapside_cascade_chain(grid, query, rels, caps=caps,
                                     partitioning=partitioning,
                                     hop_modes=hop_modes,
                                     place_output=place_output,
                                     measure_skew=measure_skew,
                                     join_impl=join_impl,
                                     overlap_chunks=overlap_chunks)
    if strategy == "shares_skew":
        raise ValueError(
            "shares_skew runs per-combination grids; call "
            "shares_skew_chain(query, flat_rels, plan, caps=...) with the "
            "SkewSplitPlan from repro_torch.core.skew.detect_chain_skew")
    if strategy == "one_round":
        return one_round_chain(grid, query, rels, caps=caps,
                               measure_skew=measure_skew,
                               join_impl=join_impl,
                               overlap_chunks=overlap_chunks)
    if strategy == "cascade":
        return cascade_chain(grid, query, rels, caps=caps, pushdown=False,
                             local_combine=local_combine,
                             measure_skew=measure_skew, join_impl=join_impl,
                             overlap_chunks=overlap_chunks)
    if strategy == "cascade_pushdown":
        if query.aggregate is None:
            raise ValueError("cascade_pushdown needs an aggregated query")
        return cascade_chain(grid, query, rels, caps=caps, pushdown=True,
                             local_combine=local_combine,
                             measure_skew=measure_skew,
                             include_final_agg=include_final_agg,
                             join_impl=join_impl,
                             overlap_chunks=overlap_chunks)
    raise ValueError(f"unknown strategy {strategy!r}")


def execute_query(grid: Grid, query: JoinQuery, rels: Sequence[Relation], *,
                  strategy: str, caps: ChainCaps,
                  join_order: Optional[Sequence[int]] = None,
                  measure_skew: bool = False, local_combine: bool = False,
                  include_final_agg: bool = False,
                  join_impl: str = "sort_merge",
                  overlap_chunks: int = 1,
                  ) -> Tuple[Relation, Stats, torch.Tensor]:
    """Execute a general :class:`JoinQuery` — chain, cycle, star, or any
    connected hypergraph — with ``"one_round"``, ``"cascade"`` or (chains
    in relation order only) ``"cascade_pushdown"``.  The skew-aware
    ``"shares_skew"`` strategy stays chain-only — see
    :func:`shares_skew_chain`.  ``overlap_chunks`` selects the shuffle
    schedule, as in :func:`execute_chain`."""
    if strategy == "one_round":
        return one_round_query(grid, query, rels, caps=caps,
                               join_order=join_order,
                               measure_skew=measure_skew,
                               join_impl=join_impl,
                               overlap_chunks=overlap_chunks)
    if strategy == "cascade":
        return cascade_query(grid, query, rels, caps=caps,
                             join_order=join_order,
                             local_combine=local_combine,
                             measure_skew=measure_skew, join_impl=join_impl,
                             overlap_chunks=overlap_chunks)
    if strategy == "cascade_pushdown":
        order = query.chain_attr_order()
        if query.aggregate is None or order is None or order != query.attrs:
            raise ValueError("cascade_pushdown needs an aggregated chain "
                             "query (pushdown between rounds is only sound "
                             "for endpoint aggregates on a chain)")
        return cascade_chain(grid, query, rels, caps=caps, pushdown=True,
                             local_combine=local_combine,
                             measure_skew=measure_skew,
                             include_final_agg=include_final_agg,
                             join_impl=join_impl,
                             overlap_chunks=overlap_chunks)
    if strategy == "shares_skew":
        raise ValueError(
            "shares_skew runs per-combination grids and is chain-only; call "
            "shares_skew_chain(query, flat_rels, plan, caps=...) with the "
            "SkewSplitPlan from repro_torch.core.skew.detect_chain_skew")
    raise ValueError(f"unknown strategy {strategy!r}")


# ---------------------------------------------------------------------------
# Whole-plan compilation: one executable per (plan, caps), a CUDA graph
# on the GPU
# ---------------------------------------------------------------------------

#: Every live compiled executable, so :func:`clear_compiled_caches` can
#: drop their graphs even where a caller (the query engine) still holds
#: the executable itself.
_LIVE: "weakref.WeakSet[CompiledPlan]" = weakref.WeakSet()

#: One graph memory pool per CUDA device, shared by every captured plan.
_POOLS: Dict[torch.device, tuple] = {}

#: Calls of a :class:`CompiledPlan` in progress.  A compiled JAX program
#: never fires a fault (the injector sees tracers); the port runs a
#: compiled plan eagerly on its first call (warm-up, then capture) and,
#: on the CPU, on every call, so a fault injector asks
#: :func:`in_compiled_plan` instead and neither fires nor draws from its
#: RNG while it holds.
_compiled_calls = 0


def in_compiled_plan() -> bool:
    """True while a :class:`CompiledPlan` call runs (capture, replay,
    or the eager call on the CPU)."""
    return _compiled_calls > 0


def _relation(rel) -> Relation:
    """The tensors of an input: a plain :class:`Relation`, or a
    :class:`~repro_torch.core.partition.PartitionedRelation`'s parts."""
    return rel.parts if isinstance(rel, PartitionedRelation) else rel


def input_signature(rels: Sequence) -> Tuple:
    """What a captured graph is specific to: every column's (and the
    mask's) shape and dtype, by name, a partitioned input's spec, and
    the device."""
    def one(rel):
        r = _relation(rel)
        sig = tuple((n, tuple(c.shape), c.dtype)
                    for n, c in sorted(r.cols.items()))
        sig += ((tuple(r.valid.shape), r.valid.dtype),)
        if isinstance(rel, PartitionedRelation):
            sig += (rel.spec,)
        return sig
    return (_relation(rels[0]).device,) + tuple(one(r) for r in rels)


class _Graph:
    """One plan captured as a CUDA graph over static input buffers.

    Capture runs the plan three times over: once eagerly on a side
    stream (kernel libraries are built and loaded, and the kernels'
    cached device queries filled, outside the capture), once under
    capture, and once per later call as a replay.  A replay runs no
    Python, so no wrapper counts its launches in ``_build.LAUNCHES``;
    the device trace does (``kernels.ops.traced_launches``)."""

    def __init__(self, fn, rels: Sequence):
        device = _relation(rels[0]).device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            fn(rels)
        torch.cuda.current_stream(device).wait_stream(side)
        # Static inputs live outside the graph pool, so no plan's
        # intermediates can alias them.  A partitioned input stays one
        # (its spec tells the plan its parts are sorted).
        self.inputs = [r.map(torch.clone) for r in rels]
        pool = _POOLS.get(device)
        if pool is None:
            pool = _POOLS[device] = torch.cuda.graph_pool_handle()
        # The captured graph is kept beside its executable, so its
        # nodes can be read (``raw_cuda_graph``).
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        # torch.cuda.graph synchronizes and empties the allocator's
        # cache first, which returns the warm-up's memory for the pool
        # to grow into.
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = fn(self.inputs)
        except BaseException:
            # A failed capture can leave the allocator recording into
            # the pool ("already recording to mempool_id" on the next
            # capture): later graphs start a fresh pool.
            _POOLS.pop(device, None)
            raise
        self.graph.instantiate()

    def replay(self, rels: Sequence[Relation]):
        """Copy ``rels`` in, replay, and return clones of the outputs.

        Every graph of a device shares one memory pool, so the cache
        costs the largest graph's intermediates, not their sum.  That is
        safe because replays run one at a time on one stream, the inputs
        live outside the pool, and the outputs are cloned as soon as the
        replay is enqueued: another graph's replay may reuse the static
        outputs' memory only after these clones have been taken."""
        for static, rel in zip(self.inputs, rels):
            static, rel = _relation(static), _relation(rel)
            static.valid.copy_(rel.valid)
            for n, c in static.cols.items():
                c.copy_(rel.cols[n])
        self.graph.replay()
        out, stats, overflow = self.outputs
        return (out.map(torch.clone),
                {k: v.clone() for k, v in stats.items()}, overflow.clone())


class CompiledPlan:
    """The executable of one plan: ``run(rels) -> (Relation, stats,
    overflow)``, like ``execute_*``.

    On a CUDA device the first call for an input signature (shapes,
    dtypes, device) captures the whole ``execute_*`` call as a CUDA
    graph (:class:`_Graph`); every later call copies the inputs in,
    replays, and returns clones of the outputs, so a result stays valid
    after the next replay.  A capture or replay error raises: there is
    no eager fallback.  On the CPU (a caller that asked for it) a call
    is the eager ``execute_*`` call.  On a :class:`ShardGrid` every rank
    calls it: the capture takes the plan's ``nccl`` collectives into the
    graph; a grid over another backend raises a ``ValueError`` on CUDA
    tensors.  ``grid``, ``query``, ``strategy``,
    ``caps``, ``opts`` and ``donate`` are the plan it was compiled for.
    """

    def __init__(self, grid: Grid, query: JoinQuery, strategy: str,
                 caps: ChainCaps, opts: Tuple, donate: bool, chain: bool):
        self.grid, self.query, self.strategy = grid, query, strategy
        self.caps, self.opts, self.donate = caps, dict(opts), donate
        self.chain = chain
        self._graphs: Dict[Tuple, _Graph] = {}
        _LIVE.add(self)

    def _execute(self, rels: Sequence[Relation]):
        fn = execute_chain if self.chain else execute_query
        return fn(self.grid, self.query, list(rels), strategy=self.strategy,
                  caps=self.caps, **self.opts)

    def __call__(self, rels: Sequence):
        global _compiled_calls
        rels = list(rels)
        _compiled_calls += 1
        try:
            if not _relation(rels[0]).valid.is_cuda:
                return self._execute(rels)
            if (isinstance(self.grid, ShardGrid)
                    and self.grid.backend != "nccl"):
                raise ValueError(
                    f"a plan on a ShardGrid over the {self.grid.backend!r} "
                    f"backend cannot be captured into a CUDA graph with "
                    f"CUDA tensors (only nccl collectives capture); run "
                    f"execute_chain / execute_query eagerly on it")
            sig = input_signature(rels)
            graph = self._graphs.get(sig)
            if graph is None:
                graph = _Graph(self._execute, rels)
                self._graphs[sig] = graph
            return graph.replay(rels)
        finally:
            _compiled_calls -= 1

    def with_lanes(self, lanes: int) -> "CompiledPlan":
        """The same plan over ``SimGrid(grid.shape, lanes=lanes)``: one
        execution of ``lanes`` stacked inputs (the query engine's
        batches), from the same program cache."""
        if not isinstance(self.grid, SimGrid):
            raise ValueError("lanes need a SimGrid")
        jit = jit_execute_chain if self.chain else jit_execute_query
        return jit(SimGrid(self.grid.shape, lanes=lanes), self.query,
                   strategy=self.strategy, caps=self.caps,
                   donate=self.donate, **self.opts)

    def reset(self) -> None:
        """Drop every captured graph and its static buffers."""
        self._graphs.clear()


@functools.lru_cache(maxsize=128)
def _compiled_sim(grid_shape: Tuple[int, ...], lanes: int, query: JoinQuery,
                  strategy: str, caps: ChainCaps, opts: Tuple, donate: bool,
                  chain: bool) -> CompiledPlan:
    return CompiledPlan(SimGrid(grid_shape, lanes=lanes), query, strategy,
                        caps, opts, donate, chain)


@functools.lru_cache(maxsize=32)
def _compiled_grid(grid: Grid, query: JoinQuery, strategy: str,
                   caps: ChainCaps, opts: Tuple, donate: bool,
                   chain: bool) -> CompiledPlan:
    # A ShardGrid hashes by identity: the cache holds per-instance
    # programs (one long-lived grid object per rank).
    return CompiledPlan(grid, query, strategy, caps, opts, donate, chain)


def _compiled(grid: Grid, query: JoinQuery, strategy: str, caps: ChainCaps,
              donate: bool, opts: dict, chain: bool) -> CompiledPlan:
    opts_key = tuple(sorted(opts.items()))
    if isinstance(grid, SimGrid):
        return _compiled_sim(grid.shape, grid.lanes, query, strategy, caps,
                             opts_key, donate, chain)
    return _compiled_grid(grid, query, strategy, caps, opts_key, donate,
                          chain)


def jit_execute_chain(grid: Grid, query: ChainQuery, *, strategy: str,
                      caps: ChainCaps, donate: bool = True, **opts
                      ) -> CompiledPlan:
    """Compile the *entire* chain-query execution into one executable.

    Returns ``run(rels) -> (Relation, Stats, overflow)`` — the whole
    lowering (every shuffle hop, local join, and aggregation round)
    captured once as a CUDA graph and replayed as a unit, instead of
    dispatching each hop's ops from the host (see :class:`CompiledPlan`;
    on the CPU it runs eagerly).  Because every buffer is static-shape,
    the executable is reusable for any inputs of the same capacities.
    Executables are cached so repeated calls with the same plan skip
    recapture: for :class:`SimGrid` the key is (grid *shape*, lanes,
    query, strategy, caps, options, ``donate``) — any equal SimGrid
    hits; for other grids the key uses the grid *instance*.

    ``donate`` is accepted and keyed as in the JAX package; the port
    copies the inputs into its own buffers and never reads the caller's
    tensors after the call, so donating or not changes nothing else.
    Options (``measure_skew``, ``local_combine``, ``include_final_agg``,
    ``join_impl``, ``overlap_chunks``, and the map-side ``partitioning``
    / ``hop_modes`` / ``place_output``) forward to :func:`execute_chain`
    and are part of the cache key.
    """
    return _compiled(grid, query, strategy, caps, donate, opts, chain=True)


def jit_execute_query(grid: Grid, query: JoinQuery, *, strategy: str,
                      caps: ChainCaps, donate: bool = True, **opts
                      ) -> CompiledPlan:
    """Compile an *entire* general-query execution into one executable
    — :func:`jit_execute_chain` lifted to :class:`JoinQuery` (same
    caching, donation, and reuse semantics).  Options (``join_order``,
    ``measure_skew``, ``local_combine``, ``join_impl``) forward to
    :func:`execute_query`; a ``join_order`` list must be passed as a
    tuple (the cache key hashes it).  ``include_final_agg`` and
    ``overlap_chunks`` forward too."""
    return _compiled(grid, query, strategy, caps, donate, opts, chain=False)


def clear_compiled_caches() -> None:
    """Drop every cached whole-plan executable (:func:`jit_execute_chain`
    / :func:`jit_execute_query`) and every captured graph, also those of
    executables a caller still holds, so that
    ``torch.cuda.empty_cache()`` can return the graph pool.  The serving
    benchmark uses this to measure a genuinely cold plan+capture."""
    _compiled_sim.cache_clear()
    _compiled_grid.cache_clear()
    for plan in list(_LIVE):
        plan.reset()
    _POOLS.clear()


# ---------------------------------------------------------------------------
# Input placement and capacity sizing
# ---------------------------------------------------------------------------

def scatter_to_grid(rel: Relation, grid_shape: Sequence[int]) -> Relation:
    """Mapper placement of a flat relation: rows split into contiguous
    per-device blocks, every column reshaped to (*grid_shape,
    rows_per_device)."""
    shape = tuple(grid_shape)
    n_dev = int(np.prod(shape, dtype=np.int64))
    per = -(-rel.capacity // n_dev)
    pad = per * n_dev - rel.capacity
    return rel.map(lambda c: torch.cat([c, c.new_zeros(pad)]).reshape(
        *shape, per))


def chain_edge_inputs(query: ChainQuery, edge_lists,
                      grid_shape: Sequence[int], device=None
                      ) -> List[Relation]:
    """Edge lists -> scattered per-relation inputs named by the query
    schema (requires a value column on every relation), on ``device``
    (default: the GPU; raises when there is none)."""
    from .matmul import edge_relation
    device = config.resolve_device(device)
    rels = []
    for j, (src, dst) in enumerate(edge_lists):
        a, b, v = query.schema(j)
        rels.append(scatter_to_grid(
            edge_relation(src, dst, names=(a, b, v), device=device),
            grid_shape))
    return rels


def query_table_inputs(query: JoinQuery, tables, grid_shape: Sequence[int],
                       key_dtype=None, device=None) -> List[Relation]:
    """Column tables -> scattered per-relation inputs named by the query
    schema.  ``tables[j]`` is a tuple of equal-length key columns
    matching relation j's attributes, optionally followed by a value
    column; a ones value column is synthesized when the schema asks for
    one.  ``key_dtype`` defaults to the configured key dtype, ``device``
    to the GPU."""
    device = config.resolve_device(device)
    key_dtype = config.default_key_dtype() if key_dtype is None else key_dtype
    rels = []
    for j, cols in enumerate(tables):
        names = query.schema(j)
        arity = len(query.relations[j])
        if len(cols) not in (arity, len(names)):
            raise ValueError(f"relation {j} needs {arity} key columns "
                             f"(+ optional value), got {len(cols)}")
        arrays = {names[i]: torch.as_tensor(np.asarray(c), dtype=key_dtype,
                                            device=device)
                  for i, c in enumerate(cols[:arity])}
        if query.values[j] is not None:
            val = (torch.as_tensor(np.asarray(cols[arity]),
                                   dtype=torch.float32, device=device)
                   if len(cols) > arity
                   else torch.ones_like(arrays[names[0]], dtype=torch.float32))
            arrays[query.values[j]] = val
        rels.append(scatter_to_grid(Relation.from_arrays(**arrays),
                                    grid_shape))
    return rels


def default_query_caps(query: JoinQuery, stats, grid_shape: Sequence[int],
                       slack: int = 6) -> ChainCaps:
    """Size ChainCaps for a general query from exact
    :class:`~repro_torch.core.cost_model.QueryStats`: every buffer gets
    its expected per-device share times a skew-slack factor; join
    buffers hold the largest raw per-hop join over the candidate
    orders."""
    from .cost_model import query_replications
    n_dev = 1
    for s in grid_shape:
        n_dev *= s

    def per(total):
        return int(total * slack / n_dev) + 256

    repl = max(query_replications(query.rel_dims(), grid_shape)) \
        if len(grid_shape) == query.n_dims else 1.0
    biggest = max(max(stats.sizes),
                  max((h for hops in stats.hop_joins for h in hops),
                      default=0.0))
    return ChainCaps(
        recv=per(max(stats.sizes) * repl),
        mid=per(biggest), out=per(biggest),
        local=per(max(stats.sizes) * repl),
        agg=per(stats.agg_groups or 256.0),
        join=per(biggest))


def default_chain_caps(stats: ChainStats, grid_shape: Sequence[int],
                       slack: int = 6) -> ChainCaps:
    """Size ChainCaps from exact statistics: each buffer gets its
    expected per-device share times a skew-slack factor."""
    n_dev = 1
    for s in grid_shape:
        n_dev *= s

    def per(total):
        return int(total * slack / n_dev) + 256

    repl = max(chain_replications(stats.sizes, grid_shape)) \
        if len(grid_shape) == len(stats.sizes) - 1 else 1.0
    biggest = max(max(stats.sizes), max(stats.prefix_joins),
                  max(stats.pushdown_joins or (0.0,)))
    return ChainCaps(
        recv=per(max(stats.sizes) * repl),
        mid=per(biggest), out=per(biggest),
        local=per(max(stats.sizes) * repl),
        agg=per(max(stats.prefix_aggs or (256.0,))),
        join=per(stats.prefix_joins[-1]))


def default_mapside_caps(stats: ChainStats, num_partitions: int,
                         slack: int = 6) -> ChainCaps:
    """Size ChainCaps for :func:`mapside_cascade_chain`: base relations
    never leave their stored partitions on proven hops, so mid/out hold
    the per-device share of the intermediates; recv/local keep
    base-relation sizing for the hops that do move tuples."""

    def per(total):
        return int(total * slack / num_partitions) + 256

    inter = per(max(stats.prefix_joins))
    return ChainCaps(
        recv=per(max(stats.sizes)), mid=inter, out=inter,
        local=per(max(stats.sizes)),
        agg=per(max(stats.prefix_aggs or (256.0,))),
        join=per(stats.prefix_joins[-1]))
