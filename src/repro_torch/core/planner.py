"""Cost-based planner — the paper's decision procedure, generalized.

Port: a copy of ``src/repro/core/planner.py`` (pure Python/numpy); the
skew sketch comes from the port's ``core/skew.py``.

Given cardinality statistics for an N-way chain and the cluster size,
enumerate the physical plans the executor can run —

  * one-round Shares join on the (N−1)-dim hypercube   (1,NJ / 1,NJA)
  * left-deep cascade of two-way rounds                (N−1,NJ)
  * cascade with aggregation pushdown                  (N−1,NJA)

— price each with the analytic cost model, and pick the cheapest.  The
paper's three-way rules fall out as the N=3 special case (asserted in
tests/test_cost_model.py):

* enumeration only: 1,3J below the crossover k*, else 2,3J;
* aggregation needed: 2,3JA is "the preferred solution" (its cost is
  flat in k while 1,3JA grows as 2r√k) — we evaluate both and pick by
  cost, which reduces to the paper's rule.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .cost_model import (ChainPartitioning, ChainStats, JoinStats,
                         QueryStats, chain_mapside_modes,
                         cost_chain_mapside, cost_chain_one_round,
                         cost_chain_shares_skew, cost_query_cascade,
                         cost_query_one_round, crossover_reducers,
                         estimate_join_size, estimate_skew_combos,
                         integer_shares, integer_shares_query,
                         optimal_shares_chain, optimal_shares_query,
                         sketch_heavy_entries, skew_excess_cascade,
                         skew_excess_mapside, skew_excess_one_round)


# ---------------------------------------------------------------------------
# N-way chain planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """A priced, executable choice for one chain query.

    ``algorithm`` uses the paper's naming (``1,4J``, ``3,4JA``, ...,
    plus ``1,NJS``/``1,NJSA`` for the skew-aware SharesSkew variant);
    ``strategy`` is the executor entry point; ``grid_shape`` is the
    integer share vector a one-round execution should use (cascades
    ignore it; the SharesSkew lowering clamps it per combination).

    When the statistics carry a key-frequency sketch with at least one
    key above the balance threshold, ``skew_detected`` is True and the
    choice is made on ``adjusted_costs`` — communication plus the
    straggler penalty ``k · Σ hop excess`` (see docs/skew.md); ``costs``
    stays pure communication in the paper's units either way.

    With a :class:`~repro.core.cost_model.ChainPartitioning` certificate
    (stored inputs are hash-partitioned and sorted — docs/storage.md),
    the map-side cascade ``MS,NJ[A]`` joins the candidates:
    ``partitioning`` echoes the certificate, ``hop_modes`` the per-hop
    physical choice (``mapside`` / ``broadcast`` / ``shuffle``), and a
    map-side winner's ``grid_shape`` is the 1-D ``(num_partitions,)``
    grid its executor lowering runs on.  Without a certificate both
    fields stay None and planning is bit-for-bit the historical rule.
    """

    algorithm: str
    strategy: str                  # executor strategy name
    k: int
    shares: Tuple[float, ...]      # optimal real-valued Shares vector
    grid_shape: Tuple[int, ...]    # executable integer shares (∏ ≤ k)
    costs: Dict[str, float]
    crossover_k: Optional[float]   # enumeration crossover k* (exact, any N)
    skew_detected: bool = False
    adjusted_costs: Optional[Dict[str, float]] = None
    partitioning: Optional[ChainPartitioning] = None
    hop_modes: Optional[Tuple[str, ...]] = None

    @property
    def predicted_cost(self) -> float:
        return self.costs[self.algorithm]


def _strategy_of(algorithm: str) -> str:
    if algorithm.startswith("MS,"):
        return "mapside"
    if "JS" in algorithm:
        return "shares_skew"
    if algorithm.startswith("1,"):
        return "one_round"
    return "cascade_pushdown" if algorithm.endswith("JA") else "cascade"


def crossover_reducers_chain(stats: ChainStats) -> float:
    """k* where the one-round plan's cost overtakes the cascade's —
    the N-way generalization of the paper's Fig. 3 crossover, found by
    bisection (cost_chain_one_round is strictly increasing in k once
    every share is active).  Returns ``inf`` if one-round never loses."""
    from .cost_model import cost_chain_cascade
    target = cost_chain_cascade(stats.sizes, stats.prefix_joins)
    lo, hi = 1.0, 2.0
    while cost_chain_one_round(stats.sizes, int(hi)) < target:
        hi *= 2.0
        if hi > 2 ** 60:
            return float("inf")
    for _ in range(80):
        mid = (lo + hi) / 2.0
        if cost_chain_one_round(stats.sizes, mid) < target:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2.0


def plan_chain(stats: ChainStats, k: int, aggregate: bool, *,
               skew_slack: float = 1.25,
               partitioning: Optional[ChainPartitioning] = None,
               broadcast_threshold: Optional[float] = None) -> ChainPlan:
    """Choose the cheapest physical plan for an N-way chain.

    Arguments:
      stats:      :class:`ChainStats` cardinalities.  If its
                  ``key_freqs`` top-k sketch is present and some key
                  exceeds the balance threshold (``skew_slack · r_j /
                  k_d`` on the integer Shares grid), the skew-aware
                  SharesSkew plan joins the candidate set and all
                  candidates are compared on *skew-adjusted* cost —
                  communication plus ``k ·`` the analytic peak-over-mean
                  hop excess (the straggler that sets round wall-clock;
                  docs/skew.md derives the model).  Without a sketch, or
                  when nothing crosses the threshold (uniform data), the
                  choice is the paper's pure-communication rule and
                  SharesSkew is never selected.
      k:          reducer budget (the paper's cluster size).
      aggregate:  price the aggregated variants (``..JA``/``..JSA``;
                  requires ``prefix_aggs`` and the full-join size in
                  ``prefix_joins[-1]``) instead of plain enumeration.
      skew_slack: balance-threshold slack factor (a key is heavy when
                  it alone exceeds ``slack`` fair reducer slices).
      partitioning: optional :class:`ChainPartitioning` certificate
                  (from ``repro.core.partition.chain_partitioning``)
                  proving which hops can merge-join stored partitions
                  with zero shuffle.  Adds the map-side cascade
                  ``MS,{N}J[A]`` candidate, priced by
                  :func:`~repro.core.cost_model.cost_chain_mapside`
                  with its greedy per-hop mode choice.  None (the
                  default) keeps planning bit-for-bit historical.
      broadcast_threshold: optional cap on the right-side size eligible
                  for a broadcast hop; None compares pure cost.

    Returns a :class:`ChainPlan`: the chosen ``algorithm`` (paper
    naming), the matching executor ``strategy``, the real-valued and
    integer Shares vectors, every candidate's cost (and adjusted cost
    when skew was detected), plus the enumeration crossover ``k*``.
    """
    n = stats.n_relations
    shares = optimal_shares_chain(stats.sizes, k)
    grid_shape = integer_shares(stats.sizes, k)
    costs = stats.costs(k, aggregate, shares=shares)
    suffix = "A" if aggregate else ""
    candidates = [f"{n - 1},{n}J{suffix}", f"1,{n}J{suffix}"]

    hop_modes = None
    ms_alg = None
    if partitioning is not None:
        hop_modes = chain_mapside_modes(stats.sizes, stats.prefix_joins,
                                        partitioning, broadcast_threshold)
        ms_alg = f"MS,{n}J{suffix}"
        costs[ms_alg] = cost_chain_mapside(stats.sizes, stats.prefix_joins,
                                           partitioning, hop_modes)
        if aggregate:
            # The map-side cascade has no sound pushdown (aggregation
            # re-keys the intermediate); the final Γ round is charged.
            costs[ms_alg] += 2.0 * stats.prefix_joins[-1]
        candidates.append(ms_alg)

    heavy = sketch_heavy_entries(stats, grid_shape, skew_slack)
    skew_detected = any(heavy)
    adjusted = None
    if skew_detected:
        combos = estimate_skew_combos(stats, grid_shape, heavy)
        skew_alg = f"1,{n}JS{suffix}"
        costs[skew_alg] = cost_chain_shares_skew(combos)
        if aggregate:
            costs[skew_alg] += 2.0 * stats.prefix_joins[-1]
        candidates.append(skew_alg)
        excess = {
            f"1,{n}J{suffix}": skew_excess_one_round(stats, grid_shape),
            f"{n - 1},{n}J{suffix}": skew_excess_cascade(stats, k),
            skew_alg: skew_excess_one_round(stats, grid_shape, heavy),
        }
        if ms_alg is not None:
            excess[ms_alg] = skew_excess_mapside(stats, partitioning,
                                                 hop_modes)
        adjusted = {a: costs[a] + k * excess[a] for a in candidates}
        algorithm = min(candidates, key=lambda a: adjusted[a])
    else:
        algorithm = min(candidates, key=lambda a: costs[a])
    if algorithm == ms_alg:
        # The map-side lowering runs one device per stored partition.
        grid_shape = (partitioning.num_partitions,)
    return ChainPlan(
        algorithm=algorithm,
        strategy=_strategy_of(algorithm),
        k=k,
        shares=shares,
        grid_shape=grid_shape,
        costs=costs,
        crossover_k=crossover_reducers_chain(stats),
        skew_detected=skew_detected,
        adjusted_costs=adjusted,
        partitioning=partitioning,
        hop_modes=hop_modes,
    )


def skew_crossover_scale(stats: ChainStats, k: int, *,
                         skew_slack: float = 1.25,
                         max_scale: float = 64.0) -> float:
    """Skew-sensitive crossover: the smallest multiplier ``s`` on the
    sketch's key frequencies at which the planner's skew-adjusted cost
    of SharesSkew drops below plain Shares — the modeled skew threshold
    of docs/skew.md.  ``s = 1`` means the workload is already past it;
    ``inf`` means SharesSkew never wins within ``max_scale``.  Found by
    bisection on the (monotone in s) cost gap."""
    if stats.key_freqs is None:
        return float("inf")
    n = stats.n_relations

    def scaled(s: float) -> ChainStats:
        kf = tuple(tuple((key, fl * s, fr * s) for key, fl, fr in entries)
                   for entries in stats.key_freqs)
        return dataclasses.replace(stats, key_freqs=kf)

    def skew_wins(s: float) -> bool:
        plan = plan_chain(scaled(s), k, aggregate=False,
                          skew_slack=skew_slack)
        if not plan.skew_detected:
            return False
        adj = plan.adjusted_costs
        return adj[f"1,{n}JS"] < adj[f"1,{n}J"]

    if skew_wins(1.0):
        hi, lo = 1.0, 0.0
    elif skew_wins(max_scale):
        lo, hi = 1.0, max_scale
    else:
        return float("inf")
    for _ in range(50):
        mid = (lo + hi) / 2.0
        if skew_wins(mid):
            hi = mid
        else:
            lo = mid
    return (lo + hi) / 2.0


def chain_stats_exact(edges, sketch_top_k: Optional[int] = None) -> ChainStats:
    """Exact ChainStats for a chain of edge-list relations, via sparse
    path-count products on the host (same trick as
    ``self_join_stats_exact``).

    ``edges`` is a sequence of (src, dst) int arrays, one per relation
    in chain order.  ``prefix_joins[i]`` = Σ of the path-count matrix
    M_{i+2} = A_1·..·A_{i+2}; ``prefix_aggs[i]`` = nnz(M_{i+2}).

    With ``sketch_top_k`` set, the returned stats also carry the top-k
    key-frequency sketch (``key_freqs``) that lets :func:`plan_chain`
    price skew and consider the SharesSkew plan.

    The JAX package multiplies dicts of dicts; this copy multiplies
    numpy COO matrices (node ids ranked densely, entries keyed
    ``row·n + col``) and gives the same numbers.
    """
    srcs = [np.asarray(s).astype(np.int64).reshape(-1) for s, _ in edges]
    dsts = [np.asarray(d).astype(np.int64).reshape(-1) for _, d in edges]
    sizes = tuple(float(len(s)) for s in srcs)
    nodes = np.unique(np.concatenate(srcs + dsts))
    n = max(len(nodes), 1)

    def coo(src, dst):
        """(unique row·n + col keys, their multiplicities)."""
        keys = np.searchsorted(nodes, src) * n + np.searchsorted(nodes, dst)
        return np.unique(keys, return_counts=True)

    mats = [coo(s, d) for s, d in zip(srcs, dsts)]
    cur_keys, cur_vals = mats[0]
    prefix_joins, prefix_nnz, pushdown_joins = [], [], []
    for step, (nxt_keys, nxt_vals) in enumerate(mats[1:]):
        nxt_rows = nxt_keys // n
        if step >= 1:
            # Pushdown round output: each nnz entry of Γ(prefix) pairs
            # with every matching next-relation tuple.
            deg = np.bincount(nxt_rows, weights=nxt_vals, minlength=n)
            pushdown_joins.append(float(deg[cur_keys % n].sum()))
        r_order, lo, cnt = _matches(cur_keys % n, nxt_rows)
        total = int(cnt.sum())
        li = np.repeat(np.arange(len(cur_keys)), cnt)
        ri = r_order[np.repeat(lo, cnt) + np.arange(total)
                     - np.repeat(np.cumsum(cnt) - cnt, cnt)]
        paths = cur_vals[li] * nxt_vals[ri]
        keys = (cur_keys[li] // n) * n + nxt_keys[ri] % n
        cur_keys, inverse = np.unique(keys, return_inverse=True)
        cur_vals = np.bincount(inverse.reshape(-1), weights=paths,
                               minlength=len(cur_keys)).astype(np.int64)
        prefix_joins.append(float(paths.sum()))
        prefix_nnz.append(float(len(cur_keys)))
    key_freqs = None
    if sketch_top_k is not None:
        from .skew import chain_key_sketch
        key_freqs = chain_key_sketch(edges, top_k=sketch_top_k)
    return ChainStats(sizes=sizes, prefix_joins=tuple(prefix_joins),
                      prefix_aggs=tuple(prefix_nnz[:-1]),
                      pushdown_joins=tuple(pushdown_joins[:-1]) or None,
                      key_freqs=key_freqs)


# ---------------------------------------------------------------------------
# General hypergraph planning (cycles, stars, cliques — plan_query)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """A priced, executable choice for one general join query.

    ``algorithm`` keeps the paper's rounds-relations naming (``1,3J``
    for the one-round triangle, ``2,3J`` for its cascade, ``..A``
    aggregated, ``..JS`` skew-aware); ``strategy`` is the
    ``execute_query`` strategy; ``grid_shape`` the integer share vector
    for a one-round execution (one dim per join *attribute* now, not
    per chain position); ``join_order`` the left-deep reduce-side /
    cascade order the executor should follow.  When the query is a
    chain, planning delegates to :func:`plan_chain` unchanged and the
    full :class:`ChainPlan` rides along as ``chain_plan`` (including
    skew detection and the SharesSkew candidate)."""

    algorithm: str
    strategy: str
    k: int
    shares: Tuple[float, ...]
    grid_shape: Tuple[int, ...]
    join_order: Tuple[int, ...]
    costs: Dict[str, float]
    chain_plan: Optional[ChainPlan] = None

    @property
    def predicted_cost(self) -> float:
        return self.costs[self.algorithm]


def plan_query(query, stats: QueryStats, k: int, *,
               skew_slack: float = 1.25) -> QueryPlan:
    """Choose the cheapest physical plan for a general join query.

    Candidates:

    * one-round Shares on the full hypercube (one dim per join
      attribute, shares from :func:`optimal_shares_query` /
      :func:`integer_shares_query`);
    * the best left-deep cascade over ``stats.orders`` (cycle-closing
      predicates are free reduce-side filters, so an order's cost is
      the plain cascade formula over its post-filter intermediates);
      aggregated queries add the charged final aggregation round
      ``2·|result|`` — pushdown is only sound for chains;
    * for chain queries (``stats.chain`` present and the hypergraph is
      a path) the whole decision — including cascade+pushdown and the
      skew-aware SharesSkew candidate — delegates to
      :func:`plan_chain`, whose behavior is unchanged.
    """
    n = query.n_relations
    agg = query.aggregate is not None
    if stats.chain is not None and query.chain_attr_order() is not None:
        cp = plan_chain(stats.chain, k, aggregate=agg, skew_slack=skew_slack)
        return QueryPlan(algorithm=cp.algorithm, strategy=cp.strategy, k=k,
                         shares=cp.shares, grid_shape=cp.grid_shape,
                         join_order=tuple(range(n)), costs=cp.costs,
                         chain_plan=cp)
    rel_dims = query.rel_dims()
    shares = optimal_shares_query(rel_dims, stats.sizes, k)
    grid_shape = integer_shares_query(rel_dims, stats.sizes, k)
    order, cascade_cost = stats.best_order()
    suffix = "A" if agg else ""
    one_cost = cost_query_one_round(rel_dims, stats.sizes, k, shares)
    if agg:
        # Both strategies materialize the raw result and ship it to the
        # final (charged) aggregation round.
        one_cost += 2.0 * stats.full_output
        cascade_cost += 2.0 * stats.full_output
    # At n=2 both candidates are one round of two relations and share
    # the paper name "1,2J" — the dict keeps the cheaper; the strategy
    # choice below still compares both costs.
    candidates = [(f"1,{n}J{suffix}", "one_round", one_cost),
                  (f"{n - 1},{n}J{suffix}", "cascade", cascade_cost)]
    costs: Dict[str, float] = {}
    for name, _, c in candidates:
        costs[name] = min(costs.get(name, float("inf")), c)
    algorithm, strategy, _ = min(candidates, key=lambda t: t[2])
    return QueryPlan(algorithm=algorithm, strategy=strategy, k=k,
                     shares=shares, grid_shape=grid_shape,
                     join_order=tuple(order), costs=costs)


def _connected_orders(query, max_relations: int = 6):
    """Every connected left-deep order of the query's relations (each
    prefix shares an attribute with the next relation).  Beyond
    ``max_relations`` relations, only the default greedy order — the
    factorial enumeration is for experiment-scale queries."""
    import itertools
    n = query.n_relations
    if n > max_relations:
        return [query.default_join_order()]
    attr_sets = [set(r) for r in query.relations]
    orders = []
    for perm in itertools.permutations(range(n)):
        seen = set(attr_sets[perm[0]])
        ok = True
        for j in perm[1:]:
            if not (seen & attr_sets[j]):
                ok = False
                break
            seen |= attr_sets[j]
        if ok:
            orders.append(perm)
    return orders


def query_stats_exact(query, tables, *, sketch_top_k: Optional[int] = None,
                      ) -> QueryStats:
    """Exact QueryStats for a general join query, by simulating every
    connected left-deep order with host-side joins (the general
    counterpart of :func:`chain_stats_exact`).

    ``tables`` is one entry per relation: a tuple of equal-length int
    column arrays matching the relation's attribute tuple (a value
    column may ride along at the end and is ignored here — statistics
    count tuples).  For every order the simulation records the per-hop
    raw join sizes (``hop_joins``) and the post-filter intermediates
    (cycle-closing predicates applied at their hop), plus the aggregate
    group count when the query aggregates.  Chain queries additionally
    get the :class:`ChainStats` view (prefix joins, aggregated
    intermediates, optional ``sketch_top_k`` skew sketch) so
    :func:`plan_query` can delegate to the chain planner.

    The JAX package joins Python tuples; this copy joins numpy columns
    (sorted keys and ``searchsorted``) and gives the same numbers.  A
    hop's result is only built where a later hop or the aggregate reads
    it, so a graph's 3-paths are counted, not listed.
    """
    n = query.n_relations
    if len(tables) != n:
        raise ValueError(f"query has {n} relations, got {len(tables)} tables")
    cols = []
    for j, table in enumerate(tables):
        arity = len(query.relations[j])
        key_cols = [np.asarray(c) for c in table[:arity]]
        if len(key_cols) != arity or any(len(c) != len(key_cols[0])
                                         for c in key_cols):
            raise ValueError(f"relation {j} needs {arity} equal-length key "
                             f"columns")
        cols.append({a: c.astype(np.int64) for a, c
                     in zip(query.relations[j], key_cols)})
    sizes = tuple(float(len(next(iter(c.values())))) for c in cols)

    agg_keys = tuple(query.aggregate.keys) if query.aggregate else ()
    orders, intermediates, hop_joins = [], [], []
    agg_groups = None
    for order in _connected_orders(query):
        acc, inter, raw = _run_order(query, cols, order,
                                     keep=agg_keys if not orders else ())
        if query.aggregate is not None and not orders:
            keys = np.stack([acc[a] for a in agg_keys], 1)
            agg_groups = float(len(np.unique(keys, axis=0)))
        orders.append(tuple(order))
        intermediates.append(tuple(inter))
        hop_joins.append(tuple(raw))

    chain = None
    if query.chain_attr_order() is not None:
        edge_lists = [(np.asarray(table[0]), np.asarray(table[1]))
                      for table in tables]
        chain = chain_stats_exact(edge_lists, sketch_top_k=sketch_top_k)
    return QueryStats(sizes=sizes, orders=tuple(orders),
                      intermediates=tuple(intermediates),
                      hop_joins=tuple(hop_joins), agg_groups=agg_groups,
                      chain=chain)


def _key_ids(left, right):
    """Equal ids for equal key tuples on the two sides: the one key
    column itself, or the mixed-radix number of each column's dense
    rank."""
    if len(left) == 1:
        return left[0], right[0]
    ids = np.zeros(len(left[0]) + len(right[0]), np.int64)
    for lc, rc in zip(left, right):
        uniq, rank = np.unique(np.concatenate([lc, rc]), return_inverse=True)
        ids = ids * len(uniq) + rank.reshape(-1)
        # every rank < len(uniq) <= rows, so no product of ranks
        # overflows before rows**columns does
    return ids[:len(left[0])], ids[len(left[0]):]


def _matches(lid, rid):
    """Per left row, the run of right rows with an equal id: (right
    rows sorted by id, run start, run length)."""
    r_order = np.argsort(rid, kind="stable")
    uniq, start, count = np.unique(rid[r_order], return_index=True,
                                   return_counts=True)
    if not len(uniq):
        zero = np.zeros(len(lid), np.int64)
        return r_order, zero, zero
    pos = np.minimum(np.searchsorted(uniq, lid), len(uniq) - 1)
    hit = uniq[pos] == lid
    return (r_order, np.where(hit, start[pos], 0),
            np.where(hit, count[pos], 0))


def _run_order(query, cols, order, keep=()):
    """Multiplicity-preserving host joins along one left-deep order:
    joins on the first shared attribute, applies the remaining shared
    attributes (cycle-closing predicates) as per-hop filters.  Returns
    (the final result's ``keep`` columns, post-filter intermediate
    sizes, raw pre-filter join sizes); the columns of a hop are built
    only where a later hop reads them."""
    acc = dict(cols[order[0]])
    inter, raw = [], []
    for h, j in enumerate(order[1:]):
        last = h == len(order) - 2
        right = cols[j]
        shared = [a for a in query.relations[j] if a in acc]
        raw.append(float(_matches(acc[shared[0]], right[shared[0]])[2].sum()))
        lid, rid = _key_ids([acc[a] for a in shared],
                            [right[a] for a in shared])
        r_order, lo, cnt = _matches(lid, rid)
        total = int(cnt.sum())
        inter.append(float(total))
        if last and not keep:
            return {}, inter, raw
        li = np.repeat(np.arange(len(lid)), cnt)
        ri = r_order[np.repeat(lo, cnt) + np.arange(total)
                     - np.repeat(np.cumsum(cnt) - cnt, cnt)]
        new = {a: right[a][ri] for a in query.relations[j] if a not in acc}
        names = keep if last else acc
        acc = {a: acc[a][li] for a in names if a in acc}
        acc.update({a: c for a, c in new.items() if not last or a in keep})
    return acc, inter, raw


# ---------------------------------------------------------------------------
# Three-way compatibility surface (the paper's original interface)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Plan:
    algorithm: str                 # "1,3J" | "2,3J" | "1,3JA" | "2,3JA"
    k: int
    costs: Dict[str, float]
    crossover_k: float

    @property
    def predicted_cost(self) -> float:
        return self.costs[self.algorithm]


def self_join_stats(src: np.ndarray, dst: np.ndarray) -> JoinStats:
    """Stats for A ⋈ A ⋈ A over edge list A(src, dst): R=S=T=A with
    R(a,b)=A, S(b,c)=A, T(c,d)=A.  |R⋈S| = Σ_x indeg(x)·outdeg(x)."""
    n = float(len(src))
    j1 = estimate_join_size(dst, src)
    return JoinStats(r=n, s=n, t=n, j1=j1)


def self_join_stats_exact(src: np.ndarray, dst: np.ndarray) -> JoinStats:
    """Full stats including a1=|Γ(A⋈A)| (=nnz(A²)) and j3=|A⋈A⋈A| via a
    sparse matmul on the host.  Used by benchmarks to drive the planner
    with exact numbers (feasible at experiment scales)."""
    n = float(len(src))
    j1 = estimate_join_size(dst, src)
    # Dict-of-rows sparse bool product for nnz(A^2) and Σ path counts.
    from collections import defaultdict
    out_adj = defaultdict(list)
    for s_, d_ in zip(src.tolist(), dst.tolist()):
        out_adj[s_].append(d_)
    a2 = {}
    for a, mids in out_adj.items():
        row = defaultdict(int)
        for b in mids:
            for c in out_adj.get(b, ()):  # noqa: B905
                row[c] += 1
        if row:
            a2[a] = row
    a1 = float(sum(len(row) for row in a2.values()))
    j3 = 0.0
    for a, row in a2.items():
        for c, mult in row.items():
            j3 += mult * len(out_adj.get(c, ()))
    return JoinStats(r=n, s=n, t=n, j1=j1, a1=a1, j3=j3)


def chain_stats_from_three_way(stats: JoinStats) -> ChainStats:
    """Bridge the paper's JoinStats to the N-way statistics object."""
    prefix_joins = (stats.j1, stats.j3 if stats.j3 is not None else float("nan"))
    prefix_aggs = (stats.a1,) if stats.a1 is not None else None
    return ChainStats(sizes=(stats.r, stats.s, stats.t),
                      prefix_joins=prefix_joins, prefix_aggs=prefix_aggs)


def plan_three_way(stats: JoinStats, k: int, aggregate: bool) -> Plan:
    """The paper's decision procedure — now the N=3 instance of
    :func:`plan_chain` (same algorithm names, same conclusions)."""
    chain = plan_chain(chain_stats_from_three_way(stats), k, aggregate)
    return Plan(algorithm=chain.algorithm, k=k, costs=chain.costs,
                crossover_k=crossover_reducers(stats.r, stats.s, stats.t,
                                               stats.j1))
