"""Pass 1 — the static plan checker: certify a plan before it runs.

A copy of ``src/repro/analysis/plan_verifier.py`` over the port's
cost model, planner output and partition manifests; its findings equal
the JAX package's on the same plan.

Given a query, its statistics, the planner's chosen plan and the
capacity budgets the executor will run under, verify — without
executing anything — that the plan is *sound* (grid covers the join
attributes, cycle-closing filters present, certificates consistent
with the runtime configuration) and *adequately provisioned* (capacity
arithmetic, int32 pair-index headroom, replication-rate floor).  Every
check emits :class:`~repro_torch.analysis.report.Finding`\\ s into a
:class:`~repro_torch.analysis.report.VerifierReport`; an error-severity
finding means the plan must not run.

The checks mirror the executor's own runtime guards (grid-rank raise,
unproven-map-side raise, sort-merge capacity range, all-pairs int32
limit) plus the arithmetic only a static pass can do ahead of time —
pigeonhole capacity floors, Afrati–Ullman replication-rate bounds,
cost-model drift between the plan's stored costs and a fresh
recomputation.

Capacity floors are deliberately *necessary* conditions (mean-share
pigeonhole: if ``cap × devices < tuples`` even a perfectly balanced
hash must overflow), never sufficiency claims — the verifier must have
zero false positives on sound plans, so it only rejects what provably
cannot fit.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence, Tuple

from .. import config
from ..core.cost_model import (ChainPartitioning, ChainStats, QueryStats,
                               chain_replications,
                               cost_chain_one_round,
                               cost_query_one_round,
                               integer_shares, integer_shares_query,
                               query_replications,
                               replication_lower_bound_chain,
                               replication_lower_bound_query)
from ..core.partition import PartitionSpec, chain_partitioning
from ..core.plan import ChainQuery, JoinQuery
from .report import ERROR, WARNING, VerifierReport

#: Relative tolerance for cost-model drift: the plan's stored cost for
#: the chosen algorithm must match a fresh recomputation this closely.
COST_RTOL = 1e-6

#: A one-round plan whose integer-share cost exceeds the real-valued
#: floor by more than this factor draws a warning (the greedy factor-2
#: refinement should land far closer).
GAP_WARN_FACTOR = 4.0


def _prod(xs: Sequence[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


# ---------------------------------------------------------------------------
# Hypercube coverage + join order / cycle-closing filters
# ---------------------------------------------------------------------------

def verify_grid(query: JoinQuery, strategy: str,
                grid_shape: Sequence[int], k: int,
                report: VerifierReport) -> None:
    """Grid-rank coverage and the share budget.

    A one-round (Shares) grid must carry exactly one dimension per join
    attribute — fewer leaves an attribute unhashed (every reducer sees
    every value: correct only by accident of capacity), more is
    unmappable.  The map-side cascade runs on the certificate's flat
    1-D partition grid; plain cascades flatten whatever grid they get.
    Either way the device product must fit the declared budget ``k``.
    """
    rank = len(grid_shape)
    if any(int(s) < 1 for s in grid_shape):
        report.add("GRID_RANK_MISMATCH", ERROR, "grid_shape",
                   f"grid {tuple(grid_shape)} has a share < 1; every "
                   f"hypercube dimension needs at least one slice")
        return
    if strategy in ("one_round", "shares_skew"):
        if rank != query.n_dims:
            report.add(
                "GRID_RANK_MISMATCH", ERROR, "grid_shape",
                f"one-round Shares on {query.n_dims} join attribute(s) "
                f"{query.join_attrs} needs a rank-{query.n_dims} grid, "
                f"got rank-{rank} {tuple(grid_shape)}; re-plan with "
                f"integer_shares over the query's own incidence")
            return
    elif strategy == "mapside" and rank != 1:
        report.add(
            "GRID_RANK_MISMATCH", ERROR, "grid_shape",
            f"the map-side cascade runs on the flat 1-D partition grid, "
            f"got rank-{rank} {tuple(grid_shape)}")
        return
    n_dev = _prod(grid_shape)
    if n_dev > k:
        report.add(
            "SHARES_BUDGET_EXCEEDED", ERROR, "grid_shape",
            f"grid {tuple(grid_shape)} uses {n_dev} reducers but the plan "
            f"budget is k={k}; shrink a share or raise the budget")
    report.metrics.setdefault("n_devices", n_dev)


def verify_join_steps(query: JoinQuery, order: Sequence[int],
                      report: VerifierReport,
                      steps: Optional[Sequence[Tuple[int, str, Tuple[str, ...]]]] = None,
                      ) -> None:
    """Join-order validity and cycle-closing completeness.

    Re-derives the left-deep steps from the hypergraph and — when the
    executor's actual ``steps`` are supplied — checks hop by hop that
    every equality the hypergraph implies at that hop (the equi-key
    plus *all* remaining shared attributes as closing filters) is
    present.  A dropped closing filter silently turns a cycle into a
    chain: the triangle would count paths, not triangles.
    """
    try:
        expected = query.join_steps(order)
    except ValueError as e:
        report.add("JOIN_ORDER_INVALID", ERROR, f"join_order={tuple(order)}",
                   f"{e}; use a connected permutation such as "
                   f"{query.default_join_order()}")
        return
    if steps is None:
        steps = expected
    if len(steps) != len(expected):
        report.add("CLOSING_FILTER_DROPPED", ERROR, "join_steps",
                   f"plan executes {len(steps)} hop(s) but the query needs "
                   f"{len(expected)}")
        return
    for hop, ((rj, key, extras), (erj, ekey, eextras)) in enumerate(
            zip(steps, expected), start=1):
        if rj != erj or key != ekey:
            report.add(
                "JOIN_ORDER_INVALID", ERROR, f"hop {hop}",
                f"hop joins relation {rj} on {key!r} but order "
                f"{tuple(order)} requires relation {erj} on {ekey!r}")
            continue
        missing = sorted(set(eextras) - set(extras))
        if missing:
            report.add(
                "CLOSING_FILTER_DROPPED", ERROR, f"hop {hop}",
                f"cycle-closing filter(s) {missing} missing at the hop "
                f"joining relation {rj}: the extra equalities of a "
                f"closing hop must be applied as post-join filters or "
                f"the cycle degenerates to a chain")


# ---------------------------------------------------------------------------
# Capacity arithmetic
# ---------------------------------------------------------------------------

def _cap_check(report: VerifierReport, where: str, cap: Optional[int],
               floor: float, what: str) -> None:
    """Pigeonhole: ``cap`` per-device slots cannot hold a mean share of
    ``floor`` tuples even under a perfectly balanced hash."""
    if cap is None:
        return
    if float(cap) < floor:
        report.add(
            "CAPS_UNDERSIZED", ERROR, where,
            f"{what}: expected mean per-device share is "
            f"{floor:.1f} tuples but the declared capacity is {cap}; "
            f"even a perfectly balanced hash must overflow — resize via "
            f"default_chain_caps/default_query_caps or raise slack")


def _pair_overflow_check(report: VerifierReport, where: str,
                         left_cap: Optional[int], right_cap: Optional[int],
                         ) -> None:
    """Worst-case pair index of a local join is ``left·right``; above
    2³¹ the all-pairs oracle raises and int32 position arithmetic in
    general loses headroom.  A warning while x64 is off."""
    if left_cap is None or right_cap is None or config.x64_enabled():
        return
    worst = int(left_cap) * int(right_cap)
    report.metrics["worst_pair_index"] = max(
        report.metrics.get("worst_pair_index", 0), worst)
    if worst >= config.INT32_PAIR_LIMIT:
        report.add(
            "PAIR_INDEX_OVERFLOW", WARNING, where,
            f"worst-case pair index {left_cap}×{right_cap} = {worst} "
            f"exceeds the int32 limit {config.INT32_PAIR_LIMIT} with x64 "
            f"disabled; the all-pairs oracle would raise here and index "
            f"arithmetic has no headroom — shrink the buffers or enable "
            f"x64 (repro_torch.config.enable_x64)")


def _sort_merge_range_check(report: VerifierReport, caps: Any) -> None:
    for field in ("recv", "mid", "out", "local", "agg", "join"):
        cap = getattr(caps, field, None)
        if cap is None:
            continue
        if not (0 < int(cap) <= config.SORT_MERGE_MAX_CAP):
            report.add(
                "SORT_MERGE_CAP_RANGE", ERROR, f"caps.{field}",
                f"capacity {cap} outside the sort-merge data plane's "
                f"valid range (0, {config.SORT_MERGE_MAX_CAP}]; the "
                f"rank-packing keys need the capacity to fit in 30 bits")


def verify_chain_caps(query: ChainQuery, stats: ChainStats, strategy: str,
                      grid_shape: Sequence[int], caps: Any,
                      report: VerifierReport) -> None:
    """Capacity floors for one chain execution, per strategy.

    One-round: relation j arrives replicated ``K/m_j``-fold, so its
    mean per-device receive share is ``r_j·repl_j / n_dev``; the
    intermediate after hop i is distributed over only the first ``i+1``
    grid dims (the later dims are still broadcast), so its floor
    divides by ``∏ grid[:i+1]``.  Cascade/map-side divide by the flat
    device count.  All floors are means — necessary conditions only.
    """
    _sort_merge_range_check(report, caps)
    n = query.n_relations
    n_dev = _prod(grid_shape)
    sizes = stats.sizes
    if strategy == "one_round" and len(grid_shape) == n - 1:
        repl = chain_replications(sizes, grid_shape)
        recv_floor = max(r * f for r, f in zip(sizes, repl)) / n_dev
        _cap_check(report, "caps.recv", caps.recv, recv_floor,
                   "largest replicated relation share")
        if caps.local is not None:
            _cap_check(report, "caps.local", caps.local, recv_floor,
                       "largest resident shard after placement")
        for i in range(n - 2):
            group = _prod(grid_shape[:i + 1])
            _cap_check(report, "caps.mid", caps.mid,
                       stats.prefix_joins[i] / group,
                       f"intermediate after hop {i + 1}")
        _cap_check(report, "caps.out", caps.out,
                   stats.prefix_joins[-1] / n_dev, "final result shard")
    else:
        k_flat = n_dev
        recv_floor = max(max(sizes), max(stats.prefix_joins[:-1],
                                         default=0.0)) / k_flat
        _cap_check(report, "caps.recv", caps.recv, recv_floor,
                   "largest per-hop input share")
        for i in range(n - 2):
            _cap_check(report, "caps.mid", caps.mid,
                       stats.prefix_joins[i] / k_flat,
                       f"intermediate after hop {i + 1}")
        _cap_check(report, "caps.out", caps.out,
                   stats.prefix_joins[-1] / k_flat, "final result shard")
    join_cap = caps.join if (query.aggregate is not None
                             and caps.join is not None) else caps.out
    _pair_overflow_check(report, "caps.recv×caps.recv (hop join)",
                         caps.recv, caps.recv)
    _pair_overflow_check(report, "caps.mid×caps.recv (hop join)",
                         caps.mid, caps.recv)
    _pair_overflow_check(report, "join buffer", caps.mid, join_cap)


def verify_query_caps(query: JoinQuery, stats: QueryStats, strategy: str,
                      grid_shape: Sequence[int], caps: Any,
                      join_order: Sequence[int],
                      report: VerifierReport) -> None:
    """General-hypergraph capacity floors: replicated receive shares
    for one-round grids, per-order hop-join buffers for the join caps
    (cycle-closing hops buffer the *pre-filter* matches)."""
    _sort_merge_range_check(report, caps)
    n_dev = _prod(grid_shape)
    if strategy == "one_round" and len(grid_shape) == query.n_dims:
        repl = query_replications(query.rel_dims(), grid_shape)
        recv_floor = max(r * f for r, f in zip(stats.sizes, repl)) / n_dev
        _cap_check(report, "caps.recv", caps.recv, recv_floor,
                   "largest replicated relation share")
        _cap_check(report, "caps.out", caps.out,
                   stats.full_output / n_dev, "final result shard")
    else:
        try:
            idx = list(stats.orders).index(tuple(join_order))
        except ValueError:
            idx = None
        if idx is not None:
            inter = stats.intermediates[idx]
            raw = stats.hop_joins[idx]
            recv_floor = max(max(stats.sizes),
                             max(inter[:-1], default=0.0)) / n_dev
            _cap_check(report, "caps.recv", caps.recv, recv_floor,
                       "largest per-hop input share")
            for i, h in enumerate(raw[:-1]):
                cap = caps.join if caps.join is not None else caps.mid
                _cap_check(report, "caps.join", cap, h / n_dev,
                           f"raw (pre-filter) join at hop {i + 1}")
            _cap_check(report, "caps.out", caps.out,
                       inter[-1] / n_dev, "final result shard")
    _pair_overflow_check(report, "caps.recv×caps.recv (hop join)",
                         caps.recv, caps.recv)
    _pair_overflow_check(report, "caps.mid×caps.recv (hop join)",
                         caps.mid, caps.recv)


# ---------------------------------------------------------------------------
# Certificate soundness
# ---------------------------------------------------------------------------

def verify_partitioning(query: ChainQuery,
                        cert: ChainPartitioning,
                        report: VerifierReport,
                        specs: Optional[Sequence[Optional[PartitionSpec]]] = None,
                        hop_modes: Optional[Sequence[str]] = None,
                        grid_shape: Optional[Sequence[int]] = None,
                        ) -> None:
    """Co-partitioning certificate checks.

    * every proven hop's spec (when the specs are supplied) must agree
      with the certificate's canonical (P, salt, key dtype) — a proof
      under different hash parameters is no proof;
    * the certificate's key dtype must match the *current* runtime
      configuration (the partition hash folds 64-bit keys, so a
      certificate minted under x64 is unsound under x32 and vice
      versa);
    * map-side hop modes may only be used on proven hops, with the
      right arity, on the certificate's own 1-D grid.
    """
    n = query.n_relations
    if len(cert.right_proven) != n - 1:
        report.add("HOP_MODES_ARITY", ERROR, "certificate.right_proven",
                   f"certificate proves {len(cert.right_proven)} hop(s) "
                   f"for a {n}-relation chain (needs {n - 1})")
        return
    current = config.key_dtype_name()
    if cert.key_dtype is not None and cert.key_dtype != current:
        report.add(
            "CERT_DTYPE_STALE", ERROR, "certificate.key_dtype",
            f"certificate was minted over {cert.key_dtype} keys but the "
            f"current configuration uses {current}; the partition hash "
            f"folds 64-bit keys, so the stored layout proves nothing "
            f"here — repartition the store under the current dtype")
    if specs is not None:
        expected = ([query.attrs[1]]
                    + [query.attrs[j] for j in range(1, n)])
        for j, spec in enumerate(specs):
            hop = "left relation 0" if j == 0 else f"hop {j}"
            proven = cert.left0_proven if j == 0 else cert.right_proven[j - 1]
            if not proven:
                continue
            if spec is None or not spec.sorted or spec.key != expected[j]:
                report.add(
                    "CERT_PARTITIONS_MISMATCH", ERROR, hop,
                    f"certificate claims the hop proven but relation {j} "
                    f"has no sorted partitioning on {expected[j]!r}")
                continue
            if spec.num_partitions != cert.num_partitions:
                report.add(
                    "CERT_PARTITIONS_MISMATCH", ERROR, hop,
                    f"relation {j} is split into {spec.num_partitions} "
                    f"partition(s) but the certificate's canonical count "
                    f"is {cert.num_partitions}; co-location needs the "
                    f"same bucket count on every proven hop")
            if spec.salt != cert.salt:
                report.add(
                    "CERT_SALT_MISMATCH", ERROR, hop,
                    f"relation {j} was partitioned under salt {spec.salt} "
                    f"but the certificate's canonical salt is {cert.salt}; "
                    f"different salts bucket the same key differently, so "
                    f"partition p would merge-join against foreign keys")
            if (spec.key_dtype is not None and cert.key_dtype is not None
                    and spec.key_dtype != cert.key_dtype):
                report.add(
                    "CERT_KEY_DTYPE_MISMATCH", ERROR, hop,
                    f"relation {j} was partitioned over {spec.key_dtype} "
                    f"keys but the certificate records {cert.key_dtype}; "
                    f"the fold of 64-bit keys buckets differently — "
                    f"repartition the odd relation out")
        fresh = chain_partitioning(query, list(specs))
        if fresh is None or fresh.right_proven != cert.right_proven \
                or fresh.left0_proven != cert.left0_proven:
            report.add(
                "CERT_PARTITIONS_MISMATCH", ERROR, "certificate",
                f"re-deriving the certificate from the supplied specs "
                f"gives {fresh}, not the plan's {cert}; the plan was made "
                f"against a different store state")
    if hop_modes is not None:
        if len(hop_modes) != n - 1:
            report.add(
                "HOP_MODES_ARITY", ERROR, "hop_modes",
                f"{n - 1} hop(s) need {n - 1} mode(s), got "
                f"{len(hop_modes)}")
        else:
            for j, mode in enumerate(hop_modes):
                if mode == "mapside" and not cert.right_proven[j]:
                    report.add(
                        "UNPROVEN_MAPSIDE_HOP", ERROR, f"hop {j + 1}",
                        f"hop {j + 1} is not proven co-partitioned; mode "
                        f"'mapside' would merge-join unaligned partitions "
                        f"— fall back to 'shuffle' or repartition "
                        f"relation {j + 1}")
    if grid_shape is not None and tuple(grid_shape) != (cert.num_partitions,):
        report.add(
            "GRID_RANK_MISMATCH", ERROR, "grid_shape",
            f"map-side cascade runs on the certificate's 1-D partition "
            f"grid ({cert.num_partitions},), got {tuple(grid_shape)}")


# ---------------------------------------------------------------------------
# Replication-rate bounds + cost-model drift
# ---------------------------------------------------------------------------

def verify_replication_bound(sizes: Sequence[float], k: int,
                             grid_shape: Sequence[int],
                             report: VerifierReport,
                             rel_dims: Optional[Sequence[Sequence[int]]] = None,
                             ) -> None:
    """Afrati–Ullman floor: no hypercube assignment at budget k can
    communicate fewer tuples than the real-valued Shares optimum.  The
    chosen integer-share cost must sit at or above the floor (below is
    a cost-model inconsistency, not a triumph); the gap
    ``chosen/floor − 1`` is recorded and large gaps draw a warning."""
    if rel_dims is None:
        floor = replication_lower_bound_chain(sizes, k)
        chosen = cost_chain_one_round(sizes, k, shares=grid_shape)
    else:
        floor = replication_lower_bound_query(rel_dims, sizes, k)
        chosen = cost_query_one_round(rel_dims, sizes, k, shares=grid_shape)
    gap = chosen / floor - 1.0 if floor > 0 else 0.0
    report.metrics["replication_floor"] = floor
    report.metrics["one_round_cost"] = chosen
    report.metrics["replication_gap"] = gap
    if chosen < floor * (1.0 - 1e-9):
        report.add(
            "REPL_BOUND_VIOLATION", ERROR, "grid_shape",
            f"one-round cost {chosen:.1f} at grid {tuple(grid_shape)} is "
            f"below the Afrati–Ullman floor {floor:.1f} for k={k} — the "
            f"cost model and the bound disagree; one of them is wrong")
    elif gap > GAP_WARN_FACTOR - 1.0:
        report.add(
            "REPL_BOUND_VIOLATION", WARNING, "grid_shape",
            f"one-round cost {chosen:.1f} is {gap + 1.0:.2f}× the "
            f"replication floor {floor:.1f}; the integer shares "
            f"{tuple(grid_shape)} are far from the real-valued optimum — "
            f"re-run integer_shares or lower k")


def verify_chain_costs(stats: ChainStats, plan: Any, report: VerifierReport,
                       aggregate: bool) -> None:
    """The plan's stored cost for its *chosen* algorithm must equal a
    fresh recomputation from the same statistics — drift means the
    planner chose on stale numbers."""
    try:
        fresh = stats.costs(plan.k, aggregate, shares=plan.shares)
    except ValueError:
        return
    stored = plan.costs.get(plan.algorithm)
    want = fresh.get(plan.algorithm)
    if stored is None or want is None:
        return
    if not math.isclose(stored, want, rel_tol=COST_RTOL):
        report.add(
            "COST_MODEL_DRIFT", ERROR, f"costs[{plan.algorithm!r}]",
            f"plan stores {stored:.3f} for its chosen algorithm but the "
            f"cost model now computes {want:.3f} from the same stats; "
            f"re-plan before executing")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def verify_chain_plan(query: ChainQuery, stats: ChainStats, plan: Any,
                      caps: Any, *,
                      specs: Optional[Sequence[Optional[PartitionSpec]]] = None,
                      target: str = "chain_plan") -> VerifierReport:
    """Certify one :class:`~repro_torch.core.planner.ChainPlan` end to end.

    Runs every chain-applicable check: grid coverage and budget,
    join-order/steps, capacity floors, pair-index headroom,
    certificate soundness (when the plan carries one), replication
    bounds, cost drift.  ``specs`` optionally supplies the store's
    per-relation :class:`PartitionSpec`\\ s for the deeper certificate
    cross-check."""
    report = VerifierReport(target=target)
    if query.n_relations != len(stats.sizes):
        report.add("GRID_RANK_MISMATCH", ERROR, "stats",
                   f"stats cover {len(stats.sizes)} relation(s) for a "
                   f"{query.n_relations}-relation query")
        return report
    verify_grid(query, plan.strategy, plan.grid_shape, plan.k, report)
    verify_join_steps(query, query.default_join_order(), report)
    verify_chain_caps(query, stats, plan.strategy, plan.grid_shape, caps,
                      report)
    if plan.partitioning is not None:
        verify_partitioning(
            query, plan.partitioning, report, specs=specs,
            hop_modes=plan.hop_modes,
            grid_shape=(plan.grid_shape
                        if plan.strategy == "mapside" else None))
    verify_replication_bound(
        stats.sizes, plan.k,
        plan.grid_shape if plan.strategy == "one_round"
        else integer_shares(stats.sizes, plan.k),
        report)
    verify_chain_costs(stats, plan, report,
                       aggregate=query.aggregate is not None)
    return report


def verify_query_plan(query: JoinQuery, stats: QueryStats, plan: Any,
                      caps: Any, *,
                      target: str = "query_plan") -> VerifierReport:
    """Certify one :class:`~repro_torch.core.planner.QueryPlan` — the
    general-hypergraph counterpart of :func:`verify_chain_plan`, with
    cycle-closing completeness checked along the plan's own join
    order."""
    report = VerifierReport(target=target)
    verify_grid(query, plan.strategy, plan.grid_shape, plan.k, report)
    verify_join_steps(query, plan.join_order, report)
    verify_query_caps(query, stats, plan.strategy, plan.grid_shape, caps,
                      plan.join_order, report)
    shares = (plan.grid_shape if plan.strategy == "one_round"
              else integer_shares_query(query.rel_dims(), stats.sizes,
                                        plan.k))
    verify_replication_bound(stats.sizes, plan.k, shares, report,
                             rel_dims=query.rel_dims())
    return report
