"""The verification corpus: every plan behind the BENCH_*.json
sweeps, rebuilt exactly as the benchmarks build them (same seeds, same
fast-mode sizes, same planner calls, same capacity sizing) — but never
executed.  ``python -m repro_torch.analysis.cli --all-bench``
certifies each of these with the plan checker.

A copy of ``src/repro/analysis/bench_targets.py`` over
``repro_torch.core``: the seeds, sizes, planner calls and caps are the
JAX package's, so every target is the plan the port's benchmarks
(``benchmarks/*_torch.py``) run, and the findings equal the JAX
package's ``repro-verify``'s.

Each target is a :class:`BenchTarget` carrying everything
:func:`~repro_torch.analysis.plan_verifier.verify_chain_plan` /
``verify_query_plan`` need.  Construction is cheap (exact statistics
over the fast-mode inputs, no joins) so the whole corpus builds in
seconds on CPU.

Fidelity notes, maintained against ``benchmarks/*.py`` (and their
``*_torch.py`` ports):

* ``nway_chain`` shares ONE rng (seed 7) sequentially across
  n = 3, 4, 5; ``mapside_sweep`` creates a FRESH rng (seed 7) per
  size.  Reproducing the draws in the right order is what makes these
  the *actual* benched plans.
* fast-mode sizes only — the CI sweeps run ``--fast``, so those are
  the plans the artifact certifies.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core import (ChainQuery, JoinQuery, chain_partitioning,
                    chain_stats_exact, default_chain_caps,
                    default_mapside_caps, default_part_capacity,
                    default_query_caps, integer_shares,
                    integer_shares_query, partition_relation, plan_chain,
                    plan_query, query_stats_exact)
from ..core.executor import ChainCaps
from ..core.relation import Relation


@dataclasses.dataclass
class BenchTarget:
    """One (query, stats, plan, caps) tuple to certify.

    kind:  ``"chain"`` (verify_chain_plan) or ``"query"``
           (verify_query_plan).
    specs: per-relation PartitionSpecs for the certificate cross-check
           (map-side targets only).
    """

    name: str
    kind: str
    query: Any
    stats: Any
    plan: Any
    caps: ChainCaps
    specs: Optional[Sequence[Any]] = None
    #: RecoveryMeta for targets the resilience sweep executes under
    #: injected faults (checked by the recovery-coverage pass).
    recovery: Optional[Any] = None


def nway_targets() -> List[BenchTarget]:
    """BENCH_nway.json: chains of n = 3, 4, 5 relations, 120 edges
    each over ~60 nodes, one shared rng, planned at k = 8 with and
    without the endpoint aggregate; caps sized at slack 4 on the
    executed grid."""
    out: List[BenchTarget] = []
    rng = np.random.default_rng(7)
    n_edges = 120
    nodes = max(8, n_edges // 2)
    for n in (3, 4, 5):
        edges = [(rng.integers(0, nodes, n_edges).astype(np.int32),
                  rng.integers(0, nodes, n_edges).astype(np.int32))
                 for _ in range(n)]
        stats = chain_stats_exact(edges)
        for aggregate in (False, True):
            query = ChainQuery.chain(n, aggregate=aggregate)
            plan = plan_chain(stats, 8, aggregate=aggregate)
            caps = default_chain_caps(stats, plan.grid_shape, slack=4)
            suffix = "A" if aggregate else ""
            out.append(BenchTarget(
                name=f"nway/n={n}{suffix} ({plan.algorithm})",
                kind="chain", query=query, stats=stats, plan=plan,
                caps=caps))
    return out


def skew_targets() -> List[BenchTarget]:
    """BENCH_skew.json: the three-way self-join chain over Zipf edge
    lists at α ∈ {0, 0.8, 1.2, 1.4} (160 edges over 800 nodes, seed
    3), planned at k = 64 with the top-16 frequency sketch; base caps
    are the sweep's fixed budgets."""
    from ..data.graphs import zipf_edges

    base_caps = ChainCaps(recv=256, mid=1024, out=65536, local=1024)
    out: List[BenchTarget] = []
    for alpha in (0.0, 0.8, 1.2, 1.4):
        src, dst = zipf_edges(800, 160, alpha, seed=3)
        edges = [(src, dst)] * 3
        query = ChainQuery.three_way()
        stats = chain_stats_exact(edges, sketch_top_k=16)
        plan = plan_chain(stats, 64, aggregate=False)
        out.append(BenchTarget(
            name=f"skew/alpha={alpha} ({plan.algorithm})",
            kind="chain", query=query, stats=stats, plan=plan,
            caps=base_caps))
    return out


def triangle_targets() -> List[BenchTarget]:
    """BENCH_triangles.json: the cyclic triangle query over the fast
    R-MAT graph (scale 8, amazon-shaped initiator, seed 1), planned at
    k = 8; the one-round config is certified on its integer-share
    hypercube with slack-16 caps, plus the chain+filter oracle's plan."""
    from ..data.graphs import DATASETS, GraphSpec, rmat_edges

    orig = DATASETS["amazon"]
    spec = GraphSpec(orig.name, scale=8,
                     edge_factor=min(orig.edge_factor, 3.0), a=orig.a)
    src, dst = rmat_edges(spec, seed=1)
    edges = (np.asarray(src), np.asarray(dst))
    query = JoinQuery.triangle()
    stats = query_stats_exact(query, [edges] * 3)
    n_dev = 8
    plan = plan_query(query, stats, n_dev)
    grid_shape = integer_shares_query(query.rel_dims(), stats.sizes, n_dev)
    caps = default_query_caps(query, stats, grid_shape, slack=16)
    # The sweep measures BOTH cycle strategies regardless of the
    # planner's winner; certify each executed configuration.
    one_round_plan = dataclasses.replace(
        plan, algorithm="1,3J", strategy="one_round", grid_shape=grid_shape)
    cascade_plan = dataclasses.replace(
        plan, algorithm="2,3J", strategy="cascade", grid_shape=(n_dev,),
        join_order=stats.best_order()[0])
    targets = [
        BenchTarget(name="triangles/cycle one_round (1,3J)",
                    kind="query", query=query, stats=stats,
                    plan=one_round_plan, caps=caps),
        BenchTarget(name="triangles/cycle cascade (2,3J)",
                    kind="query", query=query, stats=stats,
                    plan=cascade_plan,
                    caps=default_query_caps(query, stats, (n_dev,),
                                            slack=16)),
    ]
    cquery = ChainQuery.three_way(aggregate=True)
    cstats = chain_stats_exact([edges] * 3)
    cgrid = integer_shares(cstats.sizes, n_dev)
    cplan = dataclasses.replace(
        plan_chain(cstats, n_dev, aggregate=True),
        algorithm="1,3JA", strategy="one_round", grid_shape=cgrid)
    n_flat = 1
    for s in cgrid:
        n_flat *= s
    targets.append(BenchTarget(
        name="triangles/chain+filter (1,3JA)",
        kind="chain", query=cquery, stats=cstats, plan=cplan,
        caps=default_chain_caps(cstats, cgrid, slack=n_flat)))
    return targets


def mapside_targets() -> List[BenchTarget]:
    """BENCH_mapside.json: the 5-relation chain over pre-partitioned
    stores (P = 8, salt 0), fresh rng seed 7 per size, fast sizes 800
    and 3200; the planner sees the real ChainPartitioning certificate
    minted by partitioning the actual relations."""
    out: List[BenchTarget] = []
    query = ChainQuery.chain(5)
    n_rel, P = 5, 8
    for m in (800, 3200):
        rng = np.random.default_rng(7)
        dom = 2 * m
        edges = [(rng.integers(0, dom, m).astype(np.int32),
                  rng.integers(0, dom, m).astype(np.int32))
                 for _ in range(n_rel)]
        stats = chain_stats_exact(edges)
        specs: List[Any] = []
        for j, (s, d) in enumerate(edges):
            key = query.attrs[1] if j == 0 else query.attrs[j]
            names = (query.attrs[j], query.attrs[j + 1])
            rel = Relation.from_arrays(**{names[0]: s, names[1]: d})
            prel, _ = partition_relation(
                rel, key, P, salt=0,
                part_capacity=default_part_capacity(m, P))
            specs.append(prel.spec)
        part = chain_partitioning(query, specs)
        plan_ms = plan_chain(stats, P, aggregate=False, partitioning=part)
        out.append(BenchTarget(
            name=f"mapside/m={m} ({plan_ms.algorithm})",
            kind="chain", query=query, stats=stats, plan=plan_ms,
            caps=default_mapside_caps(stats, P, slack=6),
            specs=specs))
        plan_c = plan_chain(stats, P, aggregate=False)
        out.append(BenchTarget(
            name=f"mapside/m={m} shuffle baseline ({plan_c.algorithm})",
            kind="chain", query=query, stats=stats, plan=plan_c,
            caps=default_chain_caps(stats, (P,), slack=6)))
    return out


def join_kernels_targets() -> List[BenchTarget]:
    """BENCH_join_kernels.json: the executor-level micro-benchmark's
    3-chain (1000 edges, seed 0) planned at k = 8, certified for both
    the one-round and cascade configurations it times."""
    rng = np.random.default_rng(0)
    n_edges = 1000
    nodes = max(8, n_edges // 2)
    edges = [(rng.integers(0, nodes, n_edges).astype(np.int32),
              rng.integers(0, nodes, n_edges).astype(np.int32))
             for _ in range(3)]
    stats = chain_stats_exact(edges)
    query = ChainQuery.chain(3)
    plan = plan_chain(stats, 8, aggregate=False)
    grid = integer_shares(stats.sizes, 8)
    return [BenchTarget(
        name=f"join_kernels/executor ({plan.algorithm})",
        kind="chain", query=query, stats=stats, plan=plan,
        caps=default_chain_caps(stats, grid, slack=4))]


def serving_targets() -> List[BenchTarget]:
    """BENCH_serving.json: the plans the query-serving engine caches
    and executes — the repeated serve-phase triangle cascade (seed 0),
    every batched tenant's lane (seeds 100..103) and the first
    streaming delta term (Δ, E, E) of the standing triangle count
    (insert batch 0, rng seed 42).  The engine forces the cascade and
    re-derives algorithm/grid/order itself; caps are its pow2-quantized
    defaults at k = 4, slack 8 (QueryServeConfig defaults, sweep k)."""
    from ..serving.engine import _pow2  # local: serving imports analysis

    query = JoinQuery.triangle()
    k, slack = 4, 8
    n_nodes, m_edges = 16, 110

    def uedges(seed: int) -> Any:
        rng = np.random.default_rng(seed)
        seen = set()
        while len(seen) < m_edges:
            seen.add((int(rng.integers(0, n_nodes)),
                      int(rng.integers(0, n_nodes))))
        arr = np.array(sorted(seen))
        return arr[:, 0], arr[:, 1]

    def quant(caps: ChainCaps) -> ChainCaps:
        opt: Callable[[Optional[int]], Optional[int]] = \
            lambda v: None if v is None else _pow2(v)
        return ChainCaps(recv=_pow2(caps.recv), mid=_pow2(caps.mid),
                         out=_pow2(caps.out), local=opt(caps.local),
                         agg=opt(caps.agg), join=opt(caps.join))

    def cascade_target(name: str, stats: Any,
                       join_order: Optional[Sequence[int]]) -> BenchTarget:
        plan = plan_query(query, stats, k)
        if join_order is None:
            # engine rule: a forced cascade over a one-round winner
            # re-derives the cheapest left-deep order itself
            join_order = (stats.best_order()[0]
                          if plan.strategy == "one_round"
                          else plan.join_order)
        alg = "2,3J"
        exec_plan = dataclasses.replace(
            plan, algorithm=alg, strategy="cascade", grid_shape=(k,),
            join_order=tuple(join_order),
            costs={**plan.costs,
                   alg: plan.costs.get(alg, plan.predicted_cost)})
        return BenchTarget(
            name=name, kind="query", query=query, stats=stats,
            plan=exec_plan,
            caps=quant(default_query_caps(query, stats, (k,), slack=slack)))

    src, dst = uedges(0)
    stats = query_stats_exact(query, [(src, dst)] * 3)
    out = [cascade_target("serving/serve triangle (2,3J)", stats, (0, 1, 2))]
    for t in range(4):
        s, d = uedges(100 + t)
        tstats = query_stats_exact(query, [(s, d)] * 3)
        out.append(cascade_target(f"serving/tenant {t} (2,3J)",
                                  tstats, (0, 1, 2)))
    rng = np.random.default_rng(42)
    cur = set(zip(src.tolist(), dst.tolist()))
    ins: List[Any] = []
    while len(ins) < 5:
        e = (int(rng.integers(0, n_nodes)), int(rng.integers(0, n_nodes)))
        if e not in cur and e not in ins:
            ins.append(e)
    dsrc = np.array([a for a, _ in ins])
    ddst = np.array([b for _, b in ins])
    dstats = query_stats_exact(query, [(dsrc, ddst), (src, dst), (src, dst)])
    out.append(cascade_target("serving/ingest delta-term (2,3J)",
                              dstats, None))
    return out


def resilience_targets() -> List[BenchTarget]:
    """BENCH_resilience.json: the 3-chain the chaos sweep executes
    under injected faults (160 edges over 80 nodes, seed 5, k = 8) in
    both resilient configurations.  Each target carries its
    :class:`~repro_torch.resilience.recovery.RecoveryMeta` so
    ``--bench resilience`` certifies coverage: every non-final cascade hop has
    a snapshot recovery point, one-round recovery is reducer-granular
    by construction."""
    from ..resilience import recovery_meta_for

    rng = np.random.default_rng(5)
    m, nodes, k = 160, 80, 8
    query = JoinQuery.chain(3)
    tables = [(rng.integers(0, nodes, m).astype(np.int32),
               rng.integers(0, nodes, m).astype(np.int32))
              for _ in range(3)]
    stats = query_stats_exact(query, tables)
    plan = plan_query(query, stats, k)
    grid_shape = integer_shares_query(query.rel_dims(), stats.sizes, k)
    one_round_plan = dataclasses.replace(
        plan, algorithm="1,3J", strategy="one_round",
        grid_shape=grid_shape)
    cascade_plan = dataclasses.replace(
        plan, algorithm="2,3J", strategy="cascade", grid_shape=(k,),
        join_order=stats.best_order()[0])
    return [
        BenchTarget(
            name="resilience/one_round (1,3J)", kind="query",
            query=query, stats=stats, plan=one_round_plan,
            caps=default_query_caps(query, stats, grid_shape, slack=8),
            recovery=recovery_meta_for("one_round", 3)),
        BenchTarget(
            name="resilience/cascade (2,3J)", kind="query",
            query=query, stats=stats, plan=cascade_plan,
            caps=default_query_caps(query, stats, (k,), slack=8),
            recovery=recovery_meta_for("cascade", 3)),
    ]


#: name -> builder, in BENCH_* artifact order.
TARGET_BUILDERS: Dict[str, Callable[[], List[BenchTarget]]] = {
    "nway": nway_targets,
    "skew": skew_targets,
    "triangles": triangle_targets,
    "mapside": mapside_targets,
    "join_kernels": join_kernels_targets,
    "serving": serving_targets,
    "resilience": resilience_targets,
}


def all_bench_targets(names: Optional[Sequence[str]] = None,
                      ) -> List[BenchTarget]:
    """Build the whole corpus (or the named sweeps)."""
    names = list(TARGET_BUILDERS) if names is None else list(names)
    out: List[BenchTarget] = []
    for n in names:
        if n not in TARGET_BUILDERS:
            raise ValueError(f"unknown bench target {n!r}; choose from "
                             f"{sorted(TARGET_BUILDERS)}")
        out.extend(TARGET_BUILDERS[n]())
    return out
