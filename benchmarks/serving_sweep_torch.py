"""Serving sweep on the PyTorch port: the query-serving layer under a
production-shaped load — repeat queries, multi-tenant batches,
streaming ingest.

The port of ``benchmarks/serving_sweep.py``, three phases over one
fixed random graph (unique directed edges, seeded):

* **serve** — the same triangle-count query resubmitted: the first
  submission pays plan + capture (caches cleared first, so it is
  genuinely cold), every repeat is a plan-cache hit replaying the
  captured graph.  Checks: measured tuples == the cascade cost formula
  on the exact statistics, count == the host oracle, and on a GPU the
  warm p50 at least ``SPEEDUP_GATE``× below the cold submission.
* **batched** — ``N_TENANTS`` tenants submit the same query shape over
  different edge tables through ``submit_many``: one laned execution
  (one graph replay), per-lane answers and stats.  Checks: exactly one
  batch dispatched, every tenant's measured total == the analytic
  cascade cost on its own statistics, every count == the host oracle.
* **ingest** — a :class:`~repro_torch.serving.ServingStore` holding the
  edges with standing triangle and 3-path counts absorbs micro-batches
  of inserts and deletes via delta-join cascades.  Checks: both values
  equal full recomputation after every batch, and the delta path moves
  fewer tuples than the recomputes it avoided.

``--check`` exits non-zero unless every check holds and the counts
equal the JAX package's ``BENCH_serving.json`` pins (all 33; ``--fast``
changes warm repeats only, so it reaches them all too).  Latencies,
throughput and the speed checks exist only on a GPU: on the CPU the
engine runs each plan eagerly, the times are written as null and the
speed checks as not measured.  Writes ``BENCH_torch_serving.json``
(``--out`` to override).

  PYTHONPATH=src python benchmarks/serving_sweep_torch.py [--fast]
      [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import device_record, report_pins  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.core import (JoinQuery, clear_compiled_caches,  # noqa: E402
                              cost_query_cascade, oracle_triangles,
                              query_stats_exact)
from repro_torch.serving import (QueryEngine, QueryRequest,  # noqa: E402
                                 QueryServeConfig, ServingStore,
                                 weighted_total)

K = 4                         # engine devices
N_NODES = 16
M_EDGES = 110                 # unique directed edges (dense: j2 >> |E|)
JOIN_ORDER = (0, 1, 2)        # fixed order => per-tenant analytic is exact
N_TENANTS = 4
N_INGEST_BATCHES = 3
INGEST_INSERTS = 5
INGEST_DELETES = (0, 2, 2)    # per batch: first is insert-only

SPEEDUP_GATE = 10.0           # warm p50 vs cold plan+capture (GPU only)
HIT_RATE_GATE = 0.5
P99_FLOOR_MS = 250.0          # latency bound: p99 <= max(floor,
P99_P50_FACTOR = 20.0         #   factor * p50) (GPU only)

WARM_REPEATS_FULL = 100
WARM_REPEATS_FAST = 20


def unique_edges(seed, n_nodes=N_NODES, m=M_EDGES):
    rng = np.random.default_rng(seed)
    seen = set()
    while len(seen) < m:
        seen.add((int(rng.integers(0, n_nodes)),
                  int(rng.integers(0, n_nodes))))
    arr = np.array(sorted(seen))
    return arr[:, 0], arr[:, 1]


def analytic_cascade_total(query, stats, order=JOIN_ORDER):
    idx = stats.orders.index(tuple(order))
    return cost_query_cascade([stats.sizes[i] for i in order],
                              stats.intermediates[idx])


def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def bench_serve(eng, warm_repeats, on_gpu):
    """Cold plan+capture vs warm cache-hit latency for the repeated
    triangle count."""
    query = JoinQuery.triangle()
    src, dst = unique_edges(0)
    tables = [(src, dst)] * 3
    stats = query_stats_exact(query, tables)

    hits0, misses0 = eng.stats.hits, eng.stats.misses
    clear_compiled_caches()   # genuinely cold: no reusable executable
    cold = eng.submit(query, tables, stats=stats, strategy="cascade",
                      join_order=JOIN_ORDER)
    if not (cold.ok and not cold.cache_hit):
        raise RuntimeError(f"serve: cold submission: {cold.error}")

    warm_ms = []
    for _ in range(warm_repeats):
        res = eng.submit(query, tables, stats=stats, strategy="cascade",
                         join_order=JOIN_ORDER)
        if not (res.ok and res.cache_hit):
            raise RuntimeError(f"serve: warm submission: {res.error}")
        warm_ms.append(res.latency_ms)

    count = weighted_total(query, res.output) / 3
    oracle = float(oracle_triangles(src, dst))
    analytic = analytic_cascade_total(query, stats)
    measured = {k: res.measured[k] for k in ("read", "shuffled", "total")}
    hits = eng.stats.hits - hits0
    misses = eng.stats.misses - misses0
    p50 = percentile(warm_ms, 50)
    return {
        "query": "triangle",
        "n_edges": int(len(src)),
        "triangles": count,
        "oracle": oracle,
        "plan": {"algorithm": cold.plan.algorithm,
                 "strategy": cold.plan.strategy,
                 "join_order": list(JOIN_ORDER),
                 "grid_shape": list(cold.plan.grid_shape)},
        "measured": measured,
        "analytic_total": analytic,
        "match": measured["total"] == analytic and count == oracle,
        "cold_ms": cold.latency_ms if on_gpu else None,
        "warm_p50_ms": p50 if on_gpu else None,
        "warm_p99_ms": percentile(warm_ms, 99) if on_gpu else None,
        "warm_repeats": warm_repeats,
        "speedup": cold.latency_ms / p50 if on_gpu else None,
        "hit_rate": hits / (hits + misses),
    }


def bench_batched(eng, on_gpu):
    """B tenants, same query shape, different edge tables: one laned
    execution with exact per-lane accounting."""
    query = JoinQuery.triangle()
    reqs, analytic, oracles = [], [], []
    for t in range(N_TENANTS):
        src, dst = unique_edges(100 + t)
        tables = [(src, dst)] * 3
        stats = query_stats_exact(query, tables)
        reqs.append(QueryRequest(query, tables, stats=stats,
                                 strategy="cascade", join_order=JOIN_ORDER))
        analytic.append(analytic_cascade_total(query, stats))
        oracles.append(float(oracle_triangles(src, dst)))

    batches_before = eng.stats.batches
    t0 = time.perf_counter()
    results = eng.submit_many(reqs)
    wall_ms = (time.perf_counter() - t0) * 1e3
    n_batches = eng.stats.batches - batches_before

    lanes = []
    for res, want_cost, want_count in zip(results, analytic, oracles):
        if not res.ok:
            raise RuntimeError(f"batched: {res.error}")
        count = weighted_total(query, res.output) / 3
        lanes.append({
            "read": res.measured["read"],
            "shuffled": res.measured["shuffled"],
            "total": res.measured["total"],
            "analytic_total": want_cost,
            "triangles": count,
            "oracle": want_count,
            "match": res.measured["total"] == want_cost
            and count == want_count,
        })
    return {
        "n_tenants": N_TENANTS,
        "batches_dispatched": int(n_batches),
        "one_laned_execution": n_batches == 1,
        "wall_ms": wall_ms if on_gpu else None,
        "qps": N_TENANTS / (wall_ms / 1e3) if on_gpu else None,
        "lanes": lanes,
    }


def bench_ingest(eng, tmpdir, on_gpu):
    """Streaming micro-batches against standing triangle / 3-path
    aggregates: exactness after every batch, delta-vs-recompute tuple
    savings."""
    src, dst = unique_edges(0)
    store = ServingStore(tmpdir, eng, num_partitions=K,
                         drift_threshold=None, delta_capacity=16)
    store.register_aggregate("tri", "cycle", 3)
    store.register_aggregate("p3", "chain", 3)
    store.load_edges(src, dst)

    rng = np.random.default_rng(42)
    batches = []
    delta_total = recompute_total = 0.0
    all_exact = True
    for step in range(N_INGEST_BATCHES):
        cur = set(zip(store.src.tolist(), store.dst.tolist()))
        ins = []
        while len(ins) < INGEST_INSERTS:
            e = (int(rng.integers(0, N_NODES)),
                 int(rng.integers(0, N_NODES)))
            if e not in cur and e not in ins:
                ins.append(e)
        dels = []
        if INGEST_DELETES[step]:
            pick = rng.choice(store.n_edges, size=INGEST_DELETES[step],
                              replace=False)
            dels = [(int(store.src[i]), int(store.dst[i])) for i in pick]
        t0 = time.perf_counter()
        rep = store.apply_deltas(
            inserts=(np.array([a for a, b in ins]),
                     np.array([b for a, b in ins])),
            deletes=None if not dels else
                    (np.array([a for a, b in dels]),
                     np.array([b for a, b in dels])))
        batch_ms = (time.perf_counter() - t0) * 1e3
        row = {"n_inserts": len(ins), "n_deletes": len(dels),
               "version": rep["version"],
               "batch_ms": batch_ms if on_gpu else None,
               "aggregates": {}}
        for name in ("tri", "p3"):
            a = rep["aggregates"][name]
            maintained = store.aggregates[name].value
            want = (float(oracle_triangles(store.src, store.dst))
                    if name == "tri" else store.analytic_value(name))
            # the /3 triangle divisor accumulates one float64 ulp across
            # batches; "exact" means exact up to that
            exact = math.isclose(maintained, want, rel_tol=1e-9)
            all_exact &= exact
            delta_total += a["total"]
            recompute_total += a["recompute_cost"]
            row["aggregates"][name] = {
                "mode": a["mode"], "value": maintained, "expected": want,
                "exact": exact,
                "read": a["read"], "shuffled": a["shuffled"],
                "total": a["total"], "recompute_cost": a["recompute_cost"],
            }
        batches.append(row)

    return {
        "n_edges_initial": M_EDGES,
        "n_edges_final": store.n_edges,
        "versions_committed": store.version,
        "batches": batches,
        "all_values_exact": all_exact,
        "delta_total": delta_total,
        "recompute_total": recompute_total,
        "savings_ratio": 1.0 - delta_total / recompute_total,
        "delta_beats_recompute": delta_total < recompute_total,
    }


def run(*, fast: bool, device=None,
        out: str = "BENCH_torch_serving.json") -> dict:
    """Run the three phases, write ``out`` and return the report."""
    device = config.resolve_device(device)
    on_gpu = device.type == "cuda"
    warm_repeats = WARM_REPEATS_FAST if fast else WARM_REPEATS_FULL
    eng = QueryEngine(QueryServeConfig(k=K, cache_capacity=64),
                      device=device)
    serve = bench_serve(eng, warm_repeats, on_gpu)
    batched = bench_batched(eng, on_gpu)
    with tempfile.TemporaryDirectory() as tmpdir:
        ingest = bench_ingest(eng, tmpdir, on_gpu)
    snapshot = eng.stats.snapshot()
    if not on_gpu:   # wall-clock fields exist only on a GPU
        for key in ("p50_ms", "p99_ms", "qps"):
            snapshot[key] = None
    p99_bound = (max(P99_FLOOR_MS, P99_P50_FACTOR * serve["warm_p50_ms"])
                 if on_gpu else None)
    gates = {
        "serve_accounting": serve["match"],
        "serve_speedup": (serve["speedup"] >= SPEEDUP_GATE
                          if on_gpu else None),
        "batched_single_dispatch": batched["one_laned_execution"],
        "batched_accounting": all(lane["match"] for lane in batched["lanes"]),
        "ingest_exact": ingest["all_values_exact"],
        "ingest_savings": ingest["delta_beats_recompute"],
        # the serve phase: ingest misses every batch (its stats
        # signature changes), so the overall hit rate reflects the mix
        "cache_hit_rate": serve["hit_rate"] >= HIT_RATE_GATE,
        "warm_p99_bounded": (serve["warm_p99_ms"] <= p99_bound
                             if on_gpu else None),
    }
    report = {
        "benchmark": "serving_sweep_torch", "fast": fast, "k": K,
        "n_nodes": N_NODES, "m_edges": M_EDGES,
        "device": device_record(device),
        "speedup_gate": SPEEDUP_GATE, "hit_rate_gate": HIT_RATE_GATE,
        "p99_bound_ms": p99_bound,
        "serve": serve, "batched": batched, "ingest": ingest,
        "serving_stats": snapshot, "gates": gates,
    }
    clear_compiled_caches()
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="fewer warm repeats; accounting fields are "
                         "identical to full mode")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every check holds and the "
                         "counts equal the JAX package's pins")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' for counts only")
    ap.add_argument("--out", default="BENCH_torch_serving.json")
    args = ap.parse_args(argv)
    report = run(fast=args.fast, device=args.device, out=args.out)
    serve, batched, ingest = (report["serve"], report["batched"],
                              report["ingest"])
    times = ("" if serve["cold_ms"] is None else
             f" cold={serve['cold_ms']:.1f}ms warm_p50="
             f"{serve['warm_p50_ms']:.2f}ms warm_p99="
             f"{serve['warm_p99_ms']:.2f}ms speedup={serve['speedup']:.0f}x")
    print(f"serve: {'MATCH' if serve['match'] else 'MISMATCH'}{times}")
    lanes_ok = all(lane["match"] for lane in batched["lanes"])
    print(f"batched: {batched['n_tenants']} tenants in "
          f"{batched['batches_dispatched']} execution(s), lanes "
          f"{'MATCH' if lanes_ok else 'MISMATCH'}"
          + ("" if batched["wall_ms"] is None else
             f" wall={batched['wall_ms']:.1f}ms"))
    print(f"ingest: {len(ingest['batches'])} batches, "
          f"exact={ingest['all_values_exact']}, "
          f"delta={ingest['delta_total']:.0f} vs "
          f"recompute={ingest['recompute_total']:.0f} tuples "
          f"(saves {ingest['savings_ratio']:.0%})"
          + "".join(f" batch{i}_ms={b['batch_ms']:.1f}"
                    for i, b in enumerate(ingest["batches"])
                    if b["batch_ms"] is not None))
    all_ok = True
    for name, ok in report["gates"].items():
        print(f"gate {name}: "
              f"{'not measured' if ok is None else 'PASS' if ok else 'FAIL'}")
        all_ok &= ok is not False
    all_ok &= report_pins(report, "BENCH_serving.json", complete=True)
    print(f"wrote {args.out} ({report['device']})")
    return 1 if args.check and not all_ok else 0


if __name__ == "__main__":
    sys.exit(main())
