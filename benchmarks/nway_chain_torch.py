"""N-way chain-join benchmark on the PyTorch port: one-round Shares vs
cascade(+pushdown).

The port of ``benchmarks/nway_chain.py``.  For each chain length
N ∈ {3, 4, 5}: generate a chain of random edge relations, compute
exact chain statistics on the host, sweep the analytic cost model over
cluster sizes k, execute all three strategies through ``execute_chain``
on a ``SimGrid`` (``measure_skew=True``) and check measured
communication == analytic, exactly; record what the planner picks.

``--check`` exits non-zero unless every run matches the cost model and
the tuple counts (read, shuffled, max_bucket_load, total of every
measured run) equal the JAX package's ``BENCH_nway.json`` pins in
``tests/data/bench_counts_seed.json`` (all 36 at the default
``--edges 120 --seed 7``; the pins a run reaches otherwise).  Each
run's wall time (``wall_ms``, the device synchronized around it) is
written on a GPU and null on the CPU.  Writes
``BENCH_torch_nway.json`` (``--out`` to override).

  PYTHONPATH=src python benchmarks/nway_chain_torch.py [--edges 120]
      [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import device_record, report_pins, timed  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.core import (ChainQuery, SimGrid, chain_edge_inputs,  # noqa: E402
                              chain_replications, chain_stats_exact,
                              cost_chain_cascade, cost_chain_cascade_pushdown,
                              default_chain_caps, execute_chain,
                              integer_shares, plan_chain)

SWEEP_K = (16, 64, 256, 1024, 4096)
EXEC_K = 8                    # executable grid size for the measured runs
DEFAULT_EDGES, DEFAULT_SEED = 120, 7


def measured_run(strategy, query, edge_lists, stats, grid_shape, device):
    grid = SimGrid(grid_shape)
    rels = chain_edge_inputs(query, edge_lists, grid_shape, device=device)
    (out, st, ovf), ms = timed(lambda: execute_chain(
        grid, query, rels, strategy=strategy,
        caps=default_chain_caps(stats, grid_shape, slack=4),
        measure_skew=True), device)
    if bool(ovf):
        raise RuntimeError(f"{strategy} overflow — capacities undersized")
    st = {k: float(v) for k, v in st.items()}
    st.setdefault("total", st["read"] + st["shuffled"])
    return out, st, ms


def bench_chain(n: int, n_edges: int, rng, device) -> dict:
    # Average degree ~2 keeps intermediate sizes small while the chain
    # still fans out ~2x per hop.
    nodes = max(8, n_edges // 2)
    edges = [(rng.integers(0, nodes, n_edges).astype(np.int32),
              rng.integers(0, nodes, n_edges).astype(np.int32))
             for _ in range(n)]
    stats = chain_stats_exact(edges)
    sizes = stats.sizes

    analytic = {str(k): stats.costs(k, aggregate=True) for k in SWEEP_K}
    plans = {
        "enumeration": plan_chain(stats, EXEC_K, aggregate=False).algorithm,
        "aggregation": plan_chain(stats, EXEC_K, aggregate=True).algorithm,
    }

    shares = integer_shares(sizes, EXEC_K)
    query = ChainQuery.chain(n)
    query_agg = ChainQuery.chain(n, aggregate=True)
    cascade_shape = (EXEC_K // 2, 2)

    _, st_one, ms_one = measured_run("one_round", query, edges, stats,
                                     shares, device)
    repl = chain_replications(sizes, shares)
    one_analytic = {
        "read": sum(sizes),
        "shuffled": sum(r * f for r, f in zip(sizes, repl)),
    }
    _, st_casc, ms_casc = measured_run("cascade", query, edges, stats,
                                       cascade_shape, device)
    _, st_push, ms_push = measured_run("cascade_pushdown", query_agg, edges,
                                       stats, cascade_shape, device)
    casc_analytic = cost_chain_cascade(sizes, stats.prefix_joins)
    push_analytic = cost_chain_cascade_pushdown(
        sizes, stats.prefix_joins, stats.prefix_aggs, stats.pushdown_joins)

    measured = {
        "k": EXEC_K,
        "one_round": {
            "grid_shape": list(shares), **st_one,
            "analytic_shuffled": one_analytic["shuffled"],
            "match": st_one["read"] == one_analytic["read"]
            and st_one["shuffled"] == one_analytic["shuffled"],
            "wall_ms": ms_one,
        },
        "cascade": {
            "grid_shape": list(cascade_shape), **st_casc,
            "analytic_total": casc_analytic,
            "match": st_casc["total"] == casc_analytic,
            "wall_ms": ms_casc,
        },
        "cascade_pushdown": {
            "grid_shape": list(cascade_shape), **st_push,
            "analytic_total": push_analytic,
            "match": st_push["total"] == push_analytic,
            "wall_ms": ms_push,
        },
    }
    return {
        "n_relations": n,
        "sizes": list(sizes),
        "prefix_joins": list(stats.prefix_joins),
        "prefix_aggs": list(stats.prefix_aggs or ()),
        "pushdown_joins": list(stats.pushdown_joins or ()),
        "analytic_costs": analytic,
        "planner_choice": plans,
        "measured": measured,
    }


def run(*, edges: int = DEFAULT_EDGES, seed: int = DEFAULT_SEED,
        device=None, out: str = "BENCH_torch_nway.json") -> dict:
    """Run the three chain lengths, write ``out`` and return the report."""
    device = config.resolve_device(device)
    rng = np.random.default_rng(seed)
    report = {"benchmark": "nway_chain_torch", "sweep_k": list(SWEEP_K),
              "exec_k": EXEC_K, "edges": edges, "seed": seed,
              "device": device_record(device), "chains": {}}
    for n in (3, 4, 5):
        report["chains"][str(n)] = bench_chain(n, edges, rng, device)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", type=int, default=DEFAULT_EDGES)
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless measured == analytic and "
                         "the counts equal the JAX package's pins")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' for counts only")
    ap.add_argument("--out", default="BENCH_torch_nway.json")
    args = ap.parse_args(argv)
    report = run(edges=args.edges, seed=args.seed, device=args.device,
                 out=args.out)
    all_ok = True
    for n, row in report["chains"].items():
        m = row["measured"]
        ok = all(m[s]["match"] for s in ("one_round", "cascade",
                                         "cascade_pushdown"))
        all_ok &= ok
        print(f"N={n}: planner enum={row['planner_choice']['enumeration']} "
              f"agg={row['planner_choice']['aggregation']}; "
              f"measured==analytic: {'MATCH' if ok else 'MISMATCH'}")
        for s in ("one_round", "cascade", "cascade_pushdown"):
            ms = m[s]["wall_ms"]
            print(f"   {s:17s} total={m[s]['total']:.0f} "
                  f"max_load={m[s]['max_bucket_load']:.0f} "
                  f"grid={m[s]['grid_shape']}"
                  + ("" if ms is None else f" wall_ms={ms:.2f}"))
    complete = (args.edges, args.seed) == (DEFAULT_EDGES, DEFAULT_SEED)
    all_ok &= report_pins(report, "BENCH_nway.json", complete)
    print(f"wrote {args.out} ({report['device']})")
    return 1 if args.check and not all_ok else 0


if __name__ == "__main__":
    sys.exit(main())
