"""Triangle benchmark on the PyTorch port: the cycle query vs its
chain+filter oracle.

The port of ``benchmarks/triangle_sweep.py``.  Triangle counting is a
query, not an algorithm: each graph's triangles are counted three ways,
each held to the host oracle while measured communication equals the
analytic model exactly:

* **cycle-Shares** — ``JoinQuery.triangle()`` one-round on the rank-3
  join-attribute hypercube (integer shares from the general solver).
  Measured read must be Σ r_j and measured shuffle Σ r_j · K/m_j.
* **cycle-cascade** — the same query as two two-way rounds along the
  planner's best join order, the closing ``c,a`` equalities filtering
  at the second hop; measured total == ``cost_query_cascade``.
* **chain+filter** — enumerate the full 3-chain
  (``ChainQuery.three_way(aggregate=True)`` one-round, 1,3JA) and keep
  the ``a == d`` diagonal (``triangle_count_from_a3``); measured
  communication == the chain cost model plus the charged aggregation.

Every run has ``measure_skew=True``.  Also sweeps the analytic
one-round vs cascade costs over cluster sizes and records the planner's
choice.  ``--fast`` runs the one small graph; ``--check`` exits non-zero
unless every measured==analytic and count==oracle gate holds and the
counts equal the JAX package's ``BENCH_triangles.json`` pins (all 42 in
full mode; the 14 of ``amazon`` with ``--fast``).  Each run's wall time
(``wall_ms``) is written on a GPU and null on the CPU.  Writes
``BENCH_torch_triangles.json`` (``--out`` to override).

  PYTHONPATH=src python benchmarks/triangle_sweep_torch.py [--fast]
      [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import device_record, report_pins, timed  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.core import (ChainQuery, JoinQuery, SimGrid,  # noqa: E402
                              chain_edge_inputs, chain_replications,
                              chain_stats_exact, cost_query_one_round,
                              default_chain_caps, default_query_caps,
                              execute_chain, execute_query, integer_shares,
                              integer_shares_query, oracle_triangles,
                              plan_query, query_replications,
                              query_stats_exact, query_table_inputs,
                              triangle_count_from_a3)
from repro_torch.data.graphs import (DATASETS, GraphSpec,  # noqa: E402
                                     rmat_edges, zipf_edges)

SWEEP_K = (8, 64, 512, 4096)
EXEC_K = 8                    # executable grid size for the measured runs


def graph_suite(fast: bool):
    """(name, (src, dst)) pairs — downscaled R-MAT families + a Zipf
    list, small enough for the host oracle."""
    def down(spec, scale, factor):
        return GraphSpec(spec.name, scale, min(spec.edge_factor, factor),
                         spec.a)

    graphs = [("amazon", rmat_edges(down(DATASETS["amazon"], 8, 3.0), seed=1))]
    if not fast:
        graphs.append(("wikitalk",
                       rmat_edges(down(DATASETS["wikitalk"], 7, 4.0), seed=1)))
        graphs.append(("zipf-1.1", zipf_edges(128, 400, 1.1, seed=3)))
    return graphs


def stat_floats(st):
    out = {k: float(v) for k, v in st.items()}
    out.setdefault("total", out["read"] + out["shuffled"])
    return out


def run_cycle(query, edges, stats, strategy, grid_shape, join_order,
              device):
    grid = SimGrid(grid_shape)
    rels = query_table_inputs(query, [edges] * 3, grid_shape, device=device)
    # Generous slack: the Zipf graph concentrates one hub's matches on a
    # single reducer, and sort-merge buffers are linear in capacity.
    caps = default_query_caps(query, stats, grid_shape, slack=16)
    (out, st, ovf), ms = timed(lambda: execute_query(
        grid, query, rels, strategy=strategy, caps=caps,
        join_order=join_order, measure_skew=True), device)
    if bool(ovf):
        raise RuntimeError(f"cycle {strategy} overflow — caps undersized")
    count = float(out.valid.sum()) / 3.0
    return count, stat_floats(st), ms


def run_chain_filter(edges, k, device):
    """The oracle path: full 3-chain one-round Shares + diagonal filter."""
    query = ChainQuery.three_way(aggregate=True)
    cstats = chain_stats_exact([edges] * 3)
    grid_shape = integer_shares(cstats.sizes, k)
    grid = SimGrid(grid_shape)
    rels = chain_edge_inputs(query, [edges] * 3, grid_shape, device=device)
    # slack == n_devices makes every buffer total-sized (lossless): on
    # skewed graphs one reducer can hold nearly the whole 3-chain.
    n_dev = 1
    for s in grid_shape:
        n_dev *= s
    caps = default_chain_caps(cstats, grid_shape, slack=n_dev)
    (a3, st, ovf), ms = timed(lambda: execute_chain(
        grid, query, rels, strategy="one_round", caps=caps,
        measure_skew=True), device)
    if bool(ovf):
        raise RuntimeError("chain+filter overflow — capacities undersized")
    count = float(triangle_count_from_a3(a3))
    repl = chain_replications(cstats.sizes, grid_shape)
    j3 = cstats.prefix_joins[-1]
    # 1,3JA accounting: Shares placement (read Σr, shuffle Σ r·K/m) plus
    # the charged aggregation round over the raw 3-chain result (read j3,
    # shuffle j3) — the 2·r''' term the cycle query never pays.
    analytic = {
        "read": sum(cstats.sizes) + j3,
        "shuffled": sum(r * f for r, f in zip(cstats.sizes, repl)) + j3,
    }
    st = stat_floats(st)
    match = (st["read"] == analytic["read"]
             and st["shuffled"] == analytic["shuffled"])
    return count, st, analytic, match, list(grid_shape), ms


def bench_graph(name, edges, device):
    src, dst = edges
    tri_oracle = oracle_triangles(src, dst)
    query = JoinQuery.triangle()
    stats = query_stats_exact(query, [edges] * 3)
    rel_dims = query.rel_dims()
    sizes = stats.sizes

    plan = plan_query(query, stats, EXEC_K)
    analytic_sweep = {
        str(k): {
            "one_round": cost_query_one_round(rel_dims, sizes, k),
            "cascade": stats.best_order()[1],
        } for k in SWEEP_K
    }

    grid_shape = integer_shares_query(rel_dims, sizes, EXEC_K)
    tri_one, st_one, ms_one = run_cycle(query, edges, stats, "one_round",
                                        grid_shape, plan.join_order, device)
    repl = query_replications(rel_dims, grid_shape)
    one_analytic = {
        "read": sum(sizes),
        "shuffled": sum(r * f for r, f in zip(sizes, repl)),
    }
    one = {
        "grid_shape": list(grid_shape), **st_one,
        "analytic_shuffled": one_analytic["shuffled"],
        "triangles": tri_one,
        "match": st_one["read"] == one_analytic["read"]
        and st_one["shuffled"] == one_analytic["shuffled"],
        "wall_ms": ms_one,
    }

    order, casc_analytic = stats.best_order()
    inter = stats.intermediates[stats.orders.index(order)]
    tri_casc, st_casc, ms_casc = run_cycle(query, edges, stats, "cascade",
                                           (EXEC_K,), order, device)
    casc = {
        "grid_shape": [EXEC_K], "join_order": list(order), **st_casc,
        "analytic_total": casc_analytic,
        "intermediates": list(inter),
        "triangles": tri_casc,
        "match": st_casc["total"] == casc_analytic,
        "wall_ms": ms_casc,
    }

    tri_chain, st_chain, chain_analytic, chain_match, chain_grid, ms_chain \
        = run_chain_filter(edges, EXEC_K, device)
    chain = {
        "grid_shape": chain_grid, **st_chain,
        "analytic": chain_analytic,
        "triangles": tri_chain,
        "match": chain_match,
        "wall_ms": ms_chain,
    }

    # Counts are multiples of 1/3; the chain+filter path sums float32
    # path counts, so compare at nearest-third precision.
    def thirds(x):
        return round(3.0 * x)

    counts_ok = (thirds(tri_one) == thirds(tri_oracle)
                 and thirds(tri_casc) == thirds(tri_oracle)
                 and thirds(tri_chain) == thirds(tri_oracle))
    return {
        "graph": name,
        "edges": float(len(src)),
        "triangles_oracle": tri_oracle,
        "planner_choice": plan.algorithm,
        "planner_costs": plan.costs,
        "analytic_costs": analytic_sweep,
        "measured": {"k": EXEC_K, "cycle_one_round": one,
                     "cycle_cascade": casc, "chain_filter": chain},
        "counts_match_oracle": counts_ok,
    }


def run(*, fast: bool, device=None,
        out: str = "BENCH_torch_triangles.json") -> dict:
    """Run the graph suite, write ``out`` and return the report."""
    device = config.resolve_device(device)
    report = {"benchmark": "triangle_sweep_torch", "sweep_k": list(SWEEP_K),
              "exec_k": EXEC_K, "fast": fast,
              "device": device_record(device), "graphs": {}}
    for name, edges in graph_suite(fast):
        report["graphs"][name] = bench_graph(name, edges, device)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="one small graph")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless measured==analytic, all "
                         "counts equal the oracle and the counts equal "
                         "the JAX package's pins")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' for counts only")
    ap.add_argument("--out", default="BENCH_torch_triangles.json")
    args = ap.parse_args(argv)
    report = run(fast=args.fast, device=args.device, out=args.out)
    all_ok = True
    for name, row in report["graphs"].items():
        m = row["measured"]
        match_ok = all(m[s]["match"] for s in ("cycle_one_round",
                                               "cycle_cascade",
                                               "chain_filter"))
        all_ok &= match_ok and row["counts_match_oracle"]
        print(f"{name}: triangles={row['triangles_oracle']:.0f} "
              f"planner={row['planner_choice']} "
              f"measured==analytic: {'MATCH' if match_ok else 'MISMATCH'} "
              f"counts: {'OK' if row['counts_match_oracle'] else 'WRONG'}")
        for s in ("cycle_one_round", "cycle_cascade", "chain_filter"):
            ms = m[s]["wall_ms"]
            print(f"   {s:15s} total={m[s]['total']:.0f} "
                  f"max_load={m[s]['max_bucket_load']:.0f} "
                  f"grid={m[s]['grid_shape']}"
                  + ("" if ms is None else f" wall_ms={ms:.2f}"))
    all_ok &= report_pins(report, "BENCH_triangles.json",
                          complete=not args.fast)
    print(f"wrote {args.out} ({report['device']})")
    return 1 if args.check and not all_ok else 0


if __name__ == "__main__":
    sys.exit(main())
