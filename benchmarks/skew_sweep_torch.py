"""Skew sweep on the PyTorch port: plain Shares vs SharesSkew on
Zipf-distributed chains.

The port of ``benchmarks/skew_sweep.py``.  For each Zipf exponent
alpha: generate a three-way self-chain over Zipf(alpha) edge endpoints,
compute exact statistics and the top-k key-frequency sketch, let
``plan_chain`` choose among {Shares, SharesSkew, cascade,
cascade+pushdown} by skew-adjusted cost, execute plain one-round Shares
on the integer-share grid and (when skew is detected) the SharesSkew
union of per-combination sub-joins, both with ``measure_skew=True``
(the ``hash_histogram`` kernel's ``bucket_counts`` on a GPU), and
check

* measured read/shuffled == the analytic model, exactly, on both paths;
* at Zipf(1.2) the planner picks 1,3JS and the SharesSkew
  ``max_bucket_load`` is strictly below plain Shares' at the same
  reducer budget;
* on uniform data the skew path is never selected and detection finds
  nothing.

``--check`` exits non-zero unless all of these hold and the counts
equal the JAX package's ``BENCH_skew.json`` pins (all 20 at the
default ``--nodes 800 --edges 160 --k 64 --seed 3``).  Each path's wall
time (``wall_ms``) is written on a GPU and null on the CPU.  Writes
``BENCH_torch_skew.json`` (``--out`` to override).

  PYTHONPATH=src python benchmarks/skew_sweep_torch.py [--check]
      [--device cpu]
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
from repro_torch.core import (ChainCaps, ChainQuery, SimGrid,  # noqa: E402
                              chain_edge_inputs, chain_replications,
                              chain_stats_exact, detect_chain_skew,
                              edge_relation, one_round_chain, plan_chain,
                              shares_skew_chain, skew_crossover_scale)
from repro_torch.data.graphs import zipf_edges  # noqa: E402

ALPHAS = (0.0, 0.8, 1.2, 1.4)
DEFAULTS = dict(nodes=800, edges=160, k=64, seed=3)

# mid/local stay tight on the full-size grid (they bound per-reducer
# residency, the quantity under test); heavy combinations run on few
# reducers and need room for their broadcast parts.  ``out`` is sized
# for the hottest reducer of the *plain* path, which under skew holds
# all paths through the top key pair.
BASE_CAPS = ChainCaps(recv=256, mid=1024, out=65536, local=1024)
HEAVY_CAPS = ChainCaps(recv=256, mid=2048, out=65536, local=2048)


def run_plain(query, edges, grid_shape, device):
    grid = SimGrid(grid_shape)
    rels = chain_edge_inputs(query, edges, grid_shape, device=device)
    (_, st, ovf), ms = timed(lambda: one_round_chain(
        grid, query, rels, caps=BASE_CAPS, measure_skew=True), device)
    if bool(ovf):
        raise RuntimeError("plain Shares overflow — raise capacities")
    return {k: float(v) for k, v in st.items()}, ms


def run_skew(query, edges, plan, device):
    flat = [edge_relation(s, d, names=query.schema(j), device=device)
            for j, (s, d) in enumerate(edges)]

    def caps(combo):
        return BASE_CAPS if combo.grid_shape == plan.base_shape \
            else HEAVY_CAPS

    (_, st, ovf), ms = timed(lambda: shares_skew_chain(
        query, flat, plan, caps=caps, measure_skew=True), device)
    if bool(ovf):
        raise RuntimeError("SharesSkew overflow — raise capacities")
    return {k: float(v) for k, v in st.items()}, ms


def bench_alpha(alpha, n_nodes, n_edges, k, seed, device):
    src, dst = zipf_edges(n_nodes, n_edges, alpha, seed=seed)
    edges = [(src, dst)] * 3
    query = ChainQuery.three_way()
    stats = chain_stats_exact(edges, sketch_top_k=16)
    plan = plan_chain(stats, k, aggregate=False)
    skew_plan = detect_chain_skew(query, edges, k, device=device)

    measured_plain, ms_plain = run_plain(query, edges, plan.grid_shape,
                                         device)
    repl = chain_replications(stats.sizes, plan.grid_shape)
    plain_analytic = sum(r * f for r, f in zip(stats.sizes, repl))
    row = {
        "alpha": alpha,
        "sizes": list(stats.sizes),
        "prefix_joins": list(stats.prefix_joins),
        "top_key_freqs": [list(stats.key_freqs[d][0])
                          for d in range(2) if stats.key_freqs[d]],
        "planner_choice": plan.algorithm,
        "skew_detected": plan.skew_detected,
        "costs": plan.costs,
        "adjusted_costs": plan.adjusted_costs,
        "crossover_scale": skew_crossover_scale(stats, k),
        "plain": {
            "grid_shape": list(plan.grid_shape), **measured_plain,
            "analytic_shuffled": plain_analytic,
            "match": measured_plain["shuffled"] == plain_analytic,
            "wall_ms": ms_plain,
        },
    }
    if skew_plan is not None:
        measured_skew, ms_skew = run_skew(query, edges, skew_plan, device)
        row["shares_skew"] = {
            "n_heavy": list(skew_plan.n_heavy),
            "combos": [{"heavy_dims": list(c.heavy_dims),
                        "sizes": list(c.sizes),
                        "grid_shape": list(c.grid_shape)}
                       for c in skew_plan.combos],
            **measured_skew,
            "analytic_read": skew_plan.read_cost(),
            "analytic_shuffled": skew_plan.shuffle_cost(),
            "match": measured_skew["read"] == skew_plan.read_cost()
            and measured_skew["shuffled"] == skew_plan.shuffle_cost(),
            "beats_plain_load": measured_skew["max_bucket_load"]
            < measured_plain["max_bucket_load"],
            "wall_ms": ms_skew,
        }
    return row


def acceptance(report: dict) -> bool:
    """Zipf(1.2) selects SharesSkew with strictly better balance and
    exact cost accounting; uniform data does not."""
    by_alpha = {r["alpha"]: r for r in report["rows"]}
    if 0.0 not in by_alpha or 1.2 not in by_alpha:
        return False
    r0, r12 = by_alpha[0.0], by_alpha[1.2]
    return ("JS" not in r0["planner_choice"] and not r0["skew_detected"]
            and r12["planner_choice"] == "1,3JS"
            and r12["plain"]["match"] and "shares_skew" in r12
            and r12["shares_skew"]["match"]
            and r12["shares_skew"]["beats_plain_load"])


def run(*, nodes: int = DEFAULTS["nodes"], edges: int = DEFAULTS["edges"],
        k: int = DEFAULTS["k"], seed: int = DEFAULTS["seed"], device=None,
        out: str = "BENCH_torch_skew.json") -> dict:
    """Sweep the exponents, write ``out`` and return the report."""
    device = config.resolve_device(device)
    report = {"benchmark": "skew_sweep_torch", "n_nodes": nodes,
              "n_edges": edges, "k": k, "seed": seed,
              "alphas": list(ALPHAS), "device": device_record(device),
              "rows": [bench_alpha(a, nodes, edges, k, seed, device)
                       for a in ALPHAS]}
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=DEFAULTS["nodes"])
    ap.add_argument("--edges", type=int, default=DEFAULTS["edges"])
    ap.add_argument("--k", type=int, default=DEFAULTS["k"])
    ap.add_argument("--seed", type=int, default=DEFAULTS["seed"])
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every check holds and the "
                         "counts equal the JAX package's pins")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' for counts only")
    ap.add_argument("--out", default="BENCH_torch_skew.json")
    args = ap.parse_args(argv)
    report = run(nodes=args.nodes, edges=args.edges, k=args.k,
                 seed=args.seed, device=args.device, out=args.out)
    all_ok = True
    for row in report["rows"]:
        skew = row.get("shares_skew")
        all_ok &= row["plain"]["match"] and (skew is None or skew["match"])
        times = ("" if row["plain"]["wall_ms"] is None else
                 f" plain_ms={row['plain']['wall_ms']:.2f}"
                 + ("" if skew is None else
                    f" skew_ms={skew['wall_ms']:.2f}"))
        print(f"alpha={row['alpha']}: plan={row['planner_choice']} "
              f"plain_load={row['plain']['max_bucket_load']:.0f} "
              f"plain_match="
              f"{'MATCH' if row['plain']['match'] else 'MISMATCH'}"
              + (f" skew_load={skew['max_bucket_load']:.0f} "
                 f"skew_match={'MATCH' if skew['match'] else 'MISMATCH'} "
                 f"beats_plain={skew['beats_plain_load']}"
                 if skew else "  (no skew detected)") + times)
    accepted = acceptance(report)
    print(f"acceptance (Zipf(1.2) -> 1,3JS, measured==analytic, skew load "
          f"< plain load; uniform -> no skew path): "
          f"{'PASS' if accepted else 'FAIL'}")
    complete = all(getattr(args, key) == v for key, v in DEFAULTS.items())
    all_ok &= accepted & report_pins(report, "BENCH_skew.json", complete)
    print(f"wrote {args.out} ({report['device']})")
    return 1 if args.check and not all_ok else 0


if __name__ == "__main__":
    sys.exit(main())
