"""Resilience sweep on the PyTorch port: what failure costs, per
strategy.

The port of ``benchmarks/resilience_sweep.py``.  Two phases over the
3-relation chain join (160 edges over 80 nodes, seed 5, k = 8):

* **overhead** — the resilient executors run the exact lowering of the
  plain ones, hop by hop, so fault-free they must be bit-identical
  (outputs, stats, overflow) and their measured tuples must equal the
  analytic cost model on the exact statistics.  On a GPU the wall-clock
  overhead of resilient over plain execution (medians of
  ``OVERHEAD_REPEATS_*``) is gated at ``OVERHEAD_GATE`` in full mode;
  ``--fast`` takes fewer repeats and skips the gate, and on the CPU the
  times are null and the gate not measured.
* **sweep** — injected worker crashes at rates 0.0 … 0.3 across the
  shuffle / placement / reducer sites, seeds 0…2 each, for the three
  resilient configurations: one-round Shares (reducer-granular
  recovery), cascade (hop-granular, in-memory lineage), cascade with
  materialized hop snapshots.  Every faulted run must return the
  fault-free answer bit-identically or die with the typed
  ``HopFailed``; each cell records the recovery accounting
  (``recovery.read`` / ``shuffled`` / ``total`` in tuple units,
  deterministic under the seeded injector).

``--check`` exits non-zero unless every gate holds and the counts
equal the JAX package's ``BENCH_resilience.json`` pins (all 117; no
count depends on ``--fast``).  Writes ``BENCH_torch_resilience.json``
(``--out`` to override).

  PYTHONPATH=src python benchmarks/resilience_sweep_torch.py [--fast]
      [--check] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from bench_common_torch import device_record, report_pins  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.core import (JoinQuery, SimGrid,  # noqa: E402
                              cost_query_cascade, default_query_caps,
                              integer_shares_query, query_replications,
                              query_stats_exact, query_table_inputs)
from repro_torch.core.executor import cascade_query, one_round_query  # noqa: E402
from repro_torch.resilience import (FaultInjector, FaultSpec,  # noqa: E402
                                    HopFailed, resilient_cascade_query,
                                    resilient_one_round_query)

K = 8
M_EDGES = 160
N_NODES = 80
GRAPH_SEED = 5
JOIN_ORDER = (0, 1, 2)        # fixed order => analytic cascade is exact
SLACK = 8

RATES = (0.0, 0.1, 0.2, 0.3)
FAULT_SEEDS = (0, 1, 2)

OVERHEAD_GATE = 0.05          # resilient <= 1.05 x plain, fault-free
OVERHEAD_FLOOR_MS = 0.25      # absolute jitter guard on the gate
OVERHEAD_REPEATS_FULL = 30
OVERHEAD_REPEATS_FAST = 5
CONFIGS = ("one_round", "cascade", "cascade_snapshots")


def workload():
    rng = np.random.default_rng(GRAPH_SEED)
    query = JoinQuery.chain(3)
    tables = [(rng.integers(0, N_NODES, M_EDGES).astype(np.int32),
               rng.integers(0, N_NODES, M_EDGES).astype(np.int32))
              for _ in range(3)]
    stats = query_stats_exact(query, tables)
    return query, tables, stats


def results_equal(a, b) -> bool:
    """Output relation, every stat and the overflow flag equal, array
    for array (padding and row order included)."""
    (out_a, st_a, ovf_a), (out_b, st_b, ovf_b) = a[:3], b[:3]
    return (torch.equal(out_a.valid, out_b.valid)
            and sorted(out_a.cols) == sorted(out_b.cols)
            and all(torch.equal(c, out_b.cols[n])
                    for n, c in out_a.cols.items())
            and sorted(st_a) == sorted(st_b)
            and all(torch.equal(v, st_b[k]) for k, v in st_a.items())
            and torch.equal(ovf_a, ovf_b))


def stat_floats(st):
    out = {k: float(v) for k, v in st.items()}
    out.setdefault("total", out["read"] + out["shuffled"])
    return out


def build_configs(query, tables, stats, device):
    """The three resilient configurations, each with its plain twin."""
    or_shape = integer_shares_query(query.rel_dims(), stats.sizes, K)
    c_shape = (K,)
    or_grid, c_grid = SimGrid(or_shape), SimGrid(c_shape)
    or_rels = query_table_inputs(query, tables, or_shape, device=device)
    c_rels = query_table_inputs(query, tables, c_shape, device=device)
    or_caps = default_query_caps(query, stats, or_shape, slack=SLACK)
    c_caps = default_query_caps(query, stats, c_shape, slack=SLACK)

    def plain_one_round():
        return one_round_query(or_grid, query, or_rels, caps=or_caps,
                               join_order=JOIN_ORDER)

    def plain_cascade():
        return cascade_query(c_grid, query, c_rels, caps=c_caps,
                             join_order=JOIN_ORDER)

    def res_one_round():
        return resilient_one_round_query(or_grid, query, or_rels,
                                         caps=or_caps, join_order=JOIN_ORDER)

    def res_cascade(snapshot_dir=None):
        return resilient_cascade_query(c_grid, query, c_rels, caps=c_caps,
                                       join_order=JOIN_ORDER,
                                       snapshot_dir=snapshot_dir)

    return {
        "one_round": {
            "grid_shape": list(or_shape), "plain": plain_one_round,
            "resilient": res_one_round, "snapshots": False,
            "specs": lambda r: [FaultSpec("shuffle", "crash", r),
                                FaultSpec("reducer", "crash", r)],
        },
        "cascade": {
            "grid_shape": list(c_shape), "plain": plain_cascade,
            "resilient": res_cascade, "snapshots": False,
            "specs": lambda r: [FaultSpec("shuffle", "crash", r)],
        },
        "cascade_snapshots": {
            "grid_shape": list(c_shape), "plain": plain_cascade,
            "resilient": res_cascade, "snapshots": True,
            "specs": lambda r: [FaultSpec("shuffle", "crash", r)],
        },
    }


def analytic_totals(query, stats, or_shape):
    """Exact cost-model predictions for both strategies."""
    repl = query_replications(query.rel_dims(), or_shape)
    one_round = {
        "read": float(sum(stats.sizes)),
        "shuffled": float(sum(r * f for r, f in zip(stats.sizes, repl))),
    }
    one_round["total"] = one_round["read"] + one_round["shuffled"]
    idx = stats.orders.index(tuple(JOIN_ORDER))
    cascade_total = cost_query_cascade(
        [stats.sizes[i] for i in JOIN_ORDER], stats.intermediates[idx])
    return one_round, float(cascade_total)


def _wall_ms(fn, device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def bench_overhead(configs, analytic, repeats, fast, device):
    """Fault-free: bit-identical outputs, measured == analytic, and on a
    GPU the wall-clock price of resilience."""
    one_round_analytic, cascade_total = analytic
    on_gpu = device.type == "cuda"
    rows = {}
    for name in CONFIGS:
        cfg = configs[name]
        with tempfile.TemporaryDirectory() as tmp:
            kwargs = {"snapshot_dir": tmp} if cfg["snapshots"] else {}
            plain = cfg["plain"]()
            res = cfg["resilient"](**kwargs)
            identical = results_equal(plain, res)
            if bool(plain[2]):
                raise RuntimeError(f"{name}: overflow — caps undersized")
        rep = res[3]
        plain_ms, res_ms = [], []
        if on_gpu:
            for _ in range(repeats):
                plain_ms.append(_wall_ms(cfg["plain"], device))
            for _ in range(repeats):
                with tempfile.TemporaryDirectory() as tmp2:
                    kw = {"snapshot_dir": tmp2} if cfg["snapshots"] else {}
                    res_ms.append(_wall_ms(
                        lambda kw=kw: cfg["resilient"](**kw), device))
        p50_plain = float(np.median(plain_ms)) if on_gpu else None
        p50_res = float(np.median(res_ms)) if on_gpu else None
        measured = stat_floats(res[1])
        want = (one_round_analytic["total"] if name == "one_round"
                else cascade_total)
        rows[name] = {
            "grid_shape": cfg["grid_shape"],
            "bit_identical": identical,
            "measured": measured,
            "analytic_total": want,
            "match": measured["total"] == want,
            "retries": rep.retries,
            "snapshots_written": rep.snapshots_written,
            "plain_p50_ms": p50_plain,
            "resilient_p50_ms": p50_res,
            "overhead": p50_res / p50_plain - 1.0 if on_gpu else None,
            "overhead_ok": (None if not on_gpu else True if fast else
                            p50_res <= p50_plain * (1.0 + OVERHEAD_GATE)
                            + OVERHEAD_FLOOR_MS),
        }
    return rows


def bench_sweep(configs, baselines):
    """Seeded crashes at each rate: recovery cost per strategy, and the
    never-a-wrong-answer invariant."""
    cells = []
    wrong = 0
    for name in CONFIGS:
        cfg = configs[name]
        for rate in RATES:
            for seed in FAULT_SEEDS:
                with tempfile.TemporaryDirectory() as tmp:
                    kwargs = {"snapshot_dir": tmp} if cfg["snapshots"] \
                        else {}
                    inj = FaultInjector(cfg["specs"](rate), seed=seed)
                    try:
                        with inj:
                            got = cfg["resilient"](**kwargs)
                        ok = results_equal(got, baselines[name])
                        rep, failed = got[3], None
                    except HopFailed as e:
                        ok = True              # typed failure, not wrong
                        rep, failed = None, e.where
                    if not ok:
                        wrong += 1
                cell = {
                    "config": name, "rate": rate, "seed": seed,
                    "fired": inj.counters(),
                    "exact_or_typed": ok,
                }
                if rep is not None:
                    r = rep.to_json()
                    cell.update({
                        "retries": r["retries"],
                        "failed_reducers": r["failed_reducers"],
                        "snapshots_written": r["snapshots_written"],
                        "recovery": r["recovery"],
                    })
                else:
                    cell["typed_failure"] = failed
                cells.append(cell)
    return cells, wrong


def run(*, fast: bool, device=None,
        out: str = "BENCH_torch_resilience.json") -> dict:
    """Run both phases, write ``out`` and return the report."""
    device = config.resolve_device(device)
    repeats = OVERHEAD_REPEATS_FAST if fast else OVERHEAD_REPEATS_FULL
    query, tables, stats = workload()
    configs = build_configs(query, tables, stats, device)
    or_shape = tuple(configs["one_round"]["grid_shape"])
    analytic = analytic_totals(query, stats, or_shape)
    overhead = bench_overhead(configs, analytic, repeats, fast, device)
    baselines = {name: configs[name]["plain"]() for name in CONFIGS}
    cells, wrong = bench_sweep(configs, baselines)
    gates = {
        "fault_free_bit_identical": all(r["bit_identical"]
                                        for r in overhead.values()),
        "fault_free_accounting": all(r["match"] for r in overhead.values()),
        "fault_free_no_retries": all(r["retries"] == 0
                                     for r in overhead.values()),
        "overhead_bounded": (None if device.type != "cuda" else
                             all(r["overhead_ok"]
                                 for r in overhead.values())),
        "no_wrong_answers": wrong == 0,
        "faults_recovered": any(c.get("retries", 0) > 0
                                or c.get("failed_reducers", 0) > 0
                                for c in cells),
    }
    report = {
        "benchmark": "resilience_sweep_torch", "fast": fast, "k": K,
        "m_edges": M_EDGES, "n_nodes": N_NODES,
        "device": device_record(device),
        "rates": list(RATES), "fault_seeds": list(FAULT_SEEDS),
        "overhead_gate": OVERHEAD_GATE,
        "overhead": overhead, "sweep": cells, "wrong_answers": wrong,
        "gates": gates,
    }
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="fewer overhead repeats, no wall-clock gate; "
                         "accounting fields are identical to full mode")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every gate holds and the "
                         "counts equal the JAX package's pins")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' for counts only")
    ap.add_argument("--out", default="BENCH_torch_resilience.json")
    args = ap.parse_args(argv)
    report = run(fast=args.fast, device=args.device, out=args.out)
    for name, row in report["overhead"].items():
        times = ("" if row["plain_p50_ms"] is None else
                 f" {row['overhead']:+.1%} (plain {row['plain_p50_ms']:.2f}"
                 f"ms, resilient {row['resilient_p50_ms']:.2f}ms)")
        print(f"overhead {name}:"
              f" {'BIT-IDENTICAL' if row['bit_identical'] else 'DIVERGED'} "
              f"{'MATCH' if row['match'] else 'MISMATCH'}{times}")
    by_cfg: dict = {}
    for c in report["sweep"]:
        if "recovery" in c:
            by_cfg.setdefault((c["config"], c["rate"]), []).append(
                c["recovery"]["total"])
    for (name, rate), totals in sorted(by_cfg.items()):
        print(f"sweep {name} rate={rate}: mean recovery "
              f"{np.mean(totals):.0f} tuples over {len(totals)} seed(s)")
    n_typed = sum(1 for c in report["sweep"] if "typed_failure" in c)
    print(f"sweep: {len(report['sweep'])} cells, {n_typed} typed "
          f"failure(s), {report['wrong_answers']} wrong answer(s)")
    all_ok = True
    for name, ok in report["gates"].items():
        print(f"gate {name}: "
              f"{'not measured' if ok is None else 'PASS' if ok else 'FAIL'}")
        all_ok &= ok is not False
    all_ok &= report_pins(report, "BENCH_resilience.json", complete=True)
    print(f"wrote {args.out} ({report['device']})")
    return 1 if args.check and not all_ok else 0


if __name__ == "__main__":
    sys.exit(main())
