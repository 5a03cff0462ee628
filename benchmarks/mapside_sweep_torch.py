"""Map-side sweep on the PyTorch port: zero-shuffle cascades over the
partitioned store.

The port of ``benchmarks/mapside_sweep.py``: the same 4-hop chain (5
relations, selective keys: domain 2m) at the same sizes, executed two
ways on the same 8-way ``SimGrid``:

* the always-shuffle cascade (``cost_chain_cascade`` tuples moved);
* the map-side cascade — every relation goes through the partitioned
  store (``partition_relation`` → ``save_partitioned`` →
  ``load_partitioned``, CRCs verified), the planner proves the chain
  certificate from the loaded specs alone and picks ``MS,5J``, and the
  executor feeds the stored partitions straight into presorted merge
  joins with ``place_output``.

Checks (``--check`` exits non-zero unless all hold): per-hop shuffled
and placed equal to the analytic vectors, zero shuffled on every proven
hop, both totals equal to the cost model, equal tuple counts, and the
planner's choice.  Tuple counts do not depend on the framework: they
must equal the JAX package's ``BENCH_mapside.json`` pins (the CPU test
``tests/test_torch_partition.py`` holds ``--fast`` to them).

Times are CUDA-graph replays (``jit_execute_chain``, median of 7) and
exist only on a GPU; on the CPU they are written as null.  At these
sizes (800 to 25,600 edges) a replay takes a few milliseconds and is
bound by its launches, not by the tuples it moves: the two times are
recorded, not compared, and no speedup is derived from them.  Writes
``BENCH_torch_mapside.json`` (``--out`` to override).

  PYTHONPATH=src python benchmarks/mapside_sweep_torch.py [--fast] [--check]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from bench_common_torch import device_record  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.checkpoint import load_partitioned, save_partitioned  # noqa: E402
from repro_torch.core import (ChainQuery, SimGrid, chain_edge_inputs,  # noqa: E402
                              chain_mapside_placed, chain_mapside_shuffles,
                              chain_partitioning, chain_stats_exact,
                              cost_chain_cascade, cost_chain_mapside,
                              default_chain_caps, default_mapside_caps,
                              default_part_capacity, edge_relation,
                              jit_execute_chain, partition_relation,
                              plan_chain)

N = 5                         # relations -> 4 hops
EXEC_K = 8                    # devices == stored partitions
SIZES_FULL = (800, 3200, 12800, 25600)
SIZES_FAST = (800, 3200)
TIMING_REPEATS = 7


def _time_ms(run, rels, device: torch.device):
    """Median wall time of a replay, or None off the GPU."""
    if device.type != "cuda":
        return None
    times = []
    for _ in range(TIMING_REPEATS):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        run(rels)
        torch.cuda.synchronize(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def store_roundtrip(query, flat, part_cap, tmpdir, device):
    """Persist every relation hash-partitioned on its join attribute and
    load it back: the planner sees only what the manifests prove."""
    prels = []
    for j, rel in enumerate(flat):
        key = query.attrs[1] if j == 0 else query.attrs[j]
        pr, ovf = partition_relation(rel, key, EXEC_K, salt=0,
                                     part_capacity=part_cap)
        if bool(ovf):
            raise RuntimeError("partition overflow: raise part capacity")
        save_partitioned(tmpdir, f"rel_{j}", pr)
        prels.append(load_partitioned(tmpdir, f"rel_{j}", device=device))
    return prels


def bench_size(m: int, rng, tmpdir, device: torch.device) -> dict:
    dom = 2 * m
    query = ChainQuery.chain(N)
    edges = [(rng.integers(0, dom, m).astype(np.int32),
              rng.integers(0, dom, m).astype(np.int32)) for _ in range(N)]
    stats = chain_stats_exact(edges)
    flat = [edge_relation(s, d, names=query.schema(j), device=device)
            for j, (s, d) in enumerate(edges)]
    prels = store_roundtrip(query, flat, default_part_capacity(m, EXEC_K),
                            tmpdir, device)
    part = chain_partitioning(query, [pr.spec for pr in prels])
    if part is None or not (all(part.right_proven) and part.left0_proven):
        raise RuntimeError(f"m={m}: the stored specs prove {part}")
    plan = plan_chain(stats, EXEC_K, aggregate=False, partitioning=part)

    grid = SimGrid((EXEC_K,))
    run_c = jit_execute_chain(grid, query, strategy="cascade",
                              caps=default_chain_caps(stats, (EXEC_K,)),
                              donate=False)
    run_m = jit_execute_chain(grid, query, strategy="mapside",
                              caps=default_mapside_caps(stats, EXEC_K),
                              donate=False, partitioning=part,
                              hop_modes=plan.hop_modes, place_output=True)
    rels_c = chain_edge_inputs(query, edges, (EXEC_K,), device=device)
    out_c, st_c, ovf_c = run_c(rels_c)
    out_m, st_m, ovf_m = run_m(prels)
    if bool(ovf_c) or bool(ovf_m):
        raise RuntimeError(f"m={m}: overflow; raise the capacities")
    count_c, count_m = int(out_c.count().sum()), int(out_m.count().sum())

    an_sh = chain_mapside_shuffles(stats.sizes, stats.prefix_joins, part,
                                   plan.hop_modes, place_output=True)
    an_pl = chain_mapside_placed(stats.sizes, stats.prefix_joins, part,
                                 plan.hop_modes)
    me_sh = tuple(float(x) for x in st_m["hop_shuffled"])
    me_pl = tuple(float(x) for x in st_m["hop_placed"])
    hops = [{"mode": plan.hop_modes[h],
             "shuffled": me_sh[h], "analytic_shuffled": an_sh[h],
             "placed": me_pl[h], "analytic_placed": an_pl[h],
             "match": me_sh[h] == an_sh[h] and me_pl[h] == an_pl[h]}
            for h in range(N - 1)]
    casc = {k: float(v) for k, v in st_c.items()}
    maps = {k: float(v) for k, v in st_m.items()
            if k not in ("hop_shuffled", "hop_placed")}
    casc_analytic = cost_chain_cascade(stats.sizes, stats.prefix_joins)
    maps_analytic = cost_chain_mapside(stats.sizes, stats.prefix_joins, part,
                                       plan.hop_modes)
    t_c = _time_ms(run_c, rels_c, device)
    t_m = _time_ms(run_m, prels, device)
    return {
        "m_edges": m,
        "sizes": list(stats.sizes),
        "prefix_joins": list(stats.prefix_joins),
        "count": count_c,
        "planner_choice": {"algorithm": plan.algorithm,
                           "strategy": plan.strategy,
                           "hop_modes": list(plan.hop_modes),
                           "grid_shape": list(plan.grid_shape)},
        "cascade": {**casc, "analytic_total": casc_analytic,
                    "match": casc["total"] == casc_analytic},
        "mapside": {**maps, "hops": hops, "analytic_total": maps_analytic,
                    "match": maps["total"] == maps_analytic
                    and all(h["match"] for h in hops)},
        "counts_equal": count_c == count_m,
        "zero_shuffle": me_sh == (0.0,) * (N - 1),
        "cascade_replay_ms": t_c,
        "mapside_replay_ms": t_m,
    }


def run(*, fast: bool, seed: int = 7, device=None,
        out: str = "BENCH_torch_mapside.json") -> dict:
    """Sweep the sizes, write ``out`` and return the report."""
    device = config.resolve_device(device)
    sizes = SIZES_FAST if fast else SIZES_FULL
    report = {"benchmark": "mapside_sweep_torch", "n_relations": N,
              "exec_k": EXEC_K, "num_partitions": EXEC_K, "fast": fast,
              "device": device_record(device), "sweep": {}}
    with tempfile.TemporaryDirectory() as tmpdir:
        for m in sizes:
            rng = np.random.default_rng(seed)
            report["sweep"][str(m)] = bench_size(m, rng, tmpdir, device)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="the two small sizes only")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every check holds")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' for counts only")
    ap.add_argument("--out", default="BENCH_torch_mapside.json")
    args = ap.parse_args(argv)
    report = run(fast=args.fast, seed=args.seed, device=args.device,
                 out=args.out)
    all_ok = True
    for m, row in report["sweep"].items():
        ok = (row["cascade"]["match"] and row["mapside"]["match"]
              and row["counts_equal"] and row["zero_shuffle"]
              and row["planner_choice"]["strategy"] == "mapside")
        all_ok &= ok
        times = ("" if row["cascade_replay_ms"] is None else
                 f" cascade={row['cascade_replay_ms']:.3f}ms "
                 f"mapside={row['mapside_replay_ms']:.3f}ms")
        print(f"m={m}: plan={row['planner_choice']['algorithm']} "
              f"modes={row['planner_choice']['hop_modes']} "
              f"{'MATCH' if ok else 'MISMATCH'}; shuffled/hop="
              f"{[h['shuffled'] for h in row['mapside']['hops']]}{times}")
    print(f"wrote {args.out} ({report['device']})")
    return 1 if args.check and not all_ok else 0


if __name__ == "__main__":
    sys.exit(main())
