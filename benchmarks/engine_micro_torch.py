"""Engine micro-benchmarks on the PyTorch port: the data plane on a wall
clock.

The port of ``benchmarks/engine_micro.py``.  Two jobs:

* ``bench_engine()`` — throughput sanity rows for
  ``benchmarks/run_torch.py`` (median of repeats on the card; null on
  the CPU).
* ``main()`` — the data-plane harness: sweeps per-reducer capacity over
  {1k, 4k, 16k, 64k} for the all-pairs oracle, ``sort_merge_join`` and
  the fused pipeline (``impl="fused"``: rank-packed sorts and the
  ``probe_counts`` kernel); splits the join into the port's own phases
  — ``local.partition_ranks`` (the map side's counting plan), the
  (validity, key) sort both ways (``local._sorted_by_key``,
  ``fused_join.stable_key_order``), the probe (the ``probe_counts``
  kernel and ``searchsorted``, timed apart), the emit
  (``local._probe_expand_emit``: prefix scan, pair expansion, column
  gather) and one ``SimGrid`` shuffle hop — so a regression in any
  phase is attributable from the JSON alone; compares multipass and
  single-pass ``groupby_sum``; and times the eager executor against
  its CUDA-graph replay (``jit_execute_chain``).  Writes
  ``BENCH_torch_join_kernels.json`` with μs medians, mins and speedup
  ratios, and the card's name and power limit.

  PYTHONPATH=src python benchmarks/engine_micro_torch.py [--fast]
      [--check] [--device cpu] [--out BENCH_torch_join_kernels.json]

``--fast`` shrinks the sweep (small caps, 1 repeat); ``--check``
applies the reference's gate: sort-merge never slower than all-pairs
at capacity >= 4k (>= 5x at 16k), the fused pipeline >= 0.8x
sort-merge everywhere (>= 1.5x at 16k in full mode).  Times exist on
the GPU only: on the CPU every time is null and the gate has nothing
to hold.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List

import numpy as np

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

from bench_common_torch import device_record, ratio, timeit_us  # noqa: E402
from repro_torch import config  # noqa: E402

CAPACITIES = (1024, 4096, 16384, 65536)
FAST_CAPACITIES = (1024, 4096)
# The all-pairs oracle is O(cap²): at 64k² the flat pair index passes
# 2^31 (the port keeps the reference's int32 limit) and the dense
# intermediate alone is ~17 GB — past this cap only the sorted joins
# are measured and the oracle cell records why it is absent.
ALLPAIRS_MAX_CAP = 16384
ALLPAIRS_SKIPPED = ("O(cap²) oracle infeasible: int32 pair-index overflow "
                    "and a ~17 GB dense intermediate at 64k²")


def _i32(a, device):
    return torch.as_tensor(a, dtype=torch.int32, device=device)


def _f32(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Data-plane sweep: all-pairs vs sort-merge vs fused, multipass vs single
# ---------------------------------------------------------------------------

def _join_inputs(cap: int, rng, device):
    """One reducer's worth of join input: keys uniform over [0, cap), so
    the expected match count ~= cap."""
    from repro_torch.core import Relation
    left = Relation.from_arrays(
        cap, b=_i32(rng.integers(0, cap, cap), device),
        v=_f32(rng.normal(size=cap), device))
    right = Relation.from_arrays(
        cap, b=_i32(rng.integers(0, cap, cap), device),
        w=_f32(rng.normal(size=cap), device))
    return left, right


def bench_local_join(capacities, repeats: int, rng, device) -> dict:
    from repro_torch.core import local_join

    report = {}
    for cap in capacities:
        left, right = _join_inputs(cap, rng, device)
        out_cap = 4 * cap

        def t(impl):
            return timeit_us(lambda: local_join(left, right, "b", "b",
                                                out_cap, impl=impl),
                             device=device, repeats=repeats)

        row = {"out_capacity": out_cap, "sort_merge": t("sort_merge"),
               "fused": t("fused")}
        row["speedup_fused"] = ratio(row["sort_merge"], row["fused"])
        if cap <= ALLPAIRS_MAX_CAP:
            row["all_pairs"] = t("all_pairs")
            row["speedup_median"] = ratio(row["all_pairs"],
                                          row["sort_merge"])
        else:
            row["all_pairs"] = None
            row["all_pairs_skipped"] = ALLPAIRS_SKIPPED
        report[str(cap)] = row
        if row["sort_merge"] is not None:
            ap = row["all_pairs"]
            print(f"local_join    cap={cap:6d}: sort_merge "
                  f"{row['sort_merge']['median_us']:10.1f} us  fused "
                  f"{row['fused']['median_us']:10.1f} us "
                  f"({row['speedup_fused']:5.2f}x)"
                  + (f"  all_pairs {ap['median_us']:10.1f} us  speedup "
                     f"{row['speedup_median']:6.2f}x" if ap
                     else "  all_pairs skipped"))
    return report


def bench_join_phases(capacities, repeats: int, rng, device) -> dict:
    """The reduce-side join in the port's own phases, per capacity:
    ``partition_ranks`` (the counting plan of a 16-bucket partition),
    the (validity, key) sort both ways, the probe (the ``probe_counts``
    kernel — the plain version off the GPU — and ``searchsorted``), the
    emit (prefix scan, pair expansion, column gather) and one
    ``SimGrid((16,))`` shuffle hop."""
    from repro_torch.core import Relation, SimGrid
    from repro_torch.core.local import (_probe_expand_emit, _sorted_by_key,
                                        partition_ranks)
    from repro_torch.core.shuffle import shuffle_by_bucket
    from repro_torch.kernels import fused_join as fj

    n_buckets = 16
    report = {}
    for cap in capacities:
        key = _i32(rng.integers(0, cap, cap), device)
        valid = torch.arange(cap, device=device) < (cap - cap // 8)
        rel = Relation({"b": key, "v": _f32(rng.normal(size=cap), device)},
                       valid)
        bucket = _i32(rng.integers(0, n_buckets, cap), device)
        order, masked = _sorted_by_key(key, valid)
        n_v = valid.sum(-1, keepdim=True)
        lo, hi = fj.probe_counts(masked, masked)
        grid = SimGrid((n_buckets,))
        rel_d = rel.map(lambda c: c.reshape(n_buckets, -1))
        bucket_d = bucket.reshape(n_buckets, -1)

        def t(fn):
            return timeit_us(fn, device=device, repeats=repeats)

        row = {
            "partition": t(lambda: partition_ranks(bucket, valid, n_buckets)),
            "sort_staged": t(lambda: _sorted_by_key(key, valid)),
            "sort_fused": t(lambda: fj.stable_key_order(key, valid)),
            "probe": t(lambda: fj.probe_counts(masked, masked)),
            "probe_searchsorted": t(lambda: fj.probe_counts(
                masked, masked, backend="ref")),
            "emit": t(lambda: _probe_expand_emit(
                rel, rel, "b", "b", 4 * cap, "", "r_", n_v, n_v, order,
                order, lo, hi)),
            "shuffle": t(lambda: shuffle_by_bucket(
                grid, rel_d, bucket_d, 0, cap // n_buckets * 2)),
        }
        row["sort_speedup"] = ratio(row["sort_staged"], row["sort_fused"])
        row["probe_speedup"] = ratio(row["probe_searchsorted"], row["probe"])
        report[str(cap)] = row
        if row["partition"] is not None:
            us = {k: v["median_us"] for k, v in row.items()
                  if isinstance(v, dict)}
            print(f"join_phases   cap={cap:6d}: partition "
                  f"{us['partition']:8.1f} us  sort {us['sort_staged']:8.1f}"
                  f" -> {us['sort_fused']:8.1f} us  probe {us['probe']:8.1f}"
                  f" (searchsorted {us['probe_searchsorted']:8.1f}) us  emit "
                  f"{us['emit']:8.1f} us  shuffle {us['shuffle']:8.1f} us")
    return report


def bench_groupby(capacities, repeats: int, rng, device) -> dict:
    from repro_torch.core import Relation
    from repro_torch.core.local import groupby_sum, groupby_sum_multipass

    report = {}
    for cap in capacities:
        hi = max(cap // 32, 1)
        rel = Relation.from_arrays(
            cap, a=_i32(rng.integers(0, hi, cap), device),
            c=_i32(rng.integers(0, hi, cap), device),
            p=_f32(rng.normal(size=cap), device))
        row = {"single_pass": timeit_us(
                   lambda: groupby_sum(rel, ("a", "c"), "p"),
                   device=device, repeats=repeats),
               "multipass": timeit_us(
                   lambda: groupby_sum_multipass(rel, ("a", "c"), "p"),
                   device=device, repeats=repeats)}
        row["speedup_median"] = ratio(row["multipass"], row["single_pass"])
        report[str(cap)] = row
        if row["single_pass"] is not None:
            print(f"groupby_sum   cap={cap:6d}: single "
                  f"{row['single_pass']['median_us']:10.1f} us  multipass "
                  f"{row['multipass']['median_us']:10.1f} us  speedup "
                  f"{row['speedup_median']:6.2f}x")
    return report


# ---------------------------------------------------------------------------
# Eager executor vs its CUDA-graph replay
# ---------------------------------------------------------------------------

def bench_executor(repeats: int, rng, device, n_edges: int = 4000) -> dict:
    from repro_torch.core import (ChainQuery, SimGrid, chain_edge_inputs,
                                  chain_stats_exact, clear_compiled_caches,
                                  default_chain_caps, execute_chain,
                                  integer_shares, jit_execute_chain)

    nodes = max(8, n_edges // 2)
    edges = [(rng.integers(0, nodes, n_edges).astype(np.int32),
              rng.integers(0, nodes, n_edges).astype(np.int32))
             for _ in range(3)]
    stats = chain_stats_exact(edges)

    report = {}
    for strategy, shape in (("one_round", None), ("cascade", (4,))):
        query = ChainQuery.chain(3)
        if shape is None:
            shape = tuple(integer_shares(stats.sizes, 8))
        caps = default_chain_caps(stats, shape, slack=4)
        grid = SimGrid(shape)
        rels = chain_edge_inputs(query, edges, shape, device=device)
        compiled = jit_execute_chain(grid, query, strategy=strategy,
                                     caps=caps, donate=False)
        row = {"grid_shape": list(shape), "n_edges": n_edges,
               "eager": timeit_us(lambda: execute_chain(
                   grid, query, rels, strategy=strategy, caps=caps),
                   device=device, repeats=repeats),
               "replay": timeit_us(lambda: compiled(rels), device=device,
                                   repeats=repeats)}
        row["speedup_median"] = ratio(row["eager"], row["replay"])
        report[strategy] = row
        if row["eager"] is not None:
            print(f"executor {strategy:9s}: eager "
                  f"{row['eager']['median_us']:10.1f} us  replay "
                  f"{row['replay']['median_us']:10.1f} us  speedup "
                  f"{row['speedup_median']:6.2f}x")
    clear_compiled_caches()
    return report


def check_report(report: dict) -> list:
    """The reference's gate; returns the failures.  A cell without
    times (the CPU) holds nothing."""
    failures = []
    for cap_s, row in report["local_join"].items():
        cap, sp, spf = int(cap_s), row.get("speedup_median"), \
            row["speedup_fused"]
        if spf is None:
            continue
        if spf < 0.8:
            failures.append(f"fused slower than sort_merge at cap={cap}: "
                            f"{spf:.2f}x")
        if cap == 16384 and report["mode"] == "full" and spf < 1.5:
            failures.append(f"fused < 1.5x over sort_merge at cap={cap}: "
                            f"{spf:.2f}x")
        if sp is None:
            continue
        if cap >= 4096 and sp < 1.0:
            failures.append(f"sort_merge slower than all_pairs at cap={cap}: "
                            f"{sp:.2f}x")
        if cap >= 16384 and sp < 5.0:
            failures.append(f"sort_merge < 5x over all_pairs at cap={cap}: "
                            f"{sp:.2f}x")
    return failures


def run(*, fast: bool, device=None, repeats=None, seed: int = 0,
        out: str = "BENCH_torch_join_kernels.json") -> dict:
    device = config.resolve_device(device)
    caps = FAST_CAPACITIES if fast else CAPACITIES
    repeats = repeats if repeats else (1 if fast else 5)
    rng = np.random.default_rng(seed)
    report = {
        "benchmark": "join_kernels_torch",
        "device": device_record(device),
        "mode": "fast" if fast else "full",
        "repeats": repeats,
        "capacities": list(caps),
        "local_join": bench_local_join(caps, repeats, rng, device),
        "join_phases": bench_join_phases(caps, repeats, rng, device),
        "groupby_sum": bench_groupby(caps, repeats, rng, device),
        "executor": bench_executor(repeats, rng, device,
                                   n_edges=1000 if fast else 4000),
    }
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="small caps, 1 repeat")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless the reference's speedup "
                         "gates hold")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs each cell once, "
                         "untimed")
    ap.add_argument("--out", default="BENCH_torch_join_kernels.json")
    args = ap.parse_args(argv)
    report = run(fast=args.fast, device=args.device, repeats=args.repeats,
                 seed=args.seed, out=args.out)
    failures = check_report(report)
    for f in failures:
        print(f"gate FAILED: {f}")
    if not failures:
        print("check OK" + ("" if report["device"]["platform"] == "gpu"
                            else " (no times off the GPU: nothing gated)"))
    print(f"wrote {args.out} ({report['device']})")
    return 1 if args.check and failures else 0


# ---------------------------------------------------------------------------
# run_torch.py rows (throughput sanity for the whole engine)
# ---------------------------------------------------------------------------

def bench_engine(device=None) -> List[tuple]:
    """``(name, μs median or None, note)`` rows: a distributed two-way
    join, a group-by, both sorted joins and the oracle at 4k, and two
    kernels through their wrappers."""
    from repro_torch.core import (Relation, SimGrid, edge_relation,
                                  two_way_join)
    from repro_torch.core.local import groupby_sum, local_join
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.segment_sum import segment_sum

    device = config.resolve_device(device)
    rows = []
    rng = np.random.default_rng(0)

    def us(fn):
        t = timeit_us(fn, device=device, repeats=5)
        return None if t is None else t["median_us"]

    src = rng.integers(0, 2000, 20000).astype(np.int32)
    dst = rng.integers(0, 2000, 20000).astype(np.int32)
    grid = SimGrid((4,))
    R = edge_relation(src, dst, names=("a", "b", "v"), device=device)
    S = edge_relation(src, dst, names=("b", "c", "w"), device=device)
    Rd, Sd = (r.map(lambda c: c.reshape(4, -1)) for r in (R, S))
    rows.append(("engine/two_way_join_20k_tuples_4dev", us(
        lambda: two_way_join(grid, Rd, Sd, "b", "b", recv_capacity=8192,
                             out_capacity=65536, local_capacity=8192)),
        "distributed sort-merge hash join, SimGrid"))

    rel = Relation.from_arrays(
        16384, a=_i32(rng.integers(0, 500, 16384), device),
        c=_i32(rng.integers(0, 500, 16384), device),
        p=_f32(rng.normal(size=16384), device))
    rows.append(("engine/groupby_sum_16k",
                 us(lambda: groupby_sum(rel, ("a", "c"), "p")),
                 "single-pass sort + segment_sum"))

    left, right = _join_inputs(4096, rng, device)
    for impl in ("sort_merge", "fused", "all_pairs"):
        rows.append((f"engine/local_join_4k_{impl}",
                     us(lambda _i=impl: local_join(left, right, "b", "b",
                                                   16384, impl=_i)),
                     {"sort_merge": "sorted probe",
                      "fused": "rank-packed sorts + probe_counts kernel",
                      "all_pairs": "quadratic oracle"}[impl]))

    vals = _f32(rng.normal(size=65536), device)
    ids = torch.sort(_i32(rng.integers(0, 4096, 65536), device)).values
    rows.append(("kernels/segment_sum_64k",
                 us(lambda: segment_sum(vals, ids, 4096)),
                 "the segment_sum kernel (plain version off the GPU)"))
    q = torch.as_tensor(rng.normal(size=(1, 8, 512, 64)),
                        dtype=torch.bfloat16, device=device)
    k = torch.as_tensor(rng.normal(size=(1, 2, 512, 64)),
                        dtype=torch.bfloat16, device=device)
    rows.append(("kernels/attention_512_gqa",
                 us(lambda: flash_attention(q, k, k, causal=True)),
                 "the flash_attention kernel (plain version off the GPU)"))
    return rows


if __name__ == "__main__":
    sys.exit(main())
