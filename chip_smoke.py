#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to
their plain versions.

    python3 chip_smoke.py [--scale 14] [--seed 0] [--iters 10]

Run from the root of a checkout (the script puts ``src/`` on the path).
It needs one CUDA device and ``nvcc``; with no GPU, or without the
repository beside it, it exits non-zero and prints no result.

Phases, each failing the run on any error:

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together) and the build seconds.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it: the max abs difference, the kernel's
   time, the plain version's, one PyTorch library call's for the same
   function, and the least time the card could take (bytes moved at
   3.35 TB/s, operations at 67 TFLOP/s — the H100 SXM data sheet).
3. The main path at full size: R-MAT ``amazon`` at ``--scale`` (edge
   factor 3, a = 0.50), planned with ``chain_stats_exact`` and
   ``plan_chain(k=16)``, sized by ``default_chain_caps``, and run by
   ``execute_chain`` on ``SimGrid((4, 4))`` for 1,3J, 2,3J, 2,3JA and
   1,3JA (``sort_merge``), then 1,3J and 2,3JA again with ``fused``,
   which must be bit-identical; a warm-up of the first run goes before
   them, its time printed apart.  Each run checks: no overflow;
   measured read/shuffled equal to the cost model; the enumeration's
   (a, d) path counts, and the aggregation's (a, d, p) groups, equal to
   A³ computed on the host with ``scipy.sparse`` — a reference
   independent of the code under test.  The kernel launch counts are
   set to 0 just before each run and read just after.
4. One JSON line with every kernel's numbers, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM, outside the tensor cores
GRID = (4, 4)
K = 16

# (paper name, aggregated query, strategy, join_impl)
RUNS = (
    ("1,3J", False, "one_round", "sort_merge"),
    ("1,3J", False, "one_round", "fused"),
    ("2,3J", False, "cascade", "sort_merge"),
    ("2,3JA", True, "cascade_pushdown", "sort_merge"),
    ("2,3JA", True, "cascade_pushdown", "fused"),
    ("1,3JA", True, "one_round", "sort_merge"),
)

FUSED_TWINS = {r[0] for r in RUNS if r[3] == "fused"}

KERNELS = {
    "segment_sum": dict(source="src/repro_torch/csrc/segment_sum.cu",
                        replaces="src/repro/kernels/segment_sum.py:57"),
    "probe_counts": dict(source="src/repro_torch/csrc/probe_counts.cu",
                         replaces="src/repro/kernels/fused_join.py:181"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(msg)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# The workload and its host-side reference
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Workload:
    n_nodes: int
    edges: list
    stats: object
    caps: object
    a3_keys: np.ndarray        # a·n + d of every nonzero of A³, sorted
    a3_vals: np.ndarray        # its path counts


def make_workload(scale: int, seed: int) -> Workload:
    import scipy.sparse as sp
    from repro_torch.core import (chain_stats_exact, default_chain_caps,
                                  plan_chain)
    from repro_torch.data.graphs import DATASETS, rmat_edges

    spec = dataclasses.replace(DATASETS["amazon"], scale=scale)
    src, dst = rmat_edges(spec, seed=seed)
    edges = [(src, dst)] * 3
    t0 = time.perf_counter()
    stats = chain_stats_exact(edges)
    plans = {agg: plan_chain(stats, k=K, aggregate=agg)
             for agg in (False, True)}
    caps = default_chain_caps(stats, GRID)
    n = spec.n_nodes
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    a3 = (adj @ adj @ adj).tocoo()
    keys = a3.row.astype(np.int64) * n + a3.col
    order = np.argsort(keys)
    log(f"workload: R-MAT amazon scale {scale} seed {seed}: "
        f"{n} nodes, {len(src)} edges; j1={stats.prefix_joins[0]:.0f} "
        f"a1={stats.prefix_aggs[0]:.0f} j3={stats.prefix_joins[-1]:.0f} "
        f"nnz(A^3)={a3.nnz}; plans: enumerate {plans[False].algorithm} "
        f"{plans[False].grid_shape}, aggregate {plans[True].algorithm}; "
        f"caps {dataclasses.asdict(caps)}; host stats+A^3 "
        f"{time.perf_counter() - t0:.1f} s")
    return Workload(n, edges, stats, caps, keys[order], a3.data[order])


def analytic(name: str, stats) -> float:
    from repro_torch.core import cost_model as cm
    sizes, pj = stats.sizes, stats.prefix_joins
    if name == "1,3J":
        return cm.cost_chain_one_round(sizes, K, shares=GRID)
    if name == "2,3J":
        return cm.cost_chain_cascade(sizes, pj)
    if name == "2,3JA":
        return cm.cost_chain_cascade_pushdown(sizes, pj, stats.prefix_aggs,
                                              stats.pushdown_joins)
    return cm.cost_chain_one_round_agg(sizes, K, pj[-1], shares=GRID)


def check_against_a3(w: Workload, out, aggregate: bool) -> int:
    """The (a, d) groups of the result equal A³: the aggregation's sums
    exactly, the enumeration's path counts per (a, d) exactly."""
    dev = out.valid.device
    a = out.cols["a"][out.valid].to(torch.int64)
    d = out.cols["d"][out.valid].to(torch.int64)
    keys = a * w.n_nodes + d
    want_keys = torch.as_tensor(w.a3_keys, device=dev)
    if aggregate:
        keys, order = torch.sort(keys)
        vals = out.cols["p"][out.valid][order]
        want = torch.as_tensor(w.a3_vals.astype(np.float32), device=dev)
    else:
        keys, vals = torch.unique(keys, sorted=True, return_counts=True)
        want = torch.as_tensor(w.a3_vals.astype(np.int64), device=dev)
    check(keys.numel() == want_keys.numel(),
          f"{keys.numel()} groups, A^3 has {want_keys.numel()}")
    check(torch.equal(keys, want_keys), "(a, d) groups differ from A^3")
    check(torch.equal(vals, want), "path counts differ from A^3")
    return int(keys.numel())


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def run_main_path(w: Workload, device: torch.device) -> dict:
    """Every strategy through ``execute_chain``; returns the launches
    per kernel summed over the runs."""
    from repro_torch.core import ChainQuery, SimGrid, chain_edge_inputs
    from repro_torch.core import execute_chain
    from repro_torch.kernels import ops

    on_gpu = device.type == "cuda"
    launches = {name: 0 for name in ops.LAUNCHES}
    staged = {}
    # A warm-up of the first run, outside the table: the first
    # execute_chain of a process pays one-time CUDA library and
    # allocator set-up.  Its time is printed, not hidden in a run's.
    name, aggregate, strategy, impl = RUNS[0]
    query = ChainQuery.three_way(aggregate=aggregate)
    rels = chain_edge_inputs(query, w.edges, GRID, device=device)
    t0 = time.perf_counter()
    out, _, overflow = execute_chain(SimGrid(GRID), query, rels,
                                     strategy=strategy, caps=w.caps,
                                     join_impl=impl)
    check(not bool(overflow), f"warm-up {name} {impl}: overflow")
    log(f"warm-up {name} {impl}: wall_ms="
        f"{(time.perf_counter() - t0) * 1e3:.1f} (one-time set-up included)")
    del out, rels
    if on_gpu:
        torch.cuda.empty_cache()
    for name, aggregate, strategy, impl in RUNS:
        query = ChainQuery.three_way(aggregate=aggregate)
        rels = chain_edge_inputs(query, w.edges, GRID, device=device)
        if on_gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        out, stats, overflow = execute_chain(
            SimGrid(GRID), query, rels, strategy=strategy, caps=w.caps,
            join_impl=impl)
        if on_gpu:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        del rels

        check(not bool(overflow), f"{name} {impl}: overflow")
        read, shuffled = float(stats["read"]), float(stats["shuffled"])
        total = float(stats["total"]) if "total" in stats \
            else float(np.float32(read) + np.float32(shuffled))
        want = analytic(name, w.stats)
        # Stats are float32 sums: exact below 2^24; the 1,3JA charged
        # round (2·j3) may round to within one float32 ulp of the total.
        tol = float(np.spacing(np.float32(want))) if want >= 2 ** 24 else 0.0
        check(abs(total - want) <= tol,
              f"{name} {impl}: measured {total} != analytic {want}")
        rows = int(out.count().sum())
        check(aggregate or rows == w.stats.prefix_joins[-1],
              f"{name}: {rows} rows, j3 = {w.stats.prefix_joins[-1]}")
        groups = check_against_a3(w, out, aggregate)
        expect = {"segment_sum": aggregate, "probe_counts": impl == "fused"}
        if on_gpu:
            for kname, used in expect.items():
                check(counts[kname] > 0 or not used,
                      f"{name} {impl}: the {kname} kernel was never launched")
        for kname, c in counts.items():
            launches[kname] += c

        # The fused run must equal its sort_merge twin bit for bit; the
        # twin's result waits on the host, out of the peak-memory count.
        if impl == "fused":
            twin = staged.pop(name)
            check(torch.equal(out.valid.cpu(), twin.valid), f"{name}: mask")
            for n, c in out.cols.items():
                check(torch.equal(c.cpu(), twin.cols[n]), f"{name}: {n}")
        elif name in FUSED_TWINS:
            staged[name] = out.map(lambda t: t.cpu())
        del out
        if on_gpu:
            torch.cuda.empty_cache()
        log(f"main path {name:6s} {impl:10s} ok: rows={rows} groups={groups} "
            f"read={read:.0f} shuffled={shuffled:.0f} total={total:.0f} "
            f"analytic={want:.0f} wall_ms={wall_ms:.1f} "
            f"peak_bytes={peak} launches={counts}")
    return launches


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _sorted_ids(gen, batch, n, n_live, n_groups, num_segments, device):
    """Main-path group-by input: a live prefix of non-decreasing group
    ids, the padded tail at ``num_segments`` (dropped)."""
    ids = torch.full((batch, n), num_segments, dtype=torch.int32,
                     device=device)
    live = torch.randint(0, n_groups, (batch, n_live), generator=gen,
                         device=device, dtype=torch.int32)
    ids[:, :n_live] = torch.sort(live, dim=-1).values
    vals = torch.zeros(batch, n, device=device)
    vals[:, :n_live] = 1.0
    return vals, ids


def segment_sum_phase(w: Workload, gen, iters: int, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_sum import segment_sum

    st, caps = w.stats, w.caps
    batch = math.prod(GRID)
    j1, a1, j3 = st.prefix_joins[0], st.prefix_aggs[0], st.prefix_joins[-1]
    cases = {
        # 2,3JA pushdown Γ: (16, mid) rows -> (16, agg) groups.
        "pushdown": (caps.mid, caps.agg, math.ceil(j1 / batch),
                     math.ceil(a1 / batch), False),
        # 1,3JA charged round / final Γ: (16, join) -> (16, out).
        "final": (caps.join, caps.out, math.ceil(j3 / batch),
                  math.ceil(len(w.a3_keys) / batch), False),
        # The same shape with the rows shuffled and non-integer values.
        "shuffled": (caps.join, caps.out, math.ceil(j3 / batch),
                     math.ceil(len(w.a3_keys) / batch), True),
    }
    results = {}
    for case, (n, s, n_live, n_groups, shuffle) in cases.items():
        vals, ids = _sorted_ids(gen, batch, n, n_live, n_groups, s, dev)
        if shuffle:
            perm = torch.argsort(torch.rand(batch, n, generator=gen,
                                            device=dev), dim=-1)
            ids = ids.gather(-1, perm).contiguous()
            vals = torch.randn(batch, n, generator=gen, device=dev)
            vals = vals.gather(-1, perm).contiguous()
        got = segment_sum(vals, ids, s)
        want = ref.segment_sum(vals, ids, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if shuffle:       # float atomics add in another order: 1e-5
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:             # integer-valued sums below 2^24: exact
            check(err == 0.0, f"segment_sum {case}: max abs err {err}")
        # The library yardstick: one index_add_ into a flat buffer with
        # a sink slot for the dropped ids (index built outside the timing).
        flat = torch.where((ids >= 0) & (ids < s),
                           ids.to(torch.int64)
                           + torch.arange(batch, device=dev)[:, None] * s,
                           batch * s).reshape(-1)
        sink = torch.zeros(batch * s + 1, device=dev)
        flat_vals = vals.reshape(-1)
        ms = time_ms(lambda: segment_sum(vals, ids, s), iters)
        plain_ms = time_ms(lambda: ref.segment_sum(vals, ids, s), iters)
        lib_ms = time_ms(lambda: sink.zero_().index_add_(0, flat, flat_vals),
                         iters)
        b_ms, b_by = bound_ms(batch * n * 8 + batch * s * 4, batch * n)
        results[case] = dict(shape=f"({batch},{n})->({batch},{s})",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel segment_sum {case}: {results[case]}")
        del vals, ids, got, want, flat, sink, flat_vals
    torch.cuda.empty_cache()
    return results


def probe_counts_phase(w: Workload, gen, iters: int, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_join import probe_counts

    st, caps = w.stats, w.caps
    batch = math.prod(GRID)
    r, j1, a1 = st.sizes[0], st.prefix_joins[0], st.prefix_aggs[0]
    cases = {
        # 1,3J second join: the (R ⋈ S) shard probes the placed T shard.
        "one_round_join2": (caps.mid, caps.local, math.ceil(j1 / batch),
                            math.ceil(r / GRID[1])),
        # 2,3JA hop 2: the aggregated prefix probes T, both at agg.
        "cascade_hop2": (caps.agg, caps.agg, math.ceil(a1 / batch),
                         math.ceil(r / batch)),
    }
    sentinel = torch.iinfo(torch.int32).max
    results = {}
    for case, (nq, nr, q_live, r_live) in cases.items():
        def side(n, live):
            keys = torch.full((batch, n), sentinel, dtype=torch.int32,
                              device=dev)
            keys[:, :live] = torch.sort(torch.randint(
                0, w.n_nodes, (batch, live), generator=gen, device=dev,
                dtype=torch.int32), dim=-1).values
            return keys
        queries, keys = side(nq, q_live), side(nr, r_live)
        lo, hi = probe_counts(queries, keys)
        lo_r, hi_r = ref.probe_counts(queries, keys)
        torch.cuda.synchronize()
        check(torch.equal(lo, lo_r) and torch.equal(hi, hi_r),
              f"probe_counts {case}: kernel != plain")
        err = float(max((lo - lo_r).abs().max(), (hi - hi_r).abs().max()))
        ms = time_ms(lambda: probe_counts(queries, keys), iters)
        plain_ms = time_ms(lambda: ref.probe_counts(queries, keys), iters)

        def library():
            torch.searchsorted(keys, queries, side="left", out_int32=True)
            torch.searchsorted(keys, queries, side="right", out_int32=True)
        lib_ms = time_ms(library, iters)
        steps = math.ceil(math.log2(nr + 1))
        b_ms, b_by = bound_ms(batch * (nq * 4 + nr * 4 + nq * 8),
                              2 * batch * nq * steps)
        results[case] = dict(shape=f"({batch},{nq})x({batch},{nr})",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel probe_counts {case}: {results[case]}")
        del queries, keys, lo, hi, lo_r, hi_r
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Optional: where the time goes (--profile)
# ---------------------------------------------------------------------------

def profile_runs(w: Workload, device: torch.device, out_dir: Path) -> None:
    """Run every strategy once more under ``torch.profiler``: print the
    device busy time against the wall time and the ops that take most
    device time, and write each run's table to ``out_dir``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ChainQuery, SimGrid, chain_edge_inputs
    from repro_torch.core import execute_chain

    on_gpu = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu
                                     else [])
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, aggregate, strategy, impl in RUNS:
        query = ChainQuery.three_way(aggregate=aggregate)
        rels = chain_edge_inputs(query, w.edges, GRID, device=device)
        if on_gpu:
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out, _, overflow = execute_chain(
                SimGrid(GRID), query, rels, strategy=strategy, caps=w.caps,
                join_impl=impl)
            if on_gpu:
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        check(not bool(overflow), f"profile {name} {impl}: overflow")
        del out, rels
        events = prof.key_averages()

        def dev_us(e):
            return getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
        busy_ms = sum(dev_us(e) for e in events
                      if e.device_type == DeviceType.CUDA) / 1e3
        # aten ops by the device time of the kernels they launch
        # themselves; the port's own kernels launch outside any aten op.
        ops = sorted(((dev_us(e) / 1e3, e.key) for e in events
                      if e.device_type == DeviceType.CPU
                      and e.key.startswith("aten::") and dev_us(e) > 0),
                     reverse=True)
        own = sorted(((dev_us(e) / 1e3, e.key) for e in events
                      if e.device_type == DeviceType.CUDA
                      and ("segment_sum" in e.key or "probe_counts" in e.key)),
                     reverse=True)
        top = ", ".join(f"{k} {ms:.1f}" for ms, k in ops[:8] + own)
        share = busy_ms / wall_ms if wall_ms else 0.0
        log(f"profile {name:6s} {impl:10s}: wall_ms={wall_ms:.1f} "
            f"device_busy_ms={busy_ms:.1f} busy_share={share:.3f}; "
            f"device ms by op: {top}")
        label = f"{name.replace(',', '_')}_{impl}"
        (out_dir / f"profile_{label}.txt").write_text(events.table(
            sort_by="self_device_time_total" if on_gpu
            else "self_cpu_time_total", row_limit=60))
        if on_gpu:
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=14,
                    help="R-MAT scale: 2^scale nodes (default 14)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10,
                    help="timed launches per kernel (median reported)")
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="also trace every strategy once with torch.profiler"
                         " and write the tables to DIR")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    w = make_workload(args.scale, args.seed)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    phases = {"segment_sum": segment_sum_phase(w, gen, args.iters, dev),
              "probe_counts": probe_counts_phase(w, gen, args.iters, dev)}

    launches = run_main_path(w, dev)
    if args.profile is not None:
        profile_runs(w, dev, args.profile)

    # The heaviest main-path case of each kernel goes into the line.
    headline = {"segment_sum": "final", "probe_counts": "one_round_join2"}
    kernels = []
    for name, meta in KERNELS.items():
        res = phases[name][headline[name]]
        kernels.append(dict(name=name, route="cuda", **meta,
                            launches=launches[name],
                            max_abs_err=max(r["max_abs_err"]
                                            for r in phases[name].values()),
                            ms=res["ms"], plain_ms=res["plain_ms"],
                            bound_ms=res["bound_ms"],
                            bound_by=res["bound_by"],
                            library_ms=res["library_ms"],
                            shape=res["shape"]))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
