"""§Roofline of the overlapped execution path on the PyTorch port: the
fused join against the staged one, and exact tuple accounting under
both shuffle schedules.

The port of ``benchmarks/roofline.py``, three sections in
``BENCH_torch_roofline.json``:

* ``fused_vs_staged`` — the per-reducer data plane at each capacity:
  the staged ``sort_merge_join`` against ``fused_sort_merge_join``
  (``join_impl="fused"``: rank-packed sorts, the ``probe_counts``
  kernel on a GPU), with the sort phases (``local._sorted_by_key``,
  ``fused_join.stable_key_order``) and the probe (the kernel, and
  ``searchsorted`` as ``probe_ref``) timed apart.  Times come from the
  card only; on the CPU each is null.  Gate (full mode, the
  reference's): fused ≥ 1.5× at the largest capacity.
* ``overlap`` — in the reference, one shuffle-heavy hop timed on a
  16-device ShardGrid.  The port's ShardGrid runs on
  ``torch.distributed``, but the card is one device: the section stays
  null with its reason (A12's rest, not runnable on one card), and its
  gates are not evaluated.  The inputs it would draw are still drawn,
  so the next section sees the reference's random stream.
* ``accounting`` — that hop on ``SimGrid((16,))``, staged and
  overlapped (``overlap_chunks=4``): measured read/shuffled counts,
  matches and the bytes-moved conversion (``relation_row_bytes``)
  equal their analytic values exactly, in both schedules.  ``--check``
  holds the counts to the six ``BENCH_roofline.json`` pins in
  ``tests/data/bench_counts_seed.json`` too.

Usage::

  PYTHONPATH=src python benchmarks/roofline_torch.py [--fast] [--check]
      [--device cpu] [--out BENCH_torch_roofline.json]

``--fast`` shrinks capacities and repeats (wall-clock gates skipped:
only the exact accounting is asserted).
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

import torch  # noqa: E402

from bench_common_torch import (device_record, ratio, report_pins,  # noqa: E402
                                timeit_us)
from repro_torch import config  # noqa: E402

OVERLAP_DEVICES = 16
OVERLAP_CHUNKS = 4
CAPACITIES = (1024, 4096, 16384)
FAST_CAPACITIES = (1024, 4096)
OVERLAP_SKIPPED = ("ShardGrid (ROADMAP A12's rest): the reference times "
                   "the overlap hop on 16 devices; the card is one device")


# ---------------------------------------------------------------------------
# Section 1: fused vs staged per-reducer pipeline, per phase
# ---------------------------------------------------------------------------

def _join_side(rng, cap: int, value: str, device) -> "object":
    from repro_torch.core import Relation
    return Relation.from_arrays(
        cap,
        b=torch.as_tensor(rng.integers(0, cap, cap), dtype=torch.int32,
                          device=device),
        **{value: torch.as_tensor(rng.normal(size=cap), dtype=torch.float32,
                                  device=device)})


def bench_fused_vs_staged(capacities, repeats: int, rng, device) -> dict:
    from repro_torch.core.local import (_sorted_by_key,
                                        fused_sort_merge_join,
                                        sort_merge_join)
    from repro_torch.kernels import fused_join as fj

    report = {}
    for cap in capacities:
        left = _join_side(rng, cap, "v", device)
        right = _join_side(rng, cap, "w", device)
        out_cap = 4 * cap
        key, valid = left.col("b"), left.valid
        sorted_keys = torch.sort(key).values

        def t(fn, *args):
            return timeit_us(fn, *args, device=device, repeats=repeats)

        row = {
            "out_capacity": out_cap,
            "staged": t(lambda: sort_merge_join(left, right, "b", "b",
                                                out_cap)),
            "fused": t(lambda: fused_sort_merge_join(left, right, "b", "b",
                                                     out_cap)),
            "phases": {
                "sort_staged": t(lambda: _sorted_by_key(key, valid)),
                "sort_fused": t(lambda: fj.stable_key_order(key, valid)),
                "probe": t(lambda: fj.probe_counts(sorted_keys,
                                                   sorted_keys)),
                "probe_ref": t(lambda: fj.probe_counts(
                    sorted_keys, sorted_keys, backend="ref")),
            },
        }
        row["speedup_median"] = ratio(row["staged"], row["fused"])
        report[str(cap)] = row
        if row["speedup_median"] is not None:
            ph = row["phases"]
            print(f"fused_vs_staged cap={cap:6d}: staged "
                  f"{row['staged']['median_us']:10.1f} us  fused "
                  f"{row['fused']['median_us']:10.1f} us  speedup "
                  f"{row['speedup_median']:5.2f}x  (sort "
                  f"{ph['sort_staged']['median_us']:.0f} -> "
                  f"{ph['sort_fused']['median_us']:.0f} us; probe "
                  f"{ph['probe']['median_us']:.0f} us, searchsorted "
                  f"{ph['probe_ref']['median_us']:.0f} us)")
    return report


# ---------------------------------------------------------------------------
# Section 2's inputs, and section 3: accounting under both schedules
# ---------------------------------------------------------------------------

def _overlap_inputs(rng, n_per_dev: int, cap: int, devices: int, device):
    """One shuffle-heavy hop's inputs scattered over ``devices``: four
    payload columns a side, the reference's draws in its order."""
    from repro_torch.core import Relation

    def rel(key_name, payload_prefix):
        n = n_per_dev * devices
        cols = {key_name: rng.integers(0, n, n).astype(np.int32)}
        for i in range(4):
            cols[f"{payload_prefix}{i}"] = rng.normal(size=n).astype(
                np.float32)
        valid = np.zeros((devices, cap), bool)
        valid[:, :n_per_dev] = True
        out = {}
        for name, c in cols.items():
            buf = np.zeros((devices, cap), c.dtype)
            buf[:, :n_per_dev] = c.reshape(devices, n_per_dev)
            out[name] = torch.as_tensor(buf, device=device)
        return Relation(out, torch.as_tensor(valid, device=device))

    return rel("b", "u"), rel("b", "w")


def bench_accounting(rng, *, devices: int, chunks: int, device,
                     n_per_dev: int = 512) -> dict:
    """The overlap hop on ``SimGrid((devices,))``: every measured count
    equals its analytic value exactly, and the overlapped schedule
    measures the staged schedule's numbers."""
    from repro_torch.core import SimGrid, two_way_join
    from repro_torch.core.cost_model import (estimate_join_size,
                                             relation_row_bytes)

    cap = 2 * n_per_dev
    grid = SimGrid((devices,))
    left, right = _overlap_inputs(rng, n_per_dev, cap, devices, device)
    n_left, n_right = int(left.count().sum()), int(right.count().sum())
    out_cap = 8 * n_per_dev

    rows = {}
    for label, c in (("staged", 1), ("overlapped", chunks)):
        out, st, ovf = two_way_join(
            grid, left, right, "b", "b", recv_capacity=cap,
            out_capacity=out_cap, local_capacity=cap, overlap_chunks=c)
        rows[label] = {"read": float(st["read"]),
                       "shuffled": float(st["shuffled"]),
                       "matches": int(out.count().sum()),
                       "overflow": bool(ovf)}

    lk = left.col("b")[left.valid].cpu().numpy()
    rk = right.col("b")[right.valid].cpu().numpy()
    row_bytes_l = relation_row_bytes(left)
    row_bytes_r = relation_row_bytes(right)
    analytic = {
        "read": float(n_left + n_right),
        "shuffled": float(n_left + n_right),
        "matches": int(estimate_join_size(lk, rk)),
        "shuffled_bytes": float(n_left * row_bytes_l + n_right * row_bytes_r),
    }
    for label in rows:
        rows[label]["shuffled_bytes"] = (
            rows[label]["shuffled"] / analytic["shuffled"]
            * analytic["shuffled_bytes"] if analytic["shuffled"] else 0.0)
    print(f"accounting: read {rows['staged']['read']:.0f} "
          f"shuffled {rows['staged']['shuffled']:.0f} "
          f"matches {rows['staged']['matches']} "
          f"(analytic {analytic['matches']}) — overlapped identical: "
          f"{rows['staged'] == rows['overlapped']}")
    return {"devices": devices, "chunks": chunks,
            "row_bytes": {"left": row_bytes_l, "right": row_bytes_r},
            "measured": rows, "analytic": analytic}


# ---------------------------------------------------------------------------
# Gates (the reference's)
# ---------------------------------------------------------------------------

def check_report(report: dict) -> list:
    """The reference's gates; returns the failures (empty: all pass).
    The overlap section's gates are not evaluated while it is null."""
    failures = []
    acc = report["accounting"]
    ana = acc["analytic"]
    for label, row in acc["measured"].items():
        for k in ("read", "shuffled", "matches", "shuffled_bytes"):
            if row[k] != ana[k]:
                failures.append(f"{label} {k}: {row[k]} != analytic {ana[k]}")
        if row["overflow"]:
            failures.append(f"{label}: overflow")
    if acc["measured"]["staged"] != acc["measured"]["overlapped"]:
        failures.append("overlapped schedule measured different accounting")
    if not failures:
        print("check OK: measured == analytic accounting, both schedules")
    if report["mode"] != "full":
        print("check (fast mode): wall-clock gates skipped")
        return failures
    top = str(max(int(c) for c in report["fused_vs_staged"]))
    sp = report["fused_vs_staged"][top]["speedup_median"]
    if sp is None:
        print("check: no times off the GPU: the fused gate is not measured")
    elif sp < 1.5:
        failures.append(f"fused pipeline only {sp:.2f}x over staged at "
                        f"cap={top} (gate: >= 1.5x)")
    else:
        print(f"check OK: fused {sp:.2f}x >= 1.5x at {top}")
    print(f"check: overlap gates not evaluated ({report['overlap_skipped']})")
    return failures


def run(*, fast: bool, device=None, repeats=None, seed: int = 0,
        devices: int = OVERLAP_DEVICES,
        out: str = "BENCH_torch_roofline.json") -> dict:
    device = config.resolve_device(device)
    caps = FAST_CAPACITIES if fast else CAPACITIES
    repeats = repeats if repeats else (1 if fast else 5)
    rng = np.random.default_rng(seed)
    report = {
        "benchmark": "roofline_torch",
        "device": device_record(device),
        "mode": "fast" if fast else "full",
        "repeats": repeats,
        "capacities": list(caps),
        "fused_vs_staged": bench_fused_vs_staged(caps, repeats, rng, device),
    }
    # The overlap section's inputs, drawn as the reference draws them.
    n_per_dev = 2048 if fast else 8192
    _overlap_inputs(rng, n_per_dev, 2 * n_per_dev, devices,
                    torch.device("cpu"))
    report["overlap"] = None
    report["overlap_skipped"] = OVERLAP_SKIPPED
    report["accounting"] = bench_accounting(
        rng, devices=devices, chunks=OVERLAP_CHUNKS, device=device)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="small caps, 1 repeat, wall-clock gates skipped")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless the reference's gates for "
                         "the mode pass and the counts equal the pins")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' for counts only")
    ap.add_argument("--out", default="BENCH_torch_roofline.json")
    args = ap.parse_args(argv)
    report = run(fast=args.fast, device=args.device, repeats=args.repeats,
                 seed=args.seed, out=args.out)
    failures = check_report(report)
    for f in failures:
        print(f"gate FAILED: {f}")
    pins_ok = report_pins(report, "BENCH_roofline.json", complete=True)
    print(f"wrote {args.out} ({report['device']})")
    return 1 if args.check and (failures or not pins_ok) else 0


def bench_rows(device=None):
    """CSV rows for ``benchmarks/run_torch.py``: the fused sweep at 4k
    (μs on the GPU; empty off it)."""
    device = config.resolve_device(device)
    r = bench_fused_vs_staged((4096,), 3, np.random.default_rng(0),
                              device)["4096"]
    if r["speedup_median"] is None:
        return [("roofline/fused_vs_staged_4k", None, "no times off the GPU")]
    return [("roofline/fused_vs_staged_4k", r["speedup_median"],
             f"staged={r['staged']['median_us']:.0f}us;"
             f"fused={r['fused']['median_us']:.0f}us")]


if __name__ == "__main__":
    sys.exit(main())
