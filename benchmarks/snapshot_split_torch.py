"""Where the resilient cascade's fault-free time goes on the PyTorch port.

``benchmarks/resilience_sweep_torch.py`` gates the fault-free resilient
executors at 1.05x their plain twins (+0.25 ms).  This script splits
the cascade's side of that gate on the same workload (the sweep's
3-relation chain, 160 edges over 80 nodes, seed 5, on ``SimGrid((8,))``
with the sweep's caps):

* **runs** — the plain ``cascade_query``, ``resilient_cascade_query``
  without a snapshot directory, and with one (one hop snapshot), taken
  in turn within each repeat so clock drift falls on all three alike;
* **save_hop** — the hop-0 intermediate's snapshot, part by part as
  ``checkpoint.store.save_hop`` runs it: the device-to-host copies, the
  CRCs, ``np.savez``, the manifest's write, its ``fsync``, and the
  rename swap, then the whole call; and the resilient run's entry scan
  of its (empty) snapshot directory.

Snapshots go to a fresh ``tempfile`` directory per repeat, as in the
sweep.  Medians and quartiles in ms (GPU only: on the CPU the script
refuses), with the card's name and power limit.  Writes the report to
``--out`` and prints it as one JSON line.

  PYTHONPATH=src python benchmarks/snapshot_split_torch.py
      [--repeats 30] [--out snapshot_split.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
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

import resilience_sweep_torch as sweep  # noqa: E402
from bench_common_torch import device_record  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.core.executor import cascade_hop  # noqa: E402
from repro_torch.resilience.recovery import (RecoveryReport,  # noqa: E402
                                             _scan_quarantine)


def quartiles(xs):
    q1, q2, q3 = np.percentile(xs, [25, 50, 75])
    return {"p25_ms": float(q1), "p50_ms": float(q2), "p75_ms": float(q3)}


def clock(fn, device) -> float:
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3


def hop0(device):
    """The cascade's hop-0 intermediate, as the resilient run snapshots
    it."""
    query, tables, stats = sweep.workload()
    grid = sweep.SimGrid((sweep.K,))
    rels = sweep.query_table_inputs(query, tables, (sweep.K,), device=device)
    caps = sweep.default_query_caps(query, stats, (sweep.K,),
                                    slack=sweep.SLACK)
    j, key, extras = query.join_steps(sweep.JOIN_ORDER)[0]
    out, *_ = cascade_hop(grid, rels[sweep.JOIN_ORDER[0]], rels[j], key,
                          extras, i=0, last=False, left_cap=None, caps=caps)
    return out


def save_hop_parts(rel, directory, device):
    """``store.save_hop(directory, 0, rel)`` step by step, each step
    timed (ms); the result is the same snapshot."""
    t = {}
    tmp = os.path.join(directory, "step_0.tmp")
    final = os.path.join(directory, "step_0")
    os.makedirs(tmp, exist_ok=True)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    cols = {n: c.cpu().numpy() for n, c in rel.cols.items()}
    valid = rel.valid.cpu().numpy()
    t1 = time.perf_counter()
    arrays = {f"col_{n}": a for n, a in cols.items()}
    arrays["valid"] = valid
    crc = {k: store._crc(a) for k, a in arrays.items()}
    t2 = time.perf_counter()
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    t3 = time.perf_counter()
    manifest = {"format": store.HOP_FORMAT, "hop": 0,
                "columns": sorted(cols),
                "dtypes": {n: a.dtype.name for n, a in cols.items()},
                "shapes": {n: list(a.shape) for n, a in cols.items()},
                "valid_shape": list(valid.shape), "crc": crc, "extra": {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        t4 = time.perf_counter()
        os.fsync(f.fileno())
    t5 = time.perf_counter()
    store._atomic_replace(tmp, final)
    t6 = time.perf_counter()
    for name, a, b in (("d2h", t0, t1), ("crc", t1, t2), ("savez", t2, t3),
                       ("manifest_write", t3, t4), ("fsync", t4, t5),
                       ("rename_swap", t5, t6), ("parts_sum", t0, t6)):
        t[name] = (b - a) * 1e3
    t["bytes"] = int(sum(a.nbytes for a in arrays.values()))
    return t


def run(repeats: int, device) -> dict:
    query, tables, stats = sweep.workload()
    cfg = sweep.build_configs(query, tables, stats, device)["cascade"]
    plain, resilient = cfg["plain"], cfg["resilient"]

    def with_snapshots():
        with tempfile.TemporaryDirectory() as d:
            ms = clock(lambda: resilient(snapshot_dir=d), device)
        return ms

    for _ in range(3):                              # warm every path
        plain(), resilient(), with_snapshots()
    runs = {"plain": [], "resilient": [], "resilient_snapshots": []}
    order = list(runs)
    for r in range(repeats):
        for name in order[r % 3:] + order[:r % 3]:
            if name == "plain":
                runs[name].append(clock(plain, device))
            elif name == "resilient":
                runs[name].append(clock(resilient, device))
            else:
                runs[name].append(with_snapshots())

    rel = hop0(device)
    parts, whole, scan = [], [], []
    for _ in range(repeats):
        d = tempfile.mkdtemp()
        try:
            parts.append(save_hop_parts(rel, d, device))
        finally:
            shutil.rmtree(d)
        d = tempfile.mkdtemp()
        try:
            whole.append(clock(lambda: store.save_hop(d, 0, rel), device))
        finally:
            shutil.rmtree(d)
        d = tempfile.mkdtemp()
        try:
            t0 = time.perf_counter()
            _scan_quarantine(d, RecoveryReport(strategy="cascade"))
            store.latest_hop(d)
            scan.append((time.perf_counter() - t0) * 1e3)
        finally:
            shutil.rmtree(d)
    split = {k: quartiles([p[k] for p in parts])
             for k in parts[0] if k != "bytes"}
    split["save_hop_call"] = quartiles(whole)
    split["entry_scan"] = quartiles(scan)
    return {"benchmark": "snapshot_split_torch", "device": device_record(device),
            "repeats": repeats, "tmpdir": tempfile.gettempdir(),
            "snapshot_bytes": parts[0]["bytes"],
            "runs": {k: quartiles(v) for k, v in runs.items()},
            "save_hop": split}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=30)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("snapshot_split_torch: times exist only on a GPU",
              file=sys.stderr)
        return 2
    report = run(args.repeats, torch.device("cuda"))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
