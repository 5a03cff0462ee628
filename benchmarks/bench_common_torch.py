"""Shared pieces of the port's benchmark scripts (``*_torch.py``).

* :func:`extract_counts` flattens every accounting field of a report
  (``read`` / ``shuffled`` / ``max_bucket_load`` / ``total``) to
  ``{json-path: value}``, as ``tests/test_bench_accounting.py`` does
  for the JAX package's reports.
* :func:`check_pins` holds a report's counts to that benchmark's pins
  in ``tests/data/bench_counts_seed.json``: tuple accounting does not
  depend on the framework, so the port must reproduce the JAX
  package's counts exactly.
* :func:`device_record`, :func:`timed` and :func:`timeit_us` write the
  device (with the card's name and power limit) and wall times, which
  exist only on a GPU: on the CPU a time is ``None``.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

ROOT = Path(__file__).resolve().parents[1]
PINS = ROOT / "tests" / "data" / "bench_counts_seed.json"
ACCOUNTING = ("read", "shuffled", "max_bucket_load", "total")


def extract_counts(obj: Any, path: str = "") -> Dict[str, float]:
    """Flatten every accounting field to {json-path: value}."""
    out: Dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{path}/{k}" if path else k
            if k in ACCOUNTING and isinstance(v, (int, float)):
                out[p] = v
            else:
                out.update(extract_counts(v, p))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(extract_counts(v, f"{path}/{i}"))
    return out


def load_pins(bench: str) -> Dict[str, float]:
    """The pinned counts of one JAX-package report (``BENCH_*.json``)."""
    with open(PINS) as f:
        return json.load(f)[bench]


def check_pins(report: dict, bench: str, *, complete: bool
               ) -> Tuple[bool, int, list]:
    """Compare ``report``'s counts with the pins of ``bench``.

    ``complete``: the run is the pinned configuration, so its counts
    must be exactly the pinned set (no key missing, none extra);
    otherwise (a reduced run) every pin the report reaches must hold.
    Returns (ok, pins compared, mismatches as (key, got, want))."""
    pins = load_pins(bench)
    got = extract_counts(report)
    keys = sorted(pins) if complete else sorted(k for k in pins if k in got)
    bad = [(k, got.get(k), pins[k]) for k in keys if got.get(k) != pins[k]]
    if complete:
        bad += [(k, got[k], None) for k in sorted(set(got) - set(pins))]
    return not bad and bool(keys), len(keys), bad


def device_record(device: torch.device) -> dict:
    """Where the numbers come from: the CPU, or the card's name and its
    power limit (``nvidia-smi``)."""
    if device.type != "cuda":
        return {"platform": "cpu"}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "card": card}


def timed(fn: Callable[[], Any], device: torch.device
          ) -> Tuple[Any, Optional[float]]:
    """``(fn(), wall ms)``, the device synchronized around the call; the
    time is ``None`` off the GPU."""
    if device.type != "cuda":
        return fn(), None
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def report_pins(report: dict, bench: str, complete: bool) -> bool:
    """Print the pin comparison (every mismatch) and return whether it
    holds."""
    ok, n, bad = check_pins(report, bench, complete=complete)
    for key, got, want in bad:
        print(f"pin {bench} {key}: got {got}, pinned {want}")
    print(f"pins {bench}: {n} compared, {len(bad)} differ: "
          f"{'MATCH' if ok else 'MISMATCH'}")
    return ok


def timeit_us(fn: Callable[..., Any], *args, device: torch.device,
              repeats: int = 5) -> Optional[Dict[str, float]]:
    """Wall time per call in μs, ``{"median_us", "min_us"}`` over
    ``repeats`` timed calls after one warm-up, the device synchronized
    around each (the JAX package's ``_timeit``).  Off the GPU the call
    runs once and the time is ``None``."""
    import numpy as np
    if device.type != "cuda":
        fn(*args)
        return None
    fn(*args)
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return {"median_us": float(np.median(times) * 1e6),
            "min_us": float(np.min(times) * 1e6)}


def ratio(num: Optional[dict], den: Optional[dict]) -> Optional[float]:
    """``num`` median over ``den`` median, or ``None`` without times."""
    if num is None or den is None:
        return None
    return num["median_us"] / den["median_us"]
