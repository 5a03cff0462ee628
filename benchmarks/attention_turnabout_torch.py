"""Two trees' attention kernels, turn about, on one card.

Runs ``chip_smoke.py``'s phase-2 attention cases — ``flash_attention_phase``
(forward) and ``flash_attention_bwd_phase`` (backward), each case against
its plain version, with its event and device times, plain and SDPA times
and bound — of each tree in a process of its own, in the order
A, B, B, A, so drift on the card falls on both alike.  Each tree builds
its own kernels into its own ``build/kernels``.  A tree is a checkout's
root (its ``chip_smoke.py`` and ``src/``), e.g. the parent commit
unpacked with ``git archive`` into a gitignored directory:

  python3 benchmarks/attention_turnabout_torch.py --trees build/ab/parent .
      [--iters 10] [--out chiprun_out/turnabout]

Writes each run's cases to ``--out/run<i>_<tree>.json`` and prints, per
case, each tree's path and the mean of its two runs' numbers as one JSON
line, then the card's name and power limit.  GPU only: without one the
script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: The numbers of a case that are averaged over a tree's runs.
NUMBERS = ("ms", "device_ms", "ms_lse", "device_ms_lse", "ms_recompute_lse",
           "plain_ms", "library_ms", "library_device_ms", "bound_ms",
           "max_abs_err")
#: The plan a case ran, as its phase logs it.
PLAN = ("path", "tile", "splits", "slices", "ctas", "dq_tile", "dq_parts")


def run_one(root: Path, out: Path, iters: int) -> None:
    """One tree's phase-2 attention cases into ``out`` (in this process)."""
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("attention_turnabout_torch: no CUDA device")
    t0 = time.perf_counter()
    _build.build(("flash_attention", "flash_attention_bwd"))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd = chip_smoke.flash_attention_phase(gen, iters, dev)
    bwd = chip_smoke.flash_attention_bwd_phase(gen, iters, dev)
    out.write_text(json.dumps({"root": str(root), "build_s": build_s,
                               "card": chip_smoke.card_line(),
                               "flash_attention": fwd,
                               "flash_attention_bwd": bwd}))


def summary(runs: dict) -> list:
    """Per (kernel, case): each tree's plan and mean numbers."""
    lines = []
    first = next(iter(runs.values()))[0]
    for kernel in ("flash_attention", "flash_attention_bwd"):
        cases = dict.fromkeys(c for rs in runs.values() for r in rs
                              for c in r[kernel])
        for case in cases:
            line = {"kernel": kernel, "case": case}
            for tree, rs in runs.items():
                got = [r[kernel][case] for r in rs if case in r[kernel]]
                if not got:
                    continue
                entry = {k: got[0][k] for k in PLAN if k in got[0]}
                for k in NUMBERS:
                    xs = [g[k] for g in got if g.get(k) is not None]
                    if xs:
                        entry[k] = statistics.mean(xs)
                line[tree] = entry
            lines.append(line)
    lines.append({"card": first["card"]})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, type=Path, metavar=("A", "B"))
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/turnabout"))
    args = ap.parse_args(argv)
    if args.one is not None:
        run_one(args.one.resolve(), args.out, args.iters)
        return 0
    if args.trees is None:
        ap.error("--trees A B is required")
    args.out.mkdir(parents=True, exist_ok=True)
    a, b = (t.resolve() for t in args.trees)
    names = {a: "A", b: "B"}
    runs = {"A": [], "B": []}
    for i, root in enumerate((a, b, b, a), 1):
        out = args.out / f"run{i}_{names[root]}.json"
        subprocess.run([sys.executable, __file__, "--one", str(root),
                        "--iters", str(args.iters), "--out", str(out)],
                       check=True)
        runs[names[root]].append(json.loads(out.read_text()))
    for line in summary(runs):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
