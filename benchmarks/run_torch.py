"""Benchmark harness of the PyTorch port — one function per paper
table/figure, and the engine's throughput rows.

The port of ``benchmarks/run.py``.  Prints ``name,us_per_call,derived``
CSV: figures report tuple counts in the value column, micro-benchmarks
the wall time per call in μs on the GPU (empty off it).

  PYTHONPATH=src python benchmarks/run_torch.py            # everything
  PYTHONPATH=src python benchmarks/run_torch.py --only fig # the figures
  PYTHONPATH=src python benchmarks/run_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import engine_micro_torch  # noqa: E402
import paper_figures_torch  # noqa: E402
import roofline_torch  # noqa: E402


def sections(device=None):
    """``(name, rows function)`` in print order."""
    pf = paper_figures_torch
    return [
        ("fig2", pf.fig2_comm_cost),
        ("fig3", pf.fig3_crossover),
        ("fig4", pf.fig4_intermediate_aggregation),
        ("fig5", pf.fig5_output_reduction),
        ("fig6", pf.fig6_aggregated_cost),
        ("validate", lambda: pf.engine_validation(device)),
        ("engine", lambda: engine_micro_torch.bench_engine(device)),
        ("roofline", lambda: roofline_torch.bench_rows(device)),
    ]


def rows(only: str = "", device=None):
    for name, fn in sections(device):
        if only and only not in name:
            continue
        yield from fn()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="", help="substring filter")
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' for counts only")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for row_name, value, derived in rows(args.only, args.device):
        shown = "" if value is None else f"{value:.6g}"
        print(f"{row_name},{shown},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
