"""Paper-figure reproductions (Fig. 2–6) on synthetic SNAP-like graphs,
on the PyTorch port.

The port of ``benchmarks/paper_figures.py``: the same rows, from the
port's cost model (``repro_torch.core.cost_model``, a copy of the JAX
package's) and its R-MAT generator, with its own copy of
``sparse_stats.self_join_stats`` (numpy only).  Each function returns
rows of ``(name, value, derived)``; ``benchmarks/run_torch.py`` prints
them as CSV.  Claims validated:

  C1  1,3J beats 2,3J up to a crossover k* far above Afrati–Ullman's
      ~960-reducer estimate (Fig. 2/3).
  C2  with aggregation, 2,3JA's cost is flat in k while 1,3JA grows
      as 2r√k — 2,3JA always wins at scale (Fig. 6).
  C3  the pushed-down aggregation shrinks the intermediate (Fig. 4)
      and the final output (Fig. 5).

``engine_validation`` executes both aggregated pipelines end to end on
the port's ``SimGrid`` (``device``: the GPU by default) and asserts the
measured tuple counts equal the formulas.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.cost_model import (cost_cascade,  # noqa: E402
                                         cost_cascade_agg, cost_one_round,
                                         cost_one_round_agg,
                                         crossover_reducers)
from repro_torch.data.graphs import DATASETS, rmat_edges  # noqa: E402

K_GRID = [16, 64, 256, 1024, 4096, 16384, 65536]

_CACHE: Dict[str, Dict] = {}


def self_join_stats(src: np.ndarray, dst: np.ndarray) -> Dict[str, float]:
    """Exact self-join statistics by dense path-count matmuls (a copy of
    ``benchmarks/sparse_stats.py``): r = |A|, j1 = ΣA², a1 = nnz(A²),
    j3 = ΣA³, nnz_a3 = nnz(A³), triangles = trace(A³)/3.  Float32
    matmuls are exact at these scales (multiplicities < 2^24)."""
    n = int(max(src.max(initial=0), dst.max(initial=0))) + 1
    if n > 8192:
        raise ValueError(f"dense stats capped at 8192 nodes, got {n}")
    r = float(len(src))
    A = np.zeros((n, n), np.float32)
    np.add.at(A, (src, dst), 1.0)
    A2 = A @ A
    A3 = A2 @ A
    j1 = float(A2.sum(dtype=np.float64))
    a1 = float(np.count_nonzero(A2))
    j3 = float(A3.sum(dtype=np.float64))
    nnz_a3 = float(np.count_nonzero(A3))
    tri = float(np.trace(A3, dtype=np.float64) / 3.0)
    return {"r": r, "j1": j1, "a1": a1, "j3": j3, "nnz_a3": nnz_a3,
            "triangles": tri, "j1_over_r": j1 / max(r, 1.0)}


def dataset_stats(name: str) -> Dict[str, float]:
    if name not in _CACHE:
        src, dst = rmat_edges(DATASETS[name], seed=42)
        _CACHE[name] = dict(self_join_stats(src, dst), _edges=(src, dst))
    return _CACHE[name]


def fig2_comm_cost() -> List[tuple]:
    """1,3J vs 2,3J communication cost (tuples) as k grows."""
    rows = []
    for name in DATASETS:
        st = dataset_stats(name)
        r, j1 = st["r"], st["j1"]
        c23 = cost_cascade(r, r, r, j1)
        for k in K_GRID:
            c13 = cost_one_round(r, r, r, k)
            rows.append((f"fig2/{name}/k={k}/1,3J", c13, f"2,3J={c23:.3g}"))
    return rows


def fig3_crossover() -> List[tuple]:
    """Reducers needed before 1,3J costs more than 2,3J (paper Fig. 3)."""
    rows = []
    for name in DATASETS:
        st = dataset_stats(name)
        k_star = crossover_reducers(st["r"], st["r"], st["r"], st["j1"])
        rows.append((f"fig3/{name}/crossover_k", k_star,
                     f"j1_over_r={st['j1_over_r']:.1f};"
                     f"above_960={k_star > 960}"))
    return rows


def fig4_intermediate_aggregation() -> List[tuple]:
    """|Γ(A⋈A)| as % of |A⋈A| (paper: e.g. Pokec 76.4%, LJ 56.9%)."""
    return [(f"fig4/{name}/agg_intermediate_pct",
             100.0 * dataset_stats(name)["a1"] / dataset_stats(name)["j1"],
             f"a1={dataset_stats(name)['a1']:.3g}")
            for name in DATASETS]


def fig5_output_reduction() -> List[tuple]:
    """2,3JA output as % of 1,3J raw output (paper: Pokec 69.1%, LJ 42.2%)."""
    return [(f"fig5/{name}/agg_output_pct",
             100.0 * dataset_stats(name)["nnz_a3"] / dataset_stats(name)["j3"],
             f"j3={dataset_stats(name)['j3']:.3g}")
            for name in DATASETS]


def fig6_aggregated_cost() -> List[tuple]:
    """1,3JA vs 2,3JA cost vs k (paper Fig. 6): 2,3JA flat, 1,3JA rising."""
    rows = []
    for name in DATASETS:
        st = dataset_stats(name)
        r, j1, a1, j3 = st["r"], st["j1"], st["a1"], st["j3"]
        c23ja = cost_cascade_agg(r, r, r, j1, a1)
        for k in K_GRID:
            c13ja = cost_one_round_agg(r, r, r, j3, k)
            rows.append((f"fig6/{name}/k={k}/1,3JA", c13ja,
                         f"2,3JA={c23ja:.3g};2,3JA_wins={c23ja < c13ja}"))
    return rows


def engine_validation(device=None) -> List[tuple]:
    """Execute both aggregated pipelines on the port's SimGrid for a
    downscaled graph; assert measured tuple counts == the formulas."""
    from repro_torch import config
    from repro_torch.core import (SimGrid, cascade_three_way_agg,
                                  edge_relation, one_round_three_way_agg,
                                  scatter_to_grid)

    device = config.resolve_device(device)
    rng = np.random.default_rng(0)
    src = rng.integers(0, 60, 400).astype(np.int32)
    dst = rng.integers(0, 60, 400).astype(np.int32)
    st = self_join_stats(src, dst)
    r, j1, a1, j3 = st["r"], st["j1"], st["a1"], st["j3"]

    grid = SimGrid((2, 2))
    R, S, T = (scatter_to_grid(edge_relation(src, dst, names=names,
                                             device=device), (2, 2))
               for names in (("a", "b", "v"), ("b", "c", "w"),
                             ("c", "d", "x")))

    _, st13, ovf13 = one_round_three_way_agg(
        grid, R, S, T, recv_capacity=256, mid_capacity=8192,
        join_capacity=65536, out_capacity=8192, local_capacity=512)
    assert not bool(ovf13)
    measured_13ja = float(st13["read"] + st13["shuffled"])
    formula_13ja = cost_one_round_agg(r, r, r, j3, 4)

    _, st23, ovf23 = cascade_three_way_agg(
        grid, R, S, T, recv_capacity=256, mid_capacity=8192,
        agg_capacity=4096, out_capacity=16384, local_capacity=512)
    assert not bool(ovf23)
    measured_23ja = float(st23["read"] + st23["shuffled"])
    formula_23ja = cost_cascade_agg(r, r, r, j1, a1)

    assert abs(measured_13ja - formula_13ja) < 1e-3, (measured_13ja,
                                                      formula_13ja)
    assert abs(measured_23ja - formula_23ja) < 1e-3, (measured_23ja,
                                                      formula_23ja)
    return [
        ("validate/1,3JA/measured_tuples", measured_13ja,
         f"formula={formula_13ja:.6g};MATCH"),
        ("validate/2,3JA/measured_tuples", measured_23ja,
         f"formula={formula_23ja:.6g};MATCH"),
    ]
