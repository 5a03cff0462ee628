"""Quickstart on the PyTorch port: three-way joins on a reducer grid.

The README quickstart (``examples/quickstart.py``) on ``repro_torch``:
generates a small power-law graph, asks the cost-based planner which
algorithm to run (the paper's decision), executes BOTH aggregation
pipelines (2,3JA and 1,3JA) on a simulated 4x4 reducer grid, and
verifies the A^3 path counts and the triangle count against the
brute-force host oracles.  Runs on the GPU unless ``--device`` says
otherwise.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse
import sys
from pathlib import Path

try:
    import repro_torch  # noqa: F401 — installed, or on PYTHONPATH
except ImportError:  # checkout fallback: src/ relative to this file
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import (SimGrid, a_cubed, oracle_a3, oracle_triangles,
                              plan_three_way, self_join_stats_exact,
                              triangle_count_from_a3)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions "
                         "of the kernels")
    args = ap.parse_args(argv)

    # -- a small scale-free graph --------------------------------------------
    rng = np.random.default_rng(0)
    n_nodes, n_edges = 64, 300
    src = (rng.zipf(1.5, n_edges) % n_nodes).astype(np.int32)
    dst = rng.integers(0, n_nodes, n_edges).astype(np.int32)

    # -- plan: the paper's cost model picks the algorithm --------------------
    stats = self_join_stats_exact(src, dst)
    plan = plan_three_way(stats, k=16, aggregate=True)
    print(f"|A|={stats.r:.0f}  |A⋈A|={stats.j1:.0f}  "
          f"|Γ(A⋈A)|={stats.a1:.0f}  |A⋈A⋈A|={stats.j3:.0f}")
    print(f"planner: {plan.algorithm} on k=16 reducers "
          f"(costs: { {k: f'{v:.3g}' for k, v in plan.costs.items()} })")
    print(f"1,3J-vs-2,3J crossover: k* = {plan.crossover_k:.0f} reducers")

    # -- run both pipelines on a 4x4 simulated reducer grid ------------------
    grid = SimGrid((4, 4))
    caps = dict(input=512, recv=128, local=256, mid=4096, agg=4096,
                join=16384, out=4096)
    expect = oracle_a3(src, dst)
    tri_oracle = oracle_triangles(src, dst)

    for algo in ("2,3JA", "1,3JA"):
        out, st, overflow = a_cubed(grid, src, dst, algorithm=algo,
                                    caps=caps, device=args.device)
        if bool(overflow):
            raise SystemExit(f"{algo}: capacity overflow — raise caps")
        rows = {n: c[out.valid].cpu().numpy() for n, c in out.cols.items()}
        got = {}
        for a, d, p in zip(rows["a"], rows["d"], rows["p"]):
            got[(int(a), int(d))] = got.get((int(a), int(d)), 0.0) + float(p)
        if set(got) != set(expect):
            raise SystemExit(f"{algo}: (a, d) pairs differ from the oracle")
        for key in expect:
            np.testing.assert_allclose(got[key], expect[key], rtol=1e-5)
        tri = float(triangle_count_from_a3(out))
        if round(3 * tri) != round(3 * tri_oracle):
            raise SystemExit(f"{algo}: {tri} triangles, oracle {tri_oracle}")
        print(f"{algo}: A³ matches oracle ({len(got)} (a,d) pairs); "
              f"triangles={tri:.0f} (oracle {tri_oracle:.0f}); "
              f"measured comm cost = "
              f"{float(st['read'] + st['shuffled']):.0f} tuples "
              f"on {out.valid.device}")

    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
