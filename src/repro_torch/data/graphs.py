"""Synthetic SNAP-like graph generation (R-MAT).

Port: a copy of ``src/repro/data/graphs.py`` (pure numpy) without
``star_edges`` and ``degree_stats``; the same seed gives the same edge
list in both packages.

The paper's evaluation uses seven SNAP datasets (Amazon, Google Web,
Slashdot, Wikitalk, Pokec, LiveJournal, Twitter).  Offline, we generate
R-MAT graphs whose size and skew are tuned per dataset family: the
quantity driving every paper figure is the ratio |A⋈A| / |A| (= Σ
indeg·outdeg / edges), which grows with degree skew — Twitter-like
graphs get the most skewed partition matrix, Amazon-like the least.

Scales are reduced (CPU-runnable) but the RATIOS reproduce the paper's
ordering: amazon < google-web < slashdot/wikitalk < pokec < livejournal
< twitter, hence the same orders-of-magnitude spread of crossover
reducer counts (paper Fig. 3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphSpec:
    name: str
    scale: int          # log2 #nodes
    edge_factor: float  # edges per node
    a: float            # R-MAT skew (a >> b,c,d = heavier hubs)

    @property
    def n_nodes(self) -> int:
        return 1 << self.scale

    @property
    def n_edges(self) -> int:
        return int(self.n_nodes * self.edge_factor)


# Skew (a) ordered to reproduce the paper's dataset ordering by
# |A⋈A|/|A|; sizes scaled down ~1000x from SNAP.
DATASETS: Dict[str, GraphSpec] = {
    "amazon": GraphSpec("amazon", 12, 3.0, 0.50),
    "google-web": GraphSpec("google-web", 12, 5.0, 0.54),
    "slashdot": GraphSpec("slashdot", 11, 10.0, 0.57),
    "wikitalk": GraphSpec("wikitalk", 12, 4.0, 0.62),
    "pokec": GraphSpec("pokec", 12, 15.0, 0.58),
    "livejournal": GraphSpec("livejournal", 12, 14.0, 0.585),
    "twitter": GraphSpec("twitter", 12, 80.0, 0.66),
}


def rmat_edges(spec: GraphSpec, seed: int = 0,
               dedup: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Generate a directed R-MAT edge list (src, dst), deduplicated."""
    rng = np.random.default_rng(seed)
    n_bits = spec.scale
    m = spec.n_edges
    a = spec.a
    rem = 1.0 - a
    b, c, d = rem * 0.4, rem * 0.4, rem * 0.2

    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(n_bits):
        r = rng.random(m)
        src_bit = (r >= a + b) & (r < 1.0)
        src_bit &= ~((r >= a + b) & (r < a + b + 0.0))  # no-op, clarity
        # quadrant choice: [a | b / c | d]
        go_src = (r >= a + b)                  # bottom half -> src bit 1
        go_dst = ((r >= a) & (r < a + b)) | (r >= a + b + c)  # right half
        src |= go_src.astype(np.int64) << bit
        dst |= go_dst.astype(np.int64) << bit
    edges = np.stack([src, dst], axis=1)
    if dedup:
        edges = np.unique(edges, axis=0)
    # permute node ids so hub structure isn't axis-aligned with hashing
    perm = rng.permutation(spec.n_nodes)
    return (perm[edges[:, 0]].astype(np.int32),
            perm[edges[:, 1]].astype(np.int32))


def zipf_edges(n_nodes: int, n_edges: int, alpha: float,
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Edge list with Zipf(alpha)-distributed endpoints — the skewed
    workload the SharesSkew path (docs/skew.md) is built for.

    Both columns are drawn independently from P(node i) ∝ (i+1)^−alpha
    over ``n_nodes`` node ids, so every join attribute of a chain built
    from such lists is skewed: at alpha ≳ 1 the top key concentrates a
    constant fraction of each relation, which is exactly the regime
    where hashing it overloads one reducer slice of the hypercube.
    ``alpha = 0`` is the uniform baseline.  Deterministic in ``seed``
    (same seed ⇒ bit-identical arrays).
    """
    if n_nodes < 1 or n_edges < 1:
        raise ValueError("need n_nodes >= 1 and n_edges >= 1")
    if alpha < 0:
        raise ValueError(f"alpha must be >= 0, got {alpha}")
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
    p = ranks ** -alpha
    p /= p.sum()
    src = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    dst = rng.choice(n_nodes, size=n_edges, p=p).astype(np.int32)
    return src, dst
