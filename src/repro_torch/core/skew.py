"""The key-frequency sketch the planner prices skew with.

Port of ``chain_key_sketch`` from ``src/repro/core/skew.py`` (pure
numpy).  Heavy-hitter detection and the SharesSkew lowering, which
need the ``hash_histogram`` kernel, are a later slice (ROADMAP A10, B3).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def chain_key_sketch(edge_lists: Sequence[Tuple[np.ndarray, np.ndarray]],
                     top_k: int = 16,
                     ) -> Tuple[Tuple[Tuple[int, float, float], ...], ...]:
    """Top-k key-frequency sketch of a chain, in the
    ``ChainStats.key_freqs`` layout: one tuple per join attribute d,
    entries ``(key, f_left, f_right)`` with f_left the key's frequency
    in R_{d+1}'s right column (``dst``) and f_right its frequency in
    R_{d+2}'s left column (``src``), sorted by f_left+f_right
    descending."""
    out = []
    for d in range(len(edge_lists) - 1):
        left = np.asarray(edge_lists[d][1])       # dst column of rel d
        right = np.asarray(edge_lists[d + 1][0])  # src column of rel d+1
        lk, lc = np.unique(left, return_counts=True)
        rk, rc = np.unique(right, return_counts=True)
        freqs = {int(k): [float(c), 0.0] for k, c in zip(lk, lc)}
        for k, c in zip(rk, rc):
            freqs.setdefault(int(k), [0.0, 0.0])[1] = float(c)
        ranked = sorted(freqs.items(), key=lambda kv: -(kv[1][0] + kv[1][1]))
        out.append(tuple((k, fl, fr) for k, (fl, fr) in ranked[:top_k]))
    return tuple(out)
