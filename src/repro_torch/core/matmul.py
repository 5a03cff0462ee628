"""Edge relations and host-side graph oracles (paper §II).

Port of ``edge_relation``, ``oracle_a3`` and ``oracle_triangles`` from
``src/repro/core/matmul.py``.  A sparse matrix is a relation
M(row, col, val); the three-way self-join plus aggregation is A³
restricted to listed entries — friend-of-friend path counts.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

import numpy as np
import torch

from .. import config
from .relation import Relation


def edge_relation(src, dst, val=None, capacity=None,
                  names=("a", "b", "v"), key_dtype=None,
                  device=None) -> Relation:
    """Edge list -> relation with attribute names (a, b, v) by default, on
    ``device`` (default: the GPU).  ``key_dtype`` defaults to the
    configured key dtype."""
    device = config.resolve_device(device)
    key_dtype = config.default_key_dtype() if key_dtype is None else key_dtype
    src = torch.as_tensor(np.asarray(src), dtype=key_dtype, device=device)
    dst = torch.as_tensor(np.asarray(dst), dtype=key_dtype, device=device)
    v = (torch.ones_like(src, dtype=torch.float32) if val is None else
         torch.as_tensor(np.asarray(val), dtype=torch.float32, device=device))
    return Relation.from_arrays(capacity,
                                **{names[0]: src, names[1]: dst, names[2]: v})


def oracle_a3(src, dst) -> Dict[Tuple[int, int], float]:
    """Dense-dict A³ on the host."""
    adj = defaultdict(list)
    for s_, d_ in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
        adj[s_].append(d_)
    out: Dict[Tuple[int, int], float] = defaultdict(float)
    for a, bs in adj.items():
        for b in bs:
            for c in adj.get(b, ()):
                for d in adj.get(c, ()):
                    out[(a, d)] += 1.0
    return dict(out)


def oracle_triangles(src, dst) -> float:
    a3 = oracle_a3(src, dst)
    return sum(v for (a, d), v in a3.items() if a == d) / 3.0
