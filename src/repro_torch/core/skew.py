"""Heavy-hitter detection and the SharesSkew split plan.

Port of ``src/repro/core/skew.py``.  The Shares hypercube hashes every
tuple with join-attribute value v to the same slice of the grid, so one
heavy key turns a reducer slice into a straggler while the
communication charge does not move.  Following SharesSkew (Afrati,
Stasinopoulos, Ullman, Vassilakopoulos), this module

1. finds, per join attribute, the keys whose frequency exceeds the
   per-reducer balance threshold of the plain Shares grid
   (:func:`heavy_hitters` — ``bucket_counts`` on the device, the
   ``hash_histogram`` kernel on a GPU, as a no-false-negative candidate
   filter; exact host-side counts to confirm), and
2. builds a :class:`SkewSplitPlan`: each relation splits into heavy and
   residual parts per join attribute, and one Shares sub-join runs per
   heavy/residual combination on the plain integer-share grid with its
   heavy dims clamped to share 1.

The executor lowering is :func:`repro_torch.core.executor
.shares_skew_chain`; the planner prices skew from
:func:`chain_key_sketch` (``ChainStats.key_freqs``) without seeing the
data twice.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config
from ..kernels.hash_partition import bucket_counts
from .cost_model import (balance_threshold, cost_chain_shares_skew,
                         integer_shares, skew_clamped_shape)
from .hashing import bucket_hash
from .plan import ChainQuery

_SKETCH_SALT = 3  # detection hop salt, distinct from routing salts 0..2


# ---------------------------------------------------------------------------
# Heavy-hitter detection
# ---------------------------------------------------------------------------

def heavy_hitters(values: np.ndarray, threshold: float, *,
                  n_buckets: int = 4096, device=None,
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Keys of ``values`` with frequency strictly above ``threshold``.

    Two passes, so the exact count never touches the full key domain:

    1. ``bucket_counts`` on ``device`` (default: the GPU, where it is the
       ``hash_histogram`` kernel) buckets the column into ``n_buckets``;
       a bucket's count upper-bounds every resident key's frequency, so
       only keys in buckets above the threshold can be heavy (no false
       negatives);
    2. exact ``np.unique`` counting on the host, on the candidate rows
       only (their buckets from the same hash on CPU tensors).

    Returns (keys, counts) sorted by count, descending.
    """
    vals = np.asarray(values)
    if vals.size == 0 or not np.isfinite(threshold):
        return np.empty((0,), np.int32), np.empty((0,), np.float64)
    keys = torch.as_tensor(vals, device=config.resolve_device(device))
    hist = bucket_counts(keys, torch.ones_like(keys, dtype=torch.bool),
                         n_buckets, salt=_SKETCH_SALT)
    hot = hist.cpu().numpy() > threshold
    if not hot.any():
        return np.empty((0,), np.int32), np.empty((0,), np.float64)
    buckets = bucket_hash(torch.as_tensor(vals), n_buckets,
                          salt=_SKETCH_SALT).numpy()
    cand = vals[hot[buckets]]
    keys, counts = np.unique(cand, return_counts=True)
    sel = counts > threshold
    keys, counts = keys[sel], counts[sel].astype(np.float64)
    order = np.argsort(-counts, kind="stable")
    return keys[order], counts[order]


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


# ---------------------------------------------------------------------------
# The split plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SkewCombo:
    """One heavy/residual combination of a SharesSkew execution.

    heavy_dims: per hypercube dim, whether this combination takes the
                heavy part of that join attribute.
    sizes:      exact per-relation tuple counts of the combination's
                inputs (relation j filtered on its own join attrs only).
    grid_shape: the combination's grid — the plain integer-share grid
                with heavy dims clamped to 1.
    """
    heavy_dims: Tuple[bool, ...]
    sizes: Tuple[float, ...]
    grid_shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class SkewSplitPlan:
    """Everything the executor needs to run the SharesSkew lowering.

    heavy:      per join dim, the (possibly empty) array of heavy keys.
    combos:     the non-empty heavy/residual combinations, all-residual
                first.  A relation pinning fewer dims than the
                combination count is read by several combinations, and
                :meth:`cost` charges each read.
    base_shape: the plain Shares grid the residual combination keeps.
    k:          the reducer budget the plan was derived for.
    """
    heavy: Tuple[np.ndarray, ...]
    combos: Tuple[SkewCombo, ...]
    base_shape: Tuple[int, ...]
    k: int

    @property
    def n_heavy(self) -> Tuple[int, ...]:
        return tuple(int(h.size) for h in self.heavy)

    def cost(self) -> float:
        """Exact analytic SharesSkew cost (read + shuffle over all
        combinations) — equals the executor's measured total."""
        return cost_chain_shares_skew(
            [(c.sizes, c.grid_shape) for c in self.combos])

    def read_cost(self) -> float:
        return sum(sum(c.sizes) for c in self.combos)

    def shuffle_cost(self) -> float:
        return self.cost() - self.read_cost()


def _heavy_mask(col: np.ndarray, heavy: np.ndarray) -> np.ndarray:
    if heavy.size == 0:
        return np.zeros(col.shape, bool)
    return np.isin(col, heavy)


def detect_chain_skew(query: ChainQuery,
                      edge_lists: Sequence[Tuple[np.ndarray, np.ndarray]],
                      k: int, *, slack: float = 1.25,
                      n_buckets: int = 4096, device=None,
                      ) -> Optional[SkewSplitPlan]:
    """Build the exact SharesSkew plan for a chain of edge relations,
    or ``None`` when no join attribute has a key above the balance
    threshold (uniform workloads take the unskewed path untouched).

    Per join dim d the threshold is ``slack · r_j / k_d`` with ``k_d``
    the plain integer share of that dim; a key is heavy if it crosses
    the threshold in either adjacent relation.  Pass 1 of
    :func:`heavy_hitters` runs on ``device`` (default: the GPU); the
    rest is host numpy — detection is planning, done once before
    execution."""
    n = query.n_relations
    if len(edge_lists) != n:
        raise ValueError(f"query has {n} relations, got {len(edge_lists)}")
    sizes = tuple(float(len(np.asarray(src))) for src, _ in edge_lists)
    base = integer_shares(sizes, k)

    heavy: List[np.ndarray] = []
    for d in range(n - 1):
        hl, _ = heavy_hitters(
            np.asarray(edge_lists[d][1]),
            balance_threshold(sizes[d], base[d], slack),
            n_buckets=n_buckets, device=device)
        hr, _ = heavy_hitters(
            np.asarray(edge_lists[d + 1][0]),
            balance_threshold(sizes[d + 1], base[d], slack),
            n_buckets=n_buckets, device=device)
        heavy.append(np.unique(np.concatenate([hl, hr])))
    if all(h.size == 0 for h in heavy):
        return None

    # Per-relation heavy masks on each of its own join attrs.  Relation
    # j's columns: dim j−1 ↔ its src column, dim j ↔ its dst column.
    masks = []
    for j in range(n):
        src, dst = (np.asarray(a) for a in edge_lists[j])
        per_dim = {}
        if j > 0:
            per_dim[j - 1] = _heavy_mask(src, heavy[j - 1])
        if j < n - 1:
            per_dim[j] = _heavy_mask(dst, heavy[j])
        masks.append(per_dim)

    active = [d for d in range(n - 1) if heavy[d].size]
    combos: List[SkewCombo] = []
    for choice in itertools.product((False, True), repeat=len(active)):
        heavy_dims = [False] * (n - 1)
        for d, c in zip(active, choice):
            heavy_dims[d] = c
        combo_sizes = []
        for j in range(n):
            keep = np.ones(int(sizes[j]), bool)
            for d, m in masks[j].items():
                keep &= m if heavy_dims[d] else ~m
            combo_sizes.append(float(keep.sum()))
        if min(combo_sizes) <= 0.0:
            continue  # an empty input ⇒ the sub-join is empty
        combos.append(SkewCombo(
            heavy_dims=tuple(heavy_dims),
            sizes=tuple(combo_sizes),
            grid_shape=skew_clamped_shape(base, heavy_dims)))
    combos.sort(key=lambda c: sum(c.heavy_dims))  # all-residual first
    return SkewSplitPlan(heavy=tuple(heavy), combos=tuple(combos),
                         base_shape=tuple(base), k=k)
