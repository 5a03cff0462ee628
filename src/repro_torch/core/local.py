"""Per-device (per-"reducer") relational operators — the data plane.

Port of ``src/repro/core/local.py``.  Every operator is written once,
batched over any leading axes of its relations (the SimGrid's grid
axes), and works along the trailing capacity axis: sorts, searches,
gathers and scatters all take ``dim=-1``.  Outputs have a caller-chosen
capacity plus an overflow flag, which stays a device tensor (one per
leading index).

The reduce-side hot path is **sort-merge**: :func:`sort_merge_join`
(one stable sort per input, searchsorted probe, prefix-sum pair
expansion) and the single-pass :func:`groupby_sum` (one lexicographic
sort feeding the ``segment_sum`` kernel).  :func:`fused_sort_merge_join`
is the rank-packed variant whose probe is the ``probe_counts`` kernel.
:func:`local_join_allpairs` and :func:`groupby_sum_multipass` are the
oracle references.

Row order, padding and overflow behaviour equal the JAX package's as
full arrays; orders here are int64 indices (torch gathers need them)
where the reference's are int32.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .. import config
from ..kernels import fused_join as fj
from ..kernels.segment_sum import segment_sum
from .relation import Relation, scatter_drop


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


# ---------------------------------------------------------------------------
# Hash partition (map-phase counting sort into destination buckets)
# ---------------------------------------------------------------------------

def partition_ranks(bucket: torch.Tensor, valid: torch.Tensor, n_buckets: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stable counting-sort plan: ``(order, sorted_bucket, rank)`` where
    ``order`` stably sorts rows by bucket (invalid last) and ``rank[i]``
    is sorted row i's position within its bucket."""
    key = torch.where(valid, bucket, n_buckets)     # invalid rows sort last
    order = fj.partition_order(key, n_buckets)
    sorted_key = key.gather(-1, order)
    # First sorted position of every bucket value, then of each row's.
    values = _iota(n_buckets + 1, key).to(key.dtype)
    starts = torch.searchsorted(
        sorted_key, values.expand(*key.shape[:-1], -1).contiguous())
    first = starts.gather(-1, sorted_key.to(torch.int64))
    rank = _iota(key.shape[-1], key) - first
    return order, sorted_key, rank


def partition(rel: Relation, bucket: torch.Tensor, n_buckets: int,
              cap_per_bucket: int) -> Tuple[Relation, torch.Tensor]:
    """Scatter tuples into (n_buckets, cap_per_bucket) send buffers —
    the map-phase emit (tuple -> destination reducer).

    Returns a Relation whose columns are (..., n_buckets,
    cap_per_bucket), each bucket's rows in their input order, plus an
    overflow flag per leading index (any bucket fuller than its
    capacity; the rows past it are dropped)."""
    order, sorted_bucket, rank = partition_ranks(bucket, rel.valid, n_buckets)
    live = sorted_bucket < n_buckets
    in_range = live & (rank < cap_per_bucket)
    overflow = (live & ~in_range).any(-1)
    total = n_buckets * cap_per_bucket
    dest = torch.where(in_range, sorted_bucket.to(torch.int64)
                       * cap_per_bucket + rank, total)
    shape = (*rel.valid.shape[:-1], n_buckets, cap_per_bucket)

    def scatter(col: torch.Tensor) -> torch.Tensor:
        return scatter_drop(col.gather(-1, order), dest, total).view(shape)

    return Relation({n: scatter(c) for n, c in rel.cols.items()},
                    scatter_drop(in_range, dest, total).view(shape)), overflow


# ---------------------------------------------------------------------------
# Local equi-join (the reduce-side join within one reducer)
# ---------------------------------------------------------------------------

def _emit_join_columns(left: Relation, right: Relation, left_key: str,
                       right_key: str, li_out: torch.Tensor,
                       ri_out: torch.Tensor, valid_out: torch.Tensor,
                       prefix_l: str, prefix_r: str) -> Dict[str, torch.Tensor]:
    """Gather output columns for matched (left-row, right-row) index
    pairs: both inputs' columns, optional prefixes, the shared key
    emitted once under the left key's unprefixed name."""
    cols: Dict[str, torch.Tensor] = {}
    for n, c in left.cols.items():
        name = n if n == left_key else prefix_l + n
        cols[name] = torch.where(valid_out, c.gather(-1, li_out), 0)
    for n, c in right.cols.items():
        if n == right_key:
            continue  # key equal to left key; emitted once
        name = prefix_r + n
        if name in cols:
            raise ValueError(f"column collision {name!r}; use prefixes")
        cols[name] = torch.where(valid_out, c.gather(-1, ri_out), 0)
    return cols


def _pack_validity(valid: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """One int64 word ordered as (validity, int32 key): invalid rows
    above every valid one, keys offset to be non-negative."""
    return ((~valid).to(torch.int64) << 32) | (key.to(torch.int64) + 2 ** 31)


def _lex_order(valid: torch.Tensor, keys: Sequence[torch.Tensor]
               ) -> torch.Tensor:
    """Stable argsort by (validity, keys[0], keys[1], ...) along the last
    axis — the reference's multi-operand ``lax.sort`` — as successive
    stable sorts, least significant key first.  An int32 most
    significant key shares one packed int64 pass with the validity."""
    order = None

    def refine(col: torch.Tensor) -> None:
        nonlocal order
        c = col if order is None else col.gather(-1, order)
        idx = torch.sort(c, dim=-1, stable=True).indices
        order = idx if order is None else order.gather(-1, idx)

    for col in reversed(keys[1:]):
        refine(col)
    if keys and keys[0].dtype == torch.int32:
        refine(_pack_validity(valid, keys[0]))
    else:
        if keys:
            refine(keys[0])
        refine((~valid).to(torch.uint8))
    return order


def _sorted_by_key(key: torch.Tensor, valid: torch.Tensor,
                   presorted: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort by (validity, key): valid rows first in ascending key
    order.  Returns (order, masked) where ``masked`` replaces the
    trailing invalid rows' keys with the dtype's max — non-decreasing
    even when a *valid* key equals the sentinel (callers clamp search
    results by the valid count).  ``presorted=True`` asserts the rows
    already satisfy that contract and skips the sort."""
    n = key.shape[-1]
    n_valid = valid.sum(-1, keepdim=True)
    sentinel = torch.iinfo(key.dtype).max
    idx = _iota(n, key)
    if presorted:
        order = idx.expand(key.shape)
        return order, torch.where(idx < n_valid, key, sentinel)
    order = _lex_order(valid, [key])
    return order, torch.where(idx < n_valid, key.gather(-1, order), sentinel)


def sort_rows(rel: Relation, key: str) -> Relation:
    """Reorder a relation into the sorted-rows contract: valid rows
    first, ascending ``key`` (stable)."""
    order, _ = _sorted_by_key(rel.col(key), rel.valid)
    return rel.gather(order, torch.ones_like(rel.valid))


def _probe_expand_emit(left: Relation, right: Relation, left_key: str,
                       right_key: str, out_capacity: int, prefix_l: str,
                       prefix_r: str, n_lv: torch.Tensor, n_rv: torch.Tensor,
                       l_order: torch.Tensor, r_order: torch.Tensor,
                       lo: torch.Tensor, hi: torch.Tensor,
                       ) -> Tuple[Relation, torch.Tensor]:
    """Shared tail of the sorted-probe join: valid-count clamping, the
    prefix scan, pair expansion and column emit.  Both
    :func:`sort_merge_join` and :func:`fused_sort_merge_join` end here,
    which makes their outputs bit-identical by construction."""
    nl = l_order.shape[-1]
    nr = r_order.shape[-1]
    # Clamping by the valid count drops the sentinel tail (incl. the
    # INT32_MAX collision).
    lo = torch.minimum(lo.to(torch.int64), n_rv)
    hi = torch.minimum(hi.to(torch.int64), n_rv)
    cnt = torch.where(_iota(nl, lo) < n_lv, hi - lo, 0)

    # The reference's saturating int32 scan, as an int64 prefix sum
    # clamped to out_capacity + 1: equal because every count is >= 0,
    # and no int64 prefix can wrap.
    ends = torch.cumsum(cnt, -1).clamp_(max=out_capacity + 1)
    n_match = ends[..., -1:]
    overflow = (n_match > out_capacity).squeeze(-1)

    # Pair expansion: output slot s belongs to the first sorted-left row
    # whose inclusive prefix count exceeds s; its offset within that
    # row's run indexes the right-sorted range.
    slot = _iota(out_capacity, lo).expand(*lo.shape[:-1], -1).contiguous()
    owner = torch.searchsorted(ends, slot, side="right").clamp_(0, nl - 1)
    starts = torch.cat([torch.zeros_like(ends[..., :1]), ends[..., :-1]], -1)
    off = slot - starts.gather(-1, owner)
    r_pos = (lo.gather(-1, owner) + off).clamp_(0, nr - 1)

    valid_out = slot < n_match
    li_out = l_order.gather(-1, owner)
    ri_out = r_order.gather(-1, r_pos)
    cols = _emit_join_columns(left, right, left_key, right_key,
                              li_out, ri_out, valid_out, prefix_l, prefix_r)
    return Relation(cols, valid_out), overflow


def _check_out_capacity(out_capacity: int) -> None:
    # The reference's int32 position arithmetic bound, kept so both
    # packages accept the same capacities.
    if not 0 < out_capacity < config.SORT_MERGE_MAX_CAP:
        raise ValueError(f"out_capacity must be in (0, 2^30 - 1), got "
                         f"{out_capacity}")


def sort_merge_join(left: Relation, right: Relation, left_key: str,
                    right_key: str, out_capacity: int,
                    prefix_l: str = "", prefix_r: str = "",
                    presorted_l: bool = False, presorted_r: bool = False,
                    ) -> Tuple[Relation, torch.Tensor]:
    """Equi-join on ``left_key == right_key`` by sorted probe — the
    data-plane fast path: one stable sort per input, a
    ``searchsorted`` left/right run-length match count per left row, a
    prefix sum assigning output slots, and a static-capacity gather.
    ``presorted_*`` assert the input already satisfies the sorted-rows
    contract and skip its sort."""
    _check_out_capacity(out_capacity)
    lk, rk = left.col(left_key), right.col(right_key)
    n_lv = left.valid.sum(-1, keepdim=True)
    n_rv = right.valid.sum(-1, keepdim=True)
    l_order, lk_m = _sorted_by_key(lk, left.valid, presorted=presorted_l)
    r_order, rk_m = _sorted_by_key(rk, right.valid, presorted=presorted_r)
    # Matches of sorted-left row i live in right-sorted [lo[i], hi[i]).
    lo = torch.searchsorted(rk_m, lk_m, side="left")
    hi = torch.searchsorted(rk_m, lk_m, side="right")
    return _probe_expand_emit(left, right, left_key, right_key, out_capacity,
                              prefix_l, prefix_r, n_lv, n_rv,
                              l_order, r_order, lo, hi)


def fused_sort_merge_join(left: Relation, right: Relation, left_key: str,
                          right_key: str, out_capacity: int,
                          prefix_l: str = "", prefix_r: str = "",
                          presorted_l: bool = False, presorted_r: bool = False,
                          ) -> Tuple[Relation, torch.Tensor]:
    """The fused pipeline, ``join_impl="fused"``: rank-packed per-side
    sorts and the ``probe_counts`` kernel for the run bounds, then the
    staged path's own tail — bit-identical to :func:`sort_merge_join`."""
    _check_out_capacity(out_capacity)
    lk, rk = left.col(left_key), right.col(right_key)
    n_lv = left.valid.sum(-1, keepdim=True)
    n_rv = right.valid.sum(-1, keepdim=True)
    if presorted_l:
        l_order, lk_m = _sorted_by_key(lk, left.valid, presorted=True)
    else:
        l_order, lk_m = fj.stable_key_order(lk, left.valid)
    if presorted_r:
        r_order, rk_m = _sorted_by_key(rk, right.valid, presorted=True)
    else:
        r_order, rk_m = fj.stable_key_order(rk, right.valid)
    lo, hi = fj.probe_counts(lk_m.contiguous(), rk_m.contiguous())
    return _probe_expand_emit(left, right, left_key, right_key, out_capacity,
                              prefix_l, prefix_r, n_lv, n_rv,
                              l_order, r_order, lo, hi)


def local_join_allpairs(left: Relation, right: Relation, left_key: str,
                        right_key: str, out_capacity: int,
                        prefix_l: str = "", prefix_r: str = "",
                        presorted_l: bool = False, presorted_r: bool = False,
                        ) -> Tuple[Relation, torch.Tensor]:
    """All-pairs equi-join with masks — the **oracle reference** for
    :func:`sort_merge_join`: O(nl·nr) compute and memory.  Output rows
    are in left-major pair order; ``presorted_*`` are ignored."""
    del presorted_l, presorted_r
    lk, rk = left.col(left_key), right.col(right_key)
    nl, nr = lk.shape[-1], rk.shape[-1]
    if nl * nr >= config.INT32_PAIR_LIMIT:
        raise ValueError(
            f"all_pairs flat pair index overflows int32: {nl} x {nr} = "
            f"{nl * nr} >= 2^31 pairs.  Use join_impl='sort_merge' (no "
            f"pair-count limit) or shrink the per-device capacities.")
    match = ((lk.unsqueeze(-1) == rk.unsqueeze(-2))
             & left.valid.unsqueeze(-1) & right.valid.unsqueeze(-2))
    flat = match.reshape(*match.shape[:-2], nl * nr)
    slot = torch.cumsum(flat, -1) - flat.to(torch.int64)
    overflow = flat.sum(-1) > out_capacity
    dest = torch.where(flat & (slot < out_capacity), slot, out_capacity)
    pair = _iota(nl * nr, lk).expand(flat.shape)
    li_out = scatter_drop(pair // nr, dest, out_capacity)
    ri_out = scatter_drop(pair % nr, dest, out_capacity)
    valid_out = scatter_drop(flat, dest, out_capacity)
    cols = _emit_join_columns(left, right, left_key, right_key,
                              li_out, ri_out, valid_out, prefix_l, prefix_r)
    return Relation(cols, valid_out), overflow


JOIN_IMPLS = {
    "sort_merge": sort_merge_join,
    "fused": fused_sort_merge_join,
    "all_pairs": local_join_allpairs,
}


def local_join(left: Relation, right: Relation, left_key: str, right_key: str,
               out_capacity: int, prefix_l: str = "", prefix_r: str = "",
               impl: str = "sort_merge",
               presorted_l: bool = False, presorted_r: bool = False,
               ) -> Tuple[Relation, torch.Tensor]:
    """Equi-join two local relations on ``left_key == right_key`` with
    the chosen implementation (``sort_merge``, ``fused`` or the
    ``all_pairs`` oracle)."""
    try:
        fn = JOIN_IMPLS[impl]
    except KeyError:
        raise ValueError(
            f"unknown join impl {impl!r}; one of {sorted(JOIN_IMPLS)}")
    return fn(left, right, left_key, right_key, out_capacity,
              prefix_l=prefix_l, prefix_r=prefix_r,
              presorted_l=presorted_l, presorted_r=presorted_r)


# ---------------------------------------------------------------------------
# Local group-by-sum (the aggregation hot spot; paper Section V)
# ---------------------------------------------------------------------------

def _group_heads(sorted_valid: torch.Tensor, sorted_keys
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Given rows sorted by (validity, *keys): the group-head mask and
    per-row group index (cumsum of heads − 1)."""
    prev_same = torch.ones_like(sorted_valid)
    for sk in sorted_keys:
        prev_same = prev_same & (sk == torch.roll(sk, 1, -1))
    first = _iota(sorted_valid.shape[-1], sorted_valid) == 0
    head = sorted_valid & (~prev_same | first)
    return head, torch.cumsum(head, -1) - 1


def _groupby_emit(sorted_valid, sorted_keys, keys, value, sums_fn, out_cap):
    """Shared tail of both group-bys: heads, segment ids, the per-group
    sums (``sums_fn(seg, dest)``) and the scattered group keys."""
    head, seg_id = _group_heads(sorted_valid, sorted_keys)
    n_groups = head.sum(-1, keepdim=True)
    overflow = (n_groups > out_cap).squeeze(-1)
    dest = torch.where(sorted_valid & (seg_id < out_cap), seg_id, out_cap)
    out_cols = {k: scatter_drop(sk, dest, out_cap)
                for k, sk in zip(keys, sorted_keys)}
    out_cols[value] = sums_fn(seg_id, dest)
    valid_out = _iota(out_cap, sorted_valid) < n_groups
    return Relation(out_cols, valid_out), overflow


def groupby_sum(rel: Relation, keys: Tuple[str, ...], value: str,
                out_capacity: int | None = None,
                ) -> Tuple[Relation, torch.Tensor]:
    """SUM ``value`` grouped by ``keys`` — the single-pass aggregator.

    One stable lexicographic sort orders rows by (validity, keys...);
    run heads become segment ids and the per-segment sums go through
    :func:`repro_torch.kernels.segment_sum.segment_sum` (the CUDA kernel
    on a GPU).  ``overflow`` is raised when the group count exceeds the
    output capacity; the surviving groups are the first in key order.
    """
    out_cap = out_capacity if out_capacity is not None else rel.capacity
    keys = tuple(keys)
    order = _lex_order(rel.valid, [rel.cols[k] for k in keys])
    sorted_valid = rel.valid.gather(-1, order)
    sorted_keys = [rel.cols[k].gather(-1, order) for k in keys]
    sorted_val = rel.cols[value].gather(-1, order).to(torch.float32)

    def sums(seg_id, dest):
        # Segment ids are non-decreasing over the valid prefix — the
        # sorted-ids case the kernel is built for.  Invalid rows get id
        # out_cap, dropped by the kernel.
        seg = torch.where(sorted_valid, seg_id, out_cap).to(torch.int32)
        return segment_sum(torch.where(sorted_valid, sorted_val, 0.0),
                           seg, out_cap)

    return _groupby_emit(sorted_valid, sorted_keys, keys, value, sums, out_cap)


def groupby_sum_multipass(rel: Relation, keys: Tuple[str, ...], value: str,
                          out_capacity: int | None = None
                          ) -> Tuple[Relation, torch.Tensor]:
    """SUM ``value`` grouped by ``keys`` (argsort chain + scatter-add) —
    the **oracle reference** for :func:`groupby_sum`."""
    cap = rel.capacity
    out_cap = out_capacity if out_capacity is not None else cap
    keys = tuple(keys)
    order = _iota(cap, rel.valid).expand(rel.valid.shape)
    for k in reversed(keys):
        col = rel.cols[k].gather(-1, order)
        col = torch.where(rel.valid.gather(-1, order), col,
                          torch.iinfo(col.dtype).max)
        order = order.gather(-1, torch.sort(col, dim=-1, stable=True).indices)
    inv = (~rel.valid.gather(-1, order)).to(torch.uint8)
    order = order.gather(-1, torch.sort(inv, dim=-1, stable=True).indices)

    sorted_valid = rel.valid.gather(-1, order)
    sorted_keys = [rel.cols[k].gather(-1, order) for k in keys]
    sorted_val = rel.cols[value].gather(-1, order).to(torch.float32)

    def sums(seg_id, dest):
        v = torch.where(sorted_valid, sorted_val, 0.0)
        out = v.new_zeros(*v.shape[:-1], out_cap + 1)
        return out.scatter_add_(-1, dest, v)[..., :out_cap]

    return _groupby_emit(sorted_valid, sorted_keys, keys, value, sums, out_cap)
