"""The shuffle layer: MapReduce's sort/shuffle guarantee on a device grid.

Port of ``src/repro/core/shuffle.py``.  Operators of this package are
written once against the :class:`Grid` interface and run on either
grid:

* :class:`SimGrid` carries the grid axes as leading tensor axes; every
  per-device operator of this package is batched over leading axes, so
  per-device work runs on the whole grid in one call (the JAX package's
  ``map_devices`` vmap has no counterpart), an all-to-all is one
  scatter into the receive shards and an all-gather a broadcast.
  ``SimGrid(shape, lanes=L)`` adds one lane axis ahead of the grid
  axes — the port's ``jax.vmap`` over a whole execution: lanes never
  exchange tuples, and every grid reduction answers per lane.
* :class:`ShardGrid` runs on a :class:`~repro_torch.distributed.Mesh`
  of ``torch.distributed`` ranks, one device each: a rank holds its
  own flat shards and the collectives are ``all_to_all_single``,
  ``all_gather_into_tensor`` and ``all_reduce`` over the subgroup of a
  grid axis.

For every method, SimGrid's global view equals ShardGrid's per-rank
view: a rank's relation, stats and overflow flag equal the SimGrid
run's slice at the rank's grid coordinate, as full arrays
(``tests/test_torch_shardgrid.py``).  :func:`split_rows` and
:func:`concat_rows` carry the overlapped (chunked) shuffle schedule.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.mesh import all_gather_single
from .local import partition, partition_ranks
from .relation import Relation, concat, flatten_leading


class Grid:
    """Abstract k1×...×kn reducer grid.  Per-device work needs no grid
    method: the operators take a relation with or without leading grid
    axes alike."""

    shape: Tuple[int, ...]
    lanes: int = 0          # independent executions along a leading axis

    @property
    def lead(self) -> int:
        """Tensor axes ahead of the grid axes: 1 with lanes, else 0."""
        return 1 if self.lanes else 0

    def all_to_all(self, x: Relation, grid_axis: int) -> Relation:
        """Per-device x has a leading axis of size shape[grid_axis]
        (bucket-major send buffers); returns the same shape, leading
        axis = source."""
        raise NotImplementedError

    def all_gather(self, x: Relation, grid_axis: int) -> Relation:
        """Replicate per-device x along a grid axis -> leading axis=source."""
        raise NotImplementedError

    def reduce_any(self, x: torch.Tensor) -> torch.Tensor:
        """OR-reduce a per-device bool across the whole grid."""
        raise NotImplementedError

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def any_per_lane(self, x: torch.Tensor) -> torch.Tensor:
        """OR of every element of per-device ``x`` over the whole grid:
        a scalar without lanes, (L,) with them."""
        raise NotImplementedError


class SimGrid(Grid):
    """Simulated grid: tensors carry the grid axes as leading dims.

    With ``lanes=L > 0`` every tensor carries one more axis in front,
    ``(L, *shape, rows)``: L independent executions of one plan (the
    query engine's batched tenants).  Grid axes are then counted after
    the lane axis, and :meth:`reduce_any` / :meth:`reduce_sum` return
    one value per lane."""

    def __init__(self, shape: Sequence[int], lanes: int = 0):
        if lanes < 0:
            raise ValueError(f"lanes must be >= 0, got {lanes}")
        self.shape = tuple(shape)
        self.lanes = int(lanes)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def all_to_all(self, x: Relation, grid_axis: int) -> Relation:
        """(*grid, K_dest, ...) send buffers -> (*grid, K_src, ...): the
        grid axis swapped with the bucket axis.  The shuffle itself
        scatters straight into the receive shards
        (:func:`shuffle_by_bucket`); this is the primitive's global view."""
        axis, bucket = self.lead + grid_axis, self.lead + self.ndim
        return x.map(lambda a: a.transpose(axis, bucket))

    def all_gather(self, x: Relation, grid_axis: int) -> Relation:
        # (*grid, ...) -> (*grid, K_src, ...) with out[g, s, ...] =
        # x[g with coordinate grid_axis replaced by s].
        k = self.shape[grid_axis]
        axis, last = self.lead + grid_axis, self.lead + self.ndim - 1

        def gather(a):
            src_last = a.movedim(axis, last).unsqueeze(axis)
            shape = list(src_last.shape)
            shape[axis] = k
            return src_last.expand(shape)
        return x.map(gather)

    def reduce_any(self, x: torch.Tensor) -> torch.Tensor:
        return torch.any(x.flatten(self.lead, self.lead + self.ndim - 1),
                         self.lead)

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(tuple(range(self.lead, self.lead + self.ndim)))

    def any_per_lane(self, x: torch.Tensor) -> torch.Tensor:
        """OR of every element of ``x`` but its lane axis: a scalar
        without lanes, (L,) with them."""
        return x.flatten(self.lead).any(-1)


def _as_bytes(a: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor a collective can move: bool as uint8."""
    a = a.contiguous()
    return a.view(torch.uint8) if a.dtype == torch.bool else a


def _from_bytes(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return a.view(torch.bool) if like.dtype == torch.bool else a


class ShardGrid(Grid):
    """The grid of a :class:`~repro_torch.distributed.Mesh`: grid axis i
    runs over mesh axes ``axis_names[i]``, a name or a tuple of names
    (``("pod", "data")`` as k1: the first most significant).  Every
    rank holds its own device's tensors, flat ``(capacity,)`` shards
    with no grid axes (``lanes = 0``, ``lead = 0``), and calls every
    method — the per-rank program of the JAX package's ``shard_map``.

    Building one is collective (it makes the subgroups of its axes on
    every rank).  Collectives run over the subgroup of the ranks that
    share every other coordinate; ``coords`` is this rank's grid
    coordinate, so a rank's tensors are the :class:`SimGrid` run's
    slice ``[coords]``.  A rank past a mesh smaller than the process
    group takes part in building the subgroups, then raises."""

    def __init__(self, mesh, axis_names: Sequence):
        self.mesh = mesh
        self.axis_names = tuple(axis_names)
        self.shape = tuple(mesh.axis_size(a) for a in self.axis_names)
        self.lanes = 0
        groups = [mesh.group(a) for a in (*self.axis_names, self._flat_axes)]
        if mesh.coords is None:
            raise ValueError(f"rank {mesh.rank} is past the mesh of "
                             f"{mesh.size} ranks: only ranks 0..{mesh.size - 1}"
                             f" run a grid on it")
        self.coords = tuple(mesh.axis_index(a) for a in self.axis_names)
        self._axis_groups = [self._group(*g) for g in groups[:-1]]
        self._all = self._group(*groups[-1])

    def _group(self, group, members):
        # Chunk i of a collective belongs to coordinate i; the group
        # may number its ranks otherwise.
        order = [dist.get_group_rank(group, m) for m in members]
        perm = None if order == list(range(len(order))) else \
            torch.as_tensor(order, device=self.mesh.device)
        return group, perm

    @property
    def backend(self) -> str:
        return self.mesh.backend

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def _flat_axes(self) -> Tuple[str, ...]:
        out: List[str] = []
        for a in self.axis_names:
            out.extend([a] if isinstance(a, str) else list(a))
        return tuple(out)

    def all_to_all(self, x: Relation, grid_axis: int) -> Relation:
        """Per-rank ``(K, ...)`` send buffers, chunk d for coordinate d
        along ``grid_axis``, -> ``(K, ...)`` received, chunk s from
        coordinate s: one ``all_to_all_single`` a column."""
        return x.map(lambda a: self.all_to_all_tensor(a, grid_axis))

    def all_to_all_tensor(self, a: torch.Tensor,
                          grid_axis: int) -> torch.Tensor:
        """:meth:`all_to_all` of one tensor: ``(K, ...)``, chunk d sent
        to coordinate d along ``grid_axis``, chunk s received from s."""
        group, perm = self._axis_groups[grid_axis]
        send = _as_bytes(a)
        if perm is not None:                # chunk g for group rank g
            send = torch.empty_like(send).index_copy_(0, perm, send)
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=group)
        if perm is not None:
            out = out.index_select(0, perm)
        return _from_bytes(out, a)

    def all_gather(self, x: Relation, grid_axis: int) -> Relation:
        """Per-rank x -> ``(K, ...)``, chunk s from coordinate s along
        ``grid_axis``: one ``all_gather_into_tensor`` a column."""
        group, perm = self._axis_groups[grid_axis]
        k = self.shape[grid_axis]

        def one(a):
            send = _as_bytes(a)
            flat = send.reshape(-1)
            out = flat.new_empty(k * flat.numel())
            all_gather_single(out, flat, group=group)
            out = out.view(k, *send.shape)
            if perm is not None:
                out = out.index_select(0, perm)
            return _from_bytes(out, a)
        return x.map(one)

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self._all[0])
        return out

    def reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of per-rank ``x`` over every mesh axis of the grid."""
        return self._all_reduce(x)

    def reduce_any(self, x: torch.Tensor) -> torch.Tensor:
        return self._all_reduce(x.to(torch.int32)) > 0

    def any_per_lane(self, x: torch.Tensor) -> torch.Tensor:
        return self.reduce_any(x.reshape(-1).any())

    def _block(self, spec, a: torch.Tensor) -> torch.Tensor:
        for dim, names in enumerate(tuple(spec or ())):
            if names is None:
                continue
            n, i = self.mesh.axis_size(names), self.mesh.axis_index(names)
            size = a.shape[dim] // n
            a = a.narrow(dim, i * size, size)
        return a.to(self.device).contiguous()

    def run(self, fn: Callable, *args, in_specs=None, out_specs=None):
        """Call ``fn(grid, *blocks)`` on this rank, where ``blocks`` are
        this rank's blocks of the global inputs ``args`` (relations or
        tensors), moved to the mesh's device.

        ``in_specs`` holds one spec per argument (default: every one
        split along its first dim by grid axis 0); a spec is a tuple
        with one entry per leading dim, the content of a JAX
        ``PartitionSpec``: a mesh axis name, a tuple of names (the dim
        split over their product, the first most significant), or
        ``None`` (not split).  A spec applies to every tensor of its
        argument.  ``out_specs`` is accepted for the reference's
        signature only: there is no single controller that would hold
        a global array, so every output comes back as this rank
        computed it — a replicated one (a reduction) as is, a sharded
        one as the rank's own block."""
        del out_specs
        if in_specs is None:
            in_specs = ((self.axis_names[0],),) * len(args)
        if len(in_specs) != len(args):
            raise ValueError(f"{len(args)} arguments need {len(args)} "
                             f"in_specs, got {len(in_specs)}")
        blocks = [arg.map(lambda a, s=spec: self._block(s, a))
                  if isinstance(arg, Relation) else self._block(spec, arg)
                  for arg, spec in zip(args, in_specs)]
        return fn(self, *blocks)


# ---------------------------------------------------------------------------
# Fault-injection hook
# ---------------------------------------------------------------------------

#: When a fault injector (:mod:`repro_torch.resilience.faults`) is
#: installed, every shuffle and broadcast hop offers it the payload the
#: reducers are about to receive, once a hop, as the JAX package does:
#: the hook may delay, raise, or report corruption.  ``None`` (the
#: default) costs one attribute read a hop.
_fault_hook = None


def set_fault_hook(hook) -> None:
    global _fault_hook
    _fault_hook = hook


def _inject(site: str, payload):
    if _fault_hook is None:
        return payload
    return _fault_hook(site, payload)


# ---------------------------------------------------------------------------
# Distributed shuffle: the MapReduce sort/shuffle guarantee
# ---------------------------------------------------------------------------

def compact_to(grid: Grid, rel: Relation, capacity: int):
    """Per-device: move valid rows to the front and shrink the buffer to
    ``capacity`` (the reducer's memory budget).  Returns (rel, overflow)."""
    ovf = rel.count() > capacity
    return rel.compact(capacity), grid.reduce_any(ovf)


def shuffle_by_bucket(grid: Grid, rel: Relation, bucket: torch.Tensor,
                      grid_axis: int, recv_capacity: int,
                      local_capacity: int | None = None):
    """Move every tuple to the device whose index along ``grid_axis``
    equals its bucket — the same-key→same-reducer guarantee.

    ``bucket`` is per-device (capacity,) int32 in [0, shape[grid_axis]).
    ``recv_capacity`` is the per (device, source) slot capacity; the
    received K×recv buffers are compacted to ``local_capacity`` (default
    K·recv = lossless).  Returns (local Relation, global overflow flag,
    tuples sent per device).  On a laned grid the lane is the most
    significant digit of the flat device index, so no tuple leaves its
    lane, and the overflow flag is per lane.

    The result is, bit for bit, the reference's partition into (K, recv)
    send buffers → all-to-all → flatten → compact, but no send buffer is
    built: a row's receive slot is the rows its destination takes from
    earlier sources plus the row's rank among its source's rows for that
    bucket, so every column scatters straight into the receive shards.
    Memory is the shards', not K × recv per device.

    On a :class:`ShardGrid` the shuffle is the reference's own sequence
    on this rank's shard, with the same result bit for bit: the rank's
    (K, recv) send buffers, ``all_to_all`` along the grid axis, flatten
    by source, compact.
    """
    k = grid.shape[grid_axis]
    if isinstance(grid, ShardGrid):
        buf, ovf = partition(rel, bucket, k, recv_capacity)
        recv = _inject("shuffle", grid.all_to_all(buf, grid_axis))
        local = flatten_leading(recv)
        overflow = grid.reduce_any(ovf)
        if local_capacity is not None and local_capacity < k * recv_capacity:
            local, ovf_c = compact_to(grid, local, local_capacity)
            overflow = overflow | ovf_c
        return local, overflow, rel.count()
    n_sent = rel.count()
    lead = rel.valid.shape[:-1]
    order, sorted_bucket, rank = partition_ranks(bucket, rel.valid, k)
    live = sorted_bucket < k
    in_slot = live & (rank < recv_capacity)
    overflow = grid.reduce_any((live & ~in_slot).any(-1))
    # Rows each source puts in each destination's slot: (*grid, K).
    starts = torch.searchsorted(sorted_bucket, torch.arange(
        k + 1, device=rel.device, dtype=sorted_bucket.dtype).expand(
            *lead, -1).contiguous())
    sent = (starts[..., 1:] - starts[..., :-1]).clamp(max=recv_capacity)
    dest = torch.where(live, sorted_bucket, 0).to(torch.int64)
    stride = int(np.prod(grid.shape[grid_axis + 1:], dtype=np.int64))
    device_idx = torch.arange(int(np.prod(lead, dtype=np.int64)),
                              device=rel.device).view(*lead, 1)
    source = device_idx // stride % k
    if local_capacity is not None and local_capacity < k * recv_capacity:
        cap = local_capacity
        axis = grid.lead + grid_axis
        earlier = torch.cumsum(sent, axis) - sent
        pos = earlier.gather(-1, dest) + rank
        received = sent.sum(axis)             # per destination
        overflow = overflow | grid.any_per_lane(received > cap)
    else:
        cap = k * recv_capacity
        pos = source * recv_capacity + rank
    total = int(np.prod(lead, dtype=np.int64)) * cap
    flat_sorted = torch.where(in_slot & (pos < cap),
                              (device_idx + (dest - source) * stride) * cap
                              + pos, total)
    flat = torch.empty_like(flat_sorted).scatter_(-1, order, flat_sorted)
    del order, sorted_bucket, rank, dest, pos, flat_sorted
    flat = flat.reshape(-1)

    def scatter(c):
        out = c.new_zeros(total + 1)
        out.scatter_(0, flat, c.reshape(-1))
        return out[:total].view(*lead, cap)
    local = Relation({n: scatter(c) for n, c in rel.cols.items()},
                     scatter(torch.ones_like(rel.valid)))
    return _inject("shuffle", local), overflow, n_sent


# ---------------------------------------------------------------------------
# Overlapped (chunked) shuffle schedule
# ---------------------------------------------------------------------------
#
# The staged schedule blocks every reduce step on one completed shuffle.
# The overlapped schedule splits a relation's rows into C contiguous
# blocks and shuffles each block on its own, so block b+1's shuffle has
# no data dependency on block b's local join.  The blocks partition the
# rows exactly, so per-hop received counts sum to the unchunked count.
# The port runs the blocks one after another on the current stream, on
# every device: a side stream for the next block's shuffle bought no
# time on an H100 and cost graph-pool memory (PERF.md §6).

def split_rows(rel: Relation, chunks: int) -> List[Relation]:
    """Partition a relation's rows (the trailing capacity axis: flat,
    grid-leading and laned layouts alike) into ``chunks`` contiguous
    blocks, cut at ``(c·cap)//chunks`` with ``chunks`` clamped to
    ``[1, cap]``.  Valid rows need not be front-packed; positional
    slicing still partitions them exactly."""
    cap = rel.capacity
    chunks = max(1, min(int(chunks), cap))
    bounds = [(c * cap) // chunks for c in range(chunks + 1)]
    return [rel.map(lambda t, a=a, b=b: t[..., a:b])
            for a, b in zip(bounds[:-1], bounds[1:])]


def concat_rows(rels: Sequence[Relation]) -> Relation:
    """Concatenate relations along the trailing capacity axis: the
    inverse of :func:`split_rows` up to row order (it merges the
    per-chunk join outputs before the final compaction)."""
    return concat(rels)


def broadcast_along(grid: Grid, rel: Relation, grid_axis: int,
                    local_capacity: int | None = None):
    """Replicate a per-device relation along a grid axis (the 1,3J
    "row/column replication" of R and T): each device ends with the
    concatenation of all shards along that axis, so the per-device
    tuple count multiplies by shape[grid_axis] — the k·|rel|
    communication the paper charges.  Optionally compacts the result to
    ``local_capacity``."""
    gathered = _inject("shuffle", grid.all_gather(rel, grid_axis))
    out = flatten_leading(gathered)
    if local_capacity is not None:
        return compact_to(grid, out, local_capacity)
    return out, torch.zeros(rel.valid.shape[:grid.lead], dtype=torch.bool,
                            device=rel.device)
