"""Static-shape columnar relations on torch tensors.

A Relation is a fixed-capacity struct-of-tensors with a validity mask:
every operator keeps buffer sizes static and raises an ``overflow``
flag instead of growing them.  The capacity is the **trailing** axis;
any leading axes are batch axes — on a :class:`~repro_torch.core.
shuffle.SimGrid` they are the grid axes, so one tensor op runs the
operator on every simulated device at once (the JAX package vmaps a
per-device function instead).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Relation:
    """Fixed-capacity columnar relation with a validity mask.

    Attributes:
      cols:  name -> (..., capacity) tensor.  All columns share the shape.
      valid: (..., capacity) bool mask; invalid rows are padding.
    """

    cols: Dict[str, torch.Tensor]
    valid: torch.Tensor

    # -- construction ----------------------------------------------------
    @classmethod
    def from_arrays(cls, capacity: int | None = None, **cols) -> "Relation":
        """Build from equal-length 1-D tensors, zero-padding to
        ``capacity``.  The columns' device is the relation's."""
        arrs = {k: torch.as_tensor(v) for k, v in cols.items()}
        n = next(iter(arrs.values())).shape[0]
        for k, v in arrs.items():
            if v.shape[0] != n:
                raise ValueError(f"column {k!r} length {v.shape[0]} != {n}")
        cap = capacity if capacity is not None else n
        if cap < n:
            raise ValueError(f"capacity {cap} < data length {n}")
        pad = cap - n
        padded = {k: torch.cat([v, v.new_zeros(pad)]) if pad else v
                  for k, v in arrs.items()}
        device = next(iter(arrs.values())).device
        valid = torch.arange(cap, device=device) < n
        return cls(cols=padded, valid=valid)

    @classmethod
    def empty(cls, capacity: int, schema: Mapping[str, torch.dtype],
              device) -> "Relation":
        cols = {k: torch.zeros(capacity, dtype=dt, device=device)
                for k, dt in schema.items()}
        return cls(cols=cols, valid=torch.zeros(capacity, dtype=torch.bool,
                                                device=device))

    # -- accessors ---------------------------------------------------------
    @property
    def capacity(self) -> int:
        return int(self.valid.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.valid.device

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.cols))

    def count(self) -> torch.Tensor:
        """Number of valid tuples per leading index (a device tensor)."""
        return self.valid.sum(-1)

    def col(self, name: str) -> torch.Tensor:
        return self.cols[name]

    # -- transforms --------------------------------------------------------
    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Relation":
        """Apply one tensor function to every column and the mask."""
        return Relation({n: fn(c) for n, c in self.cols.items()},
                        fn(self.valid))

    def select(self, names: Iterable[str]) -> "Relation":
        names = tuple(names)
        return Relation({n: self.cols[n] for n in names}, self.valid)

    def rename(self, mapping: Mapping[str, str]) -> "Relation":
        return Relation(
            {mapping.get(n, n): c for n, c in self.cols.items()}, self.valid)

    def filter(self, mask: torch.Tensor) -> "Relation":
        return Relation(dict(self.cols), self.valid & mask)

    def gather(self, idx: torch.Tensor, valid: torch.Tensor) -> "Relation":
        """Gather rows by (int64) index along the capacity axis; rows with
        valid=False become zero padding."""
        safe = torch.where(valid, idx, 0)
        cols = {n: torch.where(valid, c.gather(-1, safe), 0)
                for n, c in self.cols.items()}
        return Relation(cols, valid & self.valid.gather(-1, safe))

    def compact(self, capacity: int | None = None) -> "Relation":
        """Move valid rows to the front (stable); optionally resize.  Rows
        past the valid count, and valid rows past ``capacity``, become
        zero padding — the reference's stable-argsort gather, computed
        as one prefix count and one scatter."""
        cap_out = capacity if capacity is not None else self.capacity
        pos = torch.cumsum(self.valid, -1) - 1
        dest = torch.where(self.valid & (pos < cap_out), pos, cap_out)
        cols = {n: scatter_drop(c, dest, cap_out)
                for n, c in self.cols.items()}
        n = self.count().unsqueeze(-1)
        valid = torch.arange(cap_out, device=self.device) < n
        return Relation(cols, valid)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Host-side dict of the *valid* rows (test/debug helper)."""
        valid = self.valid.cpu().numpy()
        return {n: c.cpu().numpy()[valid] for n, c in self.cols.items()}

    def to_tuple_set(self, names: Iterable[str] | None = None) -> set:
        """Set of valid tuples (test/debug helper)."""
        names = tuple(names) if names is not None else self.names
        data = self.to_numpy()
        return set(zip(*[data[n].tolist() for n in names])) \
            if data[names[0]].size else set()


def scatter_drop(src: torch.Tensor, dest: torch.Tensor,
                 size: int) -> torch.Tensor:
    """``zeros(..., size).at[dest].set(src, mode="drop")`` along the
    trailing axis: entries whose ``dest`` is ``size`` (or more) are
    dropped.  The leading axes fold into one flat buffer with a single
    sink slot at its end, so the result is a contiguous view and never
    a sliced copy.  Callers only send equal values to one slot, so the
    unordered scatter is deterministic."""
    lead = src.shape[:-1]
    batch = int(np.prod(lead, dtype=np.int64))
    base = torch.arange(batch, device=src.device).view(*lead, 1) * size
    flat = torch.where(dest < size, dest + base, batch * size)
    out = src.new_zeros(batch * size + 1)
    out.scatter_(0, flat.reshape(-1), src.reshape(-1))
    return out[:batch * size].view(*lead, size)


def concat(rels: Iterable[Relation]) -> Relation:
    """Concatenate relations along the capacity axis."""
    rels = list(rels)
    names = rels[0].names
    cols = {n: torch.cat([r.cols[n] for r in rels], -1) for n in names}
    return Relation(cols, torch.cat([r.valid for r in rels], -1))


def flatten_leading(rel: Relation) -> Relation:
    """Collapse the two axes in front of the capacity axis:
    ``(..., K, cap) -> (..., K·cap)`` — a device's (K, cap) bucketed
    receive buffers into one flat shard."""
    return rel.map(lambda c: c.reshape(*c.shape[:-2], -1))
