"""Hash-partitioned, key-sorted relations — the map-side-join storage
layout.

Port of ``src/repro/core/partition.py``.  A :class:`PartitionedRelation`
holds a relation bucketed into ``num_partitions`` slices by
``bucket_hash(key, num_partitions, salt)``, every slice sorted by
(validity, key).  When two relations are *co-partitioned* (same key
role, partition count, salt and key dtype, both sorted), partition p of
one joins only partition p of the other: the join needs no shuffle, and
the per-partition merge join skips the stored side's sort
(``presorted_r``).  On a 1-D ``SimGrid`` of ``num_partitions`` devices
the ``(P, part_capacity)`` columns *are* the per-device placement.

The proof side: :class:`PartitionSpec` (the manifest of one stored
relation), :func:`co_partitioned` (two specs prove a zero-shuffle merge
join) and :func:`chain_partitioning` (a chain query's specs compiled
into the :class:`~repro_torch.core.cost_model.ChainPartitioning`
certificate the planner prices and the executor trusts).  Persistence
is ``repro_torch.checkpoint.save_partitioned`` / ``load_partitioned``,
byte-compatible with the JAX package's store.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from . import hashing
from .cost_model import ChainPartitioning
from .local import partition, sort_rows
from .relation import Relation, flatten_leading

#: Identifier of the hash family behind every PartitionSpec — recorded
#: in persisted manifests so a future hash change cannot silently break
#: the co-partitioning proof against old data.
PARTITION_FN = "salted-fibonacci-mul32"

#: The only sort order the presorted fast path understands.
SORT_ASCENDING = "ascending"


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """The partitioning manifest of one stored relation.

    key:            the attribute the relation is hash-partitioned and
                    per-partition sorted on.
    num_partitions: bucket count P of the partition hash.
    salt:           salt of ``bucket_hash`` — two relations
                    co-partition only under the *same* salt.
    sort_order:     per-partition row order; only ``"ascending"``
                    (valid rows first, ascending key) qualifies for the
                    presorted merge path.
    key_dtype:      dtype name of the key column the partitioning was
                    computed over (``"int32"``/``"int64"``).  The
                    partition hash folds 64-bit keys before bucketing,
                    so a spec minted under one x64 configuration proves
                    nothing under the other; ``None`` (legacy manifests)
                    is a wildcard for backward compatibility.
    """

    key: str
    num_partitions: int
    salt: int = 0
    sort_order: str = SORT_ASCENDING
    key_dtype: Optional[str] = None

    def __post_init__(self):
        if self.num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got "
                             f"{self.num_partitions}")

    @property
    def sorted(self) -> bool:
        return self.sort_order == SORT_ASCENDING


@dataclasses.dataclass
class PartitionedRelation:
    """A relation laid out as (..., num_partitions, part_capacity)
    columns plus its :class:`PartitionSpec`.  On a 1-D grid of
    ``num_partitions`` devices, ``parts`` *is* the per-device placement
    — feeding it to the executor costs zero shuffle.  Axes ahead of the
    partition axis are lanes (the query engine's batched tenants)."""

    parts: Relation
    spec: PartitionSpec

    @property
    def num_partitions(self) -> int:
        return int(self.parts.valid.shape[-2])

    @property
    def part_capacity(self) -> int:
        return int(self.parts.valid.shape[-1])

    @property
    def device(self) -> torch.device:
        return self.parts.device

    def count(self) -> torch.Tensor:
        """Valid tuples over every partition (a device tensor; one per
        lane)."""
        return self.parts.valid.sum((-2, -1))

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "PartitionedRelation":
        """Apply one tensor function to every column and the mask (a
        device move: ``prel.map(lambda t: t.to(device))``); the spec is
        kept."""
        return PartitionedRelation(self.parts.map(fn), self.spec)

    def to_flat(self) -> Relation:
        """Collapse back to one flat relation (partition order)."""
        return flatten_leading(self.parts)


def _dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype in the JAX package's spelling (``"int32"``), so
    specs compare equal across the two packages."""
    return str(dtype).replace("torch.", "")


def partition_relation(rel: Relation, key: str, num_partitions: int, *,
                       salt: int = 0, part_capacity: Optional[int] = None,
                       ) -> Tuple[PartitionedRelation, torch.Tensor]:
    """Partition a flat relation by ``bucket_hash(key, P, salt)`` and
    sort every partition by (validity, key) — the write path of the
    partitioned store.

    ``part_capacity`` defaults to the input capacity (lossless for any
    key distribution); tighter capacities return overflow=True when a
    bucket spills.  Leading axes of ``rel`` are kept ahead of the
    partition axis.  Returns (partitioned relation, overflow flag)."""
    cap = rel.capacity if part_capacity is None else part_capacity
    bucket = hashing.bucket_hash(rel.col(key), num_partitions, salt=salt)
    parts, overflow = partition(rel, bucket, num_partitions, cap)
    spec = PartitionSpec(key=key, num_partitions=num_partitions, salt=salt,
                         key_dtype=_dtype_name(rel.col(key).dtype))
    return PartitionedRelation(sort_rows(parts, key), spec), overflow


def repartition(prel: PartitionedRelation, *, salt: int,
                key: Optional[str] = None,
                num_partitions: Optional[int] = None,
                part_capacity: Optional[int] = None,
                ) -> Tuple[PartitionedRelation, torch.Tensor]:
    """Re-bucket a stored relation under a new salt (and optionally a
    new key or partition count).

    Streaming ingest rotates the salt on every committed micro-batch: a
    certificate minted against the previous version then fails the
    :func:`co_partitioned` proof (salts differ), so a cached plan can
    never merge-join fresh partitions with a stale layout.

    ``part_capacity`` defaults to the current per-partition capacity
    when the partition count is unchanged, else to the lossless flat
    capacity.  Returns (repartitioned relation, overflow flag)."""
    P = prel.num_partitions if num_partitions is None else num_partitions
    key = prel.spec.key if key is None else key
    flat = prel.to_flat()
    if part_capacity is None:
        part_capacity = (prel.part_capacity if P == prel.num_partitions
                         else flat.capacity)
    return partition_relation(flat, key, P, salt=salt,
                              part_capacity=part_capacity)


def verify_partition_layout(prel: PartitionedRelation) -> bool:
    """Recheck the layout invariant a :class:`PartitionedRelation`'s
    spec asserts: every valid row lives in the partition its key hashes
    to, and (for ``sorted`` specs) every partition holds its valid rows
    first, keys ascending.

    The store already CRC-verifies bytes on read; this is the semantic
    audit above it — bytes can round-trip perfectly and still describe
    a layout the spec no longer proves (wrong salt, foreign manifest, a
    partial rewrite).  It is host-synchronous by design (it returns a
    Python bool): a recovery-path check, called on loaded data and
    never inside a function that ``jit_execute_*`` captures."""
    spec = prel.spec
    key = prel.parts.cols[spec.key]
    valid = prel.parts.valid
    bucket = hashing.bucket_hash(key, spec.num_partitions, salt=spec.salt)
    rows = torch.arange(valid.shape[-2], dtype=bucket.dtype,
                        device=valid.device)[:, None]
    ok = torch.where(valid, bucket == rows, True).all()
    if spec.sorted and valid.shape[-1] > 1:
        pair = valid[..., 1:] & valid[..., :-1]
        ok = ok & (valid[..., 1:] <= valid[..., :-1]).all()
        ok = ok & torch.where(pair, key[..., :-1] <= key[..., 1:],
                              True).all()
    return bool(ok)


def default_part_capacity(n_rows: int, num_partitions: int,
                          slack: float = 3.0) -> int:
    """Per-partition capacity for ``partition_relation``: the expected
    share ``n_rows / P`` times a skew-slack factor, plus a small pad for
    tiny relations.  Salted Fibonacci hashing spreads uniform and
    mildly-skewed keys evenly, so modest slack suffices; a spill is
    reported through the overflow flag, never silently dropped."""
    return int(n_rows * slack / num_partitions) + 64


def co_partitioned(spec_a: Optional[PartitionSpec],
                   spec_b: Optional[PartitionSpec],
                   key_a: Optional[str] = None,
                   key_b: Optional[str] = None) -> bool:
    """Prove that two stored relations can merge-join with zero shuffle.

    True iff both specs exist, each is partitioned on the join key its
    side contributes (``key_a``/``key_b`` default to the spec's own
    key), the bucket counts and salts match (same hash ⇒ same key lands
    in the same partition index on both sides), the recorded key dtypes
    agree (the hash folds 64-bit keys, so mixed widths bucket
    differently; a ``None`` legacy dtype is a wildcard), and both are
    sorted (the merge path consumes sorted runs).  Anything unprovable
    returns False — the planner then prices a shuffle or broadcast
    instead; False never affects correctness, only cost.
    """
    if spec_a is None or spec_b is None:
        return False
    if key_a is not None and spec_a.key != key_a:
        return False
    if key_b is not None and spec_b.key != key_b:
        return False
    if (spec_a.key_dtype is not None and spec_b.key_dtype is not None
            and spec_a.key_dtype != spec_b.key_dtype):
        return False
    return (spec_a.num_partitions == spec_b.num_partitions
            and spec_a.salt == spec_b.salt
            and spec_a.sorted and spec_b.sorted)


def chain_partitioning(query, specs: Sequence[Optional[PartitionSpec]],
                       ) -> Optional[ChainPartitioning]:
    """Compile a chain query's per-relation :class:`PartitionSpec`\\ s
    into the planner's :class:`ChainPartitioning` certificate.

    Hop j (1-based) of the cascade joins the running intermediate with
    relation j on ``query.attrs[j]``; the hop can run map-side iff
    relation j is stored partitioned+sorted on exactly that attribute
    under the canonical (num_partitions, salt) — taken from the first
    provable spec; specs with other hash parameters stay unproven (they
    would need a repartition anyway).  ``left0_proven`` records whether
    relation 0 is pre-partitioned on the *first* join attribute
    (``attrs[1]``), which makes hop 1 fully shuffle-free.

    Returns None when no spec proves anything — the planner then never
    considers the map-side candidate.
    """
    n = query.n_relations
    if len(specs) != n:
        raise ValueError(f"query has {n} relations, got {len(specs)} specs")
    expected = [query.attrs[1]] + [query.attrs[j] for j in range(1, n)]
    canonical: Optional[Tuple[int, int, Optional[str]]] = None
    for j, spec in enumerate(specs):
        if spec is not None and spec.sorted and spec.key == expected[j]:
            canonical = (spec.num_partitions, spec.salt, spec.key_dtype)
            break
    if canonical is None:
        return None
    P, salt, key_dtype = canonical

    def proven(j: int) -> bool:
        spec = specs[j]
        return (spec is not None and spec.sorted
                and spec.key == expected[j]
                and spec.num_partitions == P and spec.salt == salt
                and (spec.key_dtype is None or key_dtype is None
                     or spec.key_dtype == key_dtype))

    return ChainPartitioning(
        num_partitions=P, salt=salt,
        right_proven=tuple(proven(j) for j in range(1, n)),
        left0_proven=proven(0),
        key_dtype=key_dtype)
