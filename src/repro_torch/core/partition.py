"""Partitioning manifests and the co-partitioning proof — the host-side
half of the map-side-join storage layout.

Port of ``src/repro/core/partition.py`` for this slice: the
:class:`PartitionSpec` manifest of a stored relation (hash-partitioned
into ``num_partitions`` slices by ``bucket_hash(key, P, salt)``, each
slice sorted by (validity, key)), :func:`co_partitioned` (two specs
prove a zero-shuffle merge join), :func:`chain_partitioning` (a chain
query's specs compiled into the
:class:`~repro_torch.core.cost_model.ChainPartitioning` certificate the
planner prices) and :func:`default_part_capacity`.  The plan verifier
and the query engine need these; none touches a tensor.

The device half — ``PartitionedRelation``, ``partition_relation``,
``repartition`` and ``verify_partition_layout`` — waits for the
partitioned store and the map-side cascade (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from .cost_model import ChainPartitioning

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
