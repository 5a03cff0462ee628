"""Carrying state across packages: relations and plans as numpy.

The system has no weights; its state is relations and plans.  A
relation crosses between the JAX package and this one as a dict of
numpy columns plus the validity mask (``np.asarray`` on each field of
the JAX ``Relation``), grid axes included; a capacity budget crosses as
its dataclass fields.  A stored relation crosses as its partitions'
columns, ``(P, part_capacity)``, plus its spec's fields — or on disk:
the two packages' partitioned stores share one format
(``repro_torch.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .core.executor import ChainCaps
from .core.partition import PartitionedRelation, PartitionSpec
from .core.relation import Relation


def relation_from_numpy(cols: Mapping[str, np.ndarray], valid: np.ndarray,
                        device) -> Relation:
    """A port Relation with the given columns and mask, leading axes
    kept, on ``device``."""
    return Relation(
        {n: torch.as_tensor(np.asarray(c), device=device)
         for n, c in cols.items()},
        torch.as_tensor(np.asarray(valid, dtype=bool), device=device))


def relation_to_numpy(rel: Relation) -> Tuple[Dict[str, np.ndarray],
                                              np.ndarray]:
    """``(cols, valid)`` as host numpy arrays, leading axes kept."""
    return ({n: c.cpu().numpy() for n, c in rel.cols.items()},
            rel.valid.cpu().numpy())


def caps_from_fields(**fields) -> ChainCaps:
    """A port ChainCaps from the fields of the JAX package's one (e.g.
    ``caps_from_fields(**dataclasses.asdict(jax_caps))``)."""
    return ChainCaps(**fields)


def partitioned_from_numpy(cols: Mapping[str, np.ndarray], valid: np.ndarray,
                           spec: Any, device) -> PartitionedRelation:
    """A port PartitionedRelation from ``(P, part_capacity)`` numpy
    columns and mask and a spec — a port :class:`PartitionSpec`, or any
    object with the same fields (the JAX package's), or their dict."""
    if not isinstance(spec, PartitionSpec):
        fields = spec if isinstance(spec, Mapping) else \
            dataclasses.asdict(spec)
        spec = PartitionSpec(**fields)
    return PartitionedRelation(relation_from_numpy(cols, valid, device),
                               spec)


def partitioned_to_numpy(prel: PartitionedRelation
                         ) -> Tuple[Dict[str, np.ndarray], np.ndarray,
                                    Dict[str, Any]]:
    """``(cols, valid, spec fields)`` of a stored relation, on the
    host."""
    cols, valid = relation_to_numpy(prel.parts)
    return cols, valid, dataclasses.asdict(prel.spec)
