"""Carrying state across packages: relations, plans and LM weights as
numpy.

The join engine's state is relations and plans.  A relation crosses
between the JAX package and this one as a dict of numpy columns plus
the validity mask (``np.asarray`` on each field of the JAX
``Relation``), grid axes included; a capacity budget crosses as its
dataclass fields.  A stored relation crosses as its partitions'
columns, ``(P, part_capacity)``, plus its spec's fields — or on disk:
the two packages' partitioned stores share one format
(``repro_torch.checkpoint``).

A language model's parameters cross as their tree (nested dicts,
stacked layers on the leading axis) of numpy arrays, bit for bit
(:func:`params_from_numpy`, :func:`params_to_numpy`), and an
optimizer's state as its ``(step, inner)`` fields
(:func:`opt_state_from_numpy`, :func:`opt_state_to_numpy`), so both
packages start a train step from the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .core.executor import ChainCaps
from .core.partition import PartitionedRelation, PartitionSpec
from .core.relation import Relation
from .models.params import tree_map
from .optim import OptState


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


def params_from_numpy(tree, device, dtype=None):
    """The port's tensors for a tree of numpy arrays (the JAX package's
    parameters through ``np.asarray``), on ``device``, bit for bit, then
    cast to ``dtype`` if one is given.  numpy has no bfloat16: JAX's
    bfloat16 leaves arrive as ``ml_dtypes.bfloat16``, which
    ``torch.from_numpy`` refuses, so they cross as their uint16 bits."""
    def one(a):
        a = np.ascontiguousarray(a)
        if not a.flags.writeable:       # JAX's arrays through np.asarray
            a = a.copy()
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        t = t.to(device)
        return t if dtype is None else t.to(dtype)
    return tree_map(one, tree)


def params_to_numpy(tree):
    """The inverse of :func:`params_from_numpy`: host numpy arrays, a
    bfloat16 tensor as ``ml_dtypes.bfloat16`` (the dtype JAX gives its
    bfloat16 arrays), bit for bit."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return tree_map(one, tree)


def opt_state_from_numpy(state, device) -> OptState:
    """The port's :class:`~repro_torch.optim.OptState` from an object
    with ``step`` and ``inner`` fields holding numpy arrays (the JAX
    package's ``OptState`` through ``np.asarray``), on ``device``, bit
    for bit: ``step`` an int32 0-d tensor, ``inner`` as
    :func:`params_from_numpy` carries a tree."""
    step = torch.as_tensor(np.array(state.step, dtype=np.int32),
                           device=device)
    return OptState(step, params_from_numpy(state.inner, device))


def opt_state_to_numpy(state: OptState) -> OptState:
    """The inverse of :func:`opt_state_from_numpy`: an ``OptState`` of
    host numpy arrays (build the JAX package's from its two fields).
    Copies, never views of a CPU tensor: an optimizer's update writes
    its state's tensors in place."""
    return OptState(np.array(state.step.detach().cpu().numpy()),
                    tree_map(np.array, params_to_numpy(state.inner)))
