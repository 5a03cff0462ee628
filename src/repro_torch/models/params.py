"""Parameter definition system: shapes + logical sharding axes together.

Port of ``src/repro/models/params.py``.  A model builds a tree (nested
dicts and tuples) of :class:`ParamDef`; :func:`init_params` materializes
tensors, :func:`axes_of` extracts the logical-axes tree consumed by the
sharding planner (``distributed/sharding.py``).  Layer stacks are
stacked along a leading "layers" axis, which the forward pass walks in
a Python loop over views (the reference's ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"             # normal | zeros | ones
    scale: float = 1.0
    dtype: Optional[str] = None      # None -> the model dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")

    def resolve_dtype(self, default: torch.dtype) -> torch.dtype:
        return getattr(torch, self.dtype) if self.dtype else default


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of nested dicts, tuples and lists (a
    ``ParamDef`` or a tensor is a leaf); the structure is kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_map2(fn: Callable, a, b):
    """``fn(a_leaf, b_leaf)`` over two trees of ``a``'s structure."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, a[k], b[k]) for k in a}
    if isinstance(a, (tuple, list)):
        return type(a)(tree_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def sorted_leaves(tree) -> list:
    """The leaves in ``jax.tree.flatten``'s order: dict keys sorted,
    tuples, lists and named tuples in order; ``None`` holds no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def _device(device) -> torch.device:
    """The device of an entry point: the card unless the caller names
    another."""
    return torch.device("cuda" if device is None else device)


def init_params(defs, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device=None):
    """Tensors for a ParamDef tree: zeros, ones, or normal draws scaled by
    ``scale · fan_in^-1/2`` (fan_in = the second-to-last dim, or the
    only one), drawn in float32 from ``generator`` and cast, as the
    reference draws them.  On the card unless ``device`` says otherwise;
    the draws are made on the generator's device."""
    device = _device(device)

    def make(d: ParamDef):
        dt = d.resolve_dtype(dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale * (fan_in ** -0.5)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(std).to(device=device, dtype=dt)

    return tree_map(make, defs)


def zeros_of(defs, dtype: torch.dtype = torch.bfloat16, device=None):
    """Zero tensors matching a ParamDef tree (cache/state allocation)."""
    device = _device(device)
    return tree_map(lambda d: torch.zeros(
        d.shape, dtype=d.resolve_dtype(dtype), device=device), defs)


def abstract_params(defs, dtype: torch.dtype = torch.bfloat16):
    """Tensors on the ``meta`` device: shapes and dtypes, no storage."""
    return tree_map(lambda d: torch.empty(
        d.shape, dtype=d.resolve_dtype(dtype), device="meta"), defs)


def axes_of(defs):
    """Tree of logical-axes tuples, aligned with the param tree."""
    return tree_map(lambda d: d.axes, defs)


def stack_layers(n: int, layer_defs):
    """Prepend a 'layers' axis to every ParamDef (for the layer loop)."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, ("layers",) + d.axes, d.init,
                           d.scale),
        layer_defs)


def param_count(params) -> int:
    return sum(p.numel() for p in tree_leaves(params))
