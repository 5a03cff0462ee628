"""Optimizers as transforms of tensor trees.

Port of ``src/repro/optim/optimizers.py``.  Interface:
``init(params) -> OptState`` and
``update(grads, state, params) -> (new_params, new_state)``: the
parameter application is fused into the update, as in the reference.

Unlike the reference's pure functions, ``update`` runs under
``torch.no_grad()`` and writes the new parameters and moments into the
tensors it is given (``params`` and ``state.inner``), which it returns:
at granite-3-2b's full width a second copy of the AdamW moments alone
would be 21 GB.  ``state.step`` is a new int32 device tensor; the update
reads nothing back to the host.

Like the reference, a leaf with ``ndim >= 3`` and a leading axis of at
most 512 (a stack of layers) is updated one leading slice at a time:
the float32 temporaries then cover one layer, and Adafactor's RMS clip
is per slice, the reference's ``lax.map`` semantics.  Leaves are walked
in the reference's flatten order (dict keys sorted).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..models.params import (ParamDef, axes_of, sorted_leaves, tree_map,
                             tree_map2)


class OptState(NamedTuple):
    step: torch.Tensor
    inner: Any


def _per_leaf(params, *trees) -> list:
    """``[(p, t1, t2, ...)]`` per parameter leaf: ``trees`` flattened up to
    the structure of ``params`` (a subtree per leaf, e.g. Adafactor's
    ``{"vr", "vc"}``)."""
    def walk(p, ts):
        if isinstance(p, dict):
            return [x for k in sorted(p)
                    for x in walk(p[k], [t[k] for t in ts])]
        if isinstance(p, (tuple, list)):
            return [x for i, v in enumerate(p)
                    for x in walk(v, [t[i] for t in ts])]
        return [(p, *ts)]
    return walk(params, list(trees))


def _streamed(p: torch.Tensor) -> bool:
    """The reference's rule: stream a big stacked tensor slice by slice."""
    return p.dim() >= 3 and p.shape[0] <= 512


def _slices(p: torch.Tensor, *trees):
    """``(p[i], tree[i]...)`` per leading slice of a streamed leaf, or the
    whole leaf once."""
    if not _streamed(p):
        yield (p, *trees)
        return
    for i in range(p.shape[0]):
        yield (p[i], *(tree_map(lambda t: t[i], t) for t in trees))


def _lr_fn(lr):
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def _step0(params) -> torch.Tensor:
    leaves = sorted_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def clip_by_global_norm(grads, max_norm: float, inplace: bool = False):
    """``(grads scaled to a global norm <= max_norm, the global norm)``.
    The norm is a float32 device tensor.  ``inplace`` scales the given
    tensors (a train step's own gradients) instead of new ones."""
    leaves = sorted_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    if inplace:
        with torch.no_grad():
            for g in leaves:
                g.copy_(g.float() * scale)
        return grads, gn
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def apply_updates(params, updates):
    """``params + updates`` leaf by leaf, in float32, cast back (new
    tensors); streamed over the leading slices of big stacked tensors."""
    def one(p, u):
        if not _streamed(p):
            return (p.float() + u).to(p.dtype)
        return torch.stack([(p[i].float() + u[i]).to(p.dtype)
                            for i in range(p.shape[0])])
    return tree_map2(one, params, updates)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: Callable[[torch.Tensor], torch.Tensor] | float,
          b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(step=_step0(params),
                        inner={"m": tree_map(zeros, params),
                               "v": tree_map(zeros, params)})

    @torch.no_grad()
    def update(grads, state: OptState, params):
        step = state.step + 1
        lr_t = lr_fn(step)
        t = step.to(torch.float32)
        b1c = 1.0 - b1 ** t
        b2c = 1.0 - b2 ** t

        def one(g, m, v, p):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            mh = m / b1c
            vh = v / b2c
            u = -lr_t * (mh / (torch.sqrt(vh) + eps)
                         + weight_decay * p.float())
            p.copy_(p.float() + u)

        for p, g, m, v in _per_leaf(params, grads, state.inner["m"],
                                    state.inner["v"]):
            for ps, gs, ms, vs in _slices(p, g, m, v):
                one(gs, ms, vs, ps)
        return params, OptState(step, state.inner)

    def state_axes(param_axes):
        """Logical axes for each state leaf (mirrors the param's)."""
        return {"m": param_axes, "v": param_axes}

    return init, update, state_axes


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018), factored second moment
# ---------------------------------------------------------------------------

def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def adafactor(lr: Callable[[torch.Tensor], torch.Tensor] | float,
              decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0):
    lr_fn = _lr_fn(lr)

    def init(params):
        def one(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32,
                                          device=p.device)
            if _factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return OptState(step=_step0(params), inner=tree_map(one, params))

    @torch.no_grad()
    def update(grads, state: OptState, params):
        step = state.step + 1
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(step)

        def one(g, s, p):
            g = g.float()
            g2 = torch.square(g) + eps
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                vr.mul_(beta).add_((1 - beta) * g2.mean(-1))
                vc.mul_(beta).add_((1 - beta) * g2.mean(-2))
                rfac = torch.rsqrt(
                    vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps))
                cfac = torch.rsqrt(vc)
                u = g * rfac[..., None] * cfac[..., None, :]
            else:
                v = s["v"]
                v.mul_(beta).add_((1 - beta) * g2)
                u = g * torch.rsqrt(v)
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            u = -lr_t * (u + weight_decay * p.float())
            p.copy_(p.float() + u)

        for p, g, s in _per_leaf(params, grads, state.inner):
            for ps, gs, ss in _slices(p, g, s):
                one(gs, ss, ps)
        return params, OptState(step, state.inner)

    def state_axes(param_axes):
        # vr drops the last dim's axis; vc drops the second-to-last.
        return None  # resolved from the shapes (state_logical_axes)

    return init, update, state_axes


def make_optimizer(name: str, lr, **kw):
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


def state_logical_axes(name: str, defs):
    """Logical sharding axes for an optimizer state tree, derived from the
    model's ParamDef tree (states inherit their parameter's axes; the
    factored Adafactor moments drop the reduced dim's axis)."""
    if name == "adamw":
        ax = axes_of(defs)
        return {"m": ax, "v": ax}
    if name == "adafactor":
        def one(d: ParamDef):
            if _factored(d.shape):
                return {"vr": d.axes[:-1], "vc": d.axes[:-2] + d.axes[-1:]}
            return {"v": d.axes}
        return tree_map(one, defs)
    raise ValueError(f"unknown optimizer {name!r}")
