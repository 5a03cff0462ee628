"""Divisibility-aware logical-axis sharding planner (t5x-style rules).

Port of ``src/repro/distributed/sharding.py``.  Model code never names
mesh axes directly.  Every parameter and activation carries LOGICAL
axis names ("vocab", "ff", "heads", ...); the planner maps logical →
mesh axes, checking divisibility against the actual dimension size and
falling back per the rule list, so that one fixed production mesh
(16 "data" × 16 "model", + "pod") hosts whisper's 12 heads, grok's 8
experts and odd vocab sizes without per-arch hand sharding.

:meth:`Planner.spec` makes the reference's choices and returns them as
a plain tuple (the reference's ``PartitionSpec``), over the port's
:class:`~repro_torch.distributed.mesh.Mesh` ``.shape``.  The port runs
its language models on one device: :meth:`Planner.constrain` is the
identity on a null planner and on a mesh whose chosen axes are all of
size 1, and raises otherwise.  The tensor-parallel half — the
reference's ``sharding`` / ``tree_specs`` (placing each weight by its
spec) and a ``constrain`` that moves activations — waits for the
tensor-parallel slice (ROADMAP A15f).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

MeshAxes = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[MeshAxes], ...]

# Rule list: logical axis -> candidate mesh axes, tried in order.  The
# first candidate whose size divides the dimension wins.
DEFAULT_RULES: Dict[str, Sequence[MeshAxes]] = {
    # weights
    "vocab": ("model",),
    "ff": ("model",),
    "heads": ("model",),
    "kv_features": ("model",),       # fused (n_kv·head_dim) — always 128-mult
    "q_features": ("model",),
    "experts": ("model",),
    "expert_ff": ("model",),         # fallback target when experts don't divide
    "embed": (),                     # d_model of weights: replicated
    "embed_zero1": ("data",),        # optimizer-state extra slicing (ZeRO-1)
    # activations
    "batch": (("pod", "data"), "data"),
    "seq": ("data",),                # sequence parallelism for batch=1 decode
    "act_embed": (),
    "act_seq": ("model",),
    "act_heads": ("model",),
    "kv_heads": ("model",),
    "act_ff": ("model",),
    "act_vocab": ("model",),
    "act_experts": ("model",),
    "capacity": (),
    # ssm
    "ssm_heads": ("model",),
    "ssm_state": (),
    "conv_width": (),
}


def _axes_size(mesh_shape: Dict[str, int], axes: MeshAxes) -> int:
    if isinstance(axes, str):
        return mesh_shape.get(axes, 1)
    return math.prod(mesh_shape.get(a, 1) for a in axes)


def _present(mesh_shape: Dict[str, int], axes: MeshAxes) -> bool:
    if isinstance(axes, str):
        return axes in mesh_shape
    return all(a in mesh_shape for a in axes)


@dataclasses.dataclass
class Planner:
    """Maps logical axes to a mesh (anything with a ``shape`` dict of
    axis name -> size, as the port's ``Mesh``).  ``Planner.null()`` on
    one device."""

    mesh: Optional[Any]
    rules: Dict[str, Sequence[MeshAxes]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))

    @classmethod
    def null(cls) -> "Planner":
        return cls(mesh=None)

    @property
    def mesh_shape(self) -> Dict[str, int]:
        if self.mesh is None:
            return {}
        return dict(self.mesh.shape)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
        """The mesh axes of each dimension (``None``: replicated), trailing
        ``None`` dropped — the reference's ``PartitionSpec`` as a tuple."""
        if self.mesh is None:
            return ()
        if len(logical_axes) != len(shape):
            raise ValueError(f"logical axes {tuple(logical_axes)} vs shape "
                             f"{tuple(shape)}")
        mesh_shape = self.mesh_shape
        used: set = set()
        out = []
        for ax, dim in zip(logical_axes, shape):
            chosen = None
            for cand in self.rules.get(ax or "", ()):
                if not _present(mesh_shape, cand):
                    continue
                flat = (cand,) if isinstance(cand, str) else tuple(cand)
                if used & set(flat):
                    continue  # a mesh axis may shard only one dim
                if dim % _axes_size(mesh_shape, cand) == 0:
                    chosen = cand
                    used.update(flat)
                    break
            out.append(chosen)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def constrain(self, x, logical_axes: Sequence[Optional[str]]):
        """``x`` itself where its spec shards nothing (a null planner, or
        mesh axes of size 1); placing an activation across devices is
        the tensor-parallel slice's (ROADMAP A15f)."""
        if self.mesh is None:
            return x
        spec = self.spec(logical_axes, tuple(x.shape))
        if any(a is not None and _axes_size(self.mesh_shape, a) > 1
               for a in spec):
            raise NotImplementedError(
                f"constrain to {spec} on mesh {self.mesh_shape}: the port's "
                f"models run on one device; tensor parallelism is ROADMAP "
                f"A15f")
        return x


def rules_for_config(cfg) -> Dict[str, Sequence[MeshAxes]]:
    """Per-arch rule overrides.  cfg.fsdp=True additionally shards the
    weights' d_model ("embed") dim over the data axes — ZeRO-3/FSDP-style
    2-D weight sharding, for the 100B–1T tier."""
    rules = dict(DEFAULT_RULES)
    if getattr(cfg, "fsdp", False):
        rules["embed"] = (("pod", "data"), "data")
    return rules
