"""Meshes of ranks on ``torch.distributed`` and the launcher that starts
them — the port of ``src/repro/distributed/mesh.py`` — and the language
models' logical-axis planner (``sharding.py``: the rules and
``Planner.spec``; its tensor-parallel half is ROADMAP A15f).  The
reducer grid over a mesh is :class:`repro_torch.core.ShardGrid`.
Meshes are on the card unless made with ``device="cpu"``.
(``compression.py`` is ROADMAP A15f.)"""

from .mesh import (Mesh, Ranks, current_device, emulated_host_mesh,
                   make_mesh, set_device, single_device_mesh, spawn, start)
from .sharding import DEFAULT_RULES, Planner, rules_for_config

__all__ = ["DEFAULT_RULES", "Mesh", "Planner", "Ranks", "current_device",
           "emulated_host_mesh", "make_mesh", "rules_for_config",
           "set_device", "single_device_mesh", "spawn", "start"]
