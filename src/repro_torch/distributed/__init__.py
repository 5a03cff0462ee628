"""Meshes of ranks on ``torch.distributed`` and the launcher that starts
them — the port of ``src/repro/distributed/mesh.py`` — and the language
models' logical-axis planner (``sharding.py``: the rules and
``Planner.spec``; its tensor-parallel half is ROADMAP A15f).  The
reducer grid over a mesh is :class:`repro_torch.core.ShardGrid`.
Meshes are on the card unless made with ``device="cpu"``.
``compression.py``: int8 error-feedback gradient compression (the
train step's ``grad_compression``)."""

from .compression import dequantize, ef_compress, ef_init, quantize
from .mesh import (Mesh, Ranks, current_device, emulated_host_mesh,
                   make_mesh, set_device, single_device_mesh, spawn, start)
from .sharding import DEFAULT_RULES, Planner, rules_for_config

__all__ = ["DEFAULT_RULES", "Mesh", "Planner", "Ranks", "current_device",
           "dequantize", "ef_compress", "ef_init", "emulated_host_mesh",
           "make_mesh", "quantize", "rules_for_config", "set_device",
           "single_device_mesh", "spawn", "start"]
