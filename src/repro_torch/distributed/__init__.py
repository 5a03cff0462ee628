"""Meshes of ranks on ``torch.distributed`` and the launcher that starts
them — the port of ``src/repro/distributed/mesh.py``.  The reducer grid
over a mesh is :class:`repro_torch.core.ShardGrid`.  (The JAX package's
``sharding`` and ``compression`` modules serve its language models and
are not ported here.)"""

from .mesh import (Mesh, Ranks, current_device, emulated_host_mesh,
                   make_mesh, set_device, single_device_mesh, spawn, start)

__all__ = ["Mesh", "Ranks", "current_device", "emulated_host_mesh",
           "make_mesh", "set_device", "single_device_mesh", "spawn",
           "start"]
