"""Meshes of ranks and the launcher that starts them.

Port of ``src/repro/distributed/mesh.py`` onto ``torch.distributed``.
A :class:`Mesh` names axes over the first ranks of the initialised
default process group, row-major: rank ``r`` sits at
``np.unravel_index(r, shape)``, as the reference's mesh takes the first
devices; a rank past the mesh holds no coordinate.
Where the JAX package emulates devices in one process
(``configure_platform(host_devices=N)``), the port runs one process a
device: :func:`spawn` starts them, initialises the group and runs a
function on every rank.

Backends are explicit: ``gloo`` on the CPU; ``nccl`` when every rank
has its own card; ``gloo`` with CUDA tensors when several ranks share
one card (gloo stages each collective through the host itself: it has
a CUDA path for every collective the grid runs).

A mesh builds one subgroup per set of mesh axes that a grid axis
spans: the ranks that agree on every other coordinate, in row-major
order of the spanned axes.  ``dist.new_group`` is collective over the
whole default group, so :meth:`Mesh.group` (and a ``ShardGrid``, which
asks for its groups when it is built) must be called by every rank in
the same order, as SPMD code does.
"""

from __future__ import annotations

import atexit
import datetime
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

AxisSpec = Union[str, Tuple[str, ...]]

#: ``all_gather_into_tensor`` under the name newer torch releases give it.
all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

#: The device this process's shards live on, set by :func:`spawn`'s
#: worker (or :func:`set_device`); meshes made without a device take
#: it, or the current CUDA device when it is unset.
_DEVICE: Optional[torch.device] = None

def set_device(device) -> torch.device:
    """Make ``device`` the default device of this process's meshes."""
    global _DEVICE
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    _DEVICE = device
    return _DEVICE


def current_device() -> torch.device:
    """The device set by :func:`set_device`, else the current CUDA
    device.  With neither it raises: a mesh is on the CPU only when
    asked for it (``device="cpu"``)."""
    if _DEVICE is not None:
        return _DEVICE
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device and no device set: pass device='cpu' (or call "
            "repro_torch.distributed.set_device) to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


class Mesh:
    """Named axes over the ranks of the default process group.

    ``shape`` maps an axis name to its size, as a JAX mesh's does;
    ``coords`` is this rank's coordinate on every axis, or ``None`` on
    a rank past the mesh (which still takes part in building the
    subgroups, as every rank of the default group must)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None):
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} vs axes {axis_names}")
        self.axis_names = axis_names
        self.devices_shape = shape
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        self.size = int(np.prod(shape, dtype=np.int64))
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.device = torch.device(device) if device is not None \
            else current_device()
        self.coords: Optional[Dict[str, int]] = dict(zip(
            axis_names, (int(c) for c in np.unravel_index(self.rank, shape)))
        ) if self.rank < self.size else None
        self._groups: Dict[Tuple[str, ...], Tuple[Any, Tuple[int, ...]]] = {}

    def _axes(self, axes: AxisSpec) -> Tuple[str, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r}: {self.axis_names}")
        return axes

    def axis_size(self, axes: AxisSpec) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axes)],
                           dtype=np.int64))

    def axis_index(self, axes: AxisSpec) -> int:
        """This rank's coordinate along ``axes``: row-major over the
        named mesh axes, the first most significant."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axes: AxisSpec):
        """``(process group, members)`` of the ranks that agree with
        this one on every mesh axis outside ``axes``; ``members[i]`` is
        the global rank at coordinate ``i`` along ``axes``; ``None`` on a
        rank past the mesh.  Built on first use (collective: every rank
        of the default group, in the same order)."""
        axes = self._axes(axes)
        if axes not in self._groups:
            names = self.axis_names
            ranks = np.arange(self.size).reshape(self.devices_shape)
            # Put the spanned axes last, in the order given, so each
            # row of the reshaped grid is one subgroup in axis order.
            rest = [names.index(a) for a in names if a not in axes]
            span = [names.index(a) for a in axes]
            rows = ranks.transpose(rest + span).reshape(
                -1, self.axis_size(axes))
            mine = None
            for row in rows:
                members = tuple(int(r) for r in row)
                group = (dist.group.WORLD if members == tuple(
                    range(dist.get_world_size()))
                         else dist.new_group(list(members)))
                if self.rank in members:
                    mine = (group, members)
            self._groups[axes] = mine
        return self._groups[axes]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> Mesh:
    """A mesh of ``shape`` over the first ranks of the default process
    group; raises when the group is smaller than the mesh."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} vs axes {tuple(axes)}")
    device = current_device() if device is None else device
    n = int(np.prod(shape, dtype=np.int64))
    have = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or n > have:
        raise RuntimeError(
            f"mesh needs {n} devices, have {have}; start the ranks with "
            f"repro_torch.distributed.spawn(fn, world_size={n}, ...) (or "
            f"initialise a process group of {n} ranks) first")
    return Mesh(shape, axes, device=device)


def emulated_host_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    """A mesh over CPU ranks — the CI path for multi-rank ShardGrid
    runs.  Call it inside a function run by :func:`spawn` with
    ``backend="gloo", device="cpu"``."""
    return make_mesh(shape, axes, device="cpu")


def single_device_mesh(device=None) -> Mesh:
    """1×1 mesh — the production axis names on rank 0 of the default
    group, on ``device`` (default: :func:`current_device`, the card)."""
    return make_mesh((1, 1), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _stop_servers() -> None:
    """Stop multiprocessing's fork server and resource tracker while
    this process can still reap them: left to notice its exit, they
    would outlive it as zombies of a parent that never waits."""
    from multiprocessing import forkserver, resource_tracker
    for server in (forkserver._forkserver, resource_tracker._resource_tracker):
        stop = getattr(server, "_stop", None)
        if stop is not None:
            stop()


_STOP_AT_EXIT = False

#: What the ranks' fork server imports once, ahead of ``fn``'s module
#: (a dispatch mode, as the collectives audit runs, imports
#: ``torch._dynamo`` on first use).
_PRELOAD = ("torch", "torch._dynamo", "repro_torch.core",
            "repro_torch.analysis")

def _worker(fn: Callable, rank: int, world_size: int, backend: str,
            device: str, init_file: str, out_dir: str, args: tuple,
            timeout_s: float) -> None:
    status, payload = "ok", None
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count()
                               if dev.index is None else dev.index)
        set_device(dev)
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = dev
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
        try:
            result = fn(rank, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        payload = result if rank == 0 else None
    except BaseException as exc:  # noqa: BLE001 — re-raised by spawn
        status = "error"
        payload = (exc, traceback.format_exc())
    try:
        blob = pickle.dumps((status, payload))
    except Exception as exc:  # noqa: BLE001 — an unpicklable payload
        text = payload[1] if status == "error" else \
            f"rank {rank}: result not picklable: {exc!r}"
        blob = pickle.dumps(("error", (None, text)))
    tmp = os.path.join(out_dir, f"{rank}.tmp")
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, os.path.join(out_dir, f"{rank}.pkl"))


class Ranks:
    """Ranks started by :func:`start`, running ``fn``; :meth:`result`
    waits for them."""

    def __init__(self, fn: Callable, world_size: int, backend: str,
                 device: str, args: tuple, timeout: float):
        import multiprocessing as mp

        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                             f"{backend!r}")
        if backend == "nccl" and not str(device).startswith("cuda"):
            raise ValueError("the nccl backend needs device='cuda'")
        # Each rank forks from a single-threaded server that imported
        # _PRELOAD once: no interpreter to start, no import to repeat,
        # and none of the caller's threads (or its CUDA context) copied.
        global _STOP_AT_EXIT
        if not _STOP_AT_EXIT:
            atexit.register(_stop_servers)
            _STOP_AT_EXIT = True
        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(
            list(_PRELOAD)
            + ([fn.__module__] if fn.__module__ != "__main__" else []))
        self.world_size, self.timeout = world_size, timeout
        self.tmp = tempfile.mkdtemp(prefix="repro_torch_spawn_")
        init_file = os.path.join(self.tmp, "init")
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(fn, r, world_size, backend,
                                        str(device), init_file, self.tmp,
                                        tuple(args), timeout))
                      for r in range(world_size)]
        self.deadline = time.monotonic() + timeout
        # Starting waits for the server's imports: a thread does it, so
        # the caller goes on meanwhile (the ranks are not forked from
        # this process, so its threads do not matter to them).
        self._start_error: Optional[BaseException] = None
        self._starter = threading.Thread(target=self._start, daemon=True)
        self._starter.start()

    def _start(self) -> None:
        try:
            for p in self.procs:
                p.start()
        except BaseException as exc:  # noqa: BLE001 — re-raised by result
            self._start_error = exc

    def _poll(self) -> Dict[int, Any]:
        results: Dict[int, Any] = {}
        while len(results) < self.world_size:
            for r in range(self.world_size):
                path = os.path.join(self.tmp, f"{r}.pkl")
                if r in results or not os.path.exists(path):
                    continue
                with open(path, "rb") as f:
                    results[r] = pickle.load(f)
                if results[r][0] != "ok":
                    return {r: results[r]}
            dead = [r for r, p in enumerate(self.procs)
                    if r not in results and not p.is_alive()
                    and not os.path.exists(os.path.join(self.tmp,
                                                        f"{r}.pkl"))]
            if dead:
                return {dead[0]: ("error", (None, (
                    f"rank {dead[0]} exited with code "
                    f"{self.procs[dead[0]].exitcode} and no result")))}
            if time.monotonic() > self.deadline:
                raise TimeoutError(f"spawn: ranks still running after "
                                   f"{self.timeout} s")
            if len(results) < self.world_size:
                time.sleep(0.01)
        return results

    def result(self):
        """What rank 0 returned; the first rank to fail re-raised, with
        its traceback as a note.  Every rank is stopped on return."""
        try:
            self._starter.join()
            if self._start_error is not None:
                raise self._start_error
            results = self._poll()
            failed = [r for r, (status, _) in results.items()
                      if status != "ok"]
            if failed:
                exc, tb = results[failed[0]][1]
                if not isinstance(exc, BaseException):
                    raise RuntimeError(f"rank {failed[0]} failed:\n{tb}")
                exc.add_note(f"(raised on rank {failed[0]} of "
                             f"{self.world_size}; its traceback:)\n{tb}")
                raise exc
            for p in self.procs:
                p.join(timeout=max(1.0, self.deadline - time.monotonic()))
            return results[0][1]
        finally:
            self.stop()

    def stop(self) -> None:
        self._starter.join()
        for p in self.procs:
            if p.pid is not None and p.is_alive():
                p.terminate()
                p.join(5)
                if p.is_alive():
                    p.kill()
        shutil.rmtree(self.tmp, ignore_errors=True)


def start(fn: Callable, world_size: int, *, backend: str = "gloo",
          device: str = "cuda", args: tuple = (), timeout: float = 600.0
          ) -> Ranks:
    """:func:`spawn` without the wait: the ranks run while the caller
    goes on; ``.result()`` waits for them."""
    return Ranks(fn, world_size, backend, device, args, timeout)


def spawn(fn: Callable, world_size: int, *, backend: str = "gloo",
          device: str = "cuda", args: tuple = (), timeout: float = 600.0):
    """Start ``world_size`` ranks, initialise the default process group
    on each (a ``file://`` rendezvous in a fresh temporary directory),
    run ``fn(rank, *args)`` on every rank, and return what rank 0
    returned — the port's ``configure_platform(host_devices=N)``.

    ``backend`` is ``"gloo"`` or ``"nccl"``; ``device`` is ``"cuda"``
    (the default: rank r on card ``r % device_count``, every rank on
    ``cuda:0`` with one card) or ``"cpu"``.  The ranks fork from a
    ``forkserver`` process that imports torch, ``torch._dynamo``,
    ``repro_torch.core``, ``repro_torch.analysis`` and ``fn``'s module
    once, so ``fn`` and ``args`` must be picklable (a module-level
    function).  The first rank to fail is
    re-raised here, with its traceback as a note, and the others are
    stopped; so is every rank still running after ``timeout``
    seconds."""
    return start(fn, world_size, backend=backend, device=device, args=args,
                 timeout=timeout).result()
