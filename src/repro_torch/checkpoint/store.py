"""Checkpoints: LM training state, the partitioned relation store and
cascade hop snapshots.

Port of ``src/repro/checkpoint/store.py``, byte for byte on disk: the
same format tags, partition-function name, manifest fields, npz member
names and ``zlib.crc32`` over the same array bytes, so each package
loads the other's checkpoints and stores.

* :func:`save` / :func:`restore` / :func:`latest_step` and
  :class:`CheckpointManager` (async writer, ``keep_n`` retention): a
  tree of tensors (parameters, ``OptState``) as ``<dir>/step_<n>/``,
  ``arrays.npz`` with one ``leaf_<i>`` a leaf plus a fsynced
  ``manifest.json`` (per-leaf CRC, shape and dtype name).  Leaves are
  ordered as ``jax.tree.flatten`` orders them — dict keys sorted,
  tuples and named tuples in field order — and a bfloat16 leaf is
  stored as its ``uint16`` bits (through ``torch``'s ``view``: no
  ``ml_dtypes``), so a checkpoint written by either package restores
  in the other.  The manifest's ``treedef`` string differs between the
  two; restore ignores it, as the reference does.

* :func:`save_partitioned` / :func:`load_partitioned` persist a
  :class:`~repro_torch.core.partition.PartitionedRelation` as
  ``<dir>/<name>/``: one ``part_NNNNN.npz`` per partition plus a
  fsynced ``manifest.json`` recording the partition function, key,
  partition count, salt, sort order, key dtype and per-partition
  per-column CRCs — enough to rebuild the
  :class:`~repro_torch.core.partition.PartitionSpec` and re-prove
  co-partitioning without touching the data
  (:func:`load_partition_spec`).
* :func:`save_hop` / :func:`latest_hop` / :func:`load_hop`: one
  materialized cascade intermediate per ``step_<hop>/``,
  self-describing (columns, dtypes, mask, CRCs).

Every write is staged in ``<name>.tmp`` and swapped in by
:func:`_atomic_replace`: the old copy is renamed aside, the new one
renamed in, and only then the old deleted, so a crash at any point
leaves the old or the new artifact intact (:func:`_recover_replaced`
finishes an interrupted swap on the next read).  Loads put tensors on
the GPU unless the caller passes ``device``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .. import config
from ..models.params import sorted_leaves


class DataCorrupt(IOError):
    """Stored bytes failed their CRC (or an injected corruption was
    detected by the read path's verification).  Subclasses ``IOError``
    so callers that already guard reads keep working.  ``path`` /
    ``detail`` locate the corrupt artifact."""

    def __init__(self, message: str, *, path: str = "", detail: str = ""):
        super().__init__(message)
        self.path = path
        self.detail = detail


# ---------------------------------------------------------------------------
# Fault-injection hook
# ---------------------------------------------------------------------------

#: When installed, partitioned reads offer each partition's freshly
#: loaded arrays at the "partition_read" site: the hook may delay,
#: raise, or return the arrays corrupted — the CRC check just below it
#: then catches the damage.  ``None`` (the default) costs one attribute
#: read per partition.
_fault_hook = None


def set_fault_hook(hook) -> None:
    """Install (or, with ``None``, remove) the module's fault hook."""
    global _fault_hook
    _fault_hook = hook


def _inject(site: str, payload):
    if _fault_hook is None:
        return payload
    return _fault_hook(site, payload)


# ---------------------------------------------------------------------------
# The atomic swap protocol
# ---------------------------------------------------------------------------

def _remove(path: str) -> None:
    """Delete an artifact: a directory tree or a single file."""
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        try:
            os.remove(path)
        except OSError:
            pass


def _atomic_replace(tmp: str, final: str) -> None:
    """Replace ``final`` with ``tmp`` without a window where neither
    exists: rename the old aside, rename the new in, then delete the
    old.  A crash between the renames is healed by
    :func:`_recover_replaced`."""
    old = final + ".old"
    if os.path.exists(old):  # leftover from an earlier interrupted swap
        _remove(old)
    if os.path.exists(final):
        os.rename(final, old)
    os.rename(tmp, final)
    if os.path.exists(old):
        _remove(old)


def _recover_replaced(directory: str) -> None:
    """Finish interrupted :func:`_atomic_replace` swaps under
    ``directory``: a ``<name>.old`` with no ``<name>`` means the crash
    hit between the two renames — restore the old copy; otherwise the
    swap completed and the ``.old`` is garbage."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        if not name.endswith(".old"):
            continue
        old = os.path.join(directory, name)
        base = old[:-len(".old")]
        if os.path.exists(base):
            _remove(old)
        else:
            os.rename(old, base)


def _write_manifest(tmp: str, manifest: dict) -> None:
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def save_json_atomic(directory: str, name: str, obj: Any) -> str:
    """Persist a small JSON document with the swap protocol: staged to
    ``<name>.tmp``, fsynced, and renamed in by :func:`_atomic_replace`."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"{name}.tmp")
    final = os.path.join(directory, name)
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    _atomic_replace(tmp, final)
    return final


def load_json(directory: str, name: str) -> Optional[Any]:
    """Read a :func:`save_json_atomic` document, healing any interrupted
    swap first.  Returns None when absent."""
    _recover_replaced(directory)
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _crc(a: np.ndarray) -> int:
    return int(zlib.crc32(a.tobytes()))


def _tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a.astype(dtype)),
                           device=device)


# ---------------------------------------------------------------------------
# LM checkpoints: a tree of tensors a step
# ---------------------------------------------------------------------------

#: torch dtypes numpy has no type for: stored as raw bits of this width.
_RAW = {torch.bfloat16: np.uint16, torch.float8_e4m3fn: np.uint8,
        torch.float8_e5m2: np.uint8}
_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.uint8}


def _is_named(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _unflatten(like, leaf: Callable[[Any], Any]):
    """``like``'s structure with each leaf ``x`` replaced by
    ``leaf(x)``, called in :func:`_flatten`'s order."""
    if like is None:
        return None
    if isinstance(like, dict):
        got = {k: _unflatten(like[k], leaf) for k in sorted(like)}
        return {k: got[k] for k in like}
    if _is_named(like):
        return type(like)(*(_unflatten(v, leaf) for v in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, leaf) for v in like)
    return leaf(like)


def _structure(tree) -> str:
    """The tree's structure, leaves as ``*``: the manifest's ``treedef``
    (informational; restore reads ``like``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_named(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_structure(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"({inner},)" if isinstance(tree, tuple) and len(tree) == 1 \
            else (f"({inner})" if isinstance(tree, tuple) else f"[{inner}]")
    return "*"


def _host(x) -> Tuple[np.ndarray, str]:
    """``(array to store, true dtype name)`` of a leaf: a tensor (any
    device) or a numpy array.  A dtype numpy cannot hold is stored as its
    raw bits; the bytes, and so the CRC, are the true array's."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        raw = _RAW.get(t.dtype)
        if raw is not None:
            width = torch.int16 if raw is np.uint16 else torch.uint8
            return (t.contiguous().view(width).numpy().view(raw),
                    str(t.dtype).split(".")[-1])
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name in ("bfloat16", "float8_e4m3fn",
                                               "float8_e5m2"):
        return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint16), \
            a.dtype.name
    return a, a.dtype.name


def _from_stored(a: np.ndarray, true_dtype: str) -> torch.Tensor:
    """A host tensor of the true dtype from a stored array."""
    a = np.array(a, order="C")          # a writable copy; 0-d stays 0-d
    if a.dtype.name != true_dtype:      # stored as a raw-bits view
        bits = a.view(_SIGNED[a.dtype])
        return torch.from_numpy(bits).view(getattr(torch, true_dtype))
    return torch.from_numpy(a)


def save(directory: str, step: int, tree, extra: Optional[dict] = None
         ) -> str:
    """Write ``tree`` (tensors on any device, or numpy arrays) as
    ``<directory>/step_<step>/``, staged in ``step_<step>.tmp`` and
    swapped in atomically."""
    arrays = [_host(x) for x in sorted_leaves(tree)]
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(arrays)})
    manifest = {
        "step": step,
        "treedef": _structure(tree),
        "n_leaves": len(arrays),
        "crc": [_crc(a) for a, _ in arrays],
        "shapes": [list(a.shape) for a, _ in arrays],
        "dtypes": [name for _, name in arrays],
        "extra": extra or {},
    }
    _write_manifest(tmp, manifest)
    _atomic_replace(tmp, final)
    return final


def _checkpoint_intact(path: str, verify_crc: bool = True) -> bool:
    """True iff a ``step_<n>`` directory is restorable: the manifest
    parses, ``arrays.npz`` holds every leaf and (by default) every leaf
    matches its CRC.  A torn directory is never the latest checkpoint."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        n = int(manifest["n_leaves"])
        crcs = manifest["crc"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i in range(n):
                a = data[f"leaf_{i}"]
                if verify_crc and _crc(a) != crcs[i]:
                    return False
    except Exception:  # noqa: BLE001 — any defect means "not restorable"
        return False
    return True


def _steps(directory: str) -> List[int]:
    out = []
    for name in os.listdir(directory):
        if (name.startswith("step_") and not name.endswith(".tmp")
                and not name.endswith(".old")):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(directory: str, *, verify: bool = True) -> Optional[int]:
    """Newest *restorable* step under ``directory``: torn or corrupt step
    directories are skipped, so a resuming trainer lands on one that
    :func:`restore` reads.  ``verify=False`` skips the CRC pass."""
    if not os.path.isdir(directory):
        return None
    _recover_replaced(directory)
    for step in reversed(_steps(directory)):
        if _checkpoint_intact(os.path.join(directory, f"step_{step}"),
                              verify_crc=verify):
            return step
    return None


def restore(directory: str, step: int, like) -> Tuple[Any, dict]:
    """Restore into the structure of ``like``: each leaf checked against
    its CRC (:class:`DataCorrupt`) and ``like``'s leaf's shape, then cast
    to that leaf's dtype and put on its device."""
    _recover_replaced(directory)
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i in range(manifest["n_leaves"]):
            a = data[f"leaf_{i}"]
            if _crc(a) != manifest["crc"][i]:
                raise DataCorrupt(f"checkpoint corruption in leaf {i} at "
                                  f"{path}", path=path, detail=f"leaf_{i}")
            arrays.append(_from_stored(a, manifest["dtypes"][i]))
    n_like = len(sorted_leaves(like))
    if n_like != len(arrays):
        raise ValueError(f"leaf count mismatch: {n_like} vs {len(arrays)}")
    it: Iterator[torch.Tensor] = iter(arrays)

    def leaf(want):
        got = next(it)
        if tuple(want.shape) != tuple(got.shape):
            raise ValueError(f"shape mismatch {tuple(want.shape)} vs "
                             f"{tuple(got.shape)}")
        return got.to(device=want.device, dtype=want.dtype)

    return _unflatten(like, leaf), manifest["extra"]


class CheckpointManager:
    """``keep_n`` retention + optional async writes + preemption flush.
    ``save`` copies the tree to the host on the caller's thread (the
    caller may then update its tensors in place) and writes it on a
    worker thread."""

    def __init__(self, directory: str, keep_n: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep_n = keep_n
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree, extra: Optional[dict] = None,
             block: bool = False):
        self.wait()
        host_tree = _unflatten(tree, lambda t: t.detach().to(
            "cpu", copy=True) if isinstance(t, torch.Tensor)
            else np.array(t))

        def work():
            save(self.directory, step, host_tree, extra)
            self._gc()

        if self.async_write and not block:
            self._pending = threading.Thread(target=work, daemon=True)
            self._pending.start()
        else:
            work()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, like):
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, extra = restore(self.directory, step, like)
        return step, tree, extra

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)


# ---------------------------------------------------------------------------
# Partitioned relation store — the on-disk side of map-side joins
# ---------------------------------------------------------------------------

#: Manifest format tag; bumped if the layout ever changes shape.
PARTITIONED_FORMAT = "partitioned-relation-v1"


def save_partitioned(directory: str, name: str, prel) -> str:
    """Persist a :class:`~repro_torch.core.partition.PartitionedRelation`
    (columns ``(P, part_capacity)``) as ``<directory>/<name>/`` — one
    npz per partition plus a fsynced ``manifest.json`` with the spec and
    per-partition per-column CRCs — staged in ``<name>.tmp`` and swapped
    in atomically."""
    from ..core.partition import PARTITION_FN

    spec = prel.spec
    if prel.parts.valid.dim() != 2:
        raise ValueError(f"a stored relation is (P, part_capacity), got "
                         f"{tuple(prel.parts.valid.shape)}")
    tmp = os.path.join(directory, f"{name}.tmp")
    final = os.path.join(directory, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    columns = sorted(prel.parts.cols)
    valid = prel.parts.valid.cpu().numpy()
    cols = {c: prel.parts.cols[c].cpu().numpy() for c in columns}
    crcs = []
    for p in range(prel.num_partitions):
        part_arrays = {c: cols[c][p] for c in columns}
        part_arrays["valid"] = valid[p]
        np.savez(os.path.join(tmp, f"part_{p:05d}.npz"), **part_arrays)
        crcs.append({k: _crc(a) for k, a in part_arrays.items()})
    _write_manifest(tmp, {
        "format": PARTITIONED_FORMAT,
        "partition_fn": PARTITION_FN,
        "key": spec.key,
        "num_partitions": spec.num_partitions,
        "salt": spec.salt,
        "sort_order": spec.sort_order,
        "key_dtype": spec.key_dtype or cols[spec.key].dtype.name,
        "part_capacity": prel.part_capacity,
        "columns": columns,
        "dtypes": {c: cols[c].dtype.name for c in columns},
        "crc": crcs,
    })
    _atomic_replace(tmp, final)
    return final


def load_partition_spec(directory: str, name: str):
    """Read just the manifest of a stored partitioned relation and
    rebuild its :class:`~repro_torch.core.partition.PartitionSpec` —
    what the planner needs to prove co-partitioning, without touching
    the data.  Returns None when the relation is absent or was written
    by a different partition hash (its proof would be unsound)."""
    from ..core.partition import PARTITION_FN, PartitionSpec

    _recover_replaced(directory)
    path = os.path.join(directory, name, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        manifest = json.load(f)
    if (manifest.get("format") != PARTITIONED_FORMAT
            or manifest.get("partition_fn") != PARTITION_FN):
        return None
    # Legacy manifests predate the key_dtype field: fall back to the key
    # column's recorded storage dtype, what the hash saw at write time.
    key_dtype = (manifest.get("key_dtype")
                 or manifest["dtypes"].get(manifest["key"]))
    return PartitionSpec(key=manifest["key"],
                         num_partitions=manifest["num_partitions"],
                         salt=manifest["salt"],
                         sort_order=manifest["sort_order"],
                         key_dtype=key_dtype)


def load_partitioned(directory: str, name: str, device=None):
    """Load a stored partitioned relation back into a
    :class:`~repro_torch.core.partition.PartitionedRelation` on
    ``device`` (default: the GPU), every partition's columns CRC
    verified first (:class:`DataCorrupt` on a mismatch)."""
    from ..core.partition import PartitionedRelation
    from ..core.relation import Relation

    device = config.resolve_device(device)
    spec = load_partition_spec(directory, name)
    if spec is None:
        raise FileNotFoundError(
            f"no partitioned relation {name!r} under {directory}")
    path = os.path.join(directory, name)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    names = list(manifest["columns"]) + ["valid"]
    per_part: Dict[str, list] = {k: [] for k in names}
    for p in range(manifest["num_partitions"]):
        with np.load(os.path.join(path, f"part_{p:05d}.npz")) as data:
            arrays = {k: data[k] for k in names}
        # Fault site: an injector may corrupt the loaded arrays here —
        # the CRC check below is what catches it.
        arrays = _inject("partition_read", arrays)
        for k in names:
            a = arrays[k]
            if _crc(a) != manifest["crc"][p][k]:
                raise DataCorrupt(
                    f"partition {p} column {k!r} corrupt in {path}",
                    path=path, detail=f"part_{p:05d}.npz:{k}")
            per_part[k].append(a)
    cols = {c: _tensor(np.stack(per_part[c]), manifest["dtypes"][c], device)
            for c in manifest["columns"]}
    valid = _tensor(np.stack(per_part["valid"]), "bool", device)
    return PartitionedRelation(Relation(cols, valid), spec)


# ---------------------------------------------------------------------------
# Hop snapshots — cascade lineage recovery points
# ---------------------------------------------------------------------------

#: Format tag of one materialized cascade intermediate.
HOP_FORMAT = "hop-snapshot-v1"


def save_hop(directory: str, hop: int, rel, extra: Optional[dict] = None,
             ) -> str:
    """Materialize one cascade hop's intermediate relation as
    ``<directory>/step_<hop>/`` — the recovery point a killed later hop
    re-executes from.  Self-describing: columns under their own names
    with dtypes and the mask alongside, so :func:`load_hop` rebuilds the
    :class:`~repro_torch.core.relation.Relation` without a template.
    Per-array CRCs, fsync and the swap protocol as above; a crash
    mid-write leaves a torn directory that :func:`latest_hop` skips."""
    tmp = os.path.join(directory, f"step_{hop}.tmp")
    final = os.path.join(directory, f"step_{hop}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    cols = {n: c.cpu().numpy() for n, c in rel.cols.items()}
    valid = rel.valid.cpu().numpy()
    arrays = {f"col_{n}": a for n, a in cols.items()}
    arrays["valid"] = valid
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    _write_manifest(tmp, {
        "format": HOP_FORMAT,
        "hop": int(hop),
        "columns": sorted(cols),
        "dtypes": {n: a.dtype.name for n, a in cols.items()},
        "shapes": {n: list(a.shape) for n, a in cols.items()},
        "valid_shape": list(valid.shape),
        "crc": {k: _crc(a) for k, a in arrays.items()},
        "extra": extra or {},
    })
    _atomic_replace(tmp, final)
    return final


def _hop_intact(path: str) -> bool:
    """True iff a hop snapshot is fully restorable (manifest parses,
    every named array reads back, CRCs match)."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if manifest.get("format") != HOP_FORMAT:
            return False
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for k, crc in manifest["crc"].items():
                if _crc(data[k]) != crc:
                    return False
    except Exception:  # noqa: BLE001 — any defect means "not restorable"
        return False
    return True


def latest_hop(directory: str) -> Optional[int]:
    """Newest *intact* hop snapshot under ``directory`` (CRC verified),
    or None.  Torn or corrupt snapshots are skipped."""
    if not os.path.isdir(directory):
        return None
    _recover_replaced(directory)
    hops = []
    for name in os.listdir(directory):
        if (name.startswith("step_") and not name.endswith(".tmp")
                and not name.endswith(".old")):
            try:
                hops.append(int(name.split("_")[1]))
            except ValueError:
                continue
    for hop in sorted(hops, reverse=True):
        if _hop_intact(os.path.join(directory, f"step_{hop}")):
            return hop
    return None


def load_hop(directory: str, hop: int, device=None):
    """Restore one hop snapshot into a
    :class:`~repro_torch.core.relation.Relation` on ``device`` (default:
    the GPU) plus its ``extra`` document (CRC verified;
    :class:`DataCorrupt` on damage)."""
    from ..core.relation import Relation

    device = config.resolve_device(device)
    path = os.path.join(directory, f"step_{hop}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != HOP_FORMAT:
        raise IOError(f"not a hop snapshot: {path}")
    arrays = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, crc in manifest["crc"].items():
            a = data[k]
            if _crc(a) != crc:
                raise DataCorrupt(f"hop snapshot array {k!r} corrupt in "
                                  f"{path}", path=path, detail=k)
            arrays[k] = a
    cols = {n: _tensor(arrays[f"col_{n}"], manifest["dtypes"][n], device)
            for n in manifest["columns"]}
    return (Relation(cols, _tensor(arrays["valid"], "bool", device)),
            manifest["extra"])
