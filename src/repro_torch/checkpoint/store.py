"""The partitioned relation store and cascade hop snapshots.

Port of the relation half of ``src/repro/checkpoint/store.py``, byte for
byte on disk: the same format tags, partition-function name, manifest
fields, npz member names and ``zlib.crc32`` over the same array bytes,
so each package loads the other's stores.

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
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import config


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
