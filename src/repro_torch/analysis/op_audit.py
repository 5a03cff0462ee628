"""The op audit: run every executor lowering at a tiny size and walk its
aten ops for dtype, donation and cache hazards.

The port's counterpart of the JAX package's jaxpr audit
(``src/repro/analysis/jaxpr_audit.py``).  JAX traces a program
abstractly; PyTorch has no such trace of the port's lowerings (they
branch on host values and launch hand-written kernels), so each
lowering runs at the reference fixture's sizes (``_chain_fixture``:
16 rows a relation, keys in [0, 8)) under a
:class:`~torch.utils._python_dispatch.TorchDispatchMode` that sees
every aten op with its inputs and outputs.  Tensors derived from key
columns are tainted.  Checks (the reference's finding codes, targets
named ``ops/<lowering>``):

* **Key-dtype narrowing** (``KEY_DTYPE_NARROWED``): a signed
  int64 → int32 conversion of a key-derived value.  Taint starts at
  the inputs' key columns and dies at boolean and unsigned outputs and
  inside ``hashing.bucket_hash`` (its uint32 arithmetic, emulated in
  int64, is the reference's deliberate unsigned fold: bucket ids, not
  keys).  Sort permutations, ``searchsorted`` positions and other
  index outputs are row positions bounded by the buffer size, clean
  as in the reference; row indices and ranks are int64 by design.
* **Float count accumulation** (``FLOAT_COUNT_ACCUM``): a ≥32-bit
  integer tensor converted to float32 and then summed directly —
  exact only below 2^24.  Converting a reduction's result is fine.
* **Donation** (``DONATED_INPUT_RETURNED``): an output of
  ``jit_execute_chain(donate=True)`` sharing storage with an input.
* **Cache key coverage** (``CACHE_KEY_MISS`` / ``CACHE_KEY_COLLISION``):
  :func:`audit_jit_cache`, the reference's variants.
* **Collectives** (``FULL_RELATION_ALL_GATHER``):
  :func:`audit_collectives`, over a run on a
  :class:`~repro_torch.core.ShardGrid` rank — the c10d ops it really
  runs, with ``n_collectives`` and ``n_all_to_all`` in its metrics.

The reference's ``WEAK_TYPE_INPUT`` has no torch counterpart (a tensor
has no weak type).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .. import config
from .report import ERROR, WARNING, VerifierReport

#: Attribute names treated as value (not key) columns when tainting the
#: standard chain/triangle lowerings (query attributes are letters).
_VALUE_PREFIXES = ("v", "w", "p")

#: Ops that convert a tensor's dtype (``Tensor.to`` reaches the
#: dispatcher as ``_to_copy``).
_CONVERT = {"_to_copy", "to", "type_as"}
_SUM = {"sum", "nansum"}
#: Ops whose every output is a row position or count of positions
#: (bounded by the buffer size, not a key value).
_INDEX = {"argsort", "searchsorted", "nonzero", "argmax", "argmin",
          "bincount", "arange", "histc"}
#: Ops returning (values, indices): the values carry the input's taint,
#: the indices are positions.
_VALUES_INDICES = {"sort", "topk", "kthvalue", "max", "min", "mode",
                   "cummax", "cummin"}


def _is_int32_or_64(dt: torch.dtype) -> bool:
    return dt in (torch.int32, torch.int64)


class _OpAudit(TorchDispatchMode):
    """Walks every aten op of a run: propagates key taint and flags
    narrowing and float count accumulation into ``report``.  Holds a
    reference to every tensor it marks, so an id stays one tensor's for
    the run (the fixture is tiny)."""

    def __init__(self, report: VerifierReport, where: str,
                 keys: Iterable[torch.Tensor]):
        super().__init__()
        self.report, self.where = report, where
        self.tainted: Dict[int, torch.Tensor] = {id(t): t for t in keys}
        self.converted: Dict[int, torch.Tensor] = {}
        self.clean_depth = 0
        self.n_ops = 0

    def is_tainted(self, t: torch.Tensor) -> bool:
        return id(t) in self.tainted

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        name = func.overloadpacket.__name__
        ins = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        in_taint = any(self.is_tainted(t) for t in ins)

        src = ins[1] if name == "copy_" and len(ins) > 1 else \
            (ins[0] if ins else None)
        if (src is not None and outs and (name in _CONVERT or name == "copy_")
                and self.is_tainted(src) and src.dtype == torch.int64
                and outs[0].dtype == torch.int32):
            self.report.add(
                "KEY_DTYPE_NARROWED", ERROR, f"{self.where}: aten.{name}",
                "int64 key values are narrowed to int32 inside the "
                "lowering; under x64 this silently folds distinct keys "
                "together — cast with the configured key dtype "
                "(repro_torch.config.default_key_dtype) instead")
        if name in _SUM and ins and id(ins[0]) in self.converted:
            self.report.add(
                "FLOAT_COUNT_ACCUM", WARNING, f"{self.where}: aten.{name}",
                "integer counts are converted to float32 and then summed "
                "— exact only below 2^24; sum first (or accumulate in "
                "float64/int64) and convert the scalar result")
        if (name in _CONVERT and ins and outs and _is_int32_or_64(ins[0].dtype)
                and outs[0].dtype == torch.float32 and outs[0].dim() > 0):
            self.converted[id(outs[0])] = outs[0]

        if name in _INDEX:
            per_out = [False] * len(outs)
        elif name in _VALUES_INDICES and len(outs) == 2:
            per_out = [in_taint, False]
        else:
            per_out = [in_taint] * len(outs)
        for t, taint in zip(outs, per_out):
            # Booleans carry no key values onward; unsigned values and
            # the hash's emulated uint32 are bucket ids, not keys.
            if (not taint or self.clean_depth or t.dtype == torch.bool
                    or not (t.is_floating_point() or t.is_signed())):
                continue
            self.tainted[id(t)] = t
        return out


@contextlib.contextmanager
def _hash_is_clean(mode: _OpAudit):
    """``hashing.bucket_hash`` as an unsigned fold for the audit: no op
    inside it taints its output."""
    from ..core import hashing
    orig = hashing.bucket_hash

    def bucket_hash(*args, **kwargs):
        mode.clean_depth += 1
        try:
            return orig(*args, **kwargs)
        finally:
            mode.clean_depth -= 1

    hashing.bucket_hash = bucket_hash
    try:
        yield
    finally:
        hashing.bucket_hash = orig


def _relations(tree: Any) -> List[Any]:
    """Every Relation in ``tree`` (a partitioned input's parts)."""
    from ..core.partition import PartitionedRelation
    from ..core.relation import Relation
    if isinstance(tree, PartitionedRelation):
        return [tree.parts]
    if isinstance(tree, Relation):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [r for t in tree for r in _relations(t)]
    return []


def key_columns(tree: Any) -> List[torch.Tensor]:
    """The key columns of every relation in ``tree``: integer columns
    whose name is not a value column's."""
    return [c for rel in _relations(tree) for name, c in rel.cols.items()
            if not name.startswith(_VALUE_PREFIXES)
            and not c.is_floating_point() and c.dtype != torch.bool]


def _tensors(tree: Any) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for rel in _relations(tree):
        out.extend(rel.cols.values())
        out.append(rel.valid)
    return out


def audit_run(fn, inputs: Any, target: str,
              report: Optional[VerifierReport] = None
              ) -> Tuple[Any, VerifierReport]:
    """Run ``fn(inputs)`` under the op audit, taint seeded at the key
    columns of ``inputs``.  Returns ``(fn(inputs), report)``; the
    report's ``n_ops`` metric counts the aten ops walked."""
    report = report if report is not None else VerifierReport(target=target)
    mode = _OpAudit(report, target, key_columns(inputs))
    with _hash_is_clean(mode), mode:
        result = fn(inputs)
    report.metrics["n_ops"] = report.metrics.get("n_ops", 0) + mode.n_ops
    return result, report


def audit_donation(outputs: Any, donated: Any, target: str,
                   report: Optional[VerifierReport] = None
                   ) -> VerifierReport:
    """An output that shares storage with a donated input is a
    use-after-donate for the caller."""
    report = report if report is not None else VerifierReport(target=target)
    donated_ptrs = {t.untyped_storage().data_ptr() for t in _tensors(donated)
                    if t.numel()}
    outs = [t for t in pytree.tree_leaves(outputs)
            if isinstance(t, torch.Tensor)]
    for rel in _relations(outputs):
        outs.extend(rel.cols.values())
        outs.append(rel.valid)
    for i, t in enumerate(outs):
        if t.numel() and t.untyped_storage().data_ptr() in donated_ptrs:
            report.add(
                "DONATED_INPUT_RETURNED", ERROR, f"output {i}",
                "an output shares its storage with a donated input; the "
                "caller would read memory the executable may reuse — "
                "copy the tensor")
    return report


# ---------------------------------------------------------------------------
# Collectives of a ShardGrid lowering
# ---------------------------------------------------------------------------

#: The c10d ops a ShardGrid runs (as the dispatcher names them) ->
#: (the reference's primitive name, the position of the operand sent).
_C10D = {"alltoall_base_": ("all_to_all", 1),
         "_allgather_base_": ("all_gather", 1),
         "allreduce_": ("psum", 0)}


class _CollectiveLog(TorchDispatchMode):
    """Records every c10d collective that reaches the dispatcher: its
    reference name and the shapes of the operand it sends."""

    def __init__(self):
        super().__init__()
        self.calls: List[Dict[str, Any]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if func.namespace == "c10d" and name in _C10D:
            prim, at = _C10D[name]
            operand = args[at] if len(args) > at else ()
            shapes = [tuple(t.shape) for t in pytree.tree_leaves(operand)
                      if isinstance(t, torch.Tensor)]
            self.calls.append({
                "prim": prim, "op": name, "operand_shapes": shapes,
                "operand_rows": int(max((s[-1] for s in shapes if s),
                                        default=0))})
        return func(*args, **(kwargs or {}))


def collect_collectives(fn: Callable[[], Any]) -> Tuple[Any, List[Dict]]:
    """Run ``fn()`` on this rank and return ``(its result, the c10d
    collectives it ran)``, each ``{"prim", "op", "operand_shapes",
    "operand_rows"}`` — rows are the sent operand's trailing axis, the
    per-device row count the collective moves, as in the reference."""
    log = _CollectiveLog()
    with log:
        result = fn()
    return result, log.calls


def audit_collectives(fn: Callable[[], Any], *, max_gather_rows: int,
                      target: str) -> Tuple[Any, VerifierReport]:
    """Flag ``all_gather``s that replicate a full relation.

    ``fn`` runs a lowering on this rank of a
    :class:`~repro_torch.core.ShardGrid` (every rank must run it: it
    communicates).  JAX audits a traced program; the port has no
    tracer, so it audits what runs: every c10d op reaches the
    dispatcher (``c10d::alltoall_base_``, ``_allgather_base_``,
    and ``allreduce_``) and a dispatch mode records it.
    ``max_gather_rows`` is the capacity threshold: gathers of scalars
    and small control values pass; a gather whose operand carries at
    least this many rows is a relation being replicated to every
    device — the pattern the chunked all-to-all schedule exists to
    avoid.  Metrics: ``n_collectives`` (every collective run) and
    ``n_all_to_all`` (one a column of every shuffle hop).  Returns
    ``(fn(), report)``, as :func:`audit_run` does."""
    report = VerifierReport(target=target)
    result, colls = collect_collectives(fn)
    report.metrics["n_collectives"] = len(colls)
    report.metrics["n_all_to_all"] = sum(
        1 for c in colls if c["prim"] == "all_to_all")
    for c in colls:
        if c["prim"] == "all_gather" and c["operand_rows"] >= max_gather_rows:
            report.add(
                "FULL_RELATION_ALL_GATHER", ERROR,
                f"{target}: all_gather{c['operand_shapes']}",
                f"an all_gather moves {c['operand_rows']} rows (>= the "
                f"relation capacity {max_gather_rows}): the shuffle is "
                f"replicating a full relation to every device instead of "
                f"routing per-chunk all_to_alls — k× the communication "
                f"the overlapped schedule accounts for")
    return result, report


# ---------------------------------------------------------------------------
# The audited lowerings
# ---------------------------------------------------------------------------

def _chain_fixture(n: int = 3, rows: int = 16) -> Tuple[Any, Any, Any]:
    """The reference's fixture: ``n`` relations of ``rows`` edges over
    8 nodes (rng seed 0), in the configured key dtype, and its caps."""
    from ..core import ChainCaps, ChainQuery
    rng = np.random.default_rng(0)
    query = ChainQuery.chain(n)
    dt = np.int64 if config.x64_enabled() else np.int32
    edges = [(rng.integers(0, 8, rows).astype(dt),
              rng.integers(0, 8, rows).astype(dt)) for _ in range(n)]
    caps = ChainCaps(recv=64, mid=128, out=256, local=64, agg=64, join=128)
    return query, edges, caps


def audit_lowerings(include_jit: bool = True,
                    device: Any = None) -> List[VerifierReport]:
    """Run and audit every executor lowering on ``device`` (the card
    unless the caller passes ``"cpu"``) at the fixture's sizes.  Returns
    one report per lowering (nine, as the reference's), in the
    reference's order; seconds on the CPU."""
    from ..core import (JoinQuery, SimGrid, chain_edge_inputs,
                        chain_partitioning, clear_compiled_caches,
                        default_part_capacity, edge_relation,
                        jit_execute_chain, partition_relation,
                        query_table_inputs)
    from ..core.executor import (cascade_query, mapside_cascade_chain,
                                 one_round_chain, one_round_query)

    device = config.resolve_device(device)
    reports: List[VerifierReport] = []
    query, edges, caps = _chain_fixture(3)

    grid_shape = (2, 2)
    rels = chain_edge_inputs(query, edges, grid_shape, device=device)
    reports.append(audit_run(
        lambda r: one_round_chain(SimGrid(grid_shape), query, r, caps=caps),
        rels, "ops/one_round_chain")[1])

    tri, tri_grid = JoinQuery.triangle(), (2, 2, 2)
    tri_rels = query_table_inputs(tri, edges, tri_grid, device=device)
    flat_rels = query_table_inputs(tri, edges, (4,), device=device)
    reports.append(audit_run(
        lambda r: one_round_query(SimGrid(tri_grid), tri, r, caps=caps),
        tri_rels, "ops/one_round_query")[1])
    reports.append(audit_run(
        lambda r: cascade_query(SimGrid((4,)), tri, r, caps=caps),
        flat_rels, "ops/cascade_query")[1])
    # The fused join and the chunked schedule are other code paths:
    # audit them too (on a GPU, fused probes with the kernel).
    overlap = dict(join_impl="fused", overlap_chunks=2)
    reports.append(audit_run(
        lambda r: one_round_query(SimGrid(tri_grid), tri, r, caps=caps,
                                  **overlap),
        tri_rels, "ops/one_round_query[fused,overlap]")[1])
    reports.append(audit_run(
        lambda r: cascade_query(SimGrid((4,)), tri, r, caps=caps, **overlap),
        flat_rels, "ops/cascade_query[fused,overlap]")[1])

    P = 4
    prels = []
    for j, (s, d) in enumerate(edges):
        key = query.attrs[1] if j == 0 else query.attrs[j]
        rel = edge_relation(s, d, names=query.schema(j), device=device)
        prels.append(partition_relation(
            rel, key, P, part_capacity=default_part_capacity(len(s), P))[0])
    part = chain_partitioning(query, [p.spec for p in prels])
    modes = tuple("mapside" if p else "shuffle" for p in part.right_proven)
    reports.append(audit_run(
        lambda r: mapside_cascade_chain(SimGrid((P,)), query, r, caps=caps,
                                        partitioning=part, hop_modes=modes),
        prels, "ops/mapside_cascade_chain")[1])

    if include_jit:
        # jit_execute_chain with donation, the staged plan and the
        # fused/overlapped one: its ops audited, its outputs held apart
        # from its inputs.
        for label, opts in (("", {}), ("[fused,overlap]", overlap)):
            target = f"ops/jit_execute_chain{label}"
            run = jit_execute_chain(SimGrid(grid_shape), query,
                                    strategy="one_round", caps=caps,
                                    donate=True, **opts)
            out, rep = audit_run(run, rels, target)
            reports.append(audit_donation(out, rels, target, report=rep))
        reports.append(audit_jit_cache())
        clear_compiled_caches()
    return reports


def audit_jit_cache() -> VerifierReport:
    """Cache-key coverage of ``jit_execute_chain``'s cache: identical
    plans must HIT (no recapture per call); any changed option,
    capacity or donation flag must MISS (a hit would silently run the
    wrong executable).  The reference's variants."""
    from ..core import ChainCaps, SimGrid, jit_execute_chain

    report = VerifierReport(target="ops/jit_cache_key")
    query, _, caps = _chain_fixture(3)
    grid = SimGrid((2, 2))
    base = dict(strategy="one_round", caps=caps, donate=False)
    f0 = jit_execute_chain(grid, query, **base)
    if jit_execute_chain(SimGrid((2, 2)), query, **base) is not f0:
        report.add(
            "CACHE_KEY_MISS", ERROR, "jit_execute_chain",
            "two identical (grid shape, query, strategy, caps) plans "
            "compiled to different executables — the cache key is "
            "over-specific and every call recaptures")
    variants: Dict[str, Dict[str, Any]] = {
        "strategy": dict(base, strategy="cascade"),
        "caps": dict(base, caps=ChainCaps(recv=65, mid=128, out=256,
                                          local=64, agg=64, join=128)),
        "donate": dict(base, donate=True),
        "opts(measure_skew)": dict(base, measure_skew=True),
        "opts(join_impl)": dict(base, join_impl="all_pairs"),
        "opts(join_impl=fused)": dict(base, join_impl="fused"),
        "opts(overlap_chunks)": dict(base, overlap_chunks=2),
    }
    for name, kwargs in variants.items():
        if jit_execute_chain(grid, query, **kwargs) is f0:
            report.add(
                "CACHE_KEY_COLLISION", ERROR, f"jit_execute_chain/{name}",
                f"changing {name} returned the SAME executable — the cache "
                f"key does not cover it, so a different plan silently runs "
                f"the wrong executable")
    if jit_execute_chain(grid, _chain_fixture(4)[0], **base) is f0:
        report.add(
            "CACHE_KEY_COLLISION", ERROR, "jit_execute_chain/query",
            "a different query hit the same cache entry")
    return report


__all__ = ["audit_run", "audit_donation", "audit_jit_cache",
           "audit_lowerings", "key_columns"]
