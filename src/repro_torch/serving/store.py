"""Streaming ingest: micro-batched edge deltas with incremental
maintenance of standing aggregates.

Port of ``src/repro/serving/store.py``.  The bookkeeping is host-side
numpy, as in the JAX package; every join runs through the port's
:class:`~repro_torch.serving.engine.QueryEngine` on the engine's
device, and the store writes and reads the JAX package's on-disk
format (``serving_meta.json``, ``repro-serving-v1``, over the
partitioned store), so either package opens the other's store.

A :class:`ServingStore` owns one edge relation and a set of *standing
aggregates* over it — self-join counts the engine keeps current as
deltas stream in: triangle counts (the cyclic 3-query) and chain path
counts.  An ingested micro-batch of inserts/deletes is applied by
**delta-join cascades**, not recompute: the count C(E) = Σ ∏ weights
over the n-way self-join is multilinear in the relation, so

    C(E + Δ) − C(E)  =  Σ_{∅ ≠ S ⊆ positions}  C(term with Δ at S, E elsewhere)

— at most 2^n − 1 small joins, every one containing at least one Δ
factor, instead of one join of n full relations.  Deletions ride along
as Δ rows with weight −1: the value product carries the sign through
the cascade, so a deleted edge's triangles subtract themselves.  For
the triangle the cyclic symmetry collapses the expansion to three
terms: ΔC = [3·T(Δ,E,E) + 3·T(Δ,Δ,E) + T(Δ,Δ,Δ)] / 3.

Every delta term runs through the :class:`~repro_torch.serving.engine.QueryEngine`
(cache hits once a batch shape repeats), and the store accounts the
tuples actually moved against the analytic cost of the recompute it
avoided (``ServingStats.delta_tuples`` / ``recompute_tuples``).  When
cumulative drift (applied delta rows since the last full computation)
exceeds ``drift_threshold`` × base size, the store falls back to a
full recompute — incremental error cannot accumulate unboundedly and
the delta terms' costs stop paying once Δ history rivals E.

Durability is compute-then-commit over the checkpoint store's
crash-safe machinery: the new edge partitions land under a fresh
versioned name (``save_partitioned``), then the metadata document —
the commit point — swaps in atomically (``save_json_atomic``).  A
failure at ANY earlier point leaves stored partitions and standing
aggregates exactly as they were.  Each committed version re-partitions
under ``salt = version``, so a co-partitioning certificate minted
against an older version structurally fails the ``co_partitioned``
proof — stale cached plans cannot touch fresh partitions.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..checkpoint.store import (load_json, load_partitioned,
                                save_json_atomic, save_partitioned)
from ..core import (JoinQuery, cost_query_cascade, default_part_capacity,
                    partition_relation, query_stats_exact)
from .engine import QueryEngine, weighted_total

META_NAME = "serving_meta.json"
META_FORMAT = "repro-serving-v1"


class IngestError(RuntimeError):
    """A delta batch could not be applied; the store is unchanged."""


@dataclasses.dataclass
class StandingAggregate:
    """One continuously-maintained self-join count over the stored
    edges.

    kind:  ``"cycle"`` (n-cycle count — each directed cycle appears
           once per rotation, so the join total divides by n; n = 3 is
           the triangle count) or ``"chain"`` (n-edge path count).
    value: the maintained count.
    drift_rows: delta rows applied since the last full computation.
    delta_tuples / recompute_tuples: tuples moved by the delta cascades
           vs the analytic tuples the avoided recomputes would have
           moved (the savings surface in ``BENCH_serving.json``).
    """

    kind: str
    n: int
    value: float = 0.0
    drift_rows: int = 0
    refreshes: int = 0
    deltas_applied: int = 0
    delta_tuples: float = 0.0
    recompute_tuples: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in ("cycle", "chain"):
            raise ValueError(f"unknown aggregate kind {self.kind!r}")
        if self.n < 2:
            raise ValueError(f"need n >= 2 relations, got {self.n}")

    def query(self) -> JoinQuery:
        return (JoinQuery.cycle(self.n) if self.kind == "cycle"
                else JoinQuery.chain(self.n))

    @property
    def divisor(self) -> float:
        return float(self.n) if self.kind == "cycle" else 1.0

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def delta_terms(kind: str, n: int) -> List[Tuple[Tuple[bool, ...], float]]:
    """(pattern, coefficient) pairs of the multilinear expansion —
    pattern[j] is True where Δ substitutes for E.  The triangle's
    cyclic symmetry merges rotations of a pattern into one term with
    an integer coefficient (3 executions instead of 7); other shapes
    enumerate all 2^n − 1 subsets."""
    if kind == "cycle" and n == 3:
        return [((True, False, False), 3.0),
                ((True, True, False), 3.0),
                ((True, True, True), 1.0)]
    out: List[Tuple[Tuple[bool, ...], float]] = []
    for mask in range(1, 1 << n):
        out.append((tuple(bool(mask >> j & 1) for j in range(n)), 1.0))
    return out


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def _as_edges(edges: Optional[Tuple[Any, Any]]) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    if edges is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    s, d = np.asarray(edges[0]), np.asarray(edges[1])
    if s.shape != d.shape or s.ndim != 1:
        raise ValueError(f"edge arrays must be equal-length 1-D, got "
                         f"{s.shape} vs {d.shape}")
    return s, d


class ServingStore:
    """Stored edge relation + standing aggregates under streaming
    ingest (module docstring has the maintenance math and the
    commit protocol)."""

    def __init__(self, directory: str,
                 engine: Optional[QueryEngine] = None, *,
                 num_partitions: int = 8,
                 drift_threshold: Optional[float] = 0.5,
                 delta_capacity: int = 256):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        # NOT `engine or QueryEngine()`: QueryEngine.__len__ is the plan
        # cache size, so a caller's fresh (empty-cache) engine is falsy
        # and would be silently replaced by a private one — its stats
        # and admission state would never see this store's traffic.
        self.engine = engine if engine is not None else QueryEngine()
        self.num_partitions = int(num_partitions)
        self.drift_threshold = drift_threshold
        self.delta_capacity = int(delta_capacity)
        self.version = 0
        self.src: np.ndarray = np.zeros(0, np.int64)
        self.dst: np.ndarray = np.zeros(0, np.int64)
        self.aggregates: Dict[str, StandingAggregate] = {}
        self._spec: Any = None
        self._restore()

    # -- introspection -----------------------------------------------------

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def partition_spec(self) -> Any:
        """The current version's :class:`PartitionSpec` (salt ==
        version) — what certificates must be minted against."""
        return self._spec

    def analytic_value(self, name: str) -> float:
        """Host-side oracle for one aggregate at the CURRENT edges:
        the exact join output size over unit weights, via
        ``query_stats_exact`` — no engine execution.  Tests pin the
        incrementally-maintained value against this."""
        agg = self.aggregates[name]
        q = agg.query()
        stats = query_stats_exact(q, [(self.src, self.dst)] * agg.n)
        return stats.full_output / agg.divisor

    # -- persistence -------------------------------------------------------

    def _restore(self) -> None:
        meta = load_json(self.directory, META_NAME)
        if meta is None or meta.get("format") != META_FORMAT:
            return
        self.version = int(meta["version"])
        self.aggregates = {name: StandingAggregate(**fields)
                           for name, fields in meta["aggregates"].items()}
        prel = load_partitioned(self.directory, f"edges_v{self.version}",
                                device=self.engine.device)
        flat = prel.to_flat().map(lambda t: t.cpu())
        valid = flat.valid.numpy()
        self.src = flat.cols["src"].numpy()[valid]
        self.dst = flat.cols["dst"].numpy()[valid]
        self._spec = prel.spec
        # A crash mid-GC (or mid-commit) may have left orphaned version
        # directories behind; the next open completes the sweep.
        self._gc_orphans()

    def _gc_orphans(self) -> None:
        """Best-effort sweep of every superseded ``edges_v*`` directory
        and stray temp debris.  Crash-safe by construction: only
        non-current versions are touched, each orphan's manifest is
        deleted FIRST (so a half-deleted orphan can never be mistaken
        for a loadable relation), and any failure leaves the sweep for
        the next commit or the next open — the committed state is never
        at risk."""
        current = f"edges_v{self.version}"
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        for name in sorted(names):
            path = os.path.join(self.directory, name)
            try:
                if name.endswith(".tmp"):
                    if os.path.isdir(path):
                        shutil.rmtree(path, ignore_errors=True)
                    else:
                        os.remove(path)
                    continue
                if (not name.startswith("edges_v") or name == current
                        or not os.path.isdir(path)):
                    continue
                manifest = os.path.join(path, "manifest.json")
                if os.path.exists(manifest):
                    os.remove(manifest)      # tombstone: unloadable now
                shutil.rmtree(path)
            except OSError:  # pragma: no cover — finish next sweep
                continue

    def _commit(self, src: np.ndarray, dst: np.ndarray,
                aggregates: Dict[str, StandingAggregate]) -> None:
        """Durable commit of a fully-computed new state.  Order
        matters: partitions first under a *new* versioned name (never
        touching the old version), then the metadata document — the
        atomic commit point.  A crash before the meta swap leaves the
        old version fully intact (the orphaned new partitions are
        garbage-collected on the next successful commit)."""
        from ..core.matmul import edge_relation

        version = self.version + 1
        rel = edge_relation(src, dst, names=("src", "dst", "w"),
                            device=self.engine.device)
        cap = max(default_part_capacity(len(src), self.num_partitions),
                  # lossless fallback: a pathological key distribution
                  # may put every row in one partition
                  int(rel.capacity))
        prel, overflow = partition_relation(
            rel, "src", self.num_partitions, salt=version,
            part_capacity=cap)
        if bool(overflow):  # pragma: no cover — capacity is lossless
            raise IngestError("partitioning overflow during commit")
        save_partitioned(self.directory, f"edges_v{version}", prel)
        meta = {
            "format": META_FORMAT,
            "version": version,
            "n_edges": int(len(src)),
            "aggregates": {n: a.to_json() for n, a in aggregates.items()},
        }
        save_json_atomic(self.directory, META_NAME, meta)
        # -- committed: mutate memory, then GC superseded versions.
        # The sweep is best-effort and crash-safe (_gc_orphans): a
        # process killed mid-GC leaves the committed store loadable,
        # and the next open or commit finishes the sweep.
        self.version = version
        self.src, self.dst = src, dst
        self.aggregates = aggregates
        self._spec = prel.spec
        try:
            self._gc_orphans()
        except Exception:  # pragma: no cover — sweep later, never fail
            pass

    # -- bulk load / registration ------------------------------------------

    def load_edges(self, src: Any, dst: Any) -> None:
        """Initial (or replacement) bulk load; every registered
        aggregate is fully recomputed before the commit."""
        s, d = _as_edges((src, dst))
        if len(s) == 0:
            raise ValueError("load_edges needs a non-empty edge list")
        aggs = {name: self._refresh(agg, (s, d))
                for name, agg in self.aggregates.items()}
        self._commit(s, d, aggs)

    def register_aggregate(self, name: str, kind: str, n: int = 3) -> None:
        """Add a standing aggregate; computed immediately when edges
        are already loaded."""
        if name in self.aggregates:
            raise ValueError(f"aggregate {name!r} already registered")
        agg = StandingAggregate(kind=kind, n=n)
        if self.n_edges:
            agg = self._refresh(agg, (self.src, self.dst))
            aggs = dict(self.aggregates)
            aggs[name] = agg
            self._commit(self.src, self.dst, aggs)
        else:
            self.aggregates[name] = agg

    # -- ingest ------------------------------------------------------------

    def apply_deltas(self, inserts: Optional[Tuple[Any, Any]] = None,
                     deletes: Optional[Tuple[Any, Any]] = None,
                     ) -> Dict[str, Any]:
        """Apply one micro-batch.  Everything — merged edge arrays, all
        delta-term joins, every new aggregate value — is computed
        BEFORE anything is persisted or mutated; any failure (unknown
        deleted edge, buffer overflow, injected fault) raises with the
        store bit-identical to its pre-call state."""
        if not self.n_edges:
            raise IngestError("apply_deltas before load_edges")
        ins_s, ins_d = _as_edges(inserts)
        del_s, del_d = _as_edges(deletes)
        n_delta = len(ins_s) + len(del_s)
        if n_delta == 0:
            raise ValueError("empty delta batch")

        # --- compute phase -------------------------------------------
        new_src, new_dst = self._merged_edges(ins_s, ins_d, del_s, del_d)
        d_src = np.concatenate([ins_s, del_s])
        d_dst = np.concatenate([ins_d, del_d])
        d_w = np.concatenate([np.ones(len(ins_s), np.float32),
                              -np.ones(len(del_s), np.float32)])
        report: Dict[str, Any] = {"n_inserts": int(len(ins_s)),
                                  "n_deletes": int(len(del_s)),
                                  "aggregates": {}}
        new_aggs: Dict[str, StandingAggregate] = {}
        for name, agg in self.aggregates.items():
            new_aggs[name], agg_report = self._advance(
                agg, (d_src, d_dst, d_w), n_delta, (new_src, new_dst))
            report["aggregates"][name] = agg_report

        # --- commit phase --------------------------------------------
        self._commit(new_src, new_dst, new_aggs)
        report["version"] = self.version
        return report

    def _merged_edges(self, ins_s: np.ndarray, ins_d: np.ndarray,
                      del_s: np.ndarray, del_d: np.ndarray,
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Base edges minus one occurrence per delete row plus the
        inserts; a delete naming an absent edge aborts the batch."""
        want = Counter(zip(del_s.tolist(), del_d.tolist()))
        keep = np.ones(self.n_edges, bool)
        if want:
            for i, e in enumerate(zip(self.src.tolist(), self.dst.tolist())):
                if want.get(e, 0) > 0:
                    want[e] -= 1
                    keep[i] = False
            missing = +want
            if missing:
                raise IngestError(
                    f"delete of absent edge(s): {sorted(missing)[:5]}")
        new_src = np.concatenate([self.src[keep], ins_s.astype(self.src.dtype)])
        new_dst = np.concatenate([self.dst[keep], ins_d.astype(self.dst.dtype)])
        return new_src, new_dst

    # -- maintenance --------------------------------------------------------

    def _submit(self, query: JoinQuery, tables: Sequence[Tuple],
                capacities: Sequence[Optional[int]]) -> Any:
        stats = query_stats_exact(query, [t[:2] for t in tables])
        res = self.engine.submit(query, tables, stats=stats,
                                 strategy="cascade",
                                 capacities=list(capacities))
        if not res.ok:
            raise IngestError(f"delta-term execution failed: {res.error}")
        return res

    def _recompute_cost(self, query: JoinQuery,
                        edges: Tuple[np.ndarray, np.ndarray],
                        n: int) -> Tuple[Any, float]:
        """Exact statistics of the full query at ``edges`` and the
        analytic tuple cost of cascading it — what a full recompute
        would move."""
        stats = query_stats_exact(query, [edges] * n)
        order, _ = stats.best_order()
        idx = stats.orders.index(tuple(order))
        cost = cost_query_cascade([stats.sizes[i] for i in order],
                                  stats.intermediates[idx])
        return stats, cost

    def _refresh(self, agg: StandingAggregate,
                 edges: Tuple[np.ndarray, np.ndarray]) -> StandingAggregate:
        """Full computation through the engine (initial load and the
        drift fallback)."""
        q = agg.query()
        cap = _pow2(len(edges[0]))
        res = self._submit(q, [edges] * agg.n, [cap] * agg.n)
        moved = res.measured["total"]
        return dataclasses.replace(
            agg, value=weighted_total(q, res.output) / agg.divisor,
            drift_rows=0, refreshes=agg.refreshes + 1,
            delta_tuples=agg.delta_tuples + moved,
            recompute_tuples=agg.recompute_tuples + moved)

    def _advance(self, agg: StandingAggregate,
                 delta: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 n_delta: int, new_edges: Tuple[np.ndarray, np.ndarray],
                 ) -> Tuple[StandingAggregate, Dict[str, Any]]:
        q = agg.query()
        _, recompute_cost = self._recompute_cost(q, new_edges, agg.n)
        drift = agg.drift_rows + n_delta
        drifted = (self.drift_threshold is not None
                   and drift > self.drift_threshold * max(len(new_edges[0]),
                                                          1))
        if drifted:
            new_agg = self._refresh(agg, new_edges)
            new_agg = dataclasses.replace(
                new_agg, deltas_applied=agg.deltas_applied + 1)
            report = {"mode": "recompute", "value": new_agg.value,
                      "read": 0.0, "shuffled": 0.0,
                      "total": new_agg.delta_tuples - agg.delta_tuples,
                      "recompute_cost": recompute_cost}
            self.engine.stats.delta_tuples += report["total"]
            self.engine.stats.recompute_tuples += report["total"]
            return new_agg, report

        base = (self.src, self.dst)
        base_cap = _pow2(self.n_edges)
        delta_cap = max(self.delta_capacity, _pow2(n_delta))
        dv, moved = 0.0, 0.0
        read = shuffled = 0.0
        try:
            for pattern, coef in delta_terms(agg.kind, agg.n):
                tables = [delta if p else base for p in pattern]
                caps = [delta_cap if p else base_cap for p in pattern]
                res = self._submit(q, tables, caps)
                dv += coef * weighted_total(q, res.output) / agg.divisor
                moved += res.measured["total"]
                read += res.measured["read"]
                shuffled += res.measured["shuffled"]
        except IngestError:
            # Graceful degradation: a failed delta term (shed request,
            # injected fault, overflow) falls back to a full recompute
            # at the new edges — the maintained value stays exact, the
            # batch still applies, only the incremental saving is lost.
            new_agg = self._refresh(agg, new_edges)
            new_agg = dataclasses.replace(
                new_agg, deltas_applied=agg.deltas_applied + 1)
            spent = new_agg.delta_tuples - agg.delta_tuples
            self.engine.stats.degraded += 1
            self.engine.stats.delta_tuples += spent
            self.engine.stats.recompute_tuples += spent
            return new_agg, {"mode": "recompute_fallback",
                             "value": new_agg.value,
                             "read": 0.0, "shuffled": 0.0, "total": spent,
                             "recompute_cost": recompute_cost}
        new_agg = dataclasses.replace(
            agg, value=agg.value + dv, drift_rows=drift,
            deltas_applied=agg.deltas_applied + 1,
            delta_tuples=agg.delta_tuples + moved,
            recompute_tuples=agg.recompute_tuples + recompute_cost)
        self.engine.stats.delta_tuples += moved
        self.engine.stats.recompute_tuples += recompute_cost
        report = {"mode": "delta", "value": new_agg.value,
                  "read": read, "shuffled": shuffled, "total": moved,
                  "recompute_cost": recompute_cost}
        return new_agg, report
