"""Lineage-based recovery: resilient executors over the fault sites.

Port of ``src/repro/resilience/recovery.py``.  The rounds-vs-replication
trade-off (Afrati–Ullman) has a recovery-granularity shadow:

* a **cascade** materializes an intermediate per hop, so a killed hop
  re-executes *from its inputs* — the previous hop's output, restored
  from a CRC-verified snapshot if the process itself died;
* a **one-round Shares** join has no intermediates to restore, but its
  reduce phase is embarrassingly parallel over reducer coordinates —
  a failed reducer re-runs *alone* from its placed input shards while
  every surviving bucket's output is kept.

Both executors here run the exact lowering of
:mod:`repro_torch.core.executor` — same hops, same salts, same kernels,
same accounting — eagerly (hop by hop) so the fault hooks fire and each
recovery unit is a host-visible step.  A fault-free resilient run is
bit-identical to the plain executor, and a faulted run is bit-identical
to the fault-free one or dies with a typed
:class:`~repro_torch.resilience.faults.HopFailed` — never a wrong
answer.  The package is host-driven by design: a unit's cost is read on
the host (``float``) between steps.  On a laned
:class:`~repro_torch.core.shuffle.SimGrid` a reducer coordinate re-runs
for every lane at once.

Retries take capped exponential backoff (:class:`RecoveryPolicy`);
corrupt artifacts are quarantined (recorded and skipped, never retried
forever); every recovery action is counted in a
:class:`RecoveryReport` whose ``recovery_read`` / ``recovery_shuffled``
charge re-executed work in the paper's tuple units — the cost surface
``benchmarks/resilience_sweep_torch.py`` sweeps against the fault rate.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    TypeVar)

import torch

from ..checkpoint.store import (DataCorrupt, latest_hop, load_hop,
                                load_partitioned, save_hop)
from ..core.aggregation import distributed_groupby_sum, project_product
from ..core.executor import (ChainCaps, _count, _false, _final_aggregate,
                             cascade_hop, merge_stats, place_relation,
                             reduce_side_fn)
from ..core.plan import JoinQuery
from ..core.relation import Relation
from ..core.shuffle import Grid
from . import faults
from .faults import HopFailed, InjectedCrash

__all__ = ["RecoveryPolicy", "RecoveryMeta", "RecoveryReport",
           "resilient_cascade_query", "resilient_one_round_query",
           "resilient_load_partitioned", "recovery_meta_for"]

Stats = Dict[str, torch.Tensor]
T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """How hard to try before a typed failure.

    max_attempts:     total tries per recovery unit (1 = no retry).
    backoff_base_ms:  sleep before the first retry...
    backoff_factor:   ...multiplied per further retry...
    backoff_cap_ms:   ...and never above this cap.
    materialize_hops: cascade hops snapshot their intermediate to the
                      checkpoint store (when a snapshot directory is
                      given) so a killed *process* resumes from the
                      last intact hop instead of hop 0.
    """

    max_attempts: int = 4
    backoff_base_ms: float = 1.0
    backoff_factor: float = 2.0
    backoff_cap_ms: float = 50.0
    materialize_hops: bool = True

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")


@dataclasses.dataclass(frozen=True)
class RecoveryMeta:
    """Recovery metadata attached to a plan — what the static verifier
    pass (:func:`repro_torch.analysis.verify_recovery_meta`) checks for
    coverage: every
    non-final cascade hop must carry a recovery point
    (``snapshot_hops``) or an explicit opt-out with a reason.

    ``n_hops`` is the number of join steps (N−1 for an N-relation
    cascade; 0 for one-round Shares, whose recovery unit is the reducer
    bucket, not a hop)."""

    strategy: str
    n_hops: int
    snapshot_hops: Tuple[int, ...] = ()
    opt_out: Tuple[int, ...] = ()
    opt_out_reason: str = ""
    max_attempts: int = 4
    backoff_cap_ms: float = 50.0


def recovery_meta_for(strategy: str, n_relations: int,
                      policy: Optional[RecoveryPolicy] = None, *,
                      opt_out: Sequence[int] = (),
                      opt_out_reason: str = "") -> RecoveryMeta:
    """The metadata the resilient executors actually implement: full
    snapshot coverage of every non-final hop for cascades (minus
    explicit opt-outs), reducer-granular recovery for one-round."""
    policy = policy or RecoveryPolicy()
    n_hops = 0 if strategy == "one_round" else max(n_relations - 1, 0)
    out = tuple(sorted(set(int(h) for h in opt_out)))
    snaps = tuple(h for h in range(max(n_hops - 1, 0)) if h not in out)
    return RecoveryMeta(strategy=strategy, n_hops=n_hops,
                        snapshot_hops=snaps, opt_out=out,
                        opt_out_reason=opt_out_reason,
                        max_attempts=policy.max_attempts,
                        backoff_cap_ms=policy.backoff_cap_ms)


@dataclasses.dataclass
class RecoveryReport:
    """What recovery did and what it cost (tuple units, deterministic
    under a seeded injector — the sweep pins these).

    attempts[unit]:  tries the unit took (1 = clean first try).
    retries:         total failed attempts across all units.
    recovery_read / recovery_shuffled: tuples re-read / re-shuffled by
                     failed attempts — the recovery cost the sweep
                     plots against fault rate per strategy.
    snapshots_written / resumed_from: cascade materialization activity.
    failed_reducers: one-round buckets that were re-run alone.
    quarantined:     artifacts recorded as corrupt and skipped.
    """

    strategy: str
    attempts: Dict[str, int] = dataclasses.field(default_factory=dict)
    retries: int = 0
    recovery_read: float = 0.0
    recovery_shuffled: float = 0.0
    snapshots_written: int = 0
    resumed_from: Optional[int] = None
    failed_reducers: int = 0
    quarantined: List[str] = dataclasses.field(default_factory=list)

    @property
    def recovery_total(self) -> float:
        return self.recovery_read + self.recovery_shuffled

    def to_json(self) -> Dict[str, Any]:
        return {
            "strategy": self.strategy,
            "retries": int(self.retries),
            "failed_reducers": int(self.failed_reducers),
            "snapshots_written": int(self.snapshots_written),
            "resumed_from": self.resumed_from,
            "quarantined": list(self.quarantined),
            # Nested under "recovery" so the pinned-accounting gate
            # (tests/test_bench_accounting.py) captures the read/
            # shuffled/total keys at this path bit-identically.
            "recovery": {"read": float(self.recovery_read),
                         "shuffled": float(self.recovery_shuffled),
                         "total": float(self.recovery_total)},
        }


def _retry(policy: RecoveryPolicy, where: str,
           attempt: Callable[[], T], report: RecoveryReport,
           charge: Optional[Callable[[T], Tuple[float, float]]] = None) -> T:
    """Run one recovery unit with capped exponential backoff.  On
    success after f failed tries, charge f × (read, shuffled) of the
    successful attempt as recovery cost (each failed try re-read the
    unit's inputs).  Exhaustion raises the typed :class:`HopFailed`."""
    delay_ms = policy.backoff_base_ms
    last: Optional[BaseException] = None
    for n in range(1, policy.max_attempts + 1):
        try:
            out = attempt()
            report.attempts[where] = n
            if n > 1 and charge is not None:
                read, shuffled = charge(out)
                report.recovery_read += (n - 1) * read
                report.recovery_shuffled += (n - 1) * shuffled
            return out
        except (InjectedCrash, DataCorrupt) as e:
            last = e
            report.retries += 1
            if n < policy.max_attempts:
                time.sleep(min(delay_ms, policy.backoff_cap_ms) * 1e-3)
                delay_ms *= policy.backoff_factor
    report.attempts[where] = policy.max_attempts
    assert last is not None
    raise HopFailed(where, policy.max_attempts, last)


def _scan_quarantine(snapshot_dir: Optional[str],
                     report: RecoveryReport) -> None:
    """Record torn/corrupt snapshots under ``snapshot_dir`` — they are
    skipped by :func:`~repro_torch.checkpoint.store.latest_hop`, and the
    report makes the skip visible instead of silent."""
    import os
    from ..checkpoint.store import _hop_intact
    if snapshot_dir is None or not os.path.isdir(snapshot_dir):
        return
    for name in sorted(os.listdir(snapshot_dir)):
        if not name.startswith("step_") or name.endswith((".tmp", ".old")):
            continue
        path = os.path.join(snapshot_dir, name)
        if not _hop_intact(path):
            report.quarantined.append(path)


# ---------------------------------------------------------------------------
# Cascade: hop-granular lineage recovery with materialized intermediates
# ---------------------------------------------------------------------------

def _units(st: Stats) -> Tuple[float, float]:
    """A unit's (read, shuffled) tuples on the host, summed over lanes."""
    return float(st["read"].sum()), float(st["shuffled"].sum())


def resilient_cascade_query(grid: Grid, query: JoinQuery,
                            rels: Sequence[Relation], *,
                            caps: ChainCaps,
                            policy: Optional[RecoveryPolicy] = None,
                            join_order: Optional[Sequence[int]] = None,
                            join_impl: str = "sort_merge",
                            local_combine: bool = False,
                            snapshot_dir: Optional[str] = None,
                            ) -> Tuple[Relation, Stats, torch.Tensor,
                                       RecoveryReport]:
    """:func:`repro_torch.core.executor.cascade_query`, executed hop by
    hop with lineage recovery — same rounds, salts, kernels, and
    accounting, so a fault-free run is bit-identical to the plain
    cascade.

    Each hop (a :func:`~repro_torch.core.executor.cascade_hop` round,
    cycle-closing filters included) retries from its in-memory input on
    an injected crash or detected corruption; with ``snapshot_dir`` and
    ``policy.materialize_hops`` every non-final hop's output is also
    materialized as a CRC-verified atomic snapshot, and a *fresh call*
    over the same inputs resumes from the newest intact snapshot,
    restored onto the inputs' device.  Returns (result, stats,
    overflow, recovery report).
    """
    policy = policy or RecoveryPolicy()
    report = RecoveryReport(strategy="cascade")
    n = query.n_relations
    query.check_relations(rels)
    agg = query.aggregate
    order = tuple(join_order) if join_order is not None \
        else query.default_join_order()
    steps = query.join_steps(order)
    materialize = policy.materialize_hops and snapshot_dir is not None
    device = rels[0].device

    acc_stats: Stats = {}
    overflow = _false(rels[order[0]], grid.lead)
    left = rels[order[0]]
    left_cap: Optional[int] = None
    value_cols: List[str] = \
        [query.values[order[0]]] if query.values[order[0]] else []
    start = 0

    if materialize:
        _scan_quarantine(snapshot_dir, report)
        latest = latest_hop(snapshot_dir)
        if latest is not None:
            left, extra = load_hop(snapshot_dir, latest, device=device)
            acc_stats = {k: torch.as_tensor(v, dtype=torch.float32,
                                            device=device)
                         for k, v in extra["stats"].items()}
            overflow = torch.as_tensor(extra["overflow"], dtype=torch.bool,
                                       device=device)
            left_cap = extra["left_cap"]
            value_cols = list(extra["value_cols"])
            start = latest + 1
            report.resumed_from = latest

    for i in range(start, len(steps)):
        j, key, extras = steps[i]

        def attempt(left=left, j=j, key=key, extras=extras, i=i,
                    left_cap=left_cap):
            return cascade_hop(grid, left, rels[j], key, extras, i=i,
                               last=i == n - 2, left_cap=left_cap,
                               caps=caps, join_impl=join_impl)

        left, st, ovf, left_cap = _retry(policy, f"hop_{i}", attempt, report,
                                         charge=lambda out: _units(out[1]))
        acc_stats = merge_stats(acc_stats, st) if acc_stats \
            else merge_stats(st)
        overflow = overflow | ovf
        if query.values[j]:
            value_cols.append(query.values[j])

        if materialize and i < len(steps) - 1:
            extra = {"hop": i,
                     "stats": {k: v.tolist() for k, v in acc_stats.items()},
                     "overflow": overflow.tolist(),
                     "left_cap": left_cap,
                     "value_cols": list(value_cols)}
            save_hop(snapshot_dir, i, left, extra)
            report.snapshots_written += 1

    if agg is not None:
        def agg_attempt(left=left, value_cols=tuple(value_cols)):
            return _final_aggregate(grid, query, left, list(value_cols),
                                    caps, local_combine)

        left, st_f, ovf_f = _retry(policy, "final_agg", agg_attempt, report,
                                   charge=lambda out: _units(out[1]))
        overflow = overflow | ovf_f
        acc_stats = merge_stats(acc_stats, st_f)

    return left, acc_stats, overflow, report


# ---------------------------------------------------------------------------
# One-round Shares: reducer-granular recovery
# ---------------------------------------------------------------------------

def resilient_one_round_query(grid: Grid, query: JoinQuery,
                              rels: Sequence[Relation], *,
                              caps: ChainCaps,
                              policy: Optional[RecoveryPolicy] = None,
                              join_order: Optional[Sequence[int]] = None,
                              join_impl: str = "sort_merge",
                              ) -> Tuple[Relation, Stats, torch.Tensor,
                                         RecoveryReport]:
    """:func:`repro_torch.core.executor.one_round_query` with MapReduce's
    native recovery granularity.

    Placement (the map phase) retries per relation from the original
    input.  The reduce phase offers the injector one opportunity per
    reducer coordinate (site ``"reducer"``); a failed reducer's bucket
    is re-executed *alone* on its placed shards and spliced into the
    surviving grid output: no intermediate exists to restore, but only
    1/K of the reduce work repeats.  Recovery cost charges the failed
    reducer's resident tuples (its placed inputs, re-read per retry).
    Returns (result, stats, overflow, recovery report).
    """
    policy = policy or RecoveryPolicy()
    report = RecoveryReport(strategy="one_round")
    n = query.n_relations
    query.check_relations(rels)
    ndims = query.n_dims
    if len(grid.shape) != ndims:
        raise ValueError(f"a {n}-relation query needs a rank-{ndims} grid, "
                         f"got shape {grid.shape}")

    read = sum(_count(grid, r) for r in rels)
    overflow = _false(rels[0], grid.lead)

    placed: List[Relation] = []
    for j, rel in enumerate(rels):
        def attempt(j=j, rel=rel):
            return place_relation(grid, query, j, rel, caps=caps)

        # The charge is read only after a retry, so a clean placement
        # never waits on the device.
        cur, ovf, _ = _retry(
            policy, f"placement_{j}", attempt, report,
            charge=lambda out, rel=rel: (float(_count(grid, rel).sum()),
                                         float(_count(grid, out[0]).sum())))
        overflow = overflow | ovf
        placed.append(cur)

    order = tuple(join_order) if join_order is not None \
        else query.default_join_order()
    reduce_side = reduce_side_fn(query, order, caps=caps,
                                 join_impl=join_impl)

    # Optimistic full reduce pass, then seeded per-reducer failures.
    joined, ovf_j = reduce_side(*placed)
    failed: List[Tuple[int, ...]] = []
    for coord in itertools.product(*[range(s) for s in grid.shape]):
        try:
            faults.fire("reducer", coord)
        except (InjectedCrash, DataCorrupt):
            failed.append(coord)

    lanes = (slice(None),) * grid.lead
    for coord in failed:
        at = lanes + coord
        shards = [p.map(lambda x, at=at: x[at]) for p in placed]
        resident = float(sum(float(s.valid.sum()) for s in shards))

        def attempt(shards=shards):
            return reduce_side(*shards)

        acc, ovf_c = _retry(
            policy, f"reducer_{coord}", attempt, report,
            charge=lambda out, r=resident: (r, 0.0))
        # The failed bucket re-read its resident shards once even on a
        # clean first retry — charge the re-execution itself too.
        report.recovery_read += resident
        report.failed_reducers += 1
        joined = _splice(joined, acc, at)
        ovf_j = ovf_j.clone()
        ovf_j[at] = ovf_c

    overflow = overflow | grid.reduce_any(ovf_j)
    received = sum(_count(grid, p) for p in placed)
    stats: Stats = {
        "read": read.to(torch.float32),
        "shuffled": received.to(torch.float32),
    }

    if query.aggregate is None:
        return joined, stats, overflow, report

    agg = query.aggregate
    join_cap = caps.join if caps.join else caps.out

    def agg_attempt(joined=joined):
        proj = project_product(grid, joined, keys=agg.keys,
                               value_cols=[v for v in query.values],
                               out_name=agg.out)
        return distributed_groupby_sum(
            grid, proj, keys=agg.keys, value=agg.out,
            recv_capacity=join_cap, out_capacity=caps.out,
            local_capacity=join_cap)

    out, st_a, ovf_a = _retry(policy, "final_agg", agg_attempt, report,
                              charge=lambda o: _units(o[1]))
    return out, merge_stats(stats, st_a), overflow | ovf_a, report


def _splice(full: Relation, one: Relation, at) -> Relation:
    """``full`` with the device at index ``at`` replaced by ``one`` (a
    copy: the optimistic pass's tensors are left as they were)."""
    def put(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        dst = dst.clone()
        dst[at] = src
        return dst
    return Relation({n: put(c, one.cols[n]) for n, c in full.cols.items()},
                    put(full.valid, one.valid))


# ---------------------------------------------------------------------------
# Partition reads: retry + quarantine
# ---------------------------------------------------------------------------

def resilient_load_partitioned(directory: str, name: str, *,
                               policy: Optional[RecoveryPolicy] = None,
                               report: Optional[RecoveryReport] = None,
                               device=None):
    """:func:`repro_torch.checkpoint.load_partitioned` (onto ``device``,
    default the GPU) under the retry policy: transient faults (injected
    crashes, corruption caught by the store's CRCs, and semantic layout
    violations caught by
    :func:`~repro_torch.core.partition.verify_partition_layout` above
    the CRCs) re-read; exhaustion quarantines the relation (recorded in
    the report) and raises the typed
    :class:`~repro_torch.resilience.faults.HopFailed`."""
    import os

    from ..core.partition import verify_partition_layout

    policy = policy or RecoveryPolicy()
    report = report if report is not None \
        else RecoveryReport(strategy="partition_read")

    def attempt():
        prel = load_partitioned(directory, name, device=device)
        if not verify_partition_layout(prel):
            raise DataCorrupt(os.path.join(directory, name),
                              detail="partition layout invariant violated "
                                     "after a CRC-clean read")
        return prel

    try:
        prel = _retry(policy, f"partition_read:{name}", attempt, report,
                      charge=lambda p: (float(p.count()), 0.0))
    except HopFailed:
        report.quarantined.append(os.path.join(directory, name))
        raise
    return prel
