"""Seeded chaos on the port: fault injection and lineage recovery.

Mirrors ``tests/test_resilience.py`` (the injector, torn hop snapshots,
cascade and one-round recovery, partition reads, the chaos matrix's
shuffle / partition_read / submit cells) and the join half of
``tests/test_fault_tolerance.py`` on ``repro_torch.resilience``, on
the CPU.  The invariant: a faulted run returns the fault-free answer
bit for bit or dies with a typed error.  Baselines are the port's own
plain executors (held to the JAX package by
``tests/test_torch_executor.py``); the seeded recovery costs are held
to the JAX package's ``BENCH_resilience.json`` pins by
``tests/test_torch_benchmarks.py``.  A compiled plan never fires a
fault and never draws from the injector's RNG — the port's stand-in
for the JAX package's tracer guard.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (DataCorrupt, latest_hop,  # noqa: E402
                                    load_hop, save_hop, save_partitioned)
from repro_torch.core import (JoinQuery, SimGrid,  # noqa: E402
                              default_query_caps, edge_relation,
                              integer_shares_query, jit_execute_query,
                              partition_relation, query_stats_exact,
                              query_table_inputs, verify_partition_layout)
from repro_torch.core.executor import (cascade_query,  # noqa: E402
                                       in_compiled_plan, one_round_query)
from repro_torch.resilience import (FaultInjector, FaultSpec,  # noqa: E402
                                    HopFailed, InjectedCrash,
                                    RecoveryPolicy, RecoveryReport,
                                    recovery_meta_for,
                                    resilient_cascade_query,
                                    resilient_load_partitioned,
                                    resilient_one_round_query)
from repro_torch.resilience import faults as faults_mod  # noqa: E402
from repro_torch.serving import (QueryEngine, QueryRequest,  # noqa: E402
                                 QueryServeConfig)

CHAOS_SEED = int(os.environ.get("CHAOS_SEED", "0"))
K = 4
CPU = "cpu"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the intra-op pool only oversubscribes the CPU under
    a parallel run (see ``tests/test_torch_skew.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(seed=5, m=48, nodes=24, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, nodes, m).astype(np.int32),
             rng.integers(0, nodes, m).astype(np.int32))
            for _ in range(n)]


def _rot_hop_npz(path):
    """Corrupt one array inside a hop snapshot's npz (a rewritten array,
    so the manifest CRC must mismatch)."""
    npz = os.path.join(path, "arrays.npz")
    with np.load(npz) as data:
        arrays = {k: np.array(data[k]) for k in data.files}
    k = sorted(arrays)[0]
    flat = arrays[k].reshape(-1)
    flat[0] = ~flat[0]
    np.savez(npz, **arrays)


def same_result(a, b) -> bool:
    """Output relation, every stat and the overflow flag equal, array
    for array."""
    (out_a, st_a, ovf_a), (out_b, st_b, ovf_b) = a[:3], b[:3]
    return (torch.equal(out_a.valid, out_b.valid)
            and sorted(out_a.cols) == sorted(out_b.cols)
            and all(torch.equal(c, out_b.cols[n])
                    for n, c in out_a.cols.items())
            and sorted(st_a) == sorted(st_b)
            and all(torch.equal(v, st_b[k]) for k, v in st_a.items())
            and torch.equal(ovf_a, ovf_b))


@pytest.fixture(scope="module")
def chain3():
    """The 3-chain workload in both physical configurations, with the
    plain executors' fault-free results as the bitwise baselines."""
    query = JoinQuery.chain(3)
    tables = _tables()
    stats = query_stats_exact(query, tables)
    or_shape = integer_shares_query(query.rel_dims(), stats.sizes, K)
    c_shape = (K,)
    w = {
        "query": query,
        "or_grid": SimGrid(or_shape),
        "c_grid": SimGrid(c_shape),
        "or_rels": query_table_inputs(query, tables, or_shape, device=CPU),
        "c_rels": query_table_inputs(query, tables, c_shape, device=CPU),
        "or_caps": default_query_caps(query, stats, or_shape, slack=8),
        "c_caps": default_query_caps(query, stats, c_shape, slack=8),
    }
    w["base_or"] = one_round_query(w["or_grid"], query, w["or_rels"],
                                   caps=w["or_caps"], join_order=(0, 1, 2))
    w["base_c"] = cascade_query(w["c_grid"], query, w["c_rels"],
                                caps=w["c_caps"], join_order=(0, 1, 2))
    return w


def run_cascade(w, snapshot_dir=None, policy=None):
    return resilient_cascade_query(
        w["c_grid"], w["query"], w["c_rels"], caps=w["c_caps"],
        join_order=(0, 1, 2), snapshot_dir=snapshot_dir, policy=policy)


def run_one_round(w, policy=None):
    return resilient_one_round_query(
        w["or_grid"], w["query"], w["or_rels"], caps=w["or_caps"],
        join_order=(0, 1, 2), policy=policy)


def assert_matches(base, got):
    assert same_result(base, got), "diverged from the fault-free run"
    return got[3]


# ---------------------------------------------------------------------------
# R1 — the injector itself
# ---------------------------------------------------------------------------

class TestInjector:
    def test_same_seed_same_faults(self):
        specs = [FaultSpec("shuffle", "crash", 0.5),
                 FaultSpec("shuffle", "delay", 0.3, delay_ms=0.0)]

        def drive(inj):
            log = []
            for _ in range(64):
                try:
                    inj("shuffle", None)
                    log.append("ok")
                except InjectedCrash:
                    log.append("crash")
            return log, dict(inj.fired)

        log_a, fired_a = drive(FaultInjector(specs, seed=CHAOS_SEED))
        log_b, fired_b = drive(FaultInjector(specs, seed=CHAOS_SEED))
        assert log_a == log_b and fired_a == fired_b
        assert fired_a[("shuffle", "crash")] > 0
        log_c, _ = drive(FaultInjector(specs, seed=CHAOS_SEED + 1))
        assert log_c != log_a, "different seed must replay differently"

    def test_compiled_plans_never_fire_or_consume_rng(self, chain3):
        """The port's stand-in for the JAX package's tracer guard: a
        ``jit_execute_query`` call (on the CPU, the cached eager run)
        offers its shuffles to no injector, so it neither fires nor
        draws; the same plan run eagerly fires at once."""
        inj = FaultInjector([FaultSpec("shuffle", "crash", 1.0)], seed=0)
        run = jit_execute_query(chain3["c_grid"], chain3["query"],
                                strategy="cascade", caps=chain3["c_caps"],
                                join_order=(0, 1, 2), donate=False)
        with inj:
            for _ in range(2):                     # first call and after
                assert same_result(run(chain3["c_rels"]), chain3["base_c"])
            assert inj.observed["shuffle"] == 0    # no RNG consumed
            assert not in_compiled_plan()
            with pytest.raises(InjectedCrash):
                cascade_query(chain3["c_grid"], chain3["query"],
                              chain3["c_rels"], caps=chain3["c_caps"],
                              join_order=(0, 1, 2))
        assert inj.observed["shuffle"] == 1

    def test_kill_switch_and_arming_delay(self):
        inj = FaultInjector([FaultSpec("shuffle", "crash", 1.0,
                                       max_fires=1, skip_first=2)], seed=0)
        outcomes = []
        for _ in range(5):
            try:
                inj("shuffle", None)
                outcomes.append("ok")
            except InjectedCrash:
                outcomes.append("crash")
        assert outcomes == ["ok", "ok", "crash", "ok", "ok"]

    def test_install_restores_clean_hooks(self):
        from repro_torch.checkpoint import store as ckpt_store
        from repro_torch.core import shuffle as shuffle_mod
        from repro_torch.serving import engine as engine_mod
        inj = FaultInjector([], seed=0)
        with inj:
            assert shuffle_mod._fault_hook is inj
            assert ckpt_store._fault_hook is inj
            assert engine_mod._fault_hook is inj
            assert faults_mod.active_injector() is inj
        assert shuffle_mod._fault_hook is None
        assert ckpt_store._fault_hook is None
        assert engine_mod._fault_hook is None
        assert faults_mod.active_injector() is None

    def test_corruption_is_always_detected(self):
        inj = FaultInjector([FaultSpec("partition_read", "corrupt", 1.0)],
                            seed=0)
        a = np.arange(8, dtype=np.int32)
        damaged = inj("partition_read", a)
        assert damaged.shape == a.shape and not np.array_equal(damaged, a)
        arrays = {"a": np.zeros(0, np.int32), "b": a}
        out = inj("partition_read", arrays)
        assert not np.array_equal(out["b"], a)     # first non-empty array
        inj2 = FaultInjector([FaultSpec("submit", "corrupt", 1.0)], seed=0)
        with pytest.raises(DataCorrupt):
            inj2("submit", object())

    def test_spec_validation(self):
        with pytest.raises(ValueError):
            FaultSpec("nowhere", "crash", 0.5)
        with pytest.raises(ValueError):
            FaultSpec("shuffle", "explode", 0.5)
        with pytest.raises(ValueError):
            FaultSpec("shuffle", "crash", 1.5)
        with pytest.raises(ValueError):
            FaultSpec("shuffle", "crash", 0.5, skip_first=-1)


# ---------------------------------------------------------------------------
# R2 — torn hop snapshots are skipped
# ---------------------------------------------------------------------------

class TestTornCheckpoints:
    def test_latest_hop_skips_torn(self, tmp_path, chain3):
        rel = chain3["c_rels"][0]
        save_hop(str(tmp_path), 0, rel, {"hop": 0})
        path1 = save_hop(str(tmp_path), 1, rel, {"hop": 1})
        _rot_hop_npz(path1)
        assert latest_hop(str(tmp_path)) == 0
        os.remove(os.path.join(path1, "arrays.npz"))   # half-written
        assert latest_hop(str(tmp_path)) == 0


# ---------------------------------------------------------------------------
# R3 — cascade recovery
# ---------------------------------------------------------------------------

class TestCascadeRecovery:
    def test_fault_free_bitwise_identical(self, chain3):
        rep = assert_matches(chain3["base_c"], run_cascade(chain3))
        assert rep.retries == 0 and rep.resumed_from is None

    def test_crash_storm_recovers_bitwise(self, chain3):
        with FaultInjector([FaultSpec("shuffle", "crash", 0.3)],
                           seed=CHAOS_SEED) as inj:
            got = run_cascade(chain3)
        rep = assert_matches(chain3["base_c"], got)
        if inj.fired[("shuffle", "crash")]:
            assert rep.retries == inj.fired[("shuffle", "crash")]
            assert rep.recovery_total > 0

    def test_killed_process_resumes_from_snapshot(self, chain3, tmp_path):
        snap = str(tmp_path / "hops")
        # Armed after hop_0's two shuffle opportunities: hop_1 dies every
        # attempt, but hop_0's snapshot survives the "process".
        with FaultInjector([FaultSpec("shuffle", "crash", 1.0,
                                      skip_first=2)], seed=CHAOS_SEED):
            with pytest.raises(HopFailed) as ei:
                run_cascade(chain3, snapshot_dir=snap)
        assert ei.value.where == "hop_1"
        assert latest_hop(snap) == 0

        got = run_cascade(chain3, snapshot_dir=snap)   # the restarted process
        rep = assert_matches(chain3["base_c"], got)
        assert rep.resumed_from == 0 and rep.retries == 0

    def test_corrupt_snapshot_quarantined(self, chain3, tmp_path):
        snap = str(tmp_path / "hops")
        *_, rep = run_cascade(chain3, snapshot_dir=snap)
        assert rep.snapshots_written == 1
        _rot_hop_npz(os.path.join(snap, "step_0"))

        got = run_cascade(chain3, snapshot_dir=snap)
        rep2 = assert_matches(chain3["base_c"], got)
        assert rep2.resumed_from is None           # never resumed from rot
        assert any("step_0" in q for q in rep2.quarantined)

    def test_retry_budget_exhaustion_is_typed(self, chain3):
        policy = RecoveryPolicy(max_attempts=2, backoff_base_ms=0.0)
        with FaultInjector([FaultSpec("shuffle", "crash", 1.0)],
                           seed=CHAOS_SEED):
            with pytest.raises(HopFailed) as ei:
                run_cascade(chain3, policy=policy)
        assert ei.value.attempts == 2
        assert isinstance(ei.value.last, InjectedCrash)

    def test_aggregated_cascade_recovers_bitwise(self, chain3):
        """2,3JA-shaped (a charged final Γ): fault-free and faulted runs
        equal the plain cascade."""
        query = JoinQuery.chain(3, aggregate=True)
        tables = _tables()
        rels = query_table_inputs(query, tables, (K,), device=CPU)
        caps = default_query_caps(query, query_stats_exact(query, tables),
                                  (K,), slack=8)
        base = cascade_query(chain3["c_grid"], query, rels, caps=caps)
        run = lambda: resilient_cascade_query(  # noqa: E731
            chain3["c_grid"], query, rels, caps=caps)
        assert_matches(base, run())
        with FaultInjector([FaultSpec("shuffle", "crash", 0.3)],
                           seed=CHAOS_SEED + 3):
            assert_matches(base, run())


class TestJoinHopCheckpoints:
    """``tests/test_fault_tolerance.py``'s join half: a killed 4-chain
    cascade resumes from its newest intact hop snapshot, bit-identical
    to the uninterrupted run."""

    def test_killed_cascade_resumes_bitwise(self, tmp_path):
        query = JoinQuery.chain(4)
        rng = np.random.default_rng(11)
        tables = [(rng.integers(0, 20, 40).astype(np.int32),
                   rng.integers(0, 20, 40).astype(np.int32))
                  for _ in range(4)]
        stats = query_stats_exact(query, tables)
        grid = SimGrid((K,))
        rels = query_table_inputs(query, tables, (K,), device=CPU)
        caps = default_query_caps(query, stats, (K,), slack=8)
        base = cascade_query(grid, query, rels, caps=caps,
                             join_order=(0, 1, 2, 3))
        snap = str(tmp_path / "hops")
        with FaultInjector([FaultSpec("shuffle", "crash", 1.0,
                                      skip_first=5)], seed=3):
            with pytest.raises(HopFailed) as ei:
                resilient_cascade_query(grid, query, rels, caps=caps,
                                        join_order=(0, 1, 2, 3),
                                        snapshot_dir=snap)
        assert ei.value.where == "hop_2"
        assert latest_hop(snap) == 1
        _, extra = load_hop(snap, 1, device=CPU)
        assert extra["hop"] == 1
        got = resilient_cascade_query(grid, query, rels, caps=caps,
                                      join_order=(0, 1, 2, 3),
                                      snapshot_dir=snap)
        assert got[3].resumed_from == 1 and got[3].retries == 0
        assert same_result(base, got)


# ---------------------------------------------------------------------------
# R4 — one-round recovery
# ---------------------------------------------------------------------------

class TestOneRoundRecovery:
    def test_fault_free_bitwise_identical(self, chain3):
        rep = assert_matches(chain3["base_or"], run_one_round(chain3))
        assert rep.retries == 0 and rep.failed_reducers == 0

    def test_failed_reducers_splice_bitwise(self, chain3):
        with FaultInjector([FaultSpec("reducer", "crash", 0.3)],
                           seed=CHAOS_SEED) as inj:
            got = run_one_round(chain3)
        rep = assert_matches(chain3["base_or"], got)
        assert rep.failed_reducers == inj.fired[("reducer", "crash")]
        if rep.failed_reducers:
            assert rep.recovery_read > 0

    def test_placement_crash_retried(self, chain3):
        with FaultInjector([FaultSpec("shuffle", "crash", 1.0,
                                      max_fires=1)], seed=CHAOS_SEED) as inj:
            got = run_one_round(chain3)
        rep = assert_matches(chain3["base_or"], got)
        assert inj.fired[("shuffle", "crash")] == 1
        assert rep.retries == 1

    def test_laned_grid_reducer_rerun_is_per_lane_exact(self, chain3):
        """On ``SimGrid(shape, lanes=2)`` a failed coordinate re-runs for
        both lanes; each lane equals its own plain run."""
        query, shape = chain3["query"], chain3["or_grid"].shape
        other = query_table_inputs(query, _tables(seed=9), shape, device=CPU)
        stacked = [type(a)({n: torch.stack([a.cols[n], b.cols[n]])
                            for n in a.cols},
                           torch.stack([a.valid, b.valid]))
                   for a, b in zip(chain3["or_rels"], other)]
        laned = SimGrid(shape, lanes=2)
        with FaultInjector([FaultSpec("reducer", "crash", 0.5)],
                           seed=CHAOS_SEED):
            out, st, ovf, rep = resilient_one_round_query(
                laned, query, stacked, caps=chain3["or_caps"],
                join_order=(0, 1, 2))
        assert rep.failed_reducers > 0 and ovf.shape == (2,)
        base_b = one_round_query(chain3["or_grid"], query, other,
                                 caps=chain3["or_caps"],
                                 join_order=(0, 1, 2))
        for lane, base in enumerate((chain3["base_or"], base_b)):
            got = (out.map(lambda t, i=lane: t[i]),
                   {k: v[lane] for k, v in st.items()}, ovf[lane])
            assert same_result(base, got)


# ---------------------------------------------------------------------------
# R5 — partition reads
# ---------------------------------------------------------------------------

def _store(tmp_path):
    rng = np.random.default_rng(3)
    rel = edge_relation(rng.integers(0, 30, 64).astype(np.int32),
                        rng.integers(0, 30, 64).astype(np.int32), device=CPU)
    prel, _ = partition_relation(rel, "a", K, salt=1)
    save_partitioned(str(tmp_path), "edges", prel)
    return str(tmp_path), prel


def same_parts(a, b) -> bool:
    return (torch.equal(a.valid, b.valid)
            and all(torch.equal(c, b.cols[n]) for n, c in a.cols.items()))


class TestPartitionRead:
    def test_corrupt_read_retried_bitwise(self, tmp_path):
        d, prel = _store(tmp_path)
        with FaultInjector([FaultSpec("partition_read", "corrupt", 1.0,
                                      max_fires=2)], seed=CHAOS_SEED) as inj:
            got = resilient_load_partitioned(d, "edges", device=CPU)
        assert inj.fired[("partition_read", "corrupt")] == 2
        assert same_parts(got.parts, prel.parts)

    def test_exhaustion_quarantines(self, tmp_path):
        d, _ = _store(tmp_path)
        report = RecoveryReport(strategy="partition_read")
        policy = RecoveryPolicy(max_attempts=2, backoff_base_ms=0.0)
        with FaultInjector([FaultSpec("partition_read", "crash", 1.0)],
                           seed=CHAOS_SEED):
            with pytest.raises(HopFailed):
                resilient_load_partitioned(d, "edges", policy=policy,
                                           report=report, device=CPU)
        assert report.quarantined == [os.path.join(d, "edges")]

    def test_layout_audit_above_crcs(self, tmp_path):
        _, prel = _store(tmp_path)
        assert verify_partition_layout(prel)
        lying = dataclasses.replace(
            prel, spec=dataclasses.replace(prel.spec, salt=7))
        assert not verify_partition_layout(lying)


# ---------------------------------------------------------------------------
# R8 — the chaos matrix
# ---------------------------------------------------------------------------

def _req(seed=7):
    q = JoinQuery.triangle()
    rng = np.random.default_rng(seed)
    e = (rng.integers(0, 12, 40), rng.integers(0, 12, 40))
    tables = [e] * 3
    return QueryRequest(q, tables, stats=query_stats_exact(q, tables))


class TestChaosMatrix:
    """Exact equality or typed error, across every (kind, site) cell."""

    @pytest.mark.parametrize("kind", ["crash", "delay", "corrupt"])
    def test_shuffle_site(self, chain3, kind):
        spec = FaultSpec("shuffle", kind, 0.3, delay_ms=0.1)
        try:
            with FaultInjector([spec], seed=CHAOS_SEED):
                got = run_cascade(chain3)
        except HopFailed:
            return                                   # typed, never wrong
        assert_matches(chain3["base_c"], got)

    @pytest.mark.parametrize("kind", ["crash", "delay", "corrupt"])
    def test_partition_read_site(self, tmp_path, kind):
        d, prel = _store(tmp_path)
        spec = FaultSpec("partition_read", kind, 0.5, delay_ms=0.1)
        try:
            with FaultInjector([spec], seed=CHAOS_SEED):
                got = resilient_load_partitioned(d, "edges", device=CPU)
        except HopFailed:
            return
        assert same_parts(got.parts, prel.parts)

    @pytest.mark.parametrize("kind", ["crash", "delay", "corrupt"])
    def test_submit_site(self, kind):
        eng = QueryEngine(QueryServeConfig(k=K, submit_retries=2),
                          device=CPU)
        base = QueryEngine(QueryServeConfig(k=K), device=CPU).submit_many(
            [_req(50)])[0]
        assert base.ok
        spec = FaultSpec("submit", kind, 0.5, delay_ms=0.1)
        with FaultInjector([spec], seed=CHAOS_SEED):
            res = eng.submit_many([_req(50)])[0]
        if res.ok:
            assert same_result((res.output, {}, torch.tensor(False)),
                               (base.output, {}, torch.tensor(False)))
            assert res.measured == base.measured
        else:
            assert res.error_kind in ("fault", "deadline")
            assert res.output is None


def test_recovery_meta_covers_every_nonfinal_hop():
    from repro_torch.analysis import verify_recovery_meta
    meta = recovery_meta_for("cascade", 4)
    assert meta.snapshot_hops == (0, 1)
    assert verify_recovery_meta(meta).ok
    gap = dataclasses.replace(meta, snapshot_hops=(0,))
    assert [f.code for f in verify_recovery_meta(gap).findings] == \
        ["RECOVERY_GAP"]
    assert recovery_meta_for("one_round", 3).n_hops == 0
