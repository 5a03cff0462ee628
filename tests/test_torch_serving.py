"""The port's query-serving engine and plan verifier, on the CPU.

Mirrors ``tests/test_serving.py`` S1–S3 and ``tests/test_resilience.py``
R6 (admission control, the circuit breaker) and R7's stale-certificate
degradation against ``repro_torch.serving.QueryEngine(cfg,
device="cpu")``:

  parity  one solo triangle request and one 3-tenant batch (k = 4, 16
          nodes, 110 edges: ``benchmarks/serving_sweep.py``'s widths)
          through both packages' engines — per-lane outputs as full
          arrays, measured stats, plans, one batch each; the solo
          request holds the port's ``jit_execute_query`` to the JAX
          package's
  S1      cache-key discipline — identical resubmission hits; every
          option flip misses
  S2      LRU semantics — bounded size, eviction order, touch-refreshes
  S3      batching — same-program same-shape tenants run as ONE laned
          execution; a poisoned request or an overflowing lane fails
          alone
  R6      queue shedding, deadlines, SLO shedding, submit-site faults
          (a plain hook function through ``set_fault_hook``), the
          plan/compile circuit breaker
  R7      a current map-side certificate serves the exact answer over
          prebuilt stored partitions (solo, cached, and two tenants in
          one laned execution); a stale one serves it through the
          cascade, prebuilt partitions flattened back
  V       the verifier copies' findings equal the JAX verifier's
  x64     a torch-only subprocess: the key dtype keys the cache
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.analysis as JA  # noqa: E402
import repro.core as J  # noqa: E402
import repro.serving as JS  # noqa: E402
import repro_torch.analysis as TA  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.serving import (QueryEngine, QueryRequest,  # noqa: E402
                                 QueryServeConfig, engine as engine_mod,
                                 set_fault_hook, stats_signature,
                                 weighted_total)

ROOT = Path(__file__).resolve().parents[1]
K = 4
N_NODES, M_EDGES = 16, 110           # benchmarks/serving_sweep.py
ORDER = (0, 1, 2)


def unique_edges(seed, n_nodes=N_NODES, m=M_EDGES):
    rng = np.random.default_rng(seed)
    seen = set()
    while len(seen) < m:
        seen.add((int(rng.integers(0, n_nodes)),
                  int(rng.integers(0, n_nodes))))
    arr = np.array(sorted(seen))
    return arr[:, 0], arr[:, 1]


def _edges(seed, n_nodes=12, m=60):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n_nodes, m), rng.integers(0, n_nodes, m)


def cpu_engine(**kw):
    return QueryEngine(QueryServeConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def engine():
    return cpu_engine(k=K, cache_capacity=64)


# ---------------------------------------------------------------------------
# Parity with the JAX engine
# ---------------------------------------------------------------------------

def _requests(core, request_type, seeds):
    q = core.JoinQuery.triangle()
    reqs = []
    for s in seeds:
        tables = [unique_edges(s)] * 3
        reqs.append(request_type(q, tables,
                                 stats=core.query_stats_exact(q, tables),
                                 strategy="cascade", join_order=ORDER))
    return reqs


@pytest.fixture(scope="module")
def parity():
    """Each engine's results for one solo request and one 3-tenant
    batch (in that order), and the batch's count of executions."""
    out = {}
    for name, eng, core, request_type in (
            ("jax", JS.QueryEngine(JS.QueryServeConfig(k=K)), J,
             JS.QueryRequest),
            ("port", cpu_engine(k=K), T, QueryRequest)):
        solo = eng.submit_many(_requests(core, request_type, [0]))
        before = eng.stats.batches
        batch = eng.submit_many(_requests(core, request_type,
                                          [100, 101, 102]))
        out[name] = (solo + batch, eng.stats.batches - before)
    return out


def test_engine_matches_jax_per_lane(parity):
    (j_res, j_batches), (t_res, t_batches) = parity["jax"], parity["port"]
    assert j_batches == t_batches == 1
    for seed, jr, tr in zip((0, 100, 101, 102), j_res, t_res):
        assert jr.ok and tr.ok, tr.error
        assert tr.measured == jr.measured
        assert dataclasses.asdict(tr.plan) == dataclasses.asdict(jr.plan)
        np.testing.assert_array_equal(tr.output.valid.numpy(),
                                      np.asarray(jr.output.valid))
        assert sorted(tr.output.cols) == sorted(jr.output.cols)
        for n, c in tr.output.cols.items():
            np.testing.assert_array_equal(c.numpy(),
                                          np.asarray(jr.output.cols[n]))
        src, dst = unique_edges(seed)
        tq = T.JoinQuery.triangle()
        assert weighted_total(tq, tr.output) / 3 == \
            T.oracle_triangles(src, dst)
        stats = T.query_stats_exact(tq, [(src, dst)] * 3)
        idx = stats.orders.index(ORDER)
        assert tr.measured["total"] == T.cost_query_cascade(
            list(stats.sizes), stats.intermediates[idx])


# ---------------------------------------------------------------------------
# S1 — cache-key discipline
# ---------------------------------------------------------------------------

def certificate(salt=1, key_dtype="int32"):
    cq = T.ChainQuery.chain(3)
    return T.chain_partitioning(cq, [
        T.PartitionSpec(cq.attrs[1] if j == 0 else cq.attrs[j], 4,
                        salt=salt, key_dtype=key_dtype) for j in range(3)])


class TestCacheKey:
    def setup_method(self):
        self.eng = cpu_engine(k=K, quantize_caps=False)
        self.q = T.JoinQuery.triangle()
        self.stats = T.query_stats_exact(self.q, [_edges(0)] * 3)

    def test_identical_resubmission_hits(self):
        k1 = self.eng.cache_key(self.q, self.stats)
        assert self.eng.cache_key(self.q, self.stats) == k1
        other = T.query_stats_exact(self.q, [_edges(0)] * 3)
        assert stats_signature(other) == stats_signature(self.stats)
        assert self.eng.cache_key(self.q, other) == k1

    def test_every_flip_misses(self):
        base = self.eng.cache_key(self.q, self.stats)
        flips = {
            "caps": self.eng.cache_key(self.q, self.stats,
                                       T.ChainCaps(recv=64, mid=128, out=256)),
            "stats": self.eng.cache_key(
                self.q, T.query_stats_exact(self.q, [_edges(1)] * 3)),
            "strategy": self.eng.cache_key(self.q, self.stats,
                                           strategy="one_round"),
            "join_order": self.eng.cache_key(self.q, self.stats,
                                             join_order=(2, 1, 0)),
            "partitioning": self.eng.cache_key(self.q, self.stats,
                                               partitioning=certificate()),
            "key_dtype": self.eng.cache_key(self.q, self.stats,
                                            key_dtype="int64"),
            "query": self.eng.cache_key(T.JoinQuery.cycle(4), self.stats),
        }
        for name, key in flips.items():
            assert key != base, f"flipping {name} must change the cache key"
        assert cpu_engine(k=8, quantize_caps=False).cache_key(
            self.q, self.stats) != base
        assert cpu_engine(k=K, join_impl="all_pairs", quantize_caps=False) \
            .cache_key(self.q, self.stats) != base
        # A rotated salt (a superseded store version) never hits.
        assert self.eng.cache_key(self.q, self.stats,
                                  partitioning=certificate(salt=2)) != \
            flips["partitioning"]

    def test_live_hit_and_miss(self, engine):
        q = T.JoinQuery.triangle()
        r1 = engine.submit(q, [_edges(7)] * 3)
        r2 = engine.submit(q, [_edges(7)] * 3)
        assert r1.ok and r2.ok
        assert not r1.cache_hit and r2.cache_hit
        r3 = engine.submit(q, [_edges(8)] * 3)
        assert r3.ok and not r3.cache_hit


# ---------------------------------------------------------------------------
# S2 — LRU semantics
# ---------------------------------------------------------------------------

class TestLRU:
    def _submit(self, eng, seed):
        return eng.submit(T.JoinQuery.triangle(), [_edges(seed)] * 3,
                          caps=T.ChainCaps(recv=256, mid=512, out=1024),
                          strategy="cascade", join_order=ORDER)

    def test_bounded_size_and_eviction_order(self):
        eng = cpu_engine(k=K, cache_capacity=2)
        self._submit(eng, 0)
        self._submit(eng, 1)
        assert len(eng) == 2 and eng.stats.evictions == 0
        assert self._submit(eng, 0).cache_hit       # touch A
        rc = self._submit(eng, 2)
        assert rc.ok and len(eng) == 2 and eng.stats.evictions == 1
        assert self._submit(eng, 0).cache_hit       # A survived
        assert not self._submit(eng, 1).cache_hit   # B was evicted
        assert len(eng) == 2

    def test_churn_never_exceeds_capacity(self):
        eng = cpu_engine(k=K, cache_capacity=2)
        for seed in range(5):
            assert self._submit(eng, seed).ok
            assert len(eng) <= 2
        assert eng.stats.evictions == 3


# ---------------------------------------------------------------------------
# S3 — batched multi-tenant execution
# ---------------------------------------------------------------------------

class TestBatching:
    def test_one_laned_execution_per_shape(self, engine):
        q = T.JoinQuery.triangle()
        reqs = [QueryRequest(q, [_edges(100 + s)] * 3) for s in range(4)]
        before = engine.stats.batches
        results = engine.submit_many(reqs)
        assert engine.stats.batches == before + 1    # ONE laned run
        runs = {id(engine._cache[k].run) for k in engine.cached_keys()[-4:]}
        assert len(runs) == 1                        # one plan, 4 entries
        for s, res in enumerate(results):
            assert res.ok
            assert weighted_total(q, res.output) / 3 == \
                T.oracle_triangles(*_edges(100 + s))
        again = engine.submit_many(reqs)
        assert all(r.cache_hit for r in again)

    def test_poisoned_request_fails_alone(self, engine):
        q = T.JoinQuery.triangle()
        good = [QueryRequest(q, [_edges(100 + s)] * 3) for s in range(2)]
        bad = QueryRequest(q, [(np.arange(4),)] * 3)     # wrong arity
        results = engine.submit_many([good[0], bad, good[1]])
        assert [r.ok for r in results] == [True, False, True]
        assert "ValueError" in results[1].error
        for s, res in zip((100, 101), (results[0], results[2])):
            assert weighted_total(q, res.output) / 3 == \
                T.oracle_triangles(*_edges(s))

    def test_overflowing_lane_fails_alone(self, engine):
        q = T.JoinQuery.triangle()
        tiny = T.ChainCaps(recv=4, mid=4, out=4)
        results = engine.submit_many([
            QueryRequest(q, [_edges(100)] * 3),
            QueryRequest(q, [_edges(101)] * 3, caps=tiny)])
        assert results[0].ok
        assert not results[1].ok and results[1].overflow
        assert "overflow" in results[1].error

    def test_overflowing_lane_in_a_batch_fails_alone(self, engine):
        """Two lanes of ONE execution (equal caps and capacities): the
        dense tenant's buffers spill, its flag alone is set."""
        q = T.JoinQuery.triangle()
        kw = dict(caps=T.ChainCaps(recv=256, mid=512, out=1024),
                  strategy="cascade", join_order=ORDER, capacities=[200] * 3)
        dense = unique_edges(0, m=200)
        before = engine.stats.batches
        results = engine.submit_many([
            QueryRequest(q, [dense] * 3, **kw),
            QueryRequest(q, [_edges(100)] * 3, **kw)])
        assert engine.stats.batches == before + 1
        assert [r.overflow for r in results] == [True, False]
        assert not results[0].ok and results[1].ok
        assert weighted_total(q, results[1].output) / 3 == \
            T.oracle_triangles(*_edges(100))

    def test_prebuilt_relations_skip_table_preparation(self, engine):
        """``submit(rels=...)``: inputs already scattered onto the
        plan's grid run as they are, through the same cache entry."""
        q = T.JoinQuery.triangle()
        tables = [_edges(300)] * 3
        kw = dict(stats=T.query_stats_exact(q, tables), strategy="cascade",
                  join_order=ORDER)
        from_tables = engine.submit(q, tables, **kw)
        rels = T.query_table_inputs(q, tables, from_tables.plan.grid_shape,
                                    device="cpu")
        prebuilt = engine.submit(q, rels=rels, **kw)
        assert from_tables.ok and prebuilt.ok and prebuilt.cache_hit
        assert prebuilt.measured == from_tables.measured
        assert torch.equal(prebuilt.output.valid, from_tables.output.valid)
        for n, c in prebuilt.output.cols.items():
            assert torch.equal(c, from_tables.output.cols[n]), n

    def test_per_lane_stats_are_exact(self, engine):
        q = T.JoinQuery.triangle()
        reqs, want = [], []
        for s in range(3):
            tables = [_edges(200 + s)] * 3
            stats = T.query_stats_exact(q, tables)
            reqs.append(QueryRequest(q, tables, stats=stats,
                                     strategy="cascade", join_order=ORDER))
            idx = stats.orders.index(ORDER)
            want.append(T.cost_query_cascade(list(stats.sizes),
                                             stats.intermediates[idx]))
        for res, analytic in zip(engine.submit_many(reqs), want):
            assert res.ok
            assert res.measured["total"] == analytic


# ---------------------------------------------------------------------------
# R6 — admission control and the circuit breaker
# ---------------------------------------------------------------------------

def _req(seed=7):
    q = T.JoinQuery.triangle()
    rng = np.random.default_rng(seed)
    e = (rng.integers(0, 12, 40), rng.integers(0, 12, 40))
    tables = [e] * 3
    return QueryRequest(q, tables, stats=T.query_stats_exact(q, tables))


@pytest.fixture
def fault_hook():
    """Install a plain submit-site hook that raises its first ``n``
    offers (all of them for ``n=None``); removed after the test."""
    def install(n=None):
        fired = []

        def hook(site, payload):
            if site == "submit" and (n is None or len(fired) < n):
                fired.append(site)
                raise RuntimeError("injected submit-site crash")
            return payload
        set_fault_hook(hook)
        return fired
    yield install
    set_fault_hook(None)


class TestAdmissionControl:
    def test_queue_bound_sheds_typed(self):
        eng = cpu_engine(k=K, max_queue=1)
        res = eng.submit_many([_req(1), _req(1), _req(1)])
        assert res[0].ok
        assert [r.error_kind for r in res[1:]] == ["shed", "shed"]
        assert eng.stats.shed == 2 and all(r.output is None for r in res[1:])

    def test_deadline_is_typed_never_late(self):
        eng = cpu_engine(k=K)
        res = eng.submit_many([dataclasses.replace(_req(2),
                                                   deadline_ms=1e-6)])[0]
        assert not res.ok and res.error_kind == "deadline"
        assert res.output is None
        assert eng.stats.deadline_exceeded == 1

    def test_slo_shedding_with_probe_trickle(self):
        eng = cpu_engine(k=K, slo_ms=1e-3, shed_window=4)
        for s in range(4):
            assert eng.submit_many([_req(10 + s)])[0].ok
        res = eng.submit_many([_req(20 + i) for i in range(4)])
        kinds = [r.error_kind for r in res]
        assert kinds.count("shed") == 3 and kinds.count(None) == 1
        assert res[-1].ok

    def test_submit_fault_retried_within_budget(self, fault_hook):
        eng = cpu_engine(k=K, submit_retries=2)
        fired = fault_hook(2)
        res = eng.submit_many([_req(3)])[0]
        assert res.ok and eng.stats.fault_retries == 2 and len(fired) == 2

    def test_submit_fault_exhaustion_is_typed(self, fault_hook):
        eng = cpu_engine(k=K, submit_retries=1)
        fault_hook()
        res = eng.submit_many([_req(4)])[0]
        assert not res.ok and res.error_kind == "fault"
        assert engine_mod._fault_hook is not None


class TestCircuitBreaker:
    def _bad_req(self):
        # ChainStats without a certificate: _build_entry raises, every
        # distinct seed is a fresh cache miss.
        self._seed = getattr(self, "_seed", 100) + 1
        q = T.JoinQuery.triangle()
        rng = np.random.default_rng(self._seed)
        e = (rng.integers(0, 12, 40), rng.integers(0, 12, 40))
        return QueryRequest(q, [e] * 3, stats=T.chain_stats_exact([e] * 3))

    def test_opens_after_threshold_hits_still_serve(self):
        eng = cpu_engine(k=K, breaker_threshold=2, breaker_cooldown=3)
        good = _req(5)
        assert eng.submit_many([good])[0].ok
        for _ in range(2):
            r = eng.submit_many([self._bad_req()])[0]
            assert not r.ok and r.error_kind == "error"
        r = eng.submit_many([_req(6)])[0]
        assert not r.ok and r.error_kind == "circuit"
        assert eng.stats.circuit_open == 1
        hit = eng.submit_many([good])[0]
        assert hit.ok and hit.cache_hit

    def test_half_open_probe_closes_on_success(self):
        eng = cpu_engine(k=K, breaker_threshold=1, breaker_cooldown=2)
        assert not eng.submit_many([self._bad_req()])[0].ok
        kinds = [eng.submit_many([_req(30 + i)])[0].error_kind
                 for i in range(2)]
        assert kinds == ["circuit", "circuit"]
        assert eng.submit_many([_req(40)])[0].ok      # half-open probe
        assert eng.submit_many([_req(41)])[0].ok      # breaker closed


# ---------------------------------------------------------------------------
# R7 — the map-side certificate
# ---------------------------------------------------------------------------

def _chain_request(cert):
    cq = T.ChainQuery.chain(3)
    rng = np.random.default_rng(8)
    edges = [(rng.integers(0, 16, 50).astype(np.int32),
              rng.integers(0, 16, 50).astype(np.int32)) for _ in range(3)]
    return cq, edges, QueryRequest(cq, edges, stats=T.chain_stats_exact(edges),
                                   strategy="mapside", partitioning=cert)


def test_stale_certificate_serves_exact_via_cascade():
    eng = cpu_engine(k=K)
    cq, edges, req = _chain_request(certificate(key_dtype="int64"))
    res = eng.submit_many([req])[0]
    assert res.ok and res.degraded == "stale_certificate"
    assert res.plan.strategy == "cascade" and eng.stats.degraded == 1
    # Exact: the 3-paths a-b-c-d, counted on the host.
    assert weighted_total(cq, res.output) == _paths(edges)


def _stored(edges, cq=None, salt=1):
    """The chain's relations stored as ``certificate()`` proves them:
    P = 4, salt 1, each on its hop key."""
    cq = cq or T.ChainQuery.chain(3)
    return [T.partition_relation(
        T.edge_relation(s, d, names=cq.schema(j), device="cpu"),
        cq.attrs[1] if j == 0 else cq.attrs[j], 4, salt=salt)[0]
        for j, (s, d) in enumerate(edges)]


def _paths(edges, n=16):
    """The 3-paths a-b-c-d of a chain, counted on the host."""
    m = [np.zeros((n, n)) for _ in range(3)]
    for mat, (s, d) in zip(m, edges):
        np.add.at(mat, (s, d), 1)
    return (m[0] @ m[1] @ m[2]).sum()


def test_current_certificate_fails_alone_naming_a11():
    """A current certificate (ROADMAP A11, ported) is served map-side
    over the stored partitions, exactly, beside a co-submitted
    request."""
    eng = cpu_engine(k=K)
    cq, edges, req = _chain_request(certificate())
    results = eng.submit_many([req, _req(9)],
                              prebuilt=[_stored(edges), None])
    assert results[0].ok and results[0].error is None
    assert results[0].plan.strategy == "mapside"
    assert results[0].plan.algorithm == "MS,3J"
    assert results[0].measured["hop_shuffled"] == (0.0, 0.0)
    assert weighted_total(cq, results[0].output) == _paths(edges)
    assert results[1].ok


def test_current_certificate_never_opens_the_breaker():
    """Map-side requests past the breaker's threshold: the first plans
    and captures, every later one hits the cached plan, all exact."""
    eng = cpu_engine(k=K, breaker_threshold=2)
    cq, edges, req = _chain_request(certificate())
    prels = _stored(edges)
    results = [eng.submit_many([req], prebuilt=[prels])[0] for _ in range(3)]
    assert all(r.ok and weighted_total(cq, r.output) == _paths(edges)
               for r in results)
    assert [r.cache_hit for r in results] == [False, True, True]
    assert results[1].measured == results[0].measured
    assert eng.stats.circuit_open == 0
    good = eng.submit_many([_req(12)])[0]
    assert good.ok and not good.cache_hit


def test_prebuilt_partitions_batch_and_flatten_on_a_stale_certificate():
    """Two tenants' stored partitions run as one laned execution, each
    lane equal to its solo submission; under a stale certificate the
    same prebuilt partitions flatten back onto the cascade's grid."""
    eng = cpu_engine(k=K)
    cq = T.ChainQuery.chain(3)
    rng = np.random.default_rng(8)
    tenants = [[(rng.integers(0, 16, 50).astype(np.int32),
                 rng.integers(0, 16, 50).astype(np.int32))
                for _ in range(3)] for _ in range(2)]
    stats = [T.chain_stats_exact(e) for e in tenants]
    caps = T.ChainCaps(**{
        f: max(getattr(T.default_mapside_caps(st, 4, slack=8), f)
               for st in stats)
        for f in ("recv", "mid", "out", "local", "agg", "join")})
    reqs = [QueryRequest(cq, e, stats=st, strategy="mapside",
                         partitioning=certificate(), caps=caps)
            for e, st in zip(tenants, stats)]
    prebuilt = [_stored(e) for e in tenants]
    before = eng.stats.batches
    batch = eng.submit_many(reqs, prebuilt=prebuilt)
    assert eng.stats.batches == before + 1
    for res, req, prels, e in zip(batch, reqs, prebuilt, tenants):
        assert res.ok and weighted_total(cq, res.output) == _paths(e)
        solo = eng.submit_many([req], prebuilt=[prels])[0]
        assert solo.ok and solo.measured == res.measured
        cols, valid = interop.relation_to_numpy(solo.output)
        np.testing.assert_array_equal(valid, res.output.valid.numpy())
        for n, c in cols.items():
            np.testing.assert_array_equal(c, res.output.cols[n].numpy())
    stale = dataclasses.replace(reqs[0], partitioning=certificate(
        key_dtype="int64"))
    res = eng.submit_many([stale], prebuilt=[prebuilt[0]])[0]
    assert res.ok and res.degraded == "stale_certificate"
    assert res.plan.strategy == "cascade"
    assert weighted_total(cq, res.output) == _paths(tenants[0])


# ---------------------------------------------------------------------------
# V — the verifier copies against the JAX verifier
# ---------------------------------------------------------------------------

def test_verifier_findings_match_jax():
    edges = [_edges(3, n_nodes=32, m=100)] * 3
    t_stats, j_stats = T.chain_stats_exact(edges), J.chain_stats_exact(edges)
    cq_t = T.ChainQuery.three_way(aggregate=True)
    cq_j = J.ChainQuery.three_way(aggregate=True)
    plan_t = T.plan_chain(t_stats, 16, aggregate=True)
    plan_j = J.plan_chain(j_stats, 16, aggregate=True)
    caps = T.default_chain_caps(t_stats, plan_t.grid_shape)
    j_caps = J.ChainCaps(**dataclasses.asdict(caps))
    ok_t = TA.verify_chain_plan(cq_t, t_stats, plan_t, caps)
    ok_j = JA.verify_chain_plan(cq_j, j_stats, plan_j, j_caps)
    assert ok_t.ok and ok_t.to_dict() == ok_j.to_dict()
    # A rejected plan: the triangle's one-round grid over its budget,
    # with undersized caps.
    tq, jq = T.JoinQuery.triangle(), J.JoinQuery.triangle()
    qs_t = T.query_stats_exact(tq, edges)
    qs_j = J.query_stats_exact(jq, edges)
    bad = dict(strategy="one_round", grid_shape=(2, 2, 2), k=4)
    bad_t = dataclasses.replace(T.plan_query(tq, qs_t, 8), **bad)
    bad_j = dataclasses.replace(J.plan_query(jq, qs_j, 8), **bad)
    tiny = dict(recv=4, mid=4, out=4)
    rej_t = TA.verify_query_plan(tq, qs_t, bad_t, T.ChainCaps(**tiny))
    rej_j = JA.verify_query_plan(jq, qs_j, bad_j, J.ChainCaps(**tiny))
    assert {"SHARES_BUDGET_EXCEEDED", "CAPS_UNDERSIZED"} <= set(rej_t.codes)
    assert not rej_t.ok and rej_t.to_dict() == rej_j.to_dict()


def test_verify_plans_rejects_before_caching():
    eng = cpu_engine(k=K, verify_plans=True)
    q = T.JoinQuery.triangle()
    res = eng.submit(q, [_edges(5)] * 3, strategy="cascade",
                     caps=T.ChainCaps(recv=2, mid=2, out=2))
    assert not res.ok and res.error_kind == "error"
    assert "PlanRejected" in res.error and len(eng) == 0
    good = eng.submit(q, [_edges(5)] * 3, strategy="cascade")
    assert good.ok and eng._cache[eng.cached_keys()[0]].report.ok


# ---------------------------------------------------------------------------
# x64 — a torch-only subprocess
# ---------------------------------------------------------------------------

X64_CHECK = """
import sys
import numpy as np
from repro_torch import config
from repro_torch.core import JoinQuery, oracle_triangles, query_stats_exact
from repro_torch.serving import QueryEngine, QueryServeConfig, weighted_total

assert config.enable_x64() and config.key_dtype_name() == "int64"
rng = np.random.default_rng(0)
src = rng.integers(0, 12, 60).astype(np.int64)
dst = rng.integers(0, 12, 60).astype(np.int64)
big = 1 << 33                              # ids above 2^32
tables = [(src + big, dst + big)] * 3
eng = QueryEngine(QueryServeConfig(k=4), device="cpu")
q = JoinQuery.triangle()
stats = query_stats_exact(q, tables)
k64 = eng.cache_key(q, stats)
assert k64 == eng.cache_key(q, stats, key_dtype="int64")
assert k64 != eng.cache_key(q, stats, key_dtype="int32")
res = eng.submit(q, tables, stats=stats)
assert res.ok, res.error
assert res.output.cols["a"].dtype.is_signed and \\
    res.output.cols["a"].element_size() == 8
assert weighted_total(q, res.output) / 3 == oracle_triangles(src, dst)
assert "jax" not in sys.modules and "repro" not in sys.modules
print("OK")
"""


def test_x64_serving_subprocess():
    env = dict(os.environ, JAX_ENABLE_X64="1",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", X64_CHECK], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK" in out.stdout
