"""Streaming ingest on the port: ``repro_torch.serving.ServingStore``.

Mirrors ``tests/test_serving.py``'s ``TestDeltaMaintenance`` and
``TestFaultInjection`` and the store cases of
``tests/test_resilience.py``'s graceful degradation, on the CPU: the
delta-maintained triangle and path counts equal host recounts after
every micro-batch, the delta cascades move fewer tuples than the
recomputes they avoid, and every failed batch leaves the store (memory
and disk) as it was.  The store writes the JAX package's format: a
store the port committed opens in the JAX package's ``ServingStore``.
The delta terms' tuple counts are held to the JAX package's
``BENCH_serving.json`` pins by ``tests/test_torch_benchmarks.py``.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import oracle_triangles  # noqa: E402
from repro_torch.resilience import (FaultInjector, FaultSpec,  # noqa: E402
                                    InjectedCrash)
from repro_torch.serving import (IngestError, QueryEngine,  # noqa: E402
                                 QueryServeConfig, ServingStore,
                                 delta_terms)
from repro_torch.serving.store import META_NAME  # noqa: E402

CHAOS_SEED = int(os.environ.get("CHAOS_SEED", "0"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the intra-op pool only oversubscribes the CPU under
    a parallel run (see ``tests/test_torch_skew.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uniq_edges(seed, n_nodes=14, m=70):
    rng = np.random.default_rng(seed)
    seen = set()
    while len(seen) < m:
        seen.add((int(rng.integers(0, n_nodes)),
                  int(rng.integers(0, n_nodes))))
    arr = np.array(sorted(seen))
    return arr[:, 0], arr[:, 1]


@pytest.fixture(scope="module")
def store_engine():
    return QueryEngine(QueryServeConfig(k=4, cache_capacity=64), device="cpu")


def _store(path, engine, **kw):
    kw = dict(dict(num_partitions=4, drift_threshold=None,
                   delta_capacity=16), **kw)
    return ServingStore(str(path), engine, **kw)


class TestDeltaMaintenance:
    def _stream(self, tmp_path, store_engine, kind, n, seed):
        src, dst = _uniq_edges(seed)
        store = _store(tmp_path, store_engine)
        store.register_aggregate("agg", kind, n)
        store.load_edges(src, dst)
        assert store.aggregates["agg"].value == \
            pytest.approx(store.analytic_value("agg"))
        rng = np.random.default_rng(seed + 1000)
        for step in range(3):
            cur = set(zip(store.src.tolist(), store.dst.tolist()))
            ins = []
            while len(ins) < 4:
                e = (int(rng.integers(0, 14)), int(rng.integers(0, 14)))
                if e not in cur and e not in ins:
                    ins.append(e)
            dels = []
            if step > 0:  # mixed stream after the first batch
                pick = rng.choice(store.n_edges, size=3, replace=False)
                dels = [(int(store.src[i]), int(store.dst[i])) for i in pick]
            rep = store.apply_deltas(
                inserts=(np.array([a for a, b in ins]),
                         np.array([b for a, b in ins])),
                deletes=None if not dels else
                        (np.array([a for a, b in dels]),
                         np.array([b for a, b in dels])))
            assert rep["aggregates"]["agg"]["mode"] == "delta"
            assert store.aggregates["agg"].value == \
                pytest.approx(store.analytic_value("agg")), \
                f"{kind} drifted at step {step}"
        return store

    @pytest.mark.parametrize("seed", [0, 1])
    def test_triangle_count_stays_exact(self, tmp_path, store_engine, seed):
        store = self._stream(tmp_path, store_engine, "cycle", 3, seed)
        assert store.aggregates["agg"].value == \
            pytest.approx(oracle_triangles(store.src, store.dst))

    def test_path_count_stays_exact(self, tmp_path, store_engine):
        self._stream(tmp_path, store_engine, "chain", 3, 2)

    def test_delta_moves_fewer_tuples_than_recompute(self, tmp_path,
                                                     store_engine):
        store = self._stream(tmp_path, store_engine, "cycle", 3, 3)
        agg = store.aggregates["agg"]
        assert agg.delta_tuples < agg.recompute_tuples

    def test_triangle_term_collapse(self):
        tri = delta_terms("cycle", 3)
        assert [c for _, c in tri] == [3.0, 3.0, 1.0]
        chain = delta_terms("chain", 3)
        assert len(chain) == 7 and all(c == 1.0 for _, c in chain)
        assert delta_terms("cycle", 4) == delta_terms("chain", 4)

    def test_drift_threshold_forces_recompute(self, tmp_path, store_engine):
        src, dst = _uniq_edges(5)
        store = _store(tmp_path, store_engine, drift_threshold=0.05)
        store.register_aggregate("tri", "cycle", 3)
        store.load_edges(src, dst)
        refreshes0 = store.aggregates["tri"].refreshes
        cur = set(zip(src.tolist(), dst.tolist()))
        ins = [(a, b) for a in range(14) for b in range(14)
               if (a, b) not in cur][:8]          # > 5% of 70 edges
        rep = store.apply_deltas(inserts=(np.array([a for a, b in ins]),
                                          np.array([b for a, b in ins])))
        assert rep["aggregates"]["tri"]["mode"] == "recompute"
        assert store.aggregates["tri"].refreshes == refreshes0 + 1
        assert store.aggregates["tri"].drift_rows == 0
        assert store.aggregates["tri"].value == \
            pytest.approx(store.analytic_value("tri"))


class TestFaultInjection:
    def _loaded(self, tmp_path, engine):
        src, dst = _uniq_edges(11)
        store = _store(tmp_path, engine)
        store.register_aggregate("tri", "cycle", 3)
        store.load_edges(src, dst)
        return store

    def _snapshot(self, store):
        return (store.version, store.n_edges,
                sorted(zip(store.src.tolist(), store.dst.tolist())),
                {n: (a.value, a.drift_rows, a.deltas_applied)
                 for n, a in store.aggregates.items()})

    def _assert_unchanged(self, store, snap, store_engine):
        assert self._snapshot(store) == snap
        reloaded = ServingStore(store.directory, store_engine)
        assert self._snapshot(reloaded) == snap

    def test_validation_failure_mid_batch(self, tmp_path, store_engine):
        store = self._loaded(tmp_path, store_engine)
        snap = self._snapshot(store)
        with pytest.raises(IngestError, match="absent"):
            store.apply_deltas(inserts=(np.array([0]), np.array([1])),
                               deletes=(np.array([999]), np.array([999])))
        self._assert_unchanged(store, snap, store_engine)

    def test_persistence_crash_mid_apply(self, tmp_path, store_engine,
                                         monkeypatch):
        store = self._loaded(tmp_path, store_engine)
        snap = self._snapshot(store)
        import repro_torch.serving.store as store_mod

        def boom(*a, **k):
            raise OSError("disk full (injected)")

        monkeypatch.setattr(store_mod, "save_partitioned", boom)
        with pytest.raises(OSError, match="injected"):
            store.apply_deltas(inserts=(np.array([0]), np.array([1])))
        monkeypatch.undo()
        self._assert_unchanged(store, snap, store_engine)
        rep = store.apply_deltas(inserts=(np.array([0]), np.array([1])))
        assert rep["aggregates"]["tri"]["mode"] == "delta"
        assert store.aggregates["tri"].value == \
            pytest.approx(store.analytic_value("tri"))

    def test_crash_between_partitions_and_commit_point(self, tmp_path,
                                                       store_engine,
                                                       monkeypatch):
        store = self._loaded(tmp_path, store_engine)
        snap = self._snapshot(store)
        import repro_torch.serving.store as store_mod

        def boom(*a, **k):
            raise OSError("power loss (injected)")

        monkeypatch.setattr(store_mod, "save_json_atomic", boom)
        with pytest.raises(OSError, match="injected"):
            store.apply_deltas(inserts=(np.array([2]), np.array([3])))
        monkeypatch.undo()
        assert os.path.isdir(os.path.join(store.directory,
                                          f"edges_v{snap[0] + 1}"))
        self._assert_unchanged(store, snap, store_engine)
        rep = store.apply_deltas(inserts=(np.array([2]), np.array([3])))
        assert rep["version"] == snap[0] + 1
        assert store.aggregates["tri"].value == \
            pytest.approx(store.analytic_value("tri"))

    def test_torn_meta_tmp_is_recovered(self, tmp_path, store_engine):
        store = self._loaded(tmp_path, store_engine)
        snap = self._snapshot(store)
        with open(os.path.join(store.directory, META_NAME + ".tmp"),
                  "w") as f:
            f.write('{"format": "repro-serving-v1", "vers')  # torn
        self._assert_unchanged(store, snap, store_engine)

    def test_partition_read_crash_on_reopen_leaves_the_store(self, tmp_path,
                                                             store_engine):
        """``apply_deltas`` reads no partition (compute from memory, then
        commit), so a partition_read crash can only hit a reopen: it
        raises, and the store on disk is unchanged."""
        store = self._loaded(tmp_path, store_engine)
        snap = self._snapshot(store)
        with FaultInjector([FaultSpec("partition_read", "crash", 1.0)],
                           seed=CHAOS_SEED) as inj:
            with pytest.raises(InjectedCrash):
                ServingStore(store.directory, store_engine)
        assert inj.fired[("partition_read", "crash")] == 1
        self._assert_unchanged(store, snap, store_engine)


class TestDegradation:
    def test_delta_failure_falls_back_to_recompute(self, tmp_path,
                                                   store_engine):
        src, dst = _uniq_edges(9, n_nodes=12, m=40)
        store = _store(tmp_path, store_engine)
        store.register_aggregate("tri", "cycle", 3)
        store.load_edges(src, dst)
        degraded0 = store_engine.stats.degraded
        ins = np.array([[0, 1], [2, 3], [4, 5]])
        # submit_retries=2: 3 attempts; exactly the first delta-term
        # submit exhausts, the recompute fallback's own submits succeed
        with FaultInjector([FaultSpec("submit", "corrupt", 1.0,
                                      max_fires=3)], seed=CHAOS_SEED):
            rep = store.apply_deltas(inserts=(ins[:, 0], ins[:, 1]))
        assert rep["aggregates"]["tri"]["mode"] == "recompute_fallback"
        assert store.aggregates["tri"].value == pytest.approx(
            float(oracle_triangles(store.src, store.dst)), rel=1e-9)
        assert store_engine.stats.degraded == degraded0 + 1

    def test_permanent_failure_leaves_store_unchanged(self, tmp_path,
                                                      store_engine):
        rng = np.random.default_rng(9)
        store = _store(tmp_path, store_engine)
        store.register_aggregate("tri", "cycle", 3)
        store.load_edges(rng.integers(0, 12, 40), rng.integers(0, 12, 40))
        v0, val0 = store.version, store.aggregates["tri"].value
        with FaultInjector([FaultSpec("submit", "corrupt", 1.0)],
                           seed=CHAOS_SEED):
            with pytest.raises(IngestError):
                store.apply_deltas(inserts=(np.array([0]), np.array([1])))
        assert store.version == v0
        assert store.aggregates["tri"].value == val0

    def test_gc_killed_mid_delete_completed_on_next_open(self, tmp_path,
                                                         store_engine,
                                                         monkeypatch):
        rng = np.random.default_rng(9)
        store = _store(tmp_path, store_engine)
        store.load_edges(rng.integers(0, 12, 40), rng.integers(0, 12, 40))
        assert store.version == 1
        import repro_torch.serving.store as store_mod

        def boom(path, **kw):
            raise OSError("killed mid-delete")

        monkeypatch.setattr(store_mod.shutil, "rmtree", boom)
        store.apply_deltas(inserts=(np.array([0]), np.array([1])))
        monkeypatch.undo()
        assert store.version == 2
        orphan = tmp_path / "edges_v1"
        assert orphan.is_dir()
        assert not (orphan / "manifest.json").exists()
        store2 = _store(tmp_path, store_engine)
        assert store2.version == 2 and store2.n_edges == store.n_edges
        assert not orphan.exists()


def test_the_jax_package_opens_a_store_the_port_committed(tmp_path,
                                                          store_engine):
    """Same ``serving_meta.json`` (``repro-serving-v1``) and partitioned
    store: the JAX package's ``ServingStore`` restores the port's
    committed version, edges and standing values."""
    from repro.serving import QueryEngine as JaxEngine
    from repro.serving import ServingStore as JaxStore
    src, dst = _uniq_edges(4)
    store = _store(tmp_path, store_engine)
    store.register_aggregate("tri", "cycle", 3)
    store.register_aggregate("p3", "chain", 3)
    store.load_edges(src, dst)
    store.apply_deltas(inserts=(np.array([0]), np.array([13])),
                       deletes=(src[:1], dst[:1]))
    other = JaxStore(str(tmp_path), JaxEngine())
    reopened = _store(tmp_path, store_engine)   # edges in partition order
    assert other.version == reopened.version == store.version == 2
    np.testing.assert_array_equal(other.src, reopened.src)
    np.testing.assert_array_equal(other.dst, reopened.dst)
    assert sorted(zip(other.src.tolist(), other.dst.tolist())) == \
        sorted(zip(store.src.tolist(), store.dst.tolist()))
    assert {n: a.to_json() for n, a in other.aggregates.items()} == \
        {n: a.to_json() for n, a in store.aggregates.items()}
    assert other.partition_spec.salt == store.partition_spec.salt == 2
