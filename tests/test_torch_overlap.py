"""The port's overlapped (chunked) shuffle schedule, on the CPU.

``overlap_chunks=C`` splits each hop's incoming relation into C row
blocks, each shuffled and joined on its own, one after another.  Two
kinds of check:

* the port's mirror of ``tests/test_overlap.py``: for every entry point
  at ``CHUNK_COUNTS``, the schedule changes nothing observable — same
  tuples, same overflow flag, bit-equal stats — the tiny-output
  overflow case (only the flag and the stats are schedule-invariant
  there), the star one-round case, ``split_rows`` / ``concat_rows``
  partitioning, and the ``hop_time_*`` model;
* the port held to the JAX package's overlapped run as full arrays
  (every column, the mask, padding, row order, stats and overflow) for
  ``two_way_join`` and both triangle lowerings at every chunk count.
  The chain strategies, the map-side cascade, SharesSkew and the x64
  run are in ``tests/test_torch_overlap_chain.py``.

Each JAX reference is jitted once per module with every chunk count in
one program, and shared by the cases that read it; JAX is imported by
the cases that need it, so the module also runs where the port runs
alone.  The ``cuda`` cases run the schedule on a GPU and skip without
one:

    python -m pytest -q -m cuda tests/test_torch_overlap.py
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.cost_model import (hop_time_overlapped,  # noqa: E402
                                         hop_time_staged,
                                         overlap_hidden_fraction)
from repro_torch.core.shuffle import concat_rows, split_rows  # noqa: E402

from _torch_jax import run_fast  # noqa: E402

CHUNK_COUNTS = (2, 3, 5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the intra-op pool only oversubscribes the CPU under
    a parallel run (see ``tests/test_torch_skew.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def edges(rng, dom, m):
    return (rng.integers(0, dom, m).astype(np.int32),
            rng.integers(0, dom, m).astype(np.int32))


def jax_core():
    """The JAX package's ``repro.core`` (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import repro.core
    return repro.core


def jax_run(fn, *args):
    """``fn(*args)`` jitted, compiled without the expensive passes."""
    import jax
    return run_fast(jax.jit(fn), *args)


def assert_same_result(got, want):
    """Port ``(out, stats, overflow)`` equals the JAX one as full arrays."""
    out, stats, ovf = got
    j_out, j_stats, j_ovf = want
    cols, valid = interop.relation_to_numpy(out)
    np.testing.assert_array_equal(valid, np.asarray(j_out.valid))
    assert sorted(cols) == sorted(j_out.cols)
    for n, c in cols.items():
        want_c = np.asarray(j_out.cols[n])
        assert c.dtype == want_c.dtype, n
        np.testing.assert_array_equal(c, want_c, err_msg=n)
    assert bool(ovf) == bool(j_ovf)
    assert sorted(stats) == sorted(j_stats)
    for k, v in stats.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_stats[k]),
                                      err_msg=k)


def snapshot(result):
    out, st, ovf = result
    return (out.to_tuple_set(), int(out.count().sum()), bool(ovf),
            {k: v.numpy() for k, v in st.items()})


def assert_overlap_invisible(fn, *, expect_overflow=False):
    """fn(chunks) -> (out, stats, ovf); every chunking must match C=1."""
    base_set, base_n, base_ovf, base_st = snapshot(fn(1))
    assert base_ovf == expect_overflow
    for c in CHUNK_COUNTS:
        got_set, got_n, got_ovf, got_st = snapshot(fn(c))
        assert got_ovf == base_ovf, c
        assert sorted(got_st) == sorted(base_st), c
        for k in base_st:
            assert np.array_equal(got_st[k], base_st[k]), (c, k)
        # Under overflow only the flag and the accounting are
        # schedule-invariant: truncation hits pre-filter matches, so the
        # schedules can retain different survivor subsets.
        if not expect_overflow:
            assert got_n == base_n, c
            assert got_set == base_set, c


# ---------------------------------------------------------------------------
# Fixtures shared by the mirror and the JAX parity cases
# ---------------------------------------------------------------------------

TWO_WAY_EDGES = [edges(np.random.default_rng(0), 12, 40) for _ in range(2)]
TRI_TABLES = [edges(np.random.default_rng(2), 14, 48)] * 3
TRI_CAPS = dict(recv=512, mid=4096, out=8192, local=1024)


def two_way_port(chunks, device="cpu"):
    q2 = T.ChainQuery.chain(2)
    left, right = T.chain_edge_inputs(q2, TWO_WAY_EDGES, (4,), device=device)
    return T.two_way_join(T.SimGrid((4,)), left, right, "b", "b",
                          recv_capacity=256, out_capacity=2048,
                          overlap_chunks=chunks)


def triangle_port(strategy, shape, chunks, caps=TRI_CAPS, tables=TRI_TABLES,
                  device="cpu"):
    query = T.JoinQuery.triangle()
    rels = T.query_table_inputs(query, tables, shape, device=device)
    return T.execute_query(T.SimGrid(shape), query, rels, strategy=strategy,
                           caps=T.ChainCaps(**caps), overlap_chunks=chunks)


@functools.lru_cache(maxsize=None)
def jax_two_way():
    """The JAX package's overlapped ``two_way_join`` at every chunk
    count, one program."""
    J = jax_core()
    q2 = J.ChainQuery.chain(2)
    left, right = J.chain_edge_inputs(q2, TWO_WAY_EDGES, (4,))
    return jax_run(lambda l, r: {c: J.two_way_join(
        J.SimGrid((4,)), l, r, "b", "b", recv_capacity=256,
        out_capacity=2048, overlap_chunks=c) for c in CHUNK_COUNTS},
        left, right)


@functools.lru_cache(maxsize=None)
def jax_triangle(strategy, shape):
    J = jax_core()
    query = J.JoinQuery.triangle()
    rels = J.query_table_inputs(query, TRI_TABLES, shape)
    caps = J.ChainCaps(**TRI_CAPS)
    return jax_run(lambda r: {c: J.execute_query(
        J.SimGrid(shape), query, r, strategy=strategy, caps=caps,
        overlap_chunks=c) for c in CHUNK_COUNTS}, rels)


# ---------------------------------------------------------------------------
# The mirror of tests/test_overlap.py
# ---------------------------------------------------------------------------

def test_two_way_join_overlap():
    assert_overlap_invisible(two_way_port)


def test_cascade_chain_pushdown_overlap():
    rng = np.random.default_rng(1)
    query = T.ChainQuery.chain(3, aggregate=True)
    rels = T.chain_edge_inputs(query, [edges(rng, 16, 48) for _ in range(3)],
                               (4,), device="cpu")
    caps = T.ChainCaps(recv=512, mid=2048, out=4096, local=1024, agg=1024)

    def fn(chunks):
        return T.cascade_chain(T.SimGrid((4,)), query, rels, caps=caps,
                               pushdown=True, measure_skew=True,
                               overlap_chunks=chunks)

    assert_overlap_invisible(fn)


@pytest.mark.parametrize("strategy,shape", [("one_round", (2, 2, 2)),
                                            ("cascade", (4,))])
def test_triangle_overlap(strategy, shape):
    assert_overlap_invisible(
        lambda chunks: triangle_port(strategy, shape, chunks))


@pytest.mark.parametrize("strategy,shape", [("one_round", (2, 2, 2)),
                                            ("cascade", (4,))])
def test_triangle_overlap_tiny_out_overflow(strategy, shape):
    # out=8 is far below the triangle count: the shared final
    # compaction must raise the same overflow under every chunking.
    tables = [edges(np.random.default_rng(3), 8, 64)] * 3
    caps = dict(recv=512, mid=4096, out=8, local=1024)
    assert_overlap_invisible(
        lambda chunks: triangle_port(strategy, shape, chunks, caps=caps,
                                     tables=tables),
        expect_overflow=True)


def test_star_one_round_overlap():
    rng = np.random.default_rng(4)
    query = T.JoinQuery.star(3)
    rels = T.query_table_inputs(query, [edges(rng, 10, 40)] * 3, (4,),
                                device="cpu")
    caps = T.ChainCaps(recv=512, mid=4096, out=8192, local=1024)

    def fn(chunks):
        return T.execute_query(T.SimGrid((4,)), query, rels,
                               strategy="one_round", caps=caps,
                               overlap_chunks=chunks)

    assert_overlap_invisible(fn)


@pytest.mark.parametrize("lead", [(), (2, 3)], ids=["flat", "laned"])
def test_split_concat_rows_partition_rows_exactly(lead):
    """Flat and laned ``(L, *grid, rows)`` layouts alike: the blocks
    partition the trailing axis, cut where the JAX package cuts."""
    rng = np.random.default_rng(5)
    shape = lead + (37,)
    cols = {"b": torch.as_tensor(rng.integers(0, 9, shape), dtype=torch.int32),
            "v": torch.as_tensor(rng.random(shape), dtype=torch.float32)}
    valid = torch.as_tensor(rng.random(shape) < 0.6)
    rel = T.Relation(cols, valid)
    for chunks in (1, 2, 3, 5, 37, 100):
        parts = split_rows(rel, chunks)
        assert len(parts) == min(max(1, chunks), rel.capacity)
        assert sum(p.capacity for p in parts) == rel.capacity
        assert [p.capacity for p in parts] == [
            (c + 1) * 37 // len(parts) - c * 37 // len(parts)
            for c in range(len(parts))]
        assert sum(int(p.valid.sum()) for p in parts) == int(valid.sum())
        merged = concat_rows(parts)
        assert torch.equal(merged.valid, valid)
        for n in cols:
            assert torch.equal(merged.cols[n], cols[n])


def test_hop_time_model():
    # C=1 degenerates to the staged time exactly
    assert hop_time_overlapped(3.0, 5.0, 1) == hop_time_staged(3.0, 5.0)
    # never exceeds staged; non-increasing in C when both phases run
    prev = hop_time_staged(4.0, 6.0)
    for c in (1, 2, 3, 4, 8, 16):
        t = hop_time_overlapped(4.0, 6.0, c)
        assert t <= prev + 1e-12, c
        prev = t
    # C→∞ limit: the longer phase
    assert abs(hop_time_overlapped(4.0, 6.0, 10 ** 6) - 6.0) < 1e-3
    # fully compute-bound hiding: fraction → 1 as C grows
    frac = overlap_hidden_fraction(hop_time_staged(4.0, 6.0),
                                   hop_time_overlapped(4.0, 6.0, 8), 4.0)
    assert 0.8 < frac <= 1.0
    # degenerate zero-shuffle hop
    assert overlap_hidden_fraction(5.0, 5.0, 0.0) == 0.0
    assert overlap_hidden_fraction(5.0, 5.0, -1.0) == 0.0


# ---------------------------------------------------------------------------
# The port against the JAX package's overlapped runs, as full arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunks", CHUNK_COUNTS)
def test_two_way_join_overlap_matches_jax(chunks):
    assert_same_result(two_way_port(chunks), jax_two_way()[chunks])


@pytest.mark.parametrize("chunks", CHUNK_COUNTS)
@pytest.mark.parametrize("strategy,shape", [("one_round", (2, 2, 2)),
                                            ("cascade", (4,))])
def test_triangle_overlap_matches_jax(strategy, shape, chunks):
    """``one_round_query`` streams the last relation through placement
    against the head of the chain (the closing hop filters per chunk);
    ``cascade_query`` chunks every round's right side."""
    got = triangle_port(strategy, shape, chunks)
    assert_same_result(got, jax_triangle(strategy, shape)[chunks])
    assert int(got[0].count().sum()) == 3 * T.oracle_triangles(
        *TRI_TABLES[0])


# ---------------------------------------------------------------------------
# On a GPU
# ---------------------------------------------------------------------------

def as_numpy(result):
    out, stats, ovf = result
    cols, valid = interop.relation_to_numpy(out)
    return cols, valid, {k: float(v) for k, v in stats.items()}, bool(ovf)


def assert_equal_numpy(a, b):
    (ca, va, sa, oa), (cb, vb, sb, ob) = a, b
    np.testing.assert_array_equal(va, vb)
    assert sorted(ca) == sorted(cb)
    for n in ca:
        np.testing.assert_array_equal(ca[n], cb[n], err_msg=n)
    assert sa == sb and oa == ob


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", CHUNK_COUNTS)
def test_gpu_schedule_equals_the_cpu_schedule(cuda, chunks):
    """The chunked schedule on the GPU (its kernels and the scatter
    shuffle) equals the CPU's, array for array, for the two-way join and
    both triangle lowerings."""
    assert_equal_numpy(as_numpy(two_way_port(chunks, device=cuda)),
                       as_numpy(two_way_port(chunks)))
    for strategy, shape in (("one_round", (2, 2, 2)), ("cascade", (4,))):
        assert_equal_numpy(
            as_numpy(triangle_port(strategy, shape, chunks, device=cuda)),
            as_numpy(triangle_port(strategy, shape, chunks)))


@pytest.mark.cuda
def test_overlapped_plan_captures_and_replays_equal_to_eager(cuda):
    """An overlapped plan captures every chunk into one graph: the
    replay equals the eager run array for array."""
    query = T.JoinQuery.triangle()
    for strategy, shape in (("one_round", (2, 2, 2)), ("cascade", (4,))):
        rels = T.query_table_inputs(query, TRI_TABLES, shape, device=cuda)
        kw = dict(strategy=strategy, caps=T.ChainCaps(**TRI_CAPS),
                  overlap_chunks=3)
        eager = as_numpy(T.execute_query(T.SimGrid(shape), query, rels, **kw))
        run = T.jit_execute_query(T.SimGrid(shape), query, donate=False, **kw)
        for _ in range(3):
            assert_equal_numpy(as_numpy(run(rels)), eager)
    T.clear_compiled_caches()


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_query_engine_serves_an_overlapped_plan(device, monkeypatch):
    """The engine runs whatever plan ``jit_execute_query`` returns (on a
    GPU through the same CUDA graphs): with ``overlap_chunks=2`` bound
    in, a cold and a warm triangle submission are answered exactly, the
    warm one a cache hit, equal to the staged engine's answer."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core import executor as ex
    from repro_torch.serving import QueryEngine, QueryServeConfig
    from repro_torch.serving import engine as engine_mod

    query = T.JoinQuery.triangle()
    staged = QueryEngine(QueryServeConfig(k=4), device=device).submit(
        query, TRI_TABLES)
    monkeypatch.setattr(engine_mod, "jit_execute_query", functools.partial(
        ex.jit_execute_query, overlap_chunks=2))
    eng = QueryEngine(QueryServeConfig(k=4), device=device)
    cold, warm = (eng.submit(query, TRI_TABLES) for _ in range(2))
    assert cold.ok and warm.ok, (cold.error, warm.error)
    assert not cold.cache_hit and warm.cache_hit
    assert eng._cache[next(iter(eng._cache))].run.opts["overlap_chunks"] == 2
    for res in (cold, warm):
        assert res.measured == staged.measured
        assert res.output.to_tuple_set() == staged.output.to_tuple_set()
        assert int(res.output.count().sum()) == 3 * T.oracle_triangles(
            *TRI_TABLES[0])
    T.clear_compiled_caches()
