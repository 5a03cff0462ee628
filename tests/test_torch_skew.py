"""The port's skew path against the JAX package, on the CPU.

* ``hash_histogram`` (per-block layout), ``bucket_counts`` and
  ``partition_offsets``: the plain versions against the JAX kernel in
  interpret mode and against its oracle ``ref.masked_hash_histogram``,
  as integers.  int64 keys above 2^32 have no JAX counterpart (the two
  packages hash them differently, ROADMAP C1): they are held to a numpy
  oracle of the folded hash.
* ``heavy_hitters`` and ``detect_chain_skew``: heavy keys, counts,
  combinations, sizes and grids equal the JAX package's.
* ``execute_chain(measure_skew=True)`` for ``one_round`` and
  ``cascade_pushdown``, and ``shares_skew_chain`` for enumeration,
  aggregated and empty plans: every column, the mask, row order and
  padding, the overflow flag and every stat equal the reference's.

Each JAX executor reference is jitted with its plan closed over and
computed once per module, shared by both of the port's joins.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import repro.core as J  # noqa: E402
from repro.core.executor import jit_execute_chain  # noqa: E402
from repro.kernels import hash_partition as jhp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import hash_partition as thp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

from _torch_jax import XLA_FAST, run_fast  # noqa: E402

K = 16
CAPS = dict(recv=128, mid=2048, out=2048, local=256, agg=1024, join=2048)
JOINS = ["sort_merge", "fused"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are tiny.  Under a parallel test run the
    intra-op thread pool oversubscribes the CPU and slows each torch op
    by two orders of magnitude (measured: 0.14 s against 10.5 s for one
    case beside six busy processes), so this module runs on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def combo_caps(pkg, grid_shape):
    """Per-combination caps: the heavy-heavy combination holds every
    path through the hot key on its one device."""
    big = dict(CAPS, out=8192, join=8192) if grid_shape == (1, 1) else CAPS
    return pkg.ChainCaps(**big)

# The JAX oracles, jitted: one compile per shape instead of one per op,
# without XLA's backend optimizations (integer results).
masked_hash_histogram = jax.jit(jref.masked_hash_histogram,
                                static_argnames=("n_buckets", "salt", "block"),
                                compiler_options=XLA_FAST)
jax_bucket_counts = jax.jit(
    lambda keys, valid, n_buckets, salt: jhp.bucket_counts(
        keys, valid, n_buckets, salt=salt, use_pallas=False),
    static_argnums=(2, 3), compiler_options=XLA_FAST)
jax_partition_offsets = jax.jit(jhp.partition_offsets,
                                compiler_options=XLA_FAST)


def hot_edges(rng, n_nodes=40, n_edges=72, hot=0.4):
    """Uniform edges with a constructed heavy hitter: key 0 takes a
    ``hot`` fraction of both columns (``tests/test_skew.py``)."""
    src = rng.integers(1, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(1, n_nodes, n_edges).astype(np.int32)
    src[rng.random(n_edges) < hot] = 0
    dst[rng.random(n_edges) < hot] = 0
    return src, dst


HOT = [hot_edges(np.random.default_rng(7)) for _ in range(3)]
_U = np.random.default_rng(2)
UNIFORM = [(_U.integers(0, 200, 120).astype(np.int32),
            _U.integers(0, 200, 120).astype(np.int32)) for _ in range(3)]


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
        assert float(v) == float(j_stats[k]), k


# ---------------------------------------------------------------------------
# hash_histogram, bucket_counts, partition_offsets
# ---------------------------------------------------------------------------

def hist_case(n, seed, hi=1 << 30):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, n).astype(np.int32), rng.random(n) < 0.8)


@pytest.mark.parametrize("n,k,salt,block", [(777, 130, 1, 256),
                                            (64, 3, 3, 1024)])
def test_hash_histogram_plain_matches_pallas_interpret(n, k, salt, block):
    """Two rows batched over a leading axis, each equal to the JAX
    kernel run in interpret mode — the JAX layout, short last block and
    the below-128 block rule included."""
    rows = [hist_case(n, seed) for seed in (n, n + 1)]
    keys = torch.as_tensor(np.stack([r[0] for r in rows]))
    valid = torch.as_tensor(np.stack([r[1] for r in rows]))
    got = thp.hash_histogram(keys, valid, k, salt=salt, block=block)
    assert got.dtype == torch.int32
    for b, (kb, vb) in enumerate(rows):
        want = jhp.hash_histogram(jnp.asarray(kb), jnp.asarray(vb), k,
                                  salt=salt, block=block, interpret=True)
        assert got[b].shape == want.shape
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


# The TestHashHistogram grid of tests/test_kernels.py, then the other
# salts and the detector's 4,096 buckets.
HIST_GRID = [(n, k, salt) for n, k in [(256, 4), (1024, 16), (777, 130),
                                       (64, 3)] for salt in (0, 1)] + \
    [(300, 5, 2), (5000, 4096, 3)]


@pytest.mark.parametrize("n,k,salt", HIST_GRID)
def test_hash_histogram_matches_masked_ref(n, k, salt):
    keys, valid = hist_case(n, n * k + salt)
    block = 256
    got = thp.hash_histogram(torch.as_tensor(keys), torch.as_tensor(valid),
                             k, salt=salt, block=block)
    b = ref.histogram_block(n, block)
    assert b == min(block, max(128, 1 << (n - 1).bit_length()))
    pad = -n % b
    want = masked_hash_histogram(
        jnp.pad(jnp.asarray(keys), (0, pad)),
        jnp.pad(jnp.asarray(valid), (0, pad)), k, salt=salt, block=b)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == int(valid.sum())
    counts = thp.bucket_counts(torch.as_tensor(keys), torch.as_tensor(valid),
                               k, salt=salt)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(
        jax_bucket_counts(jnp.asarray(keys), jnp.asarray(valid), k, salt)))
    offs = thp.partition_offsets(got)
    assert offs.dtype == torch.int32
    np.testing.assert_array_equal(offs.numpy(), np.asarray(
        jax_partition_offsets(want)))


def test_hash_histogram_int64_keys_below_2_32_match_jax():
    """Non-negative int64 keys below 2^32 hash as their uint32 bits, so
    they equal the JAX package's int32 keys of the same bits."""
    rng = np.random.default_rng(11)
    keys = rng.integers(0, 1 << 32, 900, dtype=np.int64)
    valid = rng.random(900) < 0.9
    got = thp.hash_histogram(torch.as_tensor(keys), torch.as_tensor(valid),
                             130, salt=2, block=256)
    pad = -900 % 256
    want = masked_hash_histogram(
        jnp.pad(jnp.asarray(keys.astype(np.uint32).view(np.int32)), (0, pad)),
        jnp.pad(jnp.asarray(valid), (0, pad)), 130, salt=2, block=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def np_bucket_hash(keys, n_buckets, salt):
    """The folded hash in numpy's own unsigned arithmetic — an oracle
    independent of the port's int64 emulation."""
    from repro_torch.core.hashing import _KNUTH, _SALTS
    u64 = keys.astype(np.int64).view(np.uint64)
    u = ((u64 ^ (u64 >> np.uint64(32))) & np.uint64(0xFFFFFFFF)) \
        .astype(np.uint32)
    with np.errstate(over="ignore"):
        u = (u ^ np.uint32(_SALTS[salt % 4])) * np.uint32(_KNUTH)
        u = u ^ (u >> np.uint32(15))
        u = u * np.uint32(0x846CA68B)
        u = u ^ (u >> np.uint32(13))
    return (u % np.uint32(n_buckets)).astype(np.int64)


def test_hash_histogram_int64_keys_above_2_32_match_numpy_oracle():
    rng = np.random.default_rng(12)
    keys = rng.integers(-(1 << 62), 1 << 62, (2, 700), dtype=np.int64)
    valid = rng.random((2, 700)) < 0.8
    got = thp.hash_histogram(torch.as_tensor(keys), torch.as_tensor(valid),
                             3, salt=1, block=256)
    assert got.shape == (2, 3, 3)
    for b in range(2):
        blk = np.arange(700) // 256
        cell = blk * 3 + np_bucket_hash(keys[b], 3, 1)
        want = np.bincount(cell[valid[b]], minlength=9).reshape(3, 3)
        np.testing.assert_array_equal(got[b].numpy(), want)


# ---------------------------------------------------------------------------
# Heavy-hitter detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [5.0, 20.0, float("inf")])
def test_heavy_hitters_match_jax(threshold):
    rng = np.random.default_rng(5)
    vals = np.concatenate([np.full(40, 7), np.full(25, 3), np.full(6, 9),
                           rng.integers(10, 500, 300)]).astype(np.int32)
    rng.shuffle(vals)
    keys, counts = T.heavy_hitters(vals, threshold, device="cpu")
    j_keys, j_counts = J.heavy_hitters(vals, threshold)
    for got, want in ((keys, j_keys), (counts, j_counts)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_c1_int64_heavy_key_above_2_32_found_by_port():
    """ROADMAP C1: a key that needs 64 bits is hashed with the folded
    hash in both passes, so the port finds it; its count equals the
    numpy exact count."""
    rng = np.random.default_rng(6)
    heavy = (3 << 32) + 7
    vals = np.concatenate([np.full(50, heavy),
                           rng.integers(0, 1 << 40, 400)]).astype(np.int64)
    rng.shuffle(vals)
    keys, counts = T.heavy_hitters(vals, 30.0, device="cpu")
    u, c = np.unique(vals, return_counts=True)
    assert keys.dtype == np.int64
    assert keys.tolist() == u[c > 30].tolist() == [heavy]
    assert counts.tolist() == [float(c[u == heavy][0])] == [50.0]


def plan_fields(plan):
    if plan is None:
        return None
    return (tuple(h.tolist() for h in plan.heavy),
            tuple(dataclasses.astuple(c) for c in plan.combos),
            plan.base_shape, plan.k, plan.cost(), plan.read_cost())


@pytest.mark.parametrize("edges", [HOT, UNIFORM], ids=["hot", "uniform"])
def test_detect_chain_skew_matches_jax(edges):
    got = T.detect_chain_skew(T.ChainQuery.three_way(), edges, K,
                              device="cpu")
    want = J.detect_chain_skew(J.ChainQuery.three_way(), edges, K)
    assert plan_fields(got) == plan_fields(want)
    assert (got is None) == (edges is UNIFORM)


# ---------------------------------------------------------------------------
# measure_skew on the ordinary strategies
# ---------------------------------------------------------------------------

GRID = (2, 2)
STATS = T.chain_stats_exact(HOT)
SKEW_CAPS = T.default_chain_caps(STATS, GRID)
MEASURED = [("one_round", False), ("cascade_pushdown", True)]


@pytest.fixture(scope="module")
def measured_refs():
    """The JAX package's ``execute_chain(measure_skew=True)`` per
    strategy, jitted, computed once for both joins."""
    refs = {}
    for strategy, aggregate in MEASURED:
        jq = J.ChainQuery.three_way(aggregate=aggregate)
        run = jit_execute_chain(
            J.SimGrid(GRID), jq, strategy=strategy,
            caps=J.ChainCaps(**dataclasses.asdict(SKEW_CAPS)), donate=False,
            measure_skew=True)
        refs[strategy] = run_fast(run, J.chain_edge_inputs(jq, HOT, GRID))
    return refs


@pytest.mark.parametrize("join_impl", JOINS)
@pytest.mark.parametrize("strategy,aggregate", MEASURED,
                         ids=[m[0] for m in MEASURED])
def test_execute_chain_measure_skew_matches_jax(measured_refs, strategy,
                                                aggregate, join_impl):
    q = T.ChainQuery.three_way(aggregate=aggregate)
    rels = T.chain_edge_inputs(q, HOT, GRID, device="cpu")
    got = T.execute_chain(T.SimGrid(GRID), q, rels, strategy=strategy,
                          caps=SKEW_CAPS, measure_skew=True,
                          join_impl=join_impl)
    assert_same_result(got, measured_refs[strategy])
    stats = got[1]
    assert 0 < float(stats["max_bucket_load"]) <= float(stats["read"])
    # The measurement changes no other stat.
    plain = T.execute_chain(T.SimGrid(GRID), q, rels, strategy=strategy,
                            caps=SKEW_CAPS, join_impl=join_impl)[1]
    assert {k: float(v) for k, v in plain.items()} == \
        {k: float(v) for k, v in stats.items() if k != "max_bucket_load"}


# ---------------------------------------------------------------------------
# SharesSkew
# ---------------------------------------------------------------------------

def flat_inputs(pkg, query, edges, **kw):
    return [pkg.edge_relation(s, d, names=query.schema(j), **kw)
            for j, (s, d) in enumerate(edges)]


@pytest.fixture(scope="module")
def skew_refs():
    """The JAX package's ``shares_skew_chain`` with ``measure_skew`` for
    both query kinds, one jitted program with the plans closed over:
    the kinds read the same relations, and XLA compiles what they share
    once."""
    kinds = {a: J.ChainQuery.three_way(aggregate=a) for a in (False, True)}
    assert [kinds[False].schema(j) for j in range(3)] == \
        [kinds[True].schema(j) for j in range(3)]
    plans = {a: J.detect_chain_skew(q, HOT, K) for a, q in kinds.items()}
    run = jax.jit(lambda *r: {a: J.shares_skew_chain(
        q, list(r), plans[a], caps=lambda c: combo_caps(J, c.grid_shape),
        measure_skew=True) for a, q in kinds.items()})
    return run_fast(run, *flat_inputs(J, kinds[False], HOT))


@pytest.mark.parametrize("join_impl", JOINS)
@pytest.mark.parametrize("aggregate", [False, True], ids=["1,3JS", "1,3JSA"])
def test_shares_skew_chain_matches_jax(skew_refs, aggregate, join_impl):
    q = T.ChainQuery.three_way(aggregate=aggregate)
    plan = T.detect_chain_skew(q, HOT, K, device="cpu")
    assert [c.grid_shape for c in plan.combos] == [(4, 4), (4, 1), (1, 4),
                                                   (1, 1)]
    got = T.shares_skew_chain(q, flat_inputs(T, q, HOT, device="cpu"), plan,
                              caps=lambda c: combo_caps(T, c.grid_shape),
                              measure_skew=True, join_impl=join_impl)
    assert_same_result(got, skew_refs[aggregate])
    out, stats, ovf = got
    assert not bool(ovf)
    j3 = STATS.prefix_joins[-1]
    if aggregate:
        assert float(stats["total"]) == plan.cost() + 2.0 * j3
        assert float(out.cols["p"][out.valid].sum()) == j3
    else:
        assert float(stats["read"]) == plan.read_cost()
        assert float(stats["shuffled"]) == plan.shuffle_cost()
        assert int(out.count()) == j3


@pytest.mark.parametrize("aggregate", [False, True], ids=["1,3JS", "1,3JSA"])
def test_shares_skew_chain_empty_plan_matches_jax(aggregate):
    """R1.dst is one heavy key that R2.src never holds: every combination
    loses an input, so the join is empty at zero cost."""
    rng = np.random.default_rng(9)
    n = 48
    edges = [(rng.integers(1, 30, n).astype(np.int32), np.full(n, 5, np.int32)),
             (rng.integers(6, 30, n).astype(np.int32),
              rng.integers(0, 30, n).astype(np.int32)),
             (rng.integers(0, 30, n).astype(np.int32),
              rng.integers(0, 30, n).astype(np.int32))]
    jq = J.ChainQuery.three_way(aggregate=aggregate)
    tq = T.ChainQuery.three_way(aggregate=aggregate)
    plan = T.detect_chain_skew(tq, edges, K, device="cpu")
    j_plan = J.detect_chain_skew(jq, edges, K)
    assert plan.combos == () and plan_fields(plan) == plan_fields(j_plan)
    want = J.shares_skew_chain(jq, flat_inputs(J, jq, edges), j_plan,
                               caps=J.ChainCaps(**CAPS), measure_skew=True)
    got = T.shares_skew_chain(tq, flat_inputs(T, tq, edges, device="cpu"),
                              plan, caps=T.ChainCaps(**CAPS),
                              measure_skew=True)
    assert_same_result(got, want)


def test_shares_skew_strategy_raises_value_error():
    q = T.ChainQuery.three_way()
    rels = T.chain_edge_inputs(q, HOT, GRID, device="cpu")
    for run in (T.execute_chain, T.execute_query):
        with pytest.raises(ValueError, match="shares_skew_chain"):
            run(T.SimGrid(GRID), q, rels, strategy="shares_skew",
                caps=SKEW_CAPS)
