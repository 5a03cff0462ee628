"""The port's main path against the JAX package, on the CPU.

``ChainQuery.three_way()`` → ``chain_stats_exact`` → ``plan_chain`` →
``chain_edge_inputs`` → ``execute_chain`` on a (2, 2) ``SimGrid``, over
the README quickstart's 100-edge graph, for the four strategies the
paper compares (1,3J, 2,3J, 2,3JA and 1,3JA) under both reduce-side
joins (``sort_merge`` and ``fused``).  The output relation (every
column, the validity mask, row order and padding), the read/shuffled
stats and the overflow flag equal the reference's exactly — every sum
here is integer-valued — and measured equals the cost model.  The
port's ``jit_execute_chain`` is held to the same references.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
from repro.core.executor import (jit_execute_chain,  # noqa: E402
                                 jit_execute_query)
import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402

from _torch_jax import run_fast  # noqa: E402

GRID = (2, 2)
K = 4


def quickstart_edges():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 32, 100).astype(np.int32)
    dst = rng.integers(0, 32, 100).astype(np.int32)
    return [(src, dst)] * 3


EDGES = quickstart_edges()
STATS = T.chain_stats_exact(EDGES, sketch_top_k=16)
CAPS = T.default_chain_caps(STATS, GRID)

# (paper name, aggregated query, executor strategy)
STRATEGIES = [("1,3J", False, "one_round"), ("2,3J", False, "cascade"),
              ("2,3JA", True, "cascade_pushdown"), ("1,3JA", True, "one_round")]


def analytic_total(name):
    sizes, pj = STATS.sizes, STATS.prefix_joins
    if name == "1,3J":
        return cm.cost_chain_one_round(sizes, K, shares=GRID)
    if name == "2,3J":
        return cm.cost_chain_cascade(sizes, pj)
    if name == "2,3JA":
        return cm.cost_chain_cascade_pushdown(sizes, pj, STATS.prefix_aggs,
                                              STATS.pushdown_joins)
    return cm.cost_chain_one_round_agg(sizes, K, pj[-1], shares=GRID)


def test_stats_plans_and_caps_match_jax():
    j_stats = J.chain_stats_exact(EDGES, sketch_top_k=16)
    assert dataclasses.asdict(STATS) == dataclasses.asdict(j_stats)
    for agg in (False, True):
        for k in (4, 16, 64):
            got = T.plan_chain(STATS, k=k, aggregate=agg)
            want = J.plan_chain(j_stats, k=k, aggregate=agg)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(CAPS) == dataclasses.asdict(
        J.default_chain_caps(j_stats, GRID))
    assert dataclasses.asdict(T.default_chain_caps(STATS, (4, 4))) == \
        dataclasses.asdict(J.default_chain_caps(j_stats, (4, 4)))


@functools.lru_cache(maxsize=None)
def jax_reference(aggregate, strategy, local_combine=False):
    """The JAX package's ``(cols, valid, stats, overflow)`` as numpy.

    Run jitted (the JAX package's own tests hold it equal to the eager
    executor, and it compiles several times faster) and once per
    strategy, with ``join_impl="sort_merge"``: the reference's fused
    join shares the staged join's emit tail and equals it bit for bit,
    so both of the port's joins are held to this one result.
    """
    jq = J.ChainQuery.three_way(aggregate=aggregate)
    run = jit_execute_chain(J.SimGrid(GRID), jq, strategy=strategy,
                            caps=J.ChainCaps(**dataclasses.asdict(CAPS)),
                            donate=False, join_impl="sort_merge",
                            local_combine=local_combine)
    out, stats, ovf = run_fast(run, J.chain_edge_inputs(jq, EDGES, GRID))
    return ({n: np.asarray(c) for n, c in out.cols.items()},
            np.asarray(out.valid), {k: float(v) for k, v in stats.items()},
            bool(ovf))


def run_port(aggregate, strategy, join_impl, local_combine=False):
    q = T.ChainQuery.three_way(aggregate=aggregate)
    rels = T.chain_edge_inputs(q, EDGES, GRID, device="cpu")
    return T.execute_chain(T.SimGrid(GRID), q, rels, strategy=strategy,
                           caps=CAPS, join_impl=join_impl,
                           local_combine=local_combine)


def assert_matches_reference(got, want):
    """Every column, the mask, row order and padding, every stat and
    the overflow flag equal the reference's exactly."""
    out, stats, ovf = got
    j_cols, j_valid, j_stats, j_ovf = want
    assert not bool(ovf) and not j_ovf
    cols, valid = interop.relation_to_numpy(out)
    assert valid.shape == GRID + (CAPS.out,)
    np.testing.assert_array_equal(valid, j_valid)
    assert sorted(cols) == sorted(j_cols)
    for n, c in cols.items():
        assert c.dtype == j_cols[n].dtype, n
        np.testing.assert_array_equal(c, j_cols[n], err_msg=n)
    assert sorted(stats) == sorted(j_stats)
    for k, v in stats.items():
        assert v.dtype == torch.float32, k
        assert float(v) == j_stats[k], k


def result_total(out, aggregate):
    """Paths in the result: the sum of the counts, or the row count."""
    if aggregate:
        return float(out.cols["p"][out.valid].sum())
    return int(out.count().sum())


@pytest.mark.parametrize("join_impl", ["sort_merge", "fused"])
@pytest.mark.parametrize("name,aggregate,strategy", STRATEGIES,
                         ids=[s[0] for s in STRATEGIES])
def test_execute_chain_matches_jax(name, aggregate, strategy, join_impl):
    got = run_port(aggregate, strategy, join_impl)
    assert_matches_reference(got, jax_reference(aggregate, strategy))
    out, stats, _ = got
    # Measured communication equals the cost model exactly.
    measured = float(stats["read"]) + float(stats["shuffled"])
    assert measured == analytic_total(name)
    assert result_total(out, aggregate) == STATS.prefix_joins[-1]


@pytest.mark.parametrize("join_impl", ["sort_merge", "fused"])
@pytest.mark.parametrize("name,aggregate,strategy", STRATEGIES,
                         ids=[s[0] for s in STRATEGIES])
def test_jit_execute_chain_matches_jax(name, aggregate, strategy, join_impl):
    """The port's compiled executable (on the CPU: the cached eager
    call) against the same JAX ``jit_execute_chain`` references."""
    q = T.ChainQuery.three_way(aggregate=aggregate)
    run = T.jit_execute_chain(T.SimGrid(GRID), q, strategy=strategy,
                              caps=CAPS, donate=False, join_impl=join_impl)
    got = run(T.chain_edge_inputs(q, EDGES, GRID, device="cpu"))
    assert_matches_reference(got, jax_reference(aggregate, strategy))


@pytest.mark.parametrize("join_impl", ["sort_merge", "fused"])
def test_execute_chain_local_combine_matches_jax(join_impl):
    """2,3JA with the combiner (``local_combine=True``): each aggregation
    round sums locally before its shuffle, so fewer tuples are shuffled
    than the cost model charges, and the answer is unchanged."""
    got = run_port(True, "cascade_pushdown", join_impl, local_combine=True)
    assert_matches_reference(
        got, jax_reference(True, "cascade_pushdown", local_combine=True))
    out, stats, _ = got
    measured = float(stats["read"]) + float(stats["shuffled"])
    assert measured < analytic_total("2,3JA")
    assert result_total(out, True) == STATS.prefix_joins[-1]


def test_fused_is_bit_identical_to_sort_merge_on_a_4x4_grid():
    q = T.ChainQuery.three_way(aggregate=True)
    caps = T.default_chain_caps(STATS, (4, 4))
    res = {}
    for impl in ("sort_merge", "fused"):
        rels = T.chain_edge_inputs(q, EDGES, (4, 4), device="cpu")
        res[impl] = T.execute_chain(T.SimGrid((4, 4)), q, rels,
                                    strategy="cascade_pushdown", caps=caps,
                                    join_impl=impl)
    (a, sa, fa), (b, sb, fb) = res["sort_merge"], res["fused"]
    assert torch.equal(a.valid, b.valid) and not bool(fa | fb)
    for n in a.cols:
        assert torch.equal(a.cols[n], b.cols[n]), n
    assert {k: float(v) for k, v in sa.items()} == \
        {k: float(v) for k, v in sb.items()}


@pytest.mark.parametrize("strategy,grid", [("one_round", (2, 2, 2)),
                                           ("cascade", (4,))])
def test_execute_query_triangle_matches_jax(strategy, grid):
    """The general lowerings: a cyclic query whose closing hop filters
    (``_close_cycle``), built by ``query_table_inputs`` and sized by
    ``default_query_caps``."""
    jq, tq = J.JoinQuery.triangle(), T.JoinQuery.triangle()
    tables = [EDGES[0]] * 3
    stats = T.query_stats_exact(tq, tables)
    caps = T.default_query_caps(tq, stats, grid)
    j_caps = J.default_query_caps(jq, J.query_stats_exact(jq, tables), grid)
    assert dataclasses.asdict(caps) == dataclasses.asdict(j_caps)
    run = jit_execute_query(J.SimGrid(grid), jq, strategy=strategy,
                            caps=j_caps, donate=False)
    j_out, j_stats, j_ovf = run_fast(run, J.query_table_inputs(jq, tables,
                                                             grid))
    out, st, ovf = T.execute_query(
        T.SimGrid(grid), tq,
        T.query_table_inputs(tq, tables, grid, device="cpu"),
        strategy=strategy, caps=caps)
    assert not bool(ovf) and not bool(j_ovf)
    cols, valid = interop.relation_to_numpy(out)
    np.testing.assert_array_equal(valid, np.asarray(j_out.valid))
    assert sorted(cols) == sorted(j_out.cols)
    for n, c in cols.items():
        np.testing.assert_array_equal(c, np.asarray(j_out.cols[n]), err_msg=n)
    assert {k: float(v) for k, v in st.items()} == \
        {k: float(v) for k, v in j_stats.items()}
    assert int(out.count().sum()) == 3 * T.oracle_triangles(*EDGES[0])


@pytest.mark.parametrize("option", [
    dict(measure_skew=True), dict(overlap_chunks=2),
    dict(strategy="mapside"), dict(strategy="shares_skew")],
    ids=["measure_skew", "overlap_chunks", "mapside", "shares_skew"])
def test_each_option_runs_or_raises_the_reference_error(option):
    """Options that once raised ``NotImplementedError`` in the port:
    ``measure_skew`` runs and adds ``max_bucket_load``;
    ``overlap_chunks=2`` runs the overlapped schedule, with the staged
    run's stats, overflow flag and tuples (its full arrays are held to
    the JAX package's overlapped 2,3J cascade in
    ``tests/test_torch_overlap_chain.py``); ``shares_skew`` raises the
    reference's ``ValueError`` pointing to its own entry point,
    ``shares_skew_chain``; and ``mapside`` without a certificate raises
    the reference's ``ValueError`` asking for one."""
    q = T.ChainQuery.three_way()
    rels = T.chain_edge_inputs(q, EDGES, GRID, device="cpu")
    kw = dict(strategy="cascade", caps=CAPS)
    kw.update(option)
    if option.get("measure_skew"):
        _, stats, ovf = T.execute_chain(T.SimGrid(GRID), q, rels, **kw)
        assert not bool(ovf)
        assert 0 < float(stats["max_bucket_load"]) <= float(stats["read"])
    elif option.get("strategy") == "shares_skew":
        with pytest.raises(ValueError, match="shares_skew_chain"):
            T.execute_chain(T.SimGrid(GRID), q, rels, **kw)
    elif option.get("strategy") == "mapside":
        with pytest.raises(ValueError, match="partitioning and hop_modes"):
            T.execute_chain(T.SimGrid(GRID), q, rels, **kw)
    else:
        out, stats, ovf = T.execute_chain(T.SimGrid(GRID), q, rels, **kw)
        s_out, s_stats, s_ovf = T.execute_chain(
            T.SimGrid(GRID), q, rels, strategy="cascade", caps=CAPS)
        assert not bool(ovf) and not bool(s_ovf)
        assert {k: float(v) for k, v in stats.items()} == \
            {k: float(v) for k, v in s_stats.items()}
        assert out.to_tuple_set() == s_out.to_tuple_set()
        assert result_total(out, False) == STATS.prefix_joins[-1]


def test_unknown_strategy_and_missing_aggregate_raise():
    q = T.ChainQuery.three_way()
    rels = T.chain_edge_inputs(q, EDGES, GRID, device="cpu")
    with pytest.raises(ValueError, match="unknown strategy"):
        T.execute_chain(T.SimGrid(GRID), q, rels, strategy="3,3J", caps=CAPS)
    with pytest.raises(ValueError, match="aggregated"):
        T.execute_chain(T.SimGrid(GRID), q, rels, strategy="cascade_pushdown",
                        caps=CAPS)
