"""Whole-plan compilation and laned grids in the port, on the CPU.

``jit_execute_chain`` / ``jit_execute_query`` against the eager
``execute_*`` (every strategy), as full arrays — the JAX package's
``jit_execute_chain`` holds them in ``tests/test_torch_executor.py``,
its ``jit_execute_query`` through the query engines in
``tests/test_torch_serving.py``; the port of the JAX package's
``audit_jit_cache`` (an identical plan hits, every option flip misses); and ``SimGrid(shape, lanes=3)`` — the engine's batched
execution — equal to three solo runs for every strategy.  The fixture
is the README quickstart's 100-edge graph of
``tests/test_torch_executor.py``.

The map-side cascade over stored partitions (``strategy="mapside"``)
is held to eager here too.  The ``cuda``-marked tests capture each plan
— the map-side runs among them — as a CUDA graph on a GPU and skip
without one:

    python -m pytest -q -m cuda tests/test_torch_compiled.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

GRID = (2, 2)


def quickstart_edges(seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 32, 100).astype(np.int32)
    dst = rng.integers(0, 32, 100).astype(np.int32)
    return [(src, dst)] * 3


EDGES = quickstart_edges()
STATS = T.chain_stats_exact(EDGES, sketch_top_k=16)
CAPS = T.default_chain_caps(STATS, GRID)

# (paper name, aggregated query, executor strategy, join_impl)
STRATEGIES = [("1,3J", False, "one_round", "sort_merge"),
              ("2,3J", False, "cascade", "fused"),
              ("2,3JA", True, "cascade_pushdown", "sort_merge"),
              ("1,3JA", True, "one_round", "fused")]
IDS = [s[0] for s in STRATEGIES]


def as_numpy(result):
    """``(cols, valid, stats, overflow)`` as numpy, from any device."""
    out, stats, ovf = result
    cols, valid = interop.relation_to_numpy(out)
    return (cols, valid, {k: v.cpu().numpy() for k, v in stats.items()},
            ovf.cpu().numpy())


def assert_equal_results(got, want):
    """Every column, the mask (row order and padding included), every
    stat and the overflow flag, as full arrays."""
    g_cols, g_valid, g_stats, g_ovf = as_numpy(got)
    w_cols, w_valid, w_stats, w_ovf = want
    np.testing.assert_array_equal(g_valid, w_valid)
    assert sorted(g_cols) == sorted(w_cols)
    for n, c in g_cols.items():
        assert c.dtype == w_cols[n].dtype, n
        np.testing.assert_array_equal(c, w_cols[n], err_msg=n)
    assert sorted(g_stats) == sorted(w_stats)
    for k, v in g_stats.items():
        np.testing.assert_array_equal(v, w_stats[k], err_msg=k)
    np.testing.assert_array_equal(g_ovf, w_ovf)


def port_inputs(query, edges=EDGES, grid=GRID, device="cpu"):
    return T.chain_edge_inputs(query, edges, grid, device=device)


@pytest.mark.parametrize("name,aggregate,strategy,impl", STRATEGIES, ids=IDS)
def test_jit_execute_chain_equals_eager(name, aggregate, strategy, impl):
    q = T.ChainQuery.three_way(aggregate=aggregate)
    run = T.jit_execute_chain(T.SimGrid(GRID), q, strategy=strategy,
                              caps=CAPS, donate=False, join_impl=impl)
    got = run(port_inputs(q))
    want = T.execute_chain(T.SimGrid(GRID), q, port_inputs(q),
                           strategy=strategy, caps=CAPS, join_impl=impl)
    assert not bool(got[2])
    assert_equal_results(got, as_numpy(want))


def test_jit_execute_query_matches_eager():
    """The triangle (a cycle: the closing hop filters) on the cascade,
    sized by ``default_query_caps``.  The JAX package's
    ``jit_execute_query`` on the same plan is held to this one through
    the query engines in ``tests/test_torch_serving.py``."""
    grid, order = (4,), (0, 1, 2)
    tq = T.JoinQuery.triangle()
    tables = [EDGES[0]] * 3
    caps = T.default_query_caps(tq, T.query_stats_exact(tq, tables), grid)
    rels = T.query_table_inputs(tq, tables, grid, device="cpu")
    run = T.jit_execute_query(T.SimGrid(grid), tq, strategy="cascade",
                              caps=caps, donate=False, join_order=order)
    got = run(rels)
    assert_equal_results(got, as_numpy(T.execute_query(
        T.SimGrid(grid), tq, rels, strategy="cascade", caps=caps,
        join_order=order)))
    assert int(got[0].count().sum()) == 3 * T.oracle_triangles(*EDGES[0])


# ---------------------------------------------------------------------------
# The executable cache: the port of the JAX package's audit_jit_cache
# ---------------------------------------------------------------------------

def test_jit_cache_identical_plan_hits_every_flip_misses():
    q = T.ChainQuery.three_way()
    base = dict(strategy="one_round", caps=CAPS, donate=False)
    f0 = T.jit_execute_chain(T.SimGrid(GRID), q, **base)
    assert T.jit_execute_chain(T.SimGrid(GRID), q, **base) is f0
    variants = {
        "strategy": dict(base, strategy="cascade"),
        "caps": dict(base, caps=T.ChainCaps(recv=65, mid=128, out=256,
                                            local=64, agg=64, join=128)),
        "donate": dict(base, donate=True),
        "opts(measure_skew)": dict(base, measure_skew=True),
        "opts(join_impl)": dict(base, join_impl="all_pairs"),
        "opts(join_impl=fused)": dict(base, join_impl="fused"),
        "opts(overlap_chunks)": dict(base, overlap_chunks=2),
    }
    for name, kwargs in variants.items():
        assert T.jit_execute_chain(T.SimGrid(GRID), q, **kwargs) is not f0, \
            name
    assert T.jit_execute_chain(T.SimGrid(GRID), T.ChainQuery.chain(4),
                               **base) is not f0, "query"
    laned = T.jit_execute_chain(T.SimGrid(GRID, lanes=3), q, **base)
    assert laned is not f0 and f0.with_lanes(3) is laned, "lanes"
    # jit_execute_query keys the same way, join order included.
    tq = T.JoinQuery.triangle()
    g0 = T.jit_execute_query(T.SimGrid((4,)), tq, strategy="cascade",
                             caps=CAPS, join_order=(0, 1, 2))
    assert T.jit_execute_query(T.SimGrid((4,)), tq, strategy="cascade",
                               caps=CAPS, join_order=(0, 1, 2)) is g0
    assert T.jit_execute_query(T.SimGrid((4,)), tq, strategy="cascade",
                               caps=CAPS, join_order=(1, 2, 0)) is not g0


def test_clear_compiled_caches_drops_every_executable():
    q = T.ChainQuery.three_way()
    f0 = T.jit_execute_chain(T.SimGrid(GRID), q, strategy="cascade",
                             caps=CAPS)
    T.clear_compiled_caches()
    assert T.jit_execute_chain(T.SimGrid(GRID), q, strategy="cascade",
                               caps=CAPS) is not f0


def mapside_inputs(query, edges=EDGES, parts=4):
    """The query's relations stored partitioned on their hop keys, the
    certificate their specs prove, and the planner's hop modes."""
    flat = [T.edge_relation(s, d, names=query.schema(j), device="cpu")
            for j, (s, d) in enumerate(edges)]
    prels = [T.partition_relation(
        r, query.attrs[1] if j == 0 else query.attrs[j], parts)[0]
        for j, r in enumerate(flat)]
    part = T.chain_partitioning(query, [p.spec for p in prels])
    plan = T.plan_chain(STATS, k=parts, aggregate=query.aggregate is not None,
                        partitioning=part)
    return prels, part, plan.hop_modes


@pytest.mark.parametrize("option,item", [
    (dict(overlap_chunks=2), "A9"), (dict(strategy="mapside"), "A11")],
    ids=["overlap_chunks", "mapside"])
def test_later_slices_raise_from_the_call(option, item):
    """Both options of later slices are ported now, and neither raises
    from the call: a compiled overlapped run (``overlap_chunks=2``, A9)
    and a compiled map-side run over stored partitions
    (``strategy="mapside"``, A11) each equal the eager one."""
    q = T.ChainQuery.three_way()
    kw = dict(strategy="cascade", caps=CAPS)
    kw.update(option)
    if option.get("strategy") == "mapside":
        prels, part, modes = mapside_inputs(q)
        caps = T.default_mapside_caps(STATS, 4, slack=8)
        kw.update(caps=caps, partitioning=part, hop_modes=modes,
                  place_output=True)
        run = T.jit_execute_chain(T.SimGrid((4,)), q, donate=False, **kw)
        got = run(prels)
        assert not bool(got[2])
        assert float(got[1]["shuffled"]) == 0.0
        assert_equal_results(got, as_numpy(
            T.execute_chain(T.SimGrid((4,)), q, prels, **kw)))
        return
    run = T.jit_execute_chain(T.SimGrid(GRID), q, donate=False, **kw)
    rels = port_inputs(q)
    got = run(rels)
    assert not bool(got[2])
    assert_equal_results(got, as_numpy(
        T.execute_chain(T.SimGrid(GRID), q, rels, **kw)))
    staged = T.execute_chain(T.SimGrid(GRID), q, rels, strategy="cascade",
                             caps=CAPS)
    assert got[0].to_tuple_set() == staged[0].to_tuple_set()
    assert {k: float(v) for k, v in got[1].items()} == \
        {k: float(v) for k, v in staged[1].items()}


# ---------------------------------------------------------------------------
# SimGrid with a lane axis: L executions in one
# ---------------------------------------------------------------------------

def stack(per_lane):
    """Relation j of every lane on a new leading axis."""
    return [T.Relation({n: torch.stack([rels[j].cols[n] for rels in per_lane])
                        for n in per_lane[0][j].cols},
                       torch.stack([rels[j].valid for rels in per_lane]))
            for j in range(len(per_lane[0]))]


def assert_lanes_equal_solo(laned, solos):
    out, stats, ovf = laned
    assert ovf.shape == (len(solos),)
    for lane, solo in enumerate(solos):
        assert_equal_results(
            (out.map(lambda c: c[lane]), {k: v[lane] for k, v in stats.items()},
             ovf[lane]), as_numpy(solo))


LANE_EDGES = [quickstart_edges(seed) for seed in (0, 1, 2)]
# Caps that hold every lane's graph (each seed has its own statistics).
LANE_CAPS = T.ChainCaps(**{
    f: max(getattr(T.default_chain_caps(T.chain_stats_exact(e), GRID), f)
           for e in LANE_EDGES)
    for f in ("recv", "mid", "out", "local", "agg", "join")})


@pytest.mark.parametrize("name,aggregate,strategy,impl", STRATEGIES, ids=IDS)
def test_lanes_equal_three_solo_runs(name, aggregate, strategy, impl):
    """Three graphs on ``SimGrid(GRID, lanes=3)`` equal three solo runs,
    array for array, with ``measure_skew`` on (the histogram reduction
    is per lane too): a missed lane offset in the shuffle would mix
    tuples across lanes."""
    q = T.ChainQuery.three_way(aggregate=aggregate)
    kw = dict(strategy=strategy, caps=LANE_CAPS, join_impl=impl,
              measure_skew=True)
    per_lane = [port_inputs(q, e) for e in LANE_EDGES]
    solos = [T.execute_chain(T.SimGrid(GRID), q, rels, **kw)
             for rels in per_lane]
    assert not any(bool(s[2]) for s in solos)
    laned = T.execute_chain(T.SimGrid(GRID, lanes=3), q, stack(per_lane), **kw)
    assert_lanes_equal_solo(laned, solos)
    # The compiled executable over lanes is the same computation.
    run = T.jit_execute_chain(T.SimGrid(GRID), q, donate=False, **kw)
    assert_lanes_equal_solo(run.with_lanes(3)(stack(per_lane)), solos)


@pytest.mark.parametrize("strategy,grid", [("one_round", (2, 2, 2)),
                                           ("cascade", (4,))])
def test_lanes_equal_solo_runs_for_a_query(strategy, grid):
    tq = T.JoinQuery.triangle()
    tables = [[e[0]] * 3 for e in LANE_EDGES]
    caps = T.default_query_caps(tq, T.query_stats_exact(tq, tables[0]), grid,
                                slack=12)
    per_lane = [T.query_table_inputs(tq, t, grid, device="cpu")
                for t in tables]
    solos = [T.execute_query(T.SimGrid(grid), tq, rels, strategy=strategy,
                             caps=caps) for rels in per_lane]
    assert not any(bool(s[2]) for s in solos)
    laned = T.execute_query(T.SimGrid(grid, lanes=3), tq, stack(per_lane),
                            strategy=strategy, caps=caps)
    assert_lanes_equal_solo(laned, solos)


def test_lane_is_the_most_significant_device_digit():
    """``shuffle_by_bucket``'s flat device index with a lane axis: a
    tuple routed on grid axis 1 lands on its own lane's device (the
    lane is the most significant digit), and each lane's overflow flag
    is its own."""
    lanes, shape, rows = 2, (2, 3), 4
    key = torch.arange(lanes * 6 * rows, dtype=torch.int32).view(
        lanes, *shape, rows)
    rel = T.Relation({"k": key}, torch.ones_like(key, dtype=torch.bool))
    # Lane 0 sends every tuple to bucket 0; lane 1 spreads them evenly.
    bucket = torch.stack([torch.zeros(shape + (rows,), dtype=torch.int32),
                          (key[1] % 3).to(torch.int32)])
    out, ovf, _ = T.shuffle_by_bucket(T.SimGrid(shape, lanes=lanes), rel,
                                      bucket, 1, recv_capacity=rows,
                                      local_capacity=rows * 2)
    assert ovf.tolist() == [True, False]       # 12 rows into 8 slots
    for lane in range(lanes):
        got = out.cols["k"][lane][out.valid[lane]]
        assert ((got // (6 * rows)) == lane).all()   # never left its lane
    assert int(out.count()[1].sum()) == 6 * rows


# ---------------------------------------------------------------------------
# CUDA graphs (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("measure", [False, True], ids=["", "measure_skew"])
@pytest.mark.parametrize("name,aggregate,strategy,impl", STRATEGIES, ids=IDS)
def test_every_strategy_captures_and_replays_equal_to_eager(
        cuda, name, aggregate, strategy, impl, measure):
    """Capture, then a replay per call: each equals the eager call array
    for array, and each replay launches on the card, by the device
    trace, what the eager call launched.  The wrappers count the
    warm-up's launches and not the capture's, which runs none."""
    T.clear_compiled_caches()
    q = T.ChainQuery.three_way(aggregate=aggregate)
    kw = dict(strategy=strategy, caps=CAPS, join_impl=impl,
              measure_skew=measure)
    rels = port_inputs(q, device=cuda)
    ops.reset_launches()
    eager, traced, _ = ops.traced_launches(
        lambda: T.execute_chain(T.SimGrid(GRID), q, rels, **kw))
    per_call = dict(ops.LAUNCHES)
    assert traced == per_call              # the trace counts as the wrappers
    want = as_numpy(eager)
    run = T.jit_execute_chain(T.SimGrid(GRID), q, donate=False, **kw)
    ops.reset_launches()
    run(rels)                                 # warm-up + capture + replay
    torch.cuda.synchronize()
    assert dict(ops.LAUNCHES) == per_call     # the warm-up's alone
    assert len(run._graphs) == 1
    for _ in range(2):
        ops.reset_launches()
        got, traced, _ = ops.traced_launches(lambda: run(rels))
        assert traced == per_call
        assert not any(ops.LAUNCHES.values())  # a replay runs no wrapper
        assert_equal_results(got, want)
    assert len(run._graphs) == 1              # replays, no recapture
    expect = {"segment_sum": aggregate, "probe_counts": impl == "fused",
              "hash_histogram": measure}
    for kname, used in expect.items():
        assert (per_call[kname] > 0) == used, kname


@pytest.mark.cuda
def test_a_result_stays_valid_after_the_next_replay(cuda):
    """Two replays over different inputs: the first result is a clone,
    not the graph's static output, so the second replay leaves it
    intact."""
    T.clear_compiled_caches()
    q = T.ChainQuery.three_way(aggregate=True)
    kw = dict(strategy="cascade_pushdown", caps=LANE_CAPS)
    run = T.jit_execute_chain(T.SimGrid(GRID), q, donate=False, **kw)
    wants, gots = [], []
    for edges in LANE_EDGES[:2]:
        rels = port_inputs(q, edges, device=cuda)
        wants.append(as_numpy(T.execute_chain(T.SimGrid(GRID), q, rels, **kw)))
        gots.append(run(rels))
    torch.cuda.synchronize()
    assert not np.array_equal(wants[0][1], wants[1][1])
    for got, want in zip(gots, wants):
        assert_equal_results(got, want)


@pytest.mark.cuda
def test_laned_replay_equals_solo_runs(cuda):
    T.clear_compiled_caches()
    q = T.ChainQuery.three_way(aggregate=True)
    kw = dict(strategy="one_round", caps=LANE_CAPS, join_impl="fused")
    per_lane = [port_inputs(q, e, device=cuda) for e in LANE_EDGES]
    solos = [T.execute_chain(T.SimGrid(GRID), q, rels, **kw)
             for rels in per_lane]
    run = T.jit_execute_chain(T.SimGrid(GRID, lanes=3), q, **kw)
    for _ in range(2):
        laned = run(stack(per_lane))
        torch.cuda.synchronize()
        out, stats, ovf = laned
        for lane, solo in enumerate(solos):
            assert_equal_results(
                (out.map(lambda c: c[lane]),
                 {k: v[lane] for k, v in stats.items()}, ovf[lane]),
                as_numpy(solo))


@pytest.mark.cuda
def test_a_capture_error_raises_never_falls_back(cuda, monkeypatch):
    """A host sync inside the plan is legal eagerly and illegal under
    capture: the call raises, and no graph (nor eager result) is kept."""
    T.clear_compiled_caches()
    real = ex.two_way_join

    def syncing(*args, **kwargs):
        out = real(*args, **kwargs)
        float(out[1]["read"])                 # a device-to-host copy
        return out

    monkeypatch.setattr(ex, "two_way_join", syncing)
    q = T.ChainQuery.three_way()
    run = T.jit_execute_chain(T.SimGrid(GRID), q, strategy="cascade",
                              caps=CAPS)
    rels = port_inputs(q, device=cuda)
    with pytest.raises(RuntimeError):
        run(rels)
    assert not run._graphs
    # The failed capture does not poison the next one.
    monkeypatch.undo()
    good = T.jit_execute_chain(T.SimGrid(GRID), q, strategy="cascade",
                               caps=CAPS, donate=False)
    assert_equal_results(good(rels), as_numpy(T.execute_chain(
        T.SimGrid(GRID), q, rels, strategy="cascade", caps=CAPS)))


def mixed_mapside_inputs(query, edges=EDGES, parts=4):
    """R0 grid-scattered, R1 and R2 stored: hop 1 repartitions R0 and,
    with no ``place_output``, hop 2 the intermediate, by the stored hash
    (the branch that launches ``bucket_counts`` under
    ``measure_skew``)."""
    prels, _, _ = mapside_inputs(query, edges, parts)
    rels = [T.scatter_to_grid(prels[0].to_flat(), (parts,))] + prels[1:]
    part = T.chain_partitioning(query, [None] + [p.spec for p in prels[1:]])
    return rels, part, ("mapside", "mapside")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS,3JA", "mixed"])
def test_mapside_captures_and_replays_equal_to_eager(cuda, kind):
    """A map-side plan captured over partitioned inputs: three replays
    equal to eager array for array, and a traced replay launches what
    the eager run launched."""
    q = T.ChainQuery.three_way(aggregate=kind == "MS,3JA")
    rels, part, modes = (mapside_inputs(q) if kind == "MS,3JA"
                         else mixed_mapside_inputs(q))
    rels = [r.map(lambda c: c.to(cuda)) for r in rels]
    kw = dict(strategy="mapside", caps=T.default_mapside_caps(STATS, 4,
                                                              slack=8),
              partitioning=part, hop_modes=modes, join_impl="fused",
              place_output=kind == "MS,3JA", measure_skew=kind == "mixed")
    ops.reset_launches()
    eager = T.execute_chain(T.SimGrid((4,)), q, rels, **kw)
    torch.cuda.synchronize()
    counted = dict(ops.LAUNCHES)
    assert not bool(eager[2])
    want = as_numpy(eager)
    run = T.jit_execute_chain(T.SimGrid((4,)), q, donate=False, **kw)
    for _ in range(3):
        got = run(rels)
        torch.cuda.synchronize()
        assert_equal_results(got, want)
    _, traced, _ = ops.traced_launches(lambda: run(rels))
    assert traced == counted
    assert counted["probe_counts"] > 0
    assert counted["segment_sum"] > 0 or kind == "mixed"
    assert counted["hash_histogram"] > 0 or kind != "mixed"
