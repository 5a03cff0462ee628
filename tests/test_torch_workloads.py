"""The paper's three-way entry points and graph workloads on the port.

``one_round_three_way`` (1,3J), ``cascade_three_way`` (2,3J),
``cascade_three_way_agg`` (2,3JA, with and without ``include_final_agg``),
``one_round_three_way_agg`` (1,3JA), ``spmm``, ``a_cubed``,
``triangle_count_from_a3``, ``triangle_count_cycle`` and
``triangle_count_chain_filter``, on the CPU.

Held to the JAX package without compiling it: the wrappers and
``a_cubed`` equal, as full arrays (every column, the mask, padding and
row order, every stat, the overflow flag), the port's ``execute_chain``
runs that ``tests/test_torch_executor.py`` holds array for array to the
jitted JAX executor; A³ equals the JAX package's host oracle
(``oracle_a3``) on the README quickstart's 64-node / 300-edge graph;
every stat equals the JAX package's cost model on that graph's exact
statistics (the final Γ that ``include_final_agg=True`` charges
included); ``spmm`` equals A² on the host and its stats the two rounds
it runs; the triangle query's measured tuples equal the JAX package's
``BENCH_triangles.json`` pins.  Every sum here is integer-valued, so
float sums are exact.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRID = (4, 4)
CAPS = dict(input=512, recv=128, local=256, mid=4096, agg=4096,
            join=16384, out=4096)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the intra-op pool only oversubscribes the CPU under
    a parallel run (see ``tests/test_torch_skew.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quickstart_graph():
    """The README quickstart's scale-free graph."""
    rng = np.random.default_rng(0)
    src = (rng.zipf(1.5, 300) % 64).astype(np.int32)
    dst = rng.integers(0, 64, 300).astype(np.int32)
    return src, dst


SRC, DST = quickstart_graph()
NAMES = (("a", "b", "v"), ("b", "c", "w"), ("c", "d", "x"))


def port_rels():
    return [T.scatter_to_grid(T.edge_relation(SRC, DST, capacity=CAPS["input"],
                                              names=n, device="cpu"), GRID)
            for n in NAMES]


def as_numpy(result):
    out, stats, ovf = result
    if isinstance(out, T.Relation):
        cols, valid = interop.relation_to_numpy(out)
    else:
        cols = {n: np.asarray(c) for n, c in out.cols.items()}
        valid = np.asarray(out.valid)
    return cols, valid, {k: float(v) for k, v in stats.items()}, bool(ovf)


def assert_same(got, want, stats=True):
    """``got`` (a port result) equals ``want`` (``as_numpy`` of a result)
    as full arrays: every column, the mask, padding and row order, the
    overflow flag and, with ``stats``, every stat."""
    g_cols, g_valid, g_stats, g_ovf = as_numpy(got)
    w_cols, w_valid, w_stats, w_ovf = want
    assert not g_ovf and not w_ovf
    np.testing.assert_array_equal(g_valid, w_valid)
    assert sorted(g_cols) == sorted(w_cols)
    for n, c in g_cols.items():
        assert c.dtype == w_cols[n].dtype, n
        np.testing.assert_array_equal(c, w_cols[n], err_msg=n)
    assert not stats or g_stats == w_stats


def chain_counts():
    """The quickstart graph's exact 3-chain statistics, from the JAX
    package's host code, and |Γ_{a,c}(R ⋈ S) ⋈ T|: the pushdown
    cascade's last join, which its final Γ reads (one row per A² entry
    (a, c) and out-edge of c)."""
    st = J.self_join_stats_exact(SRC, DST)
    dense = np.zeros((64, 64), np.int64)
    np.add.at(dense, (SRC, DST), 1)
    final_in = int(((dense @ dense) > 0) @ np.bincount(SRC, minlength=64)
                   @ np.ones(64, np.int64))
    return st, J.chain_stats_from_three_way(st), final_in


def chain_caps():
    return T.ChainCaps(recv=CAPS["recv"], mid=CAPS["mid"], out=CAPS["out"],
                       local=CAPS["local"], agg=CAPS["agg"],
                       join=CAPS["join"])


@pytest.mark.parametrize("join_impl", ["sort_merge", "fused"])
def test_cascade_three_way_agg_charges_final_agg_like_jax(join_impl):
    """``include_final_agg=True`` returns the same relation and charges
    the final Γ as the JAX package's executor does: its input rows read
    once and shipped once, on top of the pushdown cascade's cost."""
    kw = dict(recv_capacity=CAPS["recv"], mid_capacity=CAPS["mid"],
              agg_capacity=CAPS["agg"], out_capacity=CAPS["out"],
              local_capacity=CAPS["local"], join_impl=join_impl)
    grid = T.SimGrid(GRID)
    plain = T.cascade_three_way_agg(grid, *port_rels(), **kw)
    charged = T.cascade_three_way_agg(grid, *port_rels(),
                                      include_final_agg=True, **kw)
    assert_same(charged, as_numpy(plain), stats=False)
    _, cs, final_in = chain_counts()
    want = J.cost_chain_cascade_pushdown(cs.sizes, cs.prefix_joins,
                                         cs.prefix_aggs, cs.pushdown_joins)
    assert float(plain[1]["total"]) == want
    for key in ("read", "shuffled"):
        assert float(charged[1][key] - plain[1][key]) == final_in
    assert float(charged[1]["total"]) == want + 2 * final_in


@pytest.mark.parametrize("algorithm", ["2,3JA", "1,3JA"])
def test_a_cubed_matches_jax_and_the_oracle(algorithm):
    """As full arrays, the ``execute_chain`` run that
    ``tests/test_torch_executor.py`` holds to the jitted JAX executor;
    A³ equal to the JAX package's host oracle; the stats equal to its
    cost model: 2,3JA's pushdown cascade (final Γ uncharged), 1,3JA's
    one round on the 4×4 grid plus 2·|R ⋈ S ⋈ T|."""
    got = T.a_cubed(T.SimGrid(GRID), SRC, DST, algorithm=algorithm,
                    caps=CAPS, device="cpu")
    strategy = {"2,3JA": "cascade_pushdown", "1,3JA": "one_round"}[algorithm]
    assert_same(got, as_numpy(T.execute_chain(
        T.SimGrid(GRID), T.ChainQuery.three_way(aggregate=True), port_rels(),
        strategy=strategy, caps=chain_caps())))
    st, cs, _ = chain_counts()
    want = (J.cost_chain_cascade_pushdown(cs.sizes, cs.prefix_joins,
                                          cs.prefix_aggs)
            if algorithm == "2,3JA" else
            J.cost_one_round_agg(st.r, st.s, st.t, st.j3, GRID[0] * GRID[1]))
    stats = got[1]
    assert float(stats["total"]) == want
    assert float(stats["read"] + stats["shuffled"]) == want
    out = got[0]
    a3 = J.oracle_a3(SRC, DST)
    assert T.oracle_a3(SRC, DST) == a3
    rows = {n: c[out.valid].numpy() for n, c in out.cols.items()}
    found = {(int(a), int(d)): float(p)
             for a, d, p in zip(rows["a"], rows["d"], rows["p"])}
    assert found == a3
    tri = T.triangle_count_from_a3(out)
    assert isinstance(tri, torch.Tensor) and tri.dtype == torch.float32
    assert float(tri) * 3 == pytest.approx(3 * J.oracle_triangles(SRC, DST))


def test_a_cubed_2_3ja_stats_without_the_final_agg_equal_the_cost_model():
    _, stats, _ = T.a_cubed(T.SimGrid(GRID), SRC, DST, algorithm="2,3JA",
                            caps=CAPS, device="cpu")
    st = T.self_join_stats_exact(SRC, DST)
    cs = T.chain_stats_from_three_way(st)
    assert float(stats["total"]) == T.cost_chain_cascade_pushdown(
        cs.sizes, cs.prefix_joins, cs.prefix_aggs, cs.pushdown_joins)
    with pytest.raises(ValueError, match="unknown algorithm"):
        T.a_cubed(T.SimGrid(GRID), SRC, DST, algorithm="3,3J", caps=CAPS,
                  device="cpu")


def test_spmm_matches_jax():
    """``spmm`` (a join on b, then Γ_{a,c} SUM v·w) equal to A² on the
    host, and its stats to the two rounds it runs: the join reads and
    ships |A| + |B| (the JAX package's ``cost_two_way``), the
    aggregation its |A ⋈ B| rows."""
    kw = dict(recv_capacity=256, mid_capacity=4096, out_capacity=2048,
              local_capacity=1024)
    grid = (2, 2)
    names = (("a", "b", "v"), ("b", "c", "w"))
    rng = np.random.default_rng(4)
    vals = rng.integers(1, 5, len(SRC)).astype(np.float32)
    a, b = (T.scatter_to_grid(T.edge_relation(SRC, DST, vals, names=n,
                                              device="cpu"), grid)
            for n in names)
    out, stats, ovf = T.spmm(T.SimGrid(grid), a, b, **kw)
    assert not bool(ovf)
    join = int(np.bincount(DST, minlength=64)
               @ np.bincount(SRC, minlength=64))
    assert float(stats["read"]) == float(stats["shuffled"]) == 600 + join
    assert float(stats["read"] + stats["shuffled"]) == \
        J.cost_two_way(300, 300) + 2 * join
    dense = np.zeros((64, 64))
    np.add.at(dense, (SRC, DST), vals)
    a2 = dense @ dense
    rows = {n: c[out.valid].numpy() for n, c in out.cols.items()}
    assert len(rows["p"]) == np.count_nonzero(a2)
    found = np.zeros_like(a2)
    np.add.at(found, (rows["a"], rows["c"]), rows["p"])
    np.testing.assert_array_equal(found, a2)


@pytest.mark.parametrize("join_impl", ["sort_merge", "fused"])
def test_three_way_wrappers_equal_execute_chain(join_impl):
    """The wrappers are ``execute_chain`` with the paper's caps: equal
    array for array to the runs ``tests/test_torch_executor.py`` holds
    to the JAX package."""
    caps = T.ChainCaps(recv=CAPS["recv"], mid=CAPS["mid"], out=CAPS["out"],
                       local=CAPS["local"], agg=CAPS["agg"],
                       join=CAPS["join"])
    grid = T.SimGrid(GRID)
    kw = dict(recv_capacity=caps.recv, mid_capacity=caps.mid,
              out_capacity=caps.out, local_capacity=caps.local,
              join_impl=join_impl)
    for wrapper, strategy, aggregate, extra in (
            (T.one_round_three_way, "one_round", False, {}),
            (T.cascade_three_way, "cascade", False, {}),
            (T.cascade_three_way_agg, "cascade_pushdown", True,
             {"agg_capacity": caps.agg}),
            (T.one_round_three_way_agg, "one_round", True,
             {"join_capacity": caps.join})):
        q = T.ChainQuery.three_way(aggregate=aggregate)
        want = as_numpy(T.execute_chain(grid, q, port_rels(),
                                        strategy=strategy, caps=caps,
                                        join_impl=join_impl))
        assert_same(wrapper(grid, *port_rels(), **kw, **extra), want)
    with pytest.raises(ValueError, match="2-D"):
        T.one_round_three_way(T.SimGrid((16,)), *port_rels(), **kw)


def test_include_final_agg_is_part_of_the_compiled_plan_key():
    q = T.ChainQuery.three_way(aggregate=True)
    caps = T.ChainCaps(recv=CAPS["recv"], mid=CAPS["mid"], out=CAPS["out"],
                       local=CAPS["local"], agg=CAPS["agg"])
    grid = T.SimGrid(GRID)
    runs = [T.jit_execute_chain(grid, q, strategy="cascade_pushdown",
                                caps=caps, donate=False,
                                include_final_agg=flag)
            for flag in (False, True)]
    assert runs[0] is not runs[1]
    assert runs[1] is T.jit_execute_chain(grid, q,
                                          strategy="cascade_pushdown",
                                          caps=caps, donate=False,
                                          include_final_agg=True)
    plain, charged = (run(port_rels()) for run in runs)
    assert float(charged[1]["total"]) > float(plain[1]["total"])
    eager = T.execute_chain(grid, q, port_rels(), strategy="cascade_pushdown",
                            caps=caps, include_final_agg=True)
    assert all(torch.equal(v, eager[1][k]) for k, v in charged[1].items())


def amazon_graph():
    """``benchmarks/triangle_sweep.py``'s ``amazon`` graph (R-MAT scale
    8, edge factor 3, seed 1): its triangle-query counts are pinned."""
    from repro_torch.data.graphs import DATASETS, GraphSpec, rmat_edges
    spec = DATASETS["amazon"]
    return rmat_edges(GraphSpec(spec.name, 8, min(spec.edge_factor, 3.0),
                                spec.a), seed=1)


@pytest.mark.parametrize("strategy", ["one_round", "cascade"])
def test_triangle_count_cycle_matches_the_pins_and_the_oracle(strategy):
    import json
    src, dst = amazon_graph()
    count, plan, stats, ovf = T.triangle_count_cycle(
        src, dst, k=8, strategy=strategy, device="cpu")
    assert isinstance(count, float) and not bool(ovf)
    assert count == T.oracle_triangles(src, dst)
    j_plan = J.plan_query(J.JoinQuery.triangle(),
                          J.query_stats_exact(J.JoinQuery.triangle(),
                                              [(src, dst)] * 3), 8)
    assert dataclasses.asdict(plan) == dataclasses.asdict(j_plan)
    pins = json.loads((ROOT / "tests" / "data" /
                       "bench_counts_seed.json").read_text())
    pins = pins["BENCH_triangles.json"]
    prefix = f"graphs/amazon/measured/cycle_{strategy}"
    read, shuffled = float(stats["read"]), float(stats["shuffled"])
    assert read == pins[f"{prefix}/read"]
    assert shuffled == pins[f"{prefix}/shuffled"]
    assert read + shuffled == pins[f"{prefix}/total"]


def test_triangle_count_chain_filter_agrees_with_the_cycle_query():
    """The chain+filter oracle path (1,3JA's A³, then the diagonal / 3)
    on the same graph, caps from the chain statistics (lossless)."""
    src, dst = amazon_graph()
    cstats = T.chain_stats_exact([(src, dst)] * 3)
    caps = dataclasses.asdict(T.default_chain_caps(cstats, (4, 2), slack=8))
    tri, stats, ovf = T.triangle_count_chain_filter(
        T.SimGrid((4, 2)), src, dst, algorithm="1,3JA",
        caps=dict(caps, input=len(src)), device="cpu")
    assert isinstance(tri, float) and not bool(ovf)
    assert round(3 * tri) == round(3 * T.oracle_triangles(src, dst))
    assert float(stats["read"]) == sum(cstats.sizes) + cstats.prefix_joins[-1]


def test_core_exports_the_reference_api():
    """Everything the JAX package's ``core`` exports, ``ShardGrid`` (the
    ``torch.distributed`` grid) included."""
    assert set(J.__all__) - set(T.__all__) == set()
    for name in T.__all__:
        assert getattr(T, name) is not None


def test_quickstart_example_runs_on_the_cpu(capsys):
    """``examples/quickstart_torch.py --device cpu``: both pipelines'
    A³ and triangle counts against the host oracles."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "2,3JA: A³ matches oracle" in out
    assert "1,3JA: A³ matches oracle" in out
    assert out.rstrip().endswith("quickstart OK")


def test_host_statistics_equal_the_jax_packages():
    """``query_stats_exact`` and ``chain_stats_exact`` join numpy
    columns where the JAX package joins Python tuples and dicts: the
    same numbers on random chains, cycles, stars and aggregates (empty
    and value-carrying tables included)."""
    rng = np.random.default_rng(1)
    shapes = [("triangle", (), {}), ("chain", (3,), {}),
              ("chain", (4,), {"aggregate": True}), ("cycle", (4,), {}),
              ("star", (3,), {}), ("cycle", (3,), {})]
    for trial in range(12):
        name, args, kw = shapes[trial % len(shapes)]
        jq = getattr(J.JoinQuery, name)(*args, **kw)
        tq = getattr(T.JoinQuery, name)(*args, **kw)
        m, nodes = int(rng.integers(0, 40)), int(rng.integers(1, 12))
        # The JAX package joins tuple at a time: keep the full join of
        # m rows per relation over `nodes` keys near 20,000 tuples.
        k = len(jq.relations)
        m = min(m, int((20000 * nodes ** (k - 1)) ** (1 / k)))
        tables = [tuple(rng.integers(0, nodes, m).astype(np.int32)
                        for _ in rel) + ((rng.random(m),) if trial % 3 else ())
                  for rel in jq.relations]
        assert dataclasses.asdict(T.query_stats_exact(tq, tables)) == \
            dataclasses.asdict(J.query_stats_exact(jq, tables)), (name, trial)
        edges = [(rng.integers(0, nodes, int(rng.integers(0, 30))) + 7 * j,
                  rng.integers(0, nodes, int(rng.integers(0, 30))))
                 for j in range(int(rng.integers(2, 5)))]
        edges = [(s, d[:len(s)]) if len(d) >= len(s) else (s[:len(d)], d)
                 for s, d in edges]
        top_k = 4 if trial % 2 else None
        assert dataclasses.asdict(T.chain_stats_exact(edges, top_k)) == \
            dataclasses.asdict(J.chain_stats_exact(edges, top_k)), trial
