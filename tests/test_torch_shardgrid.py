"""The port's ShardGrid on ``torch.distributed``, on the CPU.

One :func:`repro_torch.distributed.spawn` a module starts 8 gloo ranks
on a (2, 2, 2) ``("pod", "data", "model")`` mesh; each rank runs every
check of :func:`rank_checks` on its own shards and hands its arrays
back.  The test functions then hold each rank's arrays to the port's
``SimGrid`` run of the same shape, sliced at the rank's grid
coordinate, as full arrays (columns, mask, padding, row order, stats,
overflow):

* the five grid primitives on every axis layout the JAX package's
  callers use — ``("pod", "data", "model")`` (the triangle's cube),
  ``(("pod", "data", "model"),)`` (the flat grid of 8) and
  ``(("pod", "data"), "model")`` (the dry-run's join3 grid, (4, 2)) —
  and on ``(("model", "data"), "pod")``, mesh axes out of mesh order;
* ``shuffle_by_bucket`` with no overflow, a receive slot overflowing
  and the compaction overflowing, and ``n_sent``;
* the triangle ``one_round`` on (2, 2, 2), also held to the JAX
  package's ``SimGrid((2, 2, 2))`` run per device (one jitted program)
  and to ``tests/_query_shard_check.py``'s assertions: the oracle,
  read = 3|E| and the Shares formula;
* the triangle cascade staged and with ``overlap_chunks=3`` on (8,),
  and ``audit_collectives`` over both (more all-to-alls overlapped, no
  finding) and over a seeded full-relation gather (the finding);
* ``mapside_cascade_chain`` with ``place_output`` on (8,), as
  ``tests/_mapside_shard_check.py``: 0 shuffled on every hop, placed
  and read equal to the host statistics;
* ``one_round_three_way_agg`` and ``cascade_three_way_agg`` on (4, 2),
  and a fused, skew-measured 2,3JA on (8,) (every port kernel's path);
* ``jit_execute_chain`` on a CPU ShardGrid equal to ``execute_chain``.

The ``cuda`` case spawns 2 gloo ranks whose shards live on one card and
checks that a plan there refuses to capture:

    python -m pytest -q -m cuda tests/test_torch_shardgrid.py
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402

from _torch_jax import run_fast  # noqa: E402

MESH = (2, 2, 2)
AXES = ("pod", "data", "model")
LAYOUTS = {"cube": AXES, "flat": (AXES,), "pair": (("pod", "data"), "model"),
           # Mesh axes out of mesh order: a subgroup numbers its ranks
           # otherwise than the grid's coordinates.
           "swapped": (("model", "data"), "pod")}
SHAPES = {"cube": (2, 2, 2), "flat": (8,), "pair": (4, 2), "swapped": (4, 2)}

TRI_CAPS = dict(recv=256, mid=4096, out=8192, local=512)
CASCADE_CAPS = dict(recv=512, mid=4096, out=8192, local=2048)
MAPSIDE_CAPS = dict(recv=2048, mid=4096, out=4096, local=2048)
AGG_CAPS = dict(recv=256, mid=2048, agg=1024, out=2048, join=4096, local=512)
SHUFFLE_CASES = {"lossless": (40, None), "slot": (4, None),
                 "local": (40, 12)}     # name -> (recv, local_capacity)


# ---------------------------------------------------------------------------
# Inputs, the same in the ranks and in this process
# ---------------------------------------------------------------------------

def triangle_edges():
    rng = np.random.default_rng(7)
    return (rng.integers(0, 24, 80).astype(np.int32),
            rng.integers(0, 24, 80).astype(np.int32))


def triangle_inputs(shape):
    query = T.JoinQuery.triangle()
    return query, T.query_table_inputs(query, [triangle_edges()] * 3, shape,
                                       device="cpu")


def chain_edges():
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 320, 160), rng.integers(0, 320, 160))
            for _ in range(4)]


def mapside_inputs():
    """``_mapside_shard_check.py``'s 4-chain stored in 8 partitions."""
    query = T.ChainQuery.chain(4)
    prels = []
    for j, (s, d) in enumerate(chain_edges()):
        rel = T.edge_relation(s, d, names=query.schema(j), device="cpu")
        key = query.attrs[1] if j == 0 else query.attrs[j]
        prels.append(T.partition_relation(rel, key, 8, salt=0)[0])
    part = T.chain_partitioning(query, [p.spec for p in prels])
    return query, prels, part


def agg_inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    query = T.ChainQuery.three_way(aggregate=True)
    edges = [(rng.integers(0, 20, 60).astype(np.int32),
              rng.integers(0, 20, 60).astype(np.int32)) for _ in range(3)]
    return query, edges, T.chain_edge_inputs(query, edges, shape,
                                             device="cpu")


def chain3_inputs(shape):
    rng = np.random.default_rng(4)
    query = T.ChainQuery.three_way()
    edges = [(rng.integers(0, 20, 60).astype(np.int32),
              rng.integers(0, 20, 60).astype(np.int32)) for _ in range(3)]
    return query, T.chain_edge_inputs(query, edges, shape, device="cpu")


def primitive_inputs(shape):
    """Per axis: (*grid, K, 5) send buffers; then per-device values for
    the gather and the reductions, all as global tensors."""
    rng = np.random.default_rng(5)
    sends = [T.Relation(
        {"b": torch.as_tensor(rng.integers(0, 99, (*shape, k, 5)),
                              dtype=torch.int32)},
        torch.as_tensor(rng.random((*shape, k, 5)) < 0.5)) for k in shape]
    rows = T.Relation({"b": torch.as_tensor(rng.integers(0, 99, (*shape, 5)),
                                            dtype=torch.int32)},
                      torch.as_tensor(rng.random((*shape, 5)) < 0.5))
    counts = torch.as_tensor(rng.integers(0, 9, (*shape, 3)))
    flags = torch.as_tensor(rng.random((*shape, 2)) < 0.1)
    return sends, rows, counts, flags


def shuffle_inputs(shape):
    rng = np.random.default_rng(9)
    rel = T.Relation(
        {"b": torch.as_tensor(rng.integers(0, 99, (*shape, 40)),
                              dtype=torch.int32),
         "v": torch.as_tensor(rng.random((*shape, 40)), dtype=torch.float32)},
        torch.as_tensor(rng.random((*shape, 40)) < 0.8))
    buckets = [torch.as_tensor(rng.integers(0, k, (*shape, 40)),
                               dtype=torch.int32) for k in shape]
    return rel, buckets


def result_np(result):
    """``(out, stats, overflow)`` as numpy."""
    out, stats, ovf = result
    cols, valid = interop.relation_to_numpy(out)
    return cols, valid, {k: v.numpy() for k, v in stats.items()}, \
        ovf.numpy()


def rel_np(rel):
    return interop.relation_to_numpy(rel)


# ---------------------------------------------------------------------------
# Every rank's program
# ---------------------------------------------------------------------------

def rank_checks(rank):
    """Run on each of the 8 ranks: every check's arrays, by case, plus
    the rank's grid coordinate on each layout; rank 0 returns all."""
    import torch.distributed as dist
    from repro_torch.analysis.op_audit import audit_collectives
    from repro_torch.distributed import make_mesh, single_device_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(MESH, AXES)
    grids = {name: T.ShardGrid(mesh, axes) for name, axes in LAYOUTS.items()}
    res = {"rank": rank,
           "coords": {name: g.coords for name, g in grids.items()}}

    def block(g, x):
        """This rank's block of global ``x``, its grid axes dropped."""
        def strip(a):
            return a.reshape(a.shape[len(g.shape):])
        b = g.run(lambda _, b: b, x, in_specs=(tuple(g.axis_names),))
        return b.map(strip) if isinstance(b, T.Relation) else strip(b)

    # The five primitives, on every layout.
    for name, g in grids.items():
        sends, rows, counts, flags = primitive_inputs(g.shape)
        res[f"prim/{name}"] = {
            "all_to_all": [rel_np(g.all_to_all(block(g, s), axis))
                           for axis, s in enumerate(sends)],
            "all_gather": [rel_np(g.all_gather(block(g, rows), axis))
                           for axis in range(len(g.shape))],
            "reduce_sum": g.reduce_sum(block(g, counts)).numpy(),
            "reduce_any": g.reduce_any(block(g, flags)).numpy(),
            "any_per_lane": g.any_per_lane(block(g, flags)).numpy()}

    # The shuffle, every axis of the cube, each overflow.
    g = grids["cube"]
    rel, buckets = shuffle_inputs(g.shape)
    for case, (recv, local) in SHUFFLE_CASES.items():
        for axis, bucket in enumerate(buckets):
            out, ovf, n_sent = T.shuffle_by_bucket(
                g, block(g, rel), block(g, bucket), axis, recv,
                local_capacity=local)
            res[f"shuffle/{case}/{axis}"] = (rel_np(out), ovf.numpy(),
                                             n_sent.numpy())

    # The triangle one_round on (2, 2, 2), as the JAX shard check runs it.
    query, rels = triangle_inputs(g.shape)

    def one_round(g_, *shards):
        flat = [r.map(lambda a: a.reshape(a.shape[3:])) for r in shards]
        return T.execute_query(g_, query, flat, strategy="one_round",
                               caps=T.ChainCaps(**TRI_CAPS))
    res["one_round"] = result_np(g.run(
        one_round, *rels, in_specs=tuple((*AXES, None) for _ in rels)))

    # The triangle cascade on (8,), staged and overlapped, audited.
    g = grids["flat"]
    query, rels = triangle_inputs(g.shape)
    shards = [block(g, r) for r in rels]
    for chunks in (1, 3):
        out, rep = audit_collectives(functools.partial(
            T.execute_query, g, query, shards, strategy="cascade",
            caps=T.ChainCaps(**CASCADE_CAPS), overlap_chunks=chunks),
            max_gather_rows=CASCADE_CAPS["local"],
            target=f"shard/cascade[x{chunks}]")
        res[f"cascade/{chunks}"] = result_np(out)
        res[f"audit/{chunks}"] = (dict(rep.metrics),
                                  [f.code for f in rep.findings])
    _, rep = audit_collectives(
        lambda: T.broadcast_along(g, shards[0], 0),
        max_gather_rows=shards[0].capacity, target="shard/broadcast")
    res["audit/gather"] = (dict(rep.metrics), [f.code for f in rep.findings],
                           len(shards[0].cols) + 1)

    # jit_execute_chain on a CPU ShardGrid: the eager call.
    cq, crels = chain3_inputs(g.shape)
    cshards = [block(g, r) for r in crels]
    caps = T.ChainCaps(**CASCADE_CAPS)
    res["jit"] = result_np(T.jit_execute_chain(
        g, cq, strategy="cascade", caps=caps)(cshards))
    res["jit/eager"] = result_np(T.execute_chain(
        g, cq, cshards, strategy="cascade", caps=caps))

    # 2,3JA fused with measure_skew on (8,): segment_sum, probe_counts
    # and bucket_counts on every rank.
    aq, _, arels = agg_inputs(g.shape)
    res["pushdown_fused"] = result_np(T.execute_chain(
        g, aq, [block(g, r) for r in arels], strategy="cascade_pushdown",
        caps=T.ChainCaps(**AGG_CAPS), join_impl="fused", measure_skew=True))

    # The map-side 4-chain on (8,), its stored partitions on their ranks.
    mq, prels, part = mapside_inputs()

    def mapside(g_, *parts):
        rels_ = [T.PartitionedRelation(p.map(lambda a: a.reshape(
            a.shape[1:])), pr.spec) for p, pr in zip(parts, prels)]
        return T.mapside_cascade_chain(
            g_, mq, rels_, caps=T.ChainCaps(**MAPSIDE_CAPS),
            partitioning=part, hop_modes=("mapside",) * 3,
            place_output=True)
    res["mapside"] = result_np(g.run(
        mapside, *[p.parts for p in prels],
        in_specs=tuple((AXES, None) for _ in prels)))

    # The paper's aggregated entry points on (4, 2).
    g = grids["pair"]
    _, _, (R, S, Tr) = agg_inputs(g.shape)
    R, S, Tr = (block(g, r) for r in (R, S, Tr))
    c = AGG_CAPS
    res["1,3JA"] = result_np(T.one_round_three_way_agg(
        g, R, S, Tr, recv_capacity=c["recv"], mid_capacity=c["mid"],
        join_capacity=c["join"], out_capacity=c["out"],
        local_capacity=c["local"]))
    res["2,3JA"] = result_np(T.cascade_three_way_agg(
        g, R, S, Tr, recv_capacity=c["recv"], mid_capacity=c["mid"],
        agg_capacity=c["agg"], out_capacity=c["out"],
        local_capacity=c["local"]))

    # Meshes smaller than the group cover its first ranks; the others
    # help build the subgroups, then refuse to run a grid.
    for name, small in (("quad", make_mesh((4,), ("x",))),
                        ("single", single_device_mesh())):
        try:
            sg = T.ShardGrid(small, small.axis_names)
        except ValueError as exc:
            res[f"small/{name}"] = (None, str(exc))
        else:
            res[f"small/{name}"] = (sg.coords, int(sg.reduce_sum(
                torch.tensor(rank + 1))))
    try:
        make_mesh((16,), ("x",))
    except RuntimeError as exc:
        res["small/big"] = str(exc)

    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, res)
    return everyone


def cuda_capture_refusal(rank):
    """Run on 2 gloo ranks with CUDA shards: the plan's capture must
    refuse, naming the backend."""
    from repro_torch.distributed import make_mesh
    g = T.ShardGrid(make_mesh((2,), ("x",)), ("x",))
    query, rels = triangle_inputs((2,))
    shards = [r.map(lambda a: a[rank].to(g.device)) for r in rels]
    plan = T.jit_execute_query(g, query, strategy="cascade",
                               caps=T.ChainCaps(**CASCADE_CAPS))
    try:
        plan(shards)
    except ValueError as exc:
        return str(exc)
    return None


# ---------------------------------------------------------------------------
# The references in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the intra-op pool only oversubscribes the CPU under
    a parallel run (see ``tests/test_torch_skew.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def started(one_torch_thread):
    """The 8 ranks, started once a module; call it for their results
    (in rank order).  They run while the first case compiles its JAX
    reference."""
    from repro_torch.distributed import start
    ranks = start(rank_checks, 8, backend="gloo", device="cpu", timeout=300)
    yield functools.lru_cache(maxsize=None)(ranks.result)
    ranks.stop()


@pytest.fixture(scope="module")
def ranks(started):
    return started()


def at(x, coords):
    """The SimGrid slice of device ``coords`` of a global array."""
    return x[tuple(coords)]


def assert_rel_slice(got, want_rel, coords):
    cols, valid = got
    w_cols, w_valid = interop.relation_to_numpy(want_rel)
    np.testing.assert_array_equal(valid, at(w_valid, coords))
    assert sorted(cols) == sorted(w_cols)
    for n in cols:
        assert cols[n].dtype == w_cols[n].dtype, n
        np.testing.assert_array_equal(cols[n], at(w_cols[n], coords),
                                      err_msg=n)


def assert_result_slice(got, want, coords):
    """A rank's ``(out, stats, overflow)`` equals the SimGrid run's slice
    (stats and the flag are grid-wide: equal as they are)."""
    cols, valid, stats, ovf = got
    out, w_stats, w_ovf = want
    assert_rel_slice((cols, valid), out, coords)
    assert sorted(stats) == sorted(w_stats)
    for k, v in stats.items():
        np.testing.assert_array_equal(v, w_stats[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(ovf, w_ovf.numpy())


def each_rank(ranks, key, layout, check):
    assert len(ranks) == 8 and [r["rank"] for r in ranks] == list(range(8))
    seen = set()
    for r in ranks:
        coords = r["coords"][layout]
        seen.add(coords)
        check(r[key], coords)
    assert len(seen) == 8                 # every device exactly once


def test_one_round_equals_the_jax_simgrid_per_device(started):
    """Held to the JAX package's SimGrid per device, one jitted program
    (compiled while the ranks run: the module's first case)."""
    pytest.importorskip("jax")
    import jax
    import repro.core as J
    query = J.JoinQuery.triangle()
    rels = J.query_table_inputs(query, [triangle_edges()] * 3,
                                SHAPES["cube"])
    caps = J.ChainCaps(**TRI_CAPS)
    fn = jax.jit(lambda r: J.execute_query(
        J.SimGrid(SHAPES["cube"]), query, r, strategy="one_round",
        caps=caps))
    j_out, j_stats, j_ovf = run_fast(fn, rels)

    def check(got, coords):
        cols, valid, stats, ovf = got
        np.testing.assert_array_equal(valid, at(np.asarray(j_out.valid),
                                                coords))
        assert sorted(cols) == sorted(j_out.cols)
        for n in cols:
            want = at(np.asarray(j_out.cols[n]), coords)
            assert cols[n].dtype == want.dtype, n
            np.testing.assert_array_equal(cols[n], want, err_msg=n)
        for k in stats:
            np.testing.assert_array_equal(stats[k], np.asarray(j_stats[k]))
        assert bool(ovf) == bool(j_ovf)
    each_rank(started(), "one_round", "cube", check)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_primitives_equal_simgrid(ranks, layout):
    shape = SHAPES[layout]
    sim = T.SimGrid(shape)
    sends, rows, counts, flags = primitive_inputs(shape)
    a2a = [sim.all_to_all(s, axis) for axis, s in enumerate(sends)]
    ag = [sim.all_gather(rows, axis) for axis in range(len(shape))]

    def check(got, coords):
        for axis in range(len(shape)):
            assert_rel_slice(got["all_to_all"][axis], a2a[axis], coords)
            assert_rel_slice(got["all_gather"][axis], ag[axis], coords)
        np.testing.assert_array_equal(got["reduce_sum"],
                                      sim.reduce_sum(counts).numpy())
        np.testing.assert_array_equal(got["reduce_any"],
                                      sim.reduce_any(flags).numpy())
        np.testing.assert_array_equal(got["any_per_lane"],
                                      sim.any_per_lane(flags).numpy())
    each_rank(ranks, f"prim/{layout}", layout, check)


@pytest.mark.parametrize("case", list(SHUFFLE_CASES))
def test_shuffle_by_bucket_equals_simgrid(ranks, case):
    shape = SHAPES["cube"]
    rel, buckets = shuffle_inputs(shape)
    recv, local = SHUFFLE_CASES[case]
    for axis, bucket in enumerate(buckets):
        out, ovf, n_sent = T.shuffle_by_bucket(
            T.SimGrid(shape), rel, bucket, axis, recv, local_capacity=local)
        assert bool(ovf) == (case != "lossless"), (case, axis)

        def check(got, coords):
            g_rel, g_ovf, g_sent = got
            assert_rel_slice(g_rel, out, coords)
            np.testing.assert_array_equal(g_ovf, ovf.numpy())
            np.testing.assert_array_equal(g_sent, at(n_sent.numpy(), coords))
        each_rank(ranks, f"shuffle/{case}/{axis}", "cube", check)


def sim_triangle(strategy, shape, caps, chunks=1):
    query, rels = triangle_inputs(shape)
    return T.execute_query(T.SimGrid(shape), query, rels, strategy=strategy,
                           caps=T.ChainCaps(**caps), overlap_chunks=chunks)


def test_one_round_equals_simgrid_and_the_shard_check(ranks):
    want = sim_triangle("one_round", SHAPES["cube"], TRI_CAPS)
    each_rank(ranks, "one_round", "cube",
              lambda got, coords: assert_result_slice(got, want, coords))
    # tests/_query_shard_check.py's own assertions.
    src, dst = triangle_edges()
    n = sum(int(r["one_round"][1].sum()) for r in ranks)
    stats, ovf = ranks[0]["one_round"][2:]
    assert not ovf
    assert n / 3 == T.oracle_triangles(src, dst) > 0
    assert float(stats["read"]) == 3.0 * len(src)
    k = int(np.prod(SHAPES["cube"]))
    query = T.JoinQuery.triangle()
    assert float(stats["shuffled"]) == sum(
        len(src) * k / np.prod([SHAPES["cube"][d] for d in dims])
        for dims in query.rel_dims())


@pytest.mark.parametrize("chunks", (1, 3))
def test_cascade_staged_and_overlapped_equal_simgrid(ranks, chunks):
    want = sim_triangle("cascade", SHAPES["flat"], CASCADE_CAPS, chunks)
    each_rank(ranks, f"cascade/{chunks}", "flat",
              lambda got, coords: assert_result_slice(got, want, coords))
    # The shard check's: staged = overlapped, equal to the oracle.
    staged = sum(int(r["cascade/1"][1].sum()) for r in ranks)
    assert staged == sum(int(r[f"cascade/{chunks}"][1].sum())
                         for r in ranks)
    assert staged / 3 == T.oracle_triangles(*triangle_edges())
    for k, v in ranks[0]["cascade/1"][2].items():
        np.testing.assert_array_equal(ranks[0][f"cascade/{chunks}"][2][k], v)


def test_audit_collectives_counts_and_flags(ranks):
    for r in ranks:
        staged, overlapped = r["audit/1"], r["audit/3"]
        assert staged[1] == [] and overlapped[1] == []
        assert overlapped[0]["n_all_to_all"] > staged[0]["n_all_to_all"] > 0
        assert staged[0]["n_collectives"] > staged[0]["n_all_to_all"]
        # The seeded case: a relation gathered whole is the finding.
        metrics, codes, n_tensors = r["audit/gather"]
        assert codes == ["FULL_RELATION_ALL_GATHER"] * n_tensors
        assert metrics["n_all_to_all"] == 0


def test_mapside_chain_equals_simgrid_with_zero_shuffles(ranks):
    query, prels, part = mapside_inputs()
    want = T.mapside_cascade_chain(
        T.SimGrid((8,)), query, prels, caps=T.ChainCaps(**MAPSIDE_CAPS),
        partitioning=part, hop_modes=("mapside",) * 3, place_output=True)
    each_rank(ranks, "mapside", "flat",
              lambda got, coords: assert_result_slice(got, want, coords))
    # tests/_mapside_shard_check.py's own assertions.
    stats = T.chain_stats_exact(chain_edges())
    got = ranks[0]["mapside"][2]
    assert not ranks[0]["mapside"][3]
    assert sum(int(r["mapside"][1].sum()) for r in ranks) \
        == stats.prefix_joins[-1] > 0
    assert tuple(got["hop_shuffled"]) == (0.0,) * 3
    assert float(got["placed"]) == stats.prefix_joins[0] \
        + stats.prefix_joins[1]
    assert float(got["read"]) == sum(stats.sizes) + stats.prefix_joins[0] \
        + stats.prefix_joins[1]


@pytest.mark.parametrize("entry", ["1,3JA", "2,3JA"])
def test_three_way_agg_entry_points_equal_simgrid(ranks, entry):
    shape = SHAPES["pair"]
    query, edges, (R, S, Tr) = agg_inputs(shape)
    c = AGG_CAPS
    if entry == "1,3JA":
        want = T.one_round_three_way_agg(
            T.SimGrid(shape), R, S, Tr, recv_capacity=c["recv"],
            mid_capacity=c["mid"], join_capacity=c["join"],
            out_capacity=c["out"], local_capacity=c["local"])
    else:
        want = T.cascade_three_way_agg(
            T.SimGrid(shape), R, S, Tr, recv_capacity=c["recv"],
            mid_capacity=c["mid"], agg_capacity=c["agg"],
            out_capacity=c["out"], local_capacity=c["local"])
    assert not bool(want[2])
    each_rank(ranks, entry, "pair",
              lambda got, coords: assert_result_slice(got, want, coords))
    # A³'s entries: the groups sum to the path count.
    total = sum(float(r[entry][0]["p"][r[entry][1]].sum()) for r in ranks)
    assert total == T.chain_stats_exact(edges).prefix_joins[-1]


def test_fused_skew_measured_pushdown_equals_simgrid(ranks):
    shape = SHAPES["flat"]
    query, _, rels = agg_inputs(shape)
    want = T.execute_chain(T.SimGrid(shape), query, rels,
                           strategy="cascade_pushdown",
                           caps=T.ChainCaps(**AGG_CAPS), join_impl="fused",
                           measure_skew=True)
    assert float(want[1]["max_bucket_load"]) > 0
    each_rank(ranks, "pushdown_fused", "flat",
              lambda got, coords: assert_result_slice(got, want, coords))


def test_a_mesh_smaller_than_the_group_covers_its_first_ranks(ranks):
    """As the reference's mesh takes the first devices: ranks 0..3 run
    the grid of a (4,) mesh, rank 0 alone that of ``single_device_mesh``,
    and a mesh larger than the group raises the reference's error."""
    for r in ranks:
        i = r["rank"]
        for name, n in (("quad", 4), ("single", 1)):
            coords, got = r[f"small/{name}"]
            if i < n:
                assert coords == ((i,) if name == "quad" else (0, 0))
                assert got == n * (n + 1) // 2
            else:
                assert coords is None
                assert f"past the mesh of {n} ranks" in got
        assert "mesh needs 16 devices, have 8" in r["small/big"]


def test_jit_execute_chain_on_a_cpu_shardgrid_equals_eager(ranks):
    def same(a, b):
        (ca, va, sa, oa), (cb, vb, sb, ob) = a, b
        np.testing.assert_array_equal(va, vb)
        assert sorted(ca) == sorted(cb)
        for n in ca:
            np.testing.assert_array_equal(ca[n], cb[n])
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
        np.testing.assert_array_equal(oa, ob)
    for r in ranks:
        same(r["jit"], r["jit/eager"])
    assert sum(int(r["jit"][1].sum()) for r in ranks) > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gloo_cuda_grid_refuses_capture(cuda):
    """Two gloo ranks sharing one card: the shards live in CUDA memory,
    and a compiled plan raises the backend's ValueError."""
    from repro_torch.distributed import spawn
    msg = spawn(cuda_capture_refusal, 2, backend="gloo", device="cuda")
    assert msg is not None and "gloo" in msg
