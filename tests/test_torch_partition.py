"""The port's partitioned store and map-side cascade, on the CPU.

Mirrors ``tests/test_partition.py`` against the JAX package, with the
same seeded numpy inputs through both:

  layout     ``partition`` (the send buffers), ``partition_relation``,
             ``repartition``, ``to_flat`` and ``verify_partition_layout``
             — full arrays, specs and overflow flags (the execution
             cases then hand the port's layouts to the JAX package)
  store      ``save_partitioned`` / ``load_partitioned`` round trips,
             the spec-only read, CRC corruption and the fault hook,
             atomic overwrite, an interrupted swap, hop snapshots; and
             stores crossing between the packages both ways, with
             byte-equal manifests
  execution  ``execute_chain(strategy="mapside")`` held to one jitted
             JAX run per plan of hops (both of the port's joins against
             it): the all-proven ``place_output`` run (zero shuffled),
             mixed hop modes (broadcast, mapside, shuffle) with
             ``measure_skew``, and MS,3JA (the JAX package's final Γ
             round on MS,3J's run: the same hops); the analytic vectors; the
             refusals; ``jit_execute_chain`` and lanes on partitioned
             inputs
  benchmark  ``benchmarks/mapside_sweep_torch.py --fast`` counts held to
             the ``BENCH_mapside.json`` pins

The map-side capture on the card is ``tests/test_torch_compiled.py``'s,
beside the other captured plans.
"""

import dataclasses
import functools
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.checkpoint as JC  # noqa: E402
import repro.core as J  # noqa: E402
from repro.core import local as j_local  # noqa: E402
import repro_torch.checkpoint as TC  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402

from _torch_jax import XLA_FAST  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
P = 4

# The JAX side jitted: its eager ops compile one by one for every shape.
j_partition_relation = jax.jit(
    J.partition_relation,
    static_argnames=("key", "num_partitions", "salt", "part_capacity"),
    compiler_options=XLA_FAST)
j_repartition = jax.jit(
    J.repartition,
    static_argnames=("salt", "key", "num_partitions", "part_capacity"),
    compiler_options=XLA_FAST)
j_send_buffers = jax.jit(jax.vmap(j_local.partition, in_axes=(0, 0, None, None)),
                         static_argnums=(2, 3),
                         compiler_options=XLA_FAST)


def edges(seed, m, dom, n=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, dom, m).astype(np.int32),
             rng.integers(0, dom, m).astype(np.int32)) for _ in range(n)]


def flat_pair(query_t, query_j, e):
    """Relation j of both packages from the same numpy edge list."""
    return ([T.edge_relation(s, d, names=query_t.schema(j), device="cpu")
             for j, (s, d) in enumerate(e)],
            [J.edge_relation(s, d, names=query_j.schema(j))
             for j, (s, d) in enumerate(e)])


def store_key(query, j):
    """The attribute relation j is stored on: its hop's join key."""
    return query.attrs[1] if j == 0 else query.attrs[j]


def assert_rel_equal(t_rel, j_rel):
    """Every column (dtype included) and the mask, as full arrays."""
    cols, valid = interop.relation_to_numpy(t_rel)
    np.testing.assert_array_equal(valid, np.asarray(j_rel.valid))
    assert sorted(cols) == sorted(j_rel.cols)
    for n, c in cols.items():
        want = np.asarray(j_rel.cols[n])
        assert c.dtype == want.dtype, n
        np.testing.assert_array_equal(c, want, err_msg=n)


def spec_fields(spec):
    return dataclasses.asdict(spec)


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------

def test_partition_send_buffers_match_jax():
    """``local.partition``: (n_buckets, cap) buffers, rows in input
    order, batched over a leading axis; row 0 (one key) spills its
    bucket and is flagged, row 1 fits."""
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 7, (2, 40)).astype(np.int32)
    keys[0] = 3
    vals = rng.random((2, 40)).astype(np.float32)
    valid = rng.random((2, 40)) < np.array([[0.8], [0.25]])
    t_rel = T.Relation({"a": torch.as_tensor(keys),
                        "v": torch.as_tensor(vals)}, torch.as_tensor(valid))
    bucket = T.hashing.bucket_hash(t_rel.col("a"), 5, salt=1)
    got, ovf = T.partition(t_rel, bucket, 5, 12)
    j_rel = J.Relation({"a": keys, "v": vals}, valid)
    want, j_ovf = j_send_buffers(
        j_rel, J.hashing.bucket_hash(j_rel.col("a"), 5, salt=1), 5, 12)
    assert_rel_equal(got, want)
    np.testing.assert_array_equal(ovf.numpy(), np.asarray(j_ovf))
    assert ovf.tolist() == [True, False]


# One set of static arguments and one shape for the lossless layouts (and
# the stores that cross packages), so the jitted JAX partition_relation
# compiles once for them: m edges over key "b", P = 4, salt 1.
LAYOUT_M, LAYOUT = 128, dict(key="b", n_part=4, salt=1)


@pytest.mark.parametrize("dom,key,n_part,salt,cap", [
    (50, "b", 4, 1, None), (1, "b", 4, 1, None), (1, "a", 4, 0, 8)],
    ids=["lossless", "one_key", "overflow"])
def test_partition_relation_matches_jax(dom, key, n_part, salt, cap):
    """Spread keys, every row on one key (one partition holds them all),
    and a capacity that one partition overflows; the lossless layouts
    share one JAX compile, and the first is repartitioned."""
    (s, d), = edges(1, LAYOUT_M, dom, n=1)
    t_rel = T.edge_relation(s, d, device="cpu")
    j_rel = J.edge_relation(s, d)
    got, ovf = T.partition_relation(t_rel, key, n_part, salt=salt,
                                    part_capacity=cap)
    want, j_ovf = j_partition_relation(j_rel, key=key, num_partitions=n_part,
                                       salt=salt, part_capacity=cap)
    assert_rel_equal(got.parts, want.parts)
    assert bool(ovf) == bool(j_ovf) == (cap is not None)
    assert spec_fields(got.spec) == spec_fields(want.spec)
    assert got.spec.key_dtype == "int32"
    assert (got.num_partitions, got.part_capacity) == \
        (want.num_partitions, want.part_capacity)
    assert int(got.count()) == int(want.count())
    assert_rel_equal(got.to_flat(), want.to_flat())
    assert T.verify_partition_layout(got)
    if dom > 1:                       # one JAX compile: the spread layout
        again, r_ovf = T.repartition(got, salt=3, num_partitions=5)
        j_again, j_r_ovf = j_repartition(want, salt=3, num_partitions=5)
        assert_rel_equal(again.parts, j_again.parts)
        assert bool(r_ovf) == bool(j_r_ovf)
        assert spec_fields(again.spec) == spec_fields(j_again.spec)


def test_verify_partition_layout_catches_a_foreign_layout():
    (s, d), = edges(2, 80, 20, n=1)
    pr, _ = T.partition_relation(T.edge_relation(s, d, device="cpu"), "a",
                                 4, salt=1)
    assert T.verify_partition_layout(pr)
    # The same bytes under another salt prove nothing.
    assert not T.verify_partition_layout(T.PartitionedRelation(
        pr.parts, dataclasses.replace(pr.spec, salt=2)))
    # A partition whose valid keys descend breaks the sort contract.
    flipped = pr.parts.map(lambda c: c.flip(-1))
    assert not T.verify_partition_layout(T.PartitionedRelation(flipped,
                                                               pr.spec))
    # An unsorted spec asks only for the bucketing.
    assert T.verify_partition_layout(T.PartitionedRelation(
        flipped, dataclasses.replace(pr.spec, sort_order="none")))


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------

def stored(seed=5, m=64, dom=16, key="a", n_part=4, salt=1):
    (s, d), = edges(seed, m, dom, n=1)
    return T.partition_relation(T.edge_relation(s, d, device="cpu"), key,
                                n_part, salt=salt)[0]


def assert_stored_equal(got, want):
    assert spec_fields(got.spec) == spec_fields(want.spec)
    assert_rel_equal(got.parts, want.parts)


def test_store_round_trip_and_spec_only_read(tmp_path):
    t_pr = stored()
    path = TC.save_partitioned(str(tmp_path), "edges", t_pr)
    assert sorted(os.listdir(path)) == ["manifest.json"] + [
        f"part_{p:05d}.npz" for p in range(4)]
    back = TC.load_partitioned(str(tmp_path), "edges", device="cpu")
    assert back.spec == t_pr.spec
    assert torch.equal(back.parts.valid, t_pr.parts.valid)
    for n, c in t_pr.parts.cols.items():
        assert back.parts.cols[n].dtype == c.dtype
        assert torch.equal(back.parts.cols[n], c)
    assert TC.load_partition_spec(str(tmp_path), "edges") == T.PartitionSpec(
        key="a", num_partitions=4, salt=1, key_dtype="int32")
    assert TC.load_partition_spec(str(tmp_path), "absent") is None
    with pytest.raises(FileNotFoundError):
        TC.load_partitioned(str(tmp_path), "absent", device="cpu")


def test_store_crosses_between_packages_both_ways(tmp_path):
    """A store written by either package loads in the other with equal
    specs and arrays, and both write the same manifest bytes."""
    (s, d), = edges(6, LAYOUT_M, 30, n=1)
    t_pr, _ = T.partition_relation(T.edge_relation(s, d, device="cpu"),
                                   LAYOUT["key"], LAYOUT["n_part"],
                                   salt=LAYOUT["salt"])
    j_pr, _ = j_partition_relation(J.edge_relation(s, d), key=LAYOUT["key"],
                                   num_partitions=LAYOUT["n_part"],
                                   salt=LAYOUT["salt"])
    t_dir, j_dir = tmp_path / "torch", tmp_path / "jax"
    t_path = TC.save_partitioned(str(t_dir), "r", t_pr)
    j_path = JC.save_partitioned(str(j_dir), "r", j_pr)
    with open(os.path.join(t_path, "manifest.json"), "rb") as f:
        t_manifest = f.read()
    with open(os.path.join(j_path, "manifest.json"), "rb") as f:
        assert f.read() == t_manifest
    assert_stored_equal(TC.load_partitioned(str(j_dir), "r", device="cpu"),
                        j_pr)
    assert_stored_equal(t_pr, JC.load_partitioned(str(t_dir), "r"))
    assert spec_fields(TC.load_partition_spec(str(j_dir), "r")) == \
        spec_fields(JC.load_partition_spec(str(t_dir), "r"))
    # interop: the JAX-written parts as the port's input.
    cols, valid, fields = interop.partitioned_to_numpy(t_pr)
    again = interop.partitioned_from_numpy(
        {n: np.array(c) for n, c in j_pr.parts.cols.items()},
        np.array(j_pr.parts.valid), j_pr.spec, device="cpu")
    assert again.spec == t_pr.spec and fields == spec_fields(t_pr.spec)
    assert_rel_equal(again.parts, j_pr.parts)


def test_corruption_raises_data_corrupt(tmp_path):
    t_pr = stored(seed=7)
    path = TC.save_partitioned(str(tmp_path), "edges", t_pr)
    victim = os.path.join(path, "part_00001.npz")
    data = dict(np.load(victim))
    data["a"] = data["a"].copy()
    data["a"][0] ^= 1                          # a silent bit flip in a key
    np.savez(victim, **data)
    with pytest.raises(TC.DataCorrupt, match="corrupt") as err:
        TC.load_partitioned(str(tmp_path), "edges", device="cpu")
    assert err.value.detail == "part_00001.npz:a"
    # JAX's reader sees the same damage.
    with pytest.raises(IOError, match="corrupt"):
        JC.load_partitioned(str(tmp_path), "edges")


def test_fault_hook_corruption_is_caught(tmp_path):
    t_pr = stored(seed=8)
    TC.save_partitioned(str(tmp_path), "edges", t_pr)
    sites = []

    def hook(site, arrays):
        sites.append(site)
        arrays = dict(arrays)
        arrays["valid"] = ~arrays["valid"]
        return arrays

    TC.set_fault_hook(hook)
    try:
        with pytest.raises(TC.DataCorrupt):
            TC.load_partitioned(str(tmp_path), "edges", device="cpu")
    finally:
        TC.set_fault_hook(None)
    assert sites == ["partition_read"]
    TC.load_partitioned(str(tmp_path), "edges", device="cpu")


def test_overwrite_is_atomic_and_an_interrupted_swap_recovers(tmp_path):
    t_pr = stored(seed=9, key="a", n_part=4, salt=0)
    other, _ = T.repartition(t_pr, salt=2, key="b", num_partitions=8)
    d = str(tmp_path)
    TC.save_partitioned(d, "edges", t_pr)
    TC.save_partitioned(d, "edges", other)
    spec = TC.load_partition_spec(d, "edges")
    assert spec.key == "b" and spec.num_partitions == 8
    assert not os.path.exists(os.path.join(d, "edges.old"))
    # A crash between the two renames: old moved aside, new never in.
    os.rename(os.path.join(d, "edges"), os.path.join(d, "edges.old"))
    back = TC.load_partitioned(d, "edges", device="cpu")
    assert back.spec == other.spec
    # JSON documents go through the same swap.
    TC.save_json_atomic(d, "state.json", {"v": 1})
    os.rename(os.path.join(d, "state.json"), os.path.join(d, "state.json.old"))
    assert TC.load_json(d, "state.json") == {"v": 1}
    assert TC.load_json(d, "absent.json") is None


def test_hop_snapshots_round_trip_skip_torn_and_cross(tmp_path):
    q = T.ChainQuery.three_way()
    rel = T.chain_edge_inputs(q, edges(10, 30, 9), (2, 2), device="cpu")[0]
    d = str(tmp_path / "hops")
    TC.save_hop(d, 1, rel, extra={"hop": 1})
    TC.save_hop(d, 2, rel.filter(rel.col("a") > 3))
    TC.save_hop(d, 3, rel)
    assert TC.latest_hop(d) == 3
    # A torn newest snapshot and a bit flip in the next are skipped.
    with open(os.path.join(d, "step_3", "arrays.npz"), "wb") as f:
        f.write(b"torn")
    victim = os.path.join(d, "step_2", "arrays.npz")
    data = dict(np.load(victim))
    data["col_a"] = data["col_a"] ^ 1
    np.savez(victim, **data)
    assert TC.latest_hop(d) == 1
    back, extra = TC.load_hop(d, 1, device="cpu")
    assert extra == {"hop": 1}
    assert torch.equal(back.valid, rel.valid)
    assert all(torch.equal(back.cols[n], c) for n, c in rel.cols.items())
    with pytest.raises(TC.DataCorrupt, match="col_a"):
        TC.load_hop(d, 2, device="cpu")
    # The JAX package reads the port's snapshot, and the reverse.
    j_back, j_extra = JC.load_hop(d, 1)
    assert j_extra == {"hop": 1}
    assert_rel_equal(rel, j_back)
    j_dir = str(tmp_path / "jax_hops")
    JC.save_hop(j_dir, 3, j_back)
    t_back, _ = TC.load_hop(j_dir, 3, device="cpu")
    assert_rel_equal(t_back, j_back)
    assert TC.latest_hop(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# Execution: the map-side cascade against the JAX package
# ---------------------------------------------------------------------------

def numpy_result(out, stats, ovf):
    cols = {n: np.asarray(c) for n, c in out.cols.items()}
    return (cols, np.asarray(out.valid),
            {k: np.asarray(v) for k, v in stats.items()}, bool(np.asarray(ovf)))


def assert_matches(got, want):
    """Output columns and mask (padding and row order included), every
    stat (the per-hop vectors as arrays) and the overflow flag."""
    out, stats, ovf = got
    w_cols, w_valid, w_stats, w_ovf = want
    assert not bool(ovf) and not w_ovf
    cols, valid = interop.relation_to_numpy(out)
    np.testing.assert_array_equal(valid, w_valid)
    assert sorted(cols) == sorted(w_cols)
    for n, c in cols.items():
        assert c.dtype == w_cols[n].dtype, n
        np.testing.assert_array_equal(c, w_cols[n], err_msg=n)
    assert sorted(stats) == sorted(w_stats)
    for k, v in stats.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_array_equal(v.numpy(), w_stats[k], err_msg=k)


# (name, relations, aggregated, stored relations, hop modes,
#  place_output, measure_skew, seed, edges, key domain)
CASES = {
    # MS,3J and MS,3JA share their inputs, so they share their hops.
    "MS,3J": (3, False, (0, 1, 2), ("mapside", "mapside"), True, False,
              20, 150, 60),
    "MS,3JA": (3, True, (0, 1, 2), ("mapside", "mapside"), True, False,
               20, 150, 60),
    # R0, R1 and R3 arrive grid-scattered; only R2 is stored.  Hop 2
    # repartitions the intermediate by the stored hash (the branch
    # that launches bucket_counts under measure_skew).
    "mixed": (4, False, (2,), ("broadcast", "mapside", "shuffle"), False,
              True, 21, 120, 40),
}


def jax_partitioned(t_pr):
    """The JAX package's PartitionedRelation holding the port's parts
    (``test_partition_relation_matches_jax`` holds the two layouts
    equal; building the inputs once saves a JAX compile a stored
    relation)."""
    cols, valid, fields = interop.partitioned_to_numpy(t_pr)
    return J.PartitionedRelation(J.Relation(cols, valid),
                                 J.PartitionSpec(**fields))


@functools.lru_cache(maxsize=None)
def case_inputs(name):
    n, agg, stored_js, modes, place, skew, seed, m, dom = CASES[name]
    tq = T.ChainQuery.chain(n, aggregate=agg)
    jq = J.ChainQuery.chain(n, aggregate=agg)
    e = edges(seed, m, dom, n=n)
    t_flat, j_flat = flat_pair(tq, jq, e)
    t_rels, j_rels = [], []
    for j in range(n):
        if j in stored_js:
            t_pr, ovf = T.partition_relation(t_flat[j], store_key(tq, j), P)
            assert not bool(ovf)
            t_rels.append(t_pr)
            j_rels.append(jax_partitioned(t_pr))
        else:
            t_rels.append(T.scatter_to_grid(t_flat[j], (P,)))
            j_rels.append(J.scatter_to_grid(j_flat[j], (P,)))
    specs = [r.spec if j in stored_js else None for j, r in enumerate(t_rels)]
    part = T.chain_partitioning(tq, specs)
    stats = T.chain_stats_exact(e)
    caps = T.default_chain_caps(stats, (P,), slack=8)
    opts = dict(partitioning=part, hop_modes=modes, place_output=place,
                measure_skew=skew)
    return tq, jq, t_rels, j_rels, stats, caps, opts


def jax_final_aggregation(jq, caps):
    """The JAX package's charged final Γ round of an aggregated chain,
    as ``mapside_cascade_chain`` runs it after its last hop, jitted."""
    from repro.core.aggregation import (distributed_groupby_sum,
                                        project_product)
    grid, agg = J.SimGrid((P,)), jq.aggregate

    def final(left):
        proj = project_product(grid, left, keys=tuple(agg.keys),
                               value_cols=jq.values, out_name=agg.out)
        return distributed_groupby_sum(
            grid, proj, keys=tuple(agg.keys), value=agg.out,
            recv_capacity=caps.out, out_capacity=caps.out,
            local_capacity=caps.out)

    return jax.jit(final, compiler_options=XLA_FAST)


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """One jitted JAX run per plan of hops, with ``sort_merge``: the
    reference's fused join shares the staged join's emit tail, so both
    of the port's joins are held to it.  MS,3JA's hops are MS,3J's (the
    same inputs, caps and modes; an aggregated query changes no hop):
    its reference is JAX's own final Γ on MS,3J's output, merged into
    its stats as ``merge_stats`` does (read and shuffled summed, total
    = read + shuffled + placed)."""
    tq, jq, _, j_rels, _, caps, opts = case_inputs(name)
    j_caps = J.ChainCaps(**dataclasses.asdict(caps))
    if name == "MS,3JA":
        left, st, ovf = jax_run("MS,3J")
        out, st_f, ovf_f = jax_final_aggregation(jq, j_caps)(left)
        st = dict(st)
        for k in ("read", "shuffled"):
            st[k] = st[k] + st_f[k]
        st["total"] = st["read"] + st["shuffled"] + st["placed"]
        return out, st, ovf | ovf_f
    j_part = J.ChainPartitioning(**dataclasses.asdict(opts["partitioning"]))
    run = J.jit_execute_chain(
        J.SimGrid((P,)), jq, strategy="mapside", caps=j_caps, donate=False,
        **{**opts, "partitioning": j_part})
    rels = tuple(j_rels)
    return run.lower(rels).compile(compiler_options=XLA_FAST)(rels)


def jax_reference(name):
    return numpy_result(*jax_run(name))


def run_port(name, join_impl):
    tq, _, t_rels, _, _, caps, opts = case_inputs(name)
    return T.execute_chain(T.SimGrid((P,)), tq, t_rels, strategy="mapside",
                           caps=caps, join_impl=join_impl, **opts)


@pytest.mark.parametrize("join_impl", ["sort_merge", "fused"])
@pytest.mark.parametrize("name", list(CASES))
def test_mapside_matches_jax_and_the_cost_model(name, join_impl):
    got = run_port(name, join_impl)
    assert_matches(got, jax_reference(name))
    tq, _, _, _, stats, _, opts = case_inputs(name)
    part, modes = opts["partitioning"], opts["hop_modes"]
    sizes, pj = stats.sizes, stats.prefix_joins
    _, st, _ = got
    shuffled = tuple(float(x) for x in st["hop_shuffled"])
    placed = tuple(float(x) for x in st["hop_placed"])
    assert shuffled == T.chain_mapside_shuffles(
        sizes, pj, part, modes, place_output=opts["place_output"])
    if opts["place_output"]:
        assert shuffled == (0.0,) * len(modes)     # every hop proven
        assert placed == T.chain_mapside_placed(sizes, pj, part, modes)
    else:
        assert placed == (0.0,) * len(modes)
    want = T.cost_chain_mapside(sizes, pj, part, modes)
    if tq.aggregate is not None:
        want += 2.0 * pj[-1]               # the final charged Γ round
    assert float(st["total"]) == want
    if opts["measure_skew"]:
        assert 0 < float(st["max_bucket_load"]) <= float(st["read"])


def test_mapside_result_equals_the_shuffle_cascade():
    """MS,3J returns the cascade's tuples; MS,3JA its (a, d) sums."""
    for name in ("MS,3J", "MS,3JA"):
        tq, _, t_rels, _, stats, caps, _ = case_inputs(name)
        out, _, _ = run_port(name, "sort_merge")
        flat = [r.to_flat() for r in t_rels]
        ref, _, ovf = T.execute_chain(
            T.SimGrid((P,)), tq, [T.scatter_to_grid(r, (P,)) for r in flat],
            strategy="cascade", caps=caps)
        assert not bool(ovf)
        names = sorted(out.cols)
        assert out.to_tuple_set(names) == ref.to_tuple_set(names)


def test_mapside_refusals_match_jax():
    tq, _, t_rels, _, _, caps, opts = case_inputs("MS,3J")
    grid = T.SimGrid((P,))
    with pytest.raises(ValueError, match="partitioning"):
        T.execute_chain(grid, tq, t_rels, strategy="mapside", caps=caps)
    unproven = T.ChainPartitioning(num_partitions=P, salt=0,
                                   right_proven=(False, True))
    with pytest.raises(ValueError, match="not proven"):
        T.execute_chain(grid, tq, t_rels, strategy="mapside", caps=caps,
                        partitioning=unproven, hop_modes=("mapside",) * 2)
    stale = dataclasses.replace(opts["partitioning"], key_dtype="int64")
    with pytest.raises(ValueError, match="repartition"):
        T.execute_chain(grid, tq, t_rels, strategy="mapside", caps=caps,
                        partitioning=stale, hop_modes=("mapside",) * 2)
    with pytest.raises(ValueError, match="1-D partition grid"):
        T.execute_chain(T.SimGrid((2, 2)), tq, t_rels, strategy="mapside",
                        caps=caps, partitioning=opts["partitioning"],
                        hop_modes=("mapside",) * 2)
    with pytest.raises(ValueError, match="modes"):
        T.execute_chain(grid, tq, t_rels, strategy="mapside", caps=caps,
                        partitioning=opts["partitioning"],
                        hop_modes=("mapside",))


def test_compiled_and_laned_mapside_equal_eager():
    """``jit_execute_chain`` takes partitioned inputs (keyed by their
    spec) and equals eager; two tenants' partitions stacked on a lane
    axis equal two solo runs."""
    tq, _, t_rels, _, stats, caps, opts = case_inputs("MS,3JA")
    eager = run_port("MS,3JA", "fused")
    run = T.jit_execute_chain(T.SimGrid((P,)), tq, strategy="mapside",
                              caps=caps, join_impl="fused", **opts)
    assert_matches(run(t_rels), numpy_result(*eager))
    assert t_rels[0].spec in T.executor.input_signature(t_rels)[1]
    # A second tenant: other edges of the same shapes.
    n, m, dom = 3, CASES["MS,3JA"][7], CASES["MS,3JA"][8]
    e = edges(23, m, dom, n=n)
    other = [T.partition_relation(
        T.edge_relation(s, d, names=tq.schema(j), device="cpu"),
        store_key(tq, j), P)[0] for j, (s, d) in enumerate(e)]
    solo = run(other)
    stacked = [T.PartitionedRelation(
        T.Relation({c: torch.stack([a.parts.cols[c], b.parts.cols[c]])
                    for c in a.parts.cols},
                   torch.stack([a.parts.valid, b.parts.valid])), a.spec)
        for a, b in zip(t_rels, other)]
    out, st, ovf = run.with_lanes(2)(stacked)
    assert ovf.shape == (2,) and st["hop_placed"].shape == (2, 2)
    for lane, want in enumerate((eager, solo)):
        assert_matches((out.map(lambda c, i=lane: c[i]),
                        {k: v[lane] for k, v in st.items()}, ovf[lane]),
                       numpy_result(*want))


# ---------------------------------------------------------------------------
# The benchmark port's counts
# ---------------------------------------------------------------------------

def test_mapside_sweep_fast_counts_equal_the_pins(tmp_path):
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        import mapside_sweep_torch as bench
    finally:
        sys.path.pop(0)
    out = tmp_path / "BENCH_torch_mapside.json"
    report = bench.run(fast=True, seed=7, device="cpu", out=str(out))
    assert json.loads(out.read_text())["device"]["platform"] == "cpu"
    with open(ROOT / "tests" / "data" / "bench_counts_seed.json") as f:
        pins = json.load(f)["BENCH_mapside.json"]
    checked = 0
    for key, want in pins.items():
        _, m, *path = key.split("/")
        if m not in report["sweep"]:
            continue
        got = report["sweep"][m]
        for p in path:
            got = got[int(p)] if isinstance(got, list) else got[p]
        assert got == want, key
        checked += 1
    assert checked == 2 * 10
    for row in report["sweep"].values():
        assert row["mapside"]["match"] and row["cascade"]["match"]
        assert row["zero_shuffle"] and row["counts_equal"]
