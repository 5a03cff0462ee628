"""The port's overlapped schedule on the chain entry points, against the
JAX package, on the CPU.

``execute_chain`` for 1,3JA (the one-round plan streaming its last
relation into the raw join at ``caps.join``, then the charged
aggregation round), 2,3JA (every cascade round chunked, the pushdown
between them) and 2,3J (the unaggregated cascade), all with
``measure_skew=True``; the map-side
cascade whose second hop shuffles (``mapside_cascade_chain`` chunks
its shuffled hops only); ``shares_skew_chain`` (each combination's
one-round sub-join chunked); and 64-bit keys above 2^32 in an x64
subprocess.  Every column, the mask, padding, row order, every stat
and the overflow flag equal the JAX package's overlapped run at each
chunk count (SharesSkew at two chunks; its other counts are held to
the port's staged run).  Each JAX reference is jitted once with every
chunk count in one program.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as J  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro_torch import interop  # noqa: E402

from test_torch_overlap import (CHUNK_COUNTS, assert_same_result,  # noqa: E402
                                jax_run, one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
P = 4

__all__ = ["one_torch_thread"]     # the module's one-thread fixture


def quickstart_edges():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 32, 100).astype(np.int32)
    dst = rng.integers(0, 32, 100).astype(np.int32)
    return [(src, dst)] * 3


EDGES = quickstart_edges()
STATS = T.chain_stats_exact(EDGES, sketch_top_k=16)
# (paper name, strategy, grid, aggregate), all measured; the cascades
# on a 1-D grid (one shuffle hop a side, half the JAX program).
CHAIN_RUNS = [("1,3JA", "one_round", (2, 2), True),
              ("2,3JA", "cascade_pushdown", (4,), True),
              ("2,3J", "cascade", (4,), False)]


@functools.lru_cache(maxsize=None)
def jax_chain(strategy, grid, aggregate):
    jq = J.ChainQuery.three_way(aggregate=aggregate)
    caps = J.ChainCaps(**dataclasses.asdict(T.default_chain_caps(STATS,
                                                                 grid)))
    rels = J.chain_edge_inputs(jq, EDGES, grid)
    return jax_run(lambda r: {c: J.execute_chain(
        J.SimGrid(grid), jq, r, strategy=strategy, caps=caps,
        measure_skew=True, overlap_chunks=c) for c in CHUNK_COUNTS}, rels)


@pytest.mark.parametrize("chunks", CHUNK_COUNTS)
@pytest.mark.parametrize("name,strategy,grid,aggregate", CHAIN_RUNS,
                         ids=[r[0] for r in CHAIN_RUNS])
def test_execute_chain_overlap_matches_jax(name, strategy, grid, aggregate,
                                           chunks):
    q = T.ChainQuery.three_way(aggregate=aggregate)
    rels = T.chain_edge_inputs(q, EDGES, grid, device="cpu")
    got = T.execute_chain(T.SimGrid(grid), q, rels, strategy=strategy,
                          caps=T.default_chain_caps(STATS, grid),
                          measure_skew=True, overlap_chunks=chunks)
    assert_same_result(got, jax_chain(strategy, grid, aggregate)[chunks])
    assert not bool(got[2])
    total = (float(got[0].cols["p"][got[0].valid].sum()) if aggregate
             else int(got[0].count().sum()))
    assert total == STATS.prefix_joins[-1]


# ---------------------------------------------------------------------------
# The map-side cascade: its shuffled hop is chunked
# ---------------------------------------------------------------------------

MS_MODES = ("mapside", "shuffle")


@functools.lru_cache(maxsize=None)
def mapside_inputs():
    """R and S stored on b, T on c (P = 4); hop 2 shuffles anyway."""
    tq, jq = T.ChainQuery.three_way(), J.ChainQuery.three_way()
    t_rels, j_rels = [], []
    for j, (s, d) in enumerate(EDGES):
        key = tq.attrs[1] if j == 0 else tq.attrs[j]
        t_pr, ovf = T.partition_relation(
            T.edge_relation(s, d, names=tq.schema(j), device="cpu"), key, P)
        assert not bool(ovf)
        cols, valid, fields = interop.partitioned_to_numpy(t_pr)
        t_rels.append(t_pr)
        j_rels.append(J.PartitionedRelation(J.Relation(cols, valid),
                                            J.PartitionSpec(**fields)))
    part = T.chain_partitioning(tq, [r.spec for r in t_rels])
    caps = T.default_chain_caps(STATS, (P,), slack=8)
    return tq, jq, t_rels, j_rels, part, caps


@functools.lru_cache(maxsize=None)
def jax_mapside():
    _, jq, _, j_rels, part, caps = mapside_inputs()
    j_part = J.ChainPartitioning(**dataclasses.asdict(part))
    j_caps = J.ChainCaps(**dataclasses.asdict(caps))
    return jax_run(lambda r: {c: J.mapside_cascade_chain(
        J.SimGrid((P,)), jq, r, caps=j_caps, partitioning=j_part,
        hop_modes=MS_MODES, overlap_chunks=c) for c in CHUNK_COUNTS},
        j_rels)


@pytest.mark.parametrize("chunks", CHUNK_COUNTS)
def test_mapside_shuffled_hop_overlap_matches_jax(chunks):
    tq, _, t_rels, _, part, caps = mapside_inputs()
    got = T.execute_chain(T.SimGrid((P,)), tq, t_rels, strategy="mapside",
                          caps=caps, partitioning=part, hop_modes=MS_MODES,
                          overlap_chunks=chunks)
    assert_same_result(got, jax_mapside()[chunks])
    assert float(got[1]["hop_shuffled"][0]) == 0.0
    assert int(got[0].count().sum()) == STATS.prefix_joins[-1]


# ---------------------------------------------------------------------------
# SharesSkew: each combination's one-round sub-join is chunked
# ---------------------------------------------------------------------------

def hot_edges(rng, n_nodes=40, n_edges=72, hot=0.4):
    src = rng.integers(1, n_nodes, n_edges).astype(np.int32)
    dst = rng.integers(1, n_nodes, n_edges).astype(np.int32)
    src[rng.random(n_edges) < hot] = 0
    dst[rng.random(n_edges) < hot] = 0
    return src, dst


HOT = [hot_edges(np.random.default_rng(7)) for _ in range(3)]
SKEW_CAPS = dict(recv=128, mid=2048, out=8192, local=256, agg=1024, join=8192)


def skew_port(chunks):
    q = T.ChainQuery.three_way()
    plan = T.detect_chain_skew(q, HOT, 16, device="cpu")
    rels = [T.edge_relation(s, d, names=q.schema(j), device="cpu")
            for j, (s, d) in enumerate(HOT)]
    return T.shares_skew_chain(q, rels, plan, caps=T.ChainCaps(**SKEW_CAPS),
                               measure_skew=True, overlap_chunks=chunks)


def test_shares_skew_chain_overlap_matches_jax():
    jq = J.ChainQuery.three_way()
    plan = J.detect_chain_skew(jq, HOT, 16)
    rels = [J.edge_relation(s, d, names=jq.schema(j))
            for j, (s, d) in enumerate(HOT)]
    want = jax_run(lambda *r: J.shares_skew_chain(
        jq, list(r), plan, caps=J.ChainCaps(**SKEW_CAPS), measure_skew=True,
        overlap_chunks=2), *rels)
    got = skew_port(2)
    assert_same_result(got, want)
    staged = skew_port(1)
    for chunks in (3, 5):
        out, stats, ovf = skew_port(chunks)
        assert not bool(ovf)
        assert {k: float(v) for k, v in stats.items()} == \
            {k: float(v) for k, v in staged[1].items()}
        assert out.to_tuple_set() == staged[0].to_tuple_set()
        assert int(out.count()) == int(staged[0].count())


# ---------------------------------------------------------------------------
# 64-bit keys above 2^32 (x64 must be set before JAX makes an array)
# ---------------------------------------------------------------------------

_X64_CHECK = r"""
import numpy as np, torch
import repro.config as jcfg
from repro_torch import config as tcfg, interop
assert jcfg.enable_x64() and jcfg.x64_enabled() and tcfg.x64_enabled()
import jax
import repro.core as J
import repro_torch.core as T
from _torch_jax import run_fast
torch.set_num_threads(1)

def run(fn, *args):
    return run_fast(jax.jit(fn), *args)

def same(got, want):
    out, st, ovf = got
    cols, valid = interop.relation_to_numpy(out)
    assert (valid == np.asarray(want[0].valid)).all()
    assert sorted(cols) == sorted(want[0].cols)
    for n, c in cols.items():
        w = np.asarray(want[0].cols[n])
        assert c.dtype == w.dtype, n
        assert (c == w).all(), n
    assert {k: float(v) for k, v in st.items()} == \
        {k: float(v) for k, v in want[1].items()}
    assert not bool(ovf) and not bool(want[2])
    assert any(c.dtype == np.int64 and (c > 2 ** 32).any()
               for c in cols.values())
    return int(valid.sum())

rng = np.random.default_rng(11)
base = np.int64(2) ** 33
stride = np.int64(2) ** 32
# Keys that alias mod 2^32: int32 truncation would merge them.
def col(m):
    return base + rng.integers(0, 4, m) * stride + rng.integers(0, 6, m)
E = [(col(40), col(40)), (col(40), col(40))]
q2t, q2j = T.ChainQuery.chain(2), J.ChainQuery.chain(2)
tl, tr = T.chain_edge_inputs(q2t, E, (4,), device="cpu")
jl, jr = J.chain_edge_inputs(q2j, E, (4,))
want = run(lambda l, r: {c: J.two_way_join(
    J.SimGrid((4,)), l, r, "b", "b", recv_capacity=256, out_capacity=2048,
    overlap_chunks=c) for c in (2, 3, 5)}, jl, jr)
for c in (2, 3, 5):
    n = same(T.two_way_join(T.SimGrid((4,)), tl, tr, "b", "b",
                            recv_capacity=256, out_capacity=2048,
                            overlap_chunks=c), want[c])
    assert n > 0
tables = [(col(48), col(48))] * 3
caps = dict(recv=512, mid=4096, out=8192, local=1024)
tri_t, tri_j = T.JoinQuery.triangle(), J.JoinQuery.triangle()
rt = T.query_table_inputs(tri_t, tables, (2, 2, 2), device="cpu")
rj = J.query_table_inputs(tri_j, tables, (2, 2, 2))
want = run(lambda r: J.execute_query(
    J.SimGrid((2, 2, 2)), tri_j, r, strategy="one_round",
    caps=J.ChainCaps(**caps), overlap_chunks=3), rj)
same(T.execute_query(T.SimGrid((2, 2, 2)), tri_t, rt, strategy="one_round",
                     caps=T.ChainCaps(**caps), overlap_chunks=3), want)
print("OK")
"""


def test_overlap_int64_keys_match_jax_under_x64():
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _X64_CHECK], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK" in res.stdout
