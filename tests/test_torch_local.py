"""The port's per-device data plane against ``repro.core.local``.

Every operator is held to the JAX package as full arrays — keys,
validity, padding, row order, the overflow flag and the sums — on the
same numpy inputs.  Float sums are integer-valued here except where a
case says otherwise, so they are compared exactly; non-integer sums use
rtol = atol = 1e-5 (the tolerance the reference holds its own
``segment_sum`` to).  The hazards of ``tests/test_sort_merge.py`` and
``tests/test_data_plane.py`` are mirrored: a valid key equal to the
INT32_MAX sentinel, all-invalid inputs, the exact-capacity overflow
boundary, presorted inputs.  The port runs batched over leading axes;
the reference is vmapped over the same axes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import local as jl  # noqa: E402
from repro.core.relation import Relation as JRel  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import local as tl  # noqa: E402

from _torch_jax import XLA_FAST  # noqa: E402

I32_MAX = np.iinfo(np.int32).max

# The reference runs jitted (one compile per shape, several times faster
# than op-by-op dispatch on the CPU); the JAX package's own tests hold
# its jitted data plane equal to the eager one.
_JOIN_STATIC = dict(static_argnums=(2, 3, 4),
                    static_argnames=("prefix_l", "prefix_r", "presorted_l",
                                     "presorted_r"))


def both(cols, valid):
    j = JRel({n: jnp.asarray(c) for n, c in cols.items()}, jnp.asarray(valid))
    return j, interop.relation_from_numpy(cols, valid, "cpu")


def assert_same(j, t, *, rtol=0.0):
    cols, valid = interop.relation_to_numpy(t)
    assert sorted(cols) == sorted(j.cols)
    np.testing.assert_array_equal(valid, np.asarray(j.valid))
    for n, c in cols.items():
        want = np.asarray(j.cols[n])
        assert c.dtype == want.dtype, n
        if rtol and c.dtype.kind == "f":
            np.testing.assert_allclose(c, want, rtol=rtol, atol=rtol,
                                       err_msg=n)
        else:
            np.testing.assert_array_equal(c, want, err_msg=n)


def assert_flag(jf, tf):
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def side(rng, n, cap, domain, key="b", val="v", p_valid=1.0, lead=()):
    """A relation with ``n`` live rows of ``cap`` (integer-valued
    payload), some rows invalidated, with optional leading axes."""
    shape = tuple(lead) + (cap,)
    keys = rng.integers(0, domain, shape).astype(np.int32)
    vals = rng.integers(0, 7, shape).astype(np.float32)
    valid = (np.arange(cap) < n) & (rng.random(shape) < p_valid)
    return {key: keys, val: vals}, valid


JOINS = {"sort_merge": (jax.jit(jl.sort_merge_join, **_JOIN_STATIC,
                                compiler_options=XLA_FAST),
                        tl.sort_merge_join),
         "fused": (jax.jit(jl.fused_sort_merge_join, **_JOIN_STATIC,
                           compiler_options=XLA_FAST),
                   tl.fused_sort_merge_join),
         "all_pairs": (jax.jit(jl.local_join_allpairs, **_JOIN_STATIC,
                               compiler_options=XLA_FAST),
                       tl.local_join_allpairs)}


def check_join(impl, left, right, out_cap, **kw):
    (jlft, tlft), (jrgt, trgt) = both(*left), both(*right)
    jfn, tfn = JOINS[impl]
    jo, jf = jfn(jlft, jrgt, "b", "b", out_cap, **kw)
    to, tf = tfn(tlft, trgt, "b", "b", out_cap, **kw)
    assert_same(jo, to)
    assert_flag(jf, tf)
    return to, tf


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", sorted(JOINS))
@pytest.mark.parametrize("seed", range(4))
def test_join_matches_jax(impl, seed):
    rng = np.random.default_rng(seed)
    n_l, n_r = int(rng.integers(0, 40)), int(rng.integers(0, 40))
    domain = int(rng.integers(1, 12))
    left = side(rng, n_l, 44, domain, p_valid=0.8)
    right = side(rng, n_r, 40, domain, val="w", p_valid=0.8)
    for out_cap in (1, 7, 64, 600):
        check_join(impl, left, right, out_cap)


@pytest.mark.parametrize("impl", sorted(JOINS))
def test_join_sentinel_key_and_all_invalid(impl):
    # A valid INT32_MAX key equals the padding sentinel: results are
    # clamped by the valid count, so it joins like any other key.
    left = ({"b": np.array([I32_MAX, 1, I32_MAX, 2, 0, 0], np.int32),
             "v": np.arange(6, dtype=np.float32)},
            np.array([1, 1, 1, 1, 0, 0], bool))
    right = ({"b": np.array([I32_MAX, 3, I32_MAX, 0, 0], np.int32),
              "w": np.arange(5, dtype=np.float32)},
             np.array([1, 1, 1, 0, 0], bool))
    out, flag = check_join(impl, left, right, 16)
    assert int(out.count()) == 4 and not bool(flag)
    dead = ({"b": np.zeros(8, np.int32), "v": np.zeros(8, np.float32)},
            np.zeros(8, bool))
    out, flag = check_join(impl, dead, right, 8)
    assert int(out.count()) == 0 and not bool(flag)
    out, _ = check_join(impl, left, ({"b": right[0]["b"], "w": right[0]["w"]},
                                     np.zeros(5, bool)), 8)
    assert int(out.count()) == 0


@pytest.mark.parametrize("impl", sorted(JOINS))
def test_join_exact_capacity_boundary(impl):
    """out_capacity == matches keeps all, no overflow; one less flags
    overflow and keeps the first matches in key order."""
    rng = np.random.default_rng(5)
    left = side(rng, 20, 20, 4)
    right = side(rng, 15, 15, 4, val="w")
    n_match = int((left[0]["b"][:, None] == right[0]["b"][None, :]).sum())
    out, flag = check_join(impl, left, right, n_match)
    assert not bool(flag) and int(out.count()) == n_match
    out, flag = check_join(impl, left, right, n_match - 1)
    assert bool(flag) and int(out.count()) == n_match - 1


@pytest.mark.parametrize("impl", ["sort_merge", "fused"])
def test_join_presorted_and_prefixes(impl):
    rng = np.random.default_rng(6)
    left = side(rng, 12, 16, 5, p_valid=0.7)
    right = side(rng, 10, 10, 5, val="v")      # name collision: prefixes
    jlft, tlft = both(*left)
    jrgt, trgt = both(*right)
    sort_rows = jax.jit(jl.sort_rows, static_argnums=1,
                        compiler_options=XLA_FAST)
    js_l, ts_l = sort_rows(jlft, "b"), tl.sort_rows(tlft, "b")
    js_r, ts_r = sort_rows(jrgt, "b"), tl.sort_rows(trgt, "b")
    assert_same(js_l, ts_l)
    assert_same(js_r, ts_r)
    jfn, tfn = JOINS[impl]
    kw = dict(prefix_l="l_", prefix_r="r_", presorted_l=True,
              presorted_r=True)
    jo, jf = jfn(js_l, js_r, "b", "b", 64, **kw)
    to, tf = tfn(ts_l, ts_r, "b", "b", 64, **kw)
    assert_same(jo, to)
    assert_flag(jf, tf)
    assert "l_v" in to.cols and "r_v" in to.cols


def test_join_rejects_bad_capacity_and_impl():
    (_, t) = both({"b": np.zeros(3, np.int32)}, np.ones(3, bool))
    with pytest.raises(ValueError, match="out_capacity"):
        tl.sort_merge_join(t, t, "b", "b", 0)
    with pytest.raises(ValueError, match="unknown join impl"):
        tl.local_join(t, t, "b", "b", 4, impl="hash")


@pytest.mark.parametrize("impl", ["sort_merge", "fused"])
def test_join_batched_equals_vmapped_reference(impl):
    rng = np.random.default_rng(7)
    left = side(rng, 30, 34, 6, lead=(2, 3), p_valid=0.8)
    right = side(rng, 25, 25, 6, val="w", lead=(2, 3), p_valid=0.8)
    (jlft, tlft), (jrgt, trgt) = both(*left), both(*right)
    _, tfn = JOINS[impl]
    jfn = {"sort_merge": jl.sort_merge_join,
           "fused": jl.fused_sort_merge_join}[impl]
    f = jax.jit(jax.vmap(jax.vmap(lambda a, b: jfn(a, b, "b", "b", 40))),
                compiler_options=XLA_FAST)
    jo, jf = f(jlft, jrgt)
    to, tf = tfn(tlft, trgt, "b", "b", 40)
    assert_same(jo, to)
    assert_flag(jf, tf)
    assert tf.shape == (2, 3) and bool(tf.any())   # some devices overflow


# ---------------------------------------------------------------------------
# Partition, compaction, group-by
# ---------------------------------------------------------------------------

def test_partition_ranks_matches_jax():
    rng = np.random.default_rng(3)
    partition_ranks = jax.jit(jl.partition_ranks, static_argnums=2,
                              compiler_options=XLA_FAST)
    for n, k in ((1, 1), (64, 8), (200, 13)):
        bucket = rng.integers(0, k, n).astype(np.int32)
        valid = rng.random(n) < 0.7
        want = partition_ranks(jnp.asarray(bucket), jnp.asarray(valid), k)
        got = tl.partition_ranks(torch.as_tensor(bucket),
                                 torch.as_tensor(valid), k)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cap_out", [None, 3, 40])
def test_compact_matches_jax(cap_out):
    rng = np.random.default_rng(8)
    jr, tr = both(*side(rng, 20, 24, 9, p_valid=0.5))
    compact = jax.jit(lambda r: r.compact(cap_out),
                      compiler_options=XLA_FAST)
    assert_same(compact(jr), tr.compact(cap_out))


GROUPBYS = {"single_pass": (jax.jit(jl.groupby_sum, static_argnums=(1, 2, 3)),
                            tl.groupby_sum),
            "multipass": (jax.jit(jl.groupby_sum_multipass,
                                  static_argnums=(1, 2, 3)),
                          tl.groupby_sum_multipass)}


@pytest.mark.parametrize("impl", sorted(GROUPBYS))
@pytest.mark.parametrize("seed", range(3))
def test_groupby_matches_jax(impl, seed):
    rng = np.random.default_rng(seed)
    cap = 60
    cols = {"a": rng.integers(-3, 6, cap).astype(np.int32),
            "d": rng.integers(0, 5, cap).astype(np.int32),
            "p": rng.integers(0, 4, cap).astype(np.float32)}
    cols["a"][::9] = I32_MAX                   # the sentinel as a real key
    valid = rng.random(cap) < 0.7
    jr, tr = both(cols, valid)
    jfn, tfn = GROUPBYS[impl]
    n_groups = len({(a, d) for a, d, ok in
                    zip(cols["a"], cols["d"], valid) if ok})
    for out_cap in (None, n_groups, n_groups - 1, 4):
        for keys in (("a", "d"), ("d",)):
            jo, jf = jfn(jr, keys, "p", out_cap)
            to, tf = tfn(tr, keys, "p", out_cap)
            assert_same(jo, to)                    # integer sums: exact
            assert_flag(jf, tf)


def test_groupby_non_integer_sums_and_all_invalid():
    rng = np.random.default_rng(11)
    cols = {"a": rng.integers(0, 4, 50).astype(np.int32),
            "p": rng.normal(size=50).astype(np.float32)}
    jr, tr = both(cols, rng.random(50) < 0.8)
    single_pass = GROUPBYS["single_pass"][0]
    jo, jf = single_pass(jr, ("a",), "p", None)
    to, tf = tl.groupby_sum(tr, ("a",), "p")
    assert_same(jo, to, rtol=1e-5)
    assert_flag(jf, tf)
    jd, td = both(cols, np.zeros(50, bool))
    jo, jf = single_pass(jd, ("a",), "p", 8)
    to, tf = tl.groupby_sum(td, ("a",), "p", 8)
    assert_same(jo, to)
    assert int(to.count()) == 0 and not bool(tf)


def test_groupby_batched_equals_vmapped_reference():
    rng = np.random.default_rng(12)
    shape = (2, 2, 30)
    cols = {"a": rng.integers(0, 5, shape).astype(np.int32),
            "d": rng.integers(0, 3, shape).astype(np.int32),
            "p": rng.integers(1, 3, shape).astype(np.float32)}
    jr, tr = both(cols, rng.random(shape) < 0.75)
    f = jax.jit(jax.vmap(jax.vmap(
        lambda r: jl.groupby_sum(r, ("a", "d"), "p", 9))))
    jo, jf = f(jr)
    to, tf = tl.groupby_sum(tr, ("a", "d"), "p", 9)
    assert_same(jo, to)
    assert_flag(jf, tf)


def shuffle_oracle(shape, axis, cols, valid, bucket, recv, local):
    """The reference's shuffle, row by row in numpy: each device sends
    its valid rows, in order, to slot (source, rank) of the device whose
    ``axis`` coordinate is the row's bucket (ranks past ``recv`` are
    dropped and flagged); a receiver's (K, recv) slots are read source
    by source and, when ``local < K·recv``, compacted to ``local``."""
    k, n_dev = shape[axis], int(np.prod(shape))
    slots = [[[] for _ in range(k)] for _ in range(n_dev)]
    overflow = False
    for src in np.ndindex(*shape):
        rank = [0] * k
        for i in np.flatnonzero(valid[src]):
            b = int(bucket[src][i])
            if rank[b] >= recv:
                overflow = True
                continue
            dst = np.ravel_multi_index(src[:axis] + (b,) + src[axis + 1:],
                                       shape)
            slots[dst][src[axis]].append((rank[b], src, i))
            rank[b] += 1
    compact = local is not None and local < k * recv
    cap = local if compact else k * recv
    out = {c: np.zeros((n_dev, cap), v.dtype) for c, v in cols.items()}
    out_valid = np.zeros((n_dev, cap), bool)
    for dst in range(n_dev):
        rows = [(s * recv + r, src, i) for s in range(k)
                for r, src, i in slots[dst][s]]
        if compact:
            overflow |= len(rows) > cap
            rows = [(j, src, i) for j, (_, src, i) in enumerate(rows)][:cap]
        for pos, src, i in rows:
            out_valid[dst, pos] = True
            for c, v in cols.items():
                out[c][dst, pos] = v[src][i]
    shaped = {c: v.reshape(*shape, cap) for c, v in out.items()}
    return shaped, out_valid.reshape(*shape, cap), overflow


@pytest.mark.parametrize("shape,axis,n,recv,local", [
    ((4,), 0, 10, 10, None),           # lossless: the (K, recv) layout
    ((4,), 0, 10, 2, None),            # a source's bucket overflows recv
    ((2, 3), 1, 10, 10, 5),            # compacted; a destination overflows
    ((2, 3), 1, 12, 2, 4),             # both slots and destinations overflow
    ((2, 3), 0, 12, 20, 24),           # compacted, no overflow
    ((3, 1, 2), 2, 7, 7, 100),         # local >= K·recv: no compaction
    ((1, 4), 1, 16, 16, 40),
    ((2, 2), 0, 0, 2, 3)])             # empty shards
def test_shuffle_by_bucket_matches_oracle(shape, axis, n, recv, local):
    """The port's shuffle scatters straight into the receive shards; it
    equals the reference's partition → all-to-all → flatten → compact,
    done row by row, as full arrays (row order, padding, overflow)."""
    from repro_torch.core import shuffle as tsh
    rng = np.random.default_rng(n * 7 + recv + axis)
    cols = {"a": rng.integers(-5, 5, (*shape, n)).astype(np.int32),
            "p": rng.normal(size=(*shape, n)).astype(np.float32)}
    valid = rng.random((*shape, n)) < 0.7
    bucket = rng.integers(0, shape[axis], (*shape, n)).astype(np.int32)
    want, want_valid, want_ovf = shuffle_oracle(shape, axis, cols, valid,
                                                bucket, recv, local)
    to, tf, tn = tsh.shuffle_by_bucket(
        tsh.SimGrid(shape), interop.relation_from_numpy(cols, valid, "cpu"),
        torch.as_tensor(bucket), axis, recv, local)
    got, got_valid = interop.relation_to_numpy(to)
    np.testing.assert_array_equal(got_valid, want_valid)
    for c in cols:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    assert bool(tf) == want_ovf
    np.testing.assert_array_equal(tn.numpy(), valid.sum(-1))
