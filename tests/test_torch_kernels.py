"""The port's kernels: plain versions against the JAX kernels, CUDA
kernels against the plain versions.  (The parity tests of
``hash_histogram`` and attention live in ``test_torch_skew.py`` and
``test_torch_attention.py``; their CUDA tests are here.)

On the CPU the plain PyTorch versions (``repro_torch.kernels.ref``) are
held to the JAX package's Pallas kernels run as its own tests run them
(interpret mode): ``segment_sum`` at rtol = atol = 1e-5, the tolerance
the reference holds its kernel to (exact for integer-valued sums), and
``probe_counts`` as integers.  The hand-written CUDA kernels run only
on a GPU: those tests carry the ``cuda`` marker and skip without one.
JAX is imported only by the parity tests, so the ``cuda`` tests also
run where only the port is installed:

    python -m pytest -q -m cuda tests/test_torch_kernels.py
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import fused_join as tfj  # noqa: E402
from repro_torch.kernels import hash_partition as thp  # noqa: E402
from repro_torch.kernels import segment_sum as tss  # noqa: E402

I32_MAX = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def J():
    """The JAX package's kernels and ``jax.numpy``."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import fused_join, ref as jax_ref, segment_sum
    return types.SimpleNamespace(jnp=jnp, fj=fused_join, ref=jax_ref,
                                 segment_sum=segment_sum.segment_sum)


def segment_case(seed, batch, n, num_segments, kind):
    """(values, ids) of shape (batch, n): sorted, unsorted, or with ids
    outside [0, num_segments) mixed in."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num_segments, (batch, n))
    if kind == "sorted":
        ids = np.sort(ids, axis=-1)
    elif kind == "out_of_range":
        ids = np.where(rng.random((batch, n)) < 0.3,
                       rng.choice([-7, -1, num_segments, num_segments + 50],
                                  (batch, n)), ids)
    vals = rng.normal(size=(batch, n)).astype(np.float32)
    return vals, ids.astype(np.int32)


# ---------------------------------------------------------------------------
# Plain versions against the JAX kernels (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,num_segments", [(128, 16), (300, 700),
                                            (1000, 64)])
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "out_of_range"])
def test_segment_sum_plain_matches_pallas(J, n, num_segments, kind):
    batch = 2
    vals, ids = segment_case(n + num_segments, batch, n, num_segments, kind)
    got = ref.segment_sum(torch.as_tensor(vals), torch.as_tensor(ids),
                          num_segments)
    assert got.shape == (batch, num_segments) and got.dtype == torch.float32
    for b in range(batch):
        want = J.segment_sum(J.jnp.asarray(vals[b]), J.jnp.asarray(ids[b]),
                             num_segments, interpret=True, seg_tile=128,
                             block=256)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_segment_sum_integer_values_exact(J):
    """Integer-valued sums (every main-path value is a product of 1.0
    edge weights) are exact: equal to the JAX kernel bit for bit."""
    rng = np.random.default_rng(1)
    ids = np.sort(rng.integers(0, 40, 500)).astype(np.int32)
    vals = rng.integers(0, 5, 500).astype(np.float32)
    got = tss.segment_sum(torch.as_tensor(vals), torch.as_tensor(ids), 40)
    want = J.segment_sum(J.jnp.asarray(vals), J.jnp.asarray(ids), 40,
                         interpret=True, seg_tile=128, block=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_segment_sum_out_of_range_dropped(J):
    ids = torch.tensor([-1, 0, 1, 5, 99], dtype=torch.int32)
    got = tss.segment_sum(torch.ones(5), ids, 4)
    np.testing.assert_array_equal(got.numpy(), [1, 1, 0, 0])
    want = J.ref.segment_sum(J.jnp.ones(5), J.jnp.asarray(ids.numpy()), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def probe_case(seed, batch, nq, nr, domain, n_valid_r):
    """Sorted keys with a sentinel-padded tail (and a valid INT32_MAX
    key in the mix), queries drawn around them."""
    rng = np.random.default_rng(seed)
    keys = np.full((batch, nr), I32_MAX, np.int64)
    for b in range(batch):
        k = rng.integers(0, domain, n_valid_r)
        if b % 2:
            k[: n_valid_r // 8 + 1] = I32_MAX
        keys[b, :n_valid_r] = np.sort(k)
    queries = rng.integers(-1, domain + 1, (batch, nq))
    queries[:, ::7] = I32_MAX
    return queries.astype(np.int32), np.sort(keys, -1).astype(np.int32)


@pytest.mark.parametrize("nq,nr,n_valid_r", [(96, 128, 128), (200, 64, 40),
                                             (33, 300, 0)])
def test_probe_counts_plain_matches_pallas(J, nq, nr, n_valid_r):
    queries, keys = probe_case(nq + nr, 3, nq, nr, 40, n_valid_r)
    lo, hi = tfj.probe_counts(torch.as_tensor(queries), torch.as_tensor(keys))
    assert lo.dtype == hi.dtype == torch.int32 and lo.shape == (3, nq)
    for b in range(3):
        lo_p, hi_p = J.fj.probe_counts_pallas(
            J.jnp.asarray(queries[b]), J.jnp.asarray(keys[b]), block_q=32,
            block_r=32, interpret=True)
        np.testing.assert_array_equal(lo[b].numpy(), np.asarray(lo_p))
        np.testing.assert_array_equal(hi[b].numpy(), np.asarray(hi_p))
        lo_r, hi_r = J.fj.probe_counts(J.jnp.asarray(queries[b]),
                                       J.jnp.asarray(keys[b]), backend="ref")
        np.testing.assert_array_equal(lo[b].numpy(), np.asarray(lo_r))
        np.testing.assert_array_equal(hi[b].numpy(), np.asarray(hi_r))


def test_stable_key_order_and_partition_order_match_jax(J):
    import jax
    from _torch_jax import XLA_FAST
    stable_key_order = jax.jit(J.fj.stable_key_order,
                               compiler_options=XLA_FAST)
    partition_order = jax.jit(J.fj.partition_order, static_argnums=1,
                              compiler_options=XLA_FAST)
    rng = np.random.default_rng(0)
    for n, n_keys in ((1, 1), (7, 3), (64, 5), (257, 11)):
        key = rng.integers(0, n_keys, n).astype(np.int32)
        key[::5] = I32_MAX
        valid = rng.random(n) < 0.8
        o_j, m_j = stable_key_order(J.jnp.asarray(key),
                                    J.jnp.asarray(valid))
        o_t, m_t = tfj.stable_key_order(torch.as_tensor(key),
                                        torch.as_tensor(valid))
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
        bucket = rng.integers(0, 5, n).astype(np.int32)
        np.testing.assert_array_equal(
            tfj.partition_order(torch.as_tensor(bucket), 5).numpy(),
            np.asarray(partition_order(J.jnp.asarray(bucket), 5)))


# ---------------------------------------------------------------------------
# Dispatch: the plain version only for CPU tensors or backend="ref"
# ---------------------------------------------------------------------------

def test_dispatch_policy_on_cpu_tensors():
    t = torch.zeros(4)
    assert _build.resolve("auto", t) == "ref"
    assert _build.resolve("ref", t) == "ref"
    assert _build.resolve("kernel", t) == "kernel"
    with pytest.raises(ValueError, match="unknown backend"):
        _build.resolve("pallas", t)
    before = dict(ops.LAUNCHES)
    tss.segment_sum(t, torch.zeros(4, dtype=torch.int32), 2)
    tfj.probe_counts(torch.zeros(4, dtype=torch.int32),
                     torch.zeros(4, dtype=torch.int32))
    assert ops.LAUNCHES == before      # plain versions launch nothing
    # Asking for the kernel on a CPU tensor raises; it never falls back.
    with pytest.raises(ValueError, match="CUDA"):
        tss.segment_sum(t, torch.zeros(4, dtype=torch.int32), 2,
                        backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tfj.probe_counts(torch.zeros(4, dtype=torch.int32),
                         torch.zeros(4, dtype=torch.int32), backend="kernel")
    assert ops.LAUNCHES == before


def test_build_paths_and_missing_compiler(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert path.parent == tmp_path and path.name.startswith(name + "-")
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert set(_build.SOURCES) == set(ops.LAUNCHES)
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not list(tmp_path.glob("*.so"))


def test_library_path_follows_sources_and_headers(monkeypatch, tmp_path):
    """An edited ``csrc/*.cuh`` header renames every library, so a stale
    build is never loaded; an edited source renames only its own."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "build"))
    assert list(csrc.glob("*.cuh")), "the kernels share a header"
    before = {name: _build.library_path(name) for name in _build.SOURCES}
    assert before == {name: _build.library_path(name)
                      for name in _build.SOURCES}
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    (csrc / "new_header.cuh").write_text("#pragma once\n")
    added = {name: _build.library_path(name) for name in _build.SOURCES}
    assert all(added[n] != after[n] for n in _build.SOURCES)
    src = csrc / "segment_sum.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = {name: _build.library_path(name) for name in _build.SOURCES}
    assert edited["segment_sum"] != added["segment_sum"]
    assert all(edited[n] == added[n] for n in _build.SOURCES
               if n != "segment_sum")


# ---------------------------------------------------------------------------
# CUDA kernels against the plain versions (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sorted", "unsorted", "out_of_range"])
@pytest.mark.parametrize("batch,n,num_segments", [(1, 1, 1), (3, 1000, 64),
                                                  (16, 5000, 7000)])
def test_segment_sum_kernel_matches_plain(cuda, kind, batch, n, num_segments):
    vals, ids = segment_case(n, batch, n, num_segments, kind)
    v, i = torch.as_tensor(vals, device=cuda), torch.as_tensor(ids, device=cuda)
    before = ops.LAUNCHES["segment_sum"]
    got = tss.segment_sum(v, i, num_segments, backend="kernel")
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_sum"] == before + 1
    want = tss.segment_sum(v, i, num_segments, backend="ref")
    # Float atomics add in another order than the plain scatter.
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    ints = torch.as_tensor(np.rint(vals * 3), device=cuda)
    np.testing.assert_array_equal(
        tss.segment_sum(ints, i, num_segments).cpu().numpy(),
        tss.segment_sum(ints, i, num_segments, backend="ref").cpu().numpy())


def long_segments_case(seed, batch, n, num_segments):
    """Sorted ids whose segments span several kernel tiles, end exactly
    on tile edges, or are one row long, with non-integer values; the
    padded tail takes id ``num_segments`` (dropped)."""
    rng = np.random.default_rng(seed)
    tile = tss.TILE
    lengths = [3 * tile, tile, 1, tile - 1, 1, 2 * tile + 5, 7]
    ids = np.concatenate([np.full(m, i) for i, m in enumerate(lengths)])
    rest = n - len(ids) - n // 8
    ids = np.concatenate([ids, len(lengths) + np.sort(
        rng.integers(0, num_segments - len(lengths), rest))])
    ids = np.concatenate([ids, np.full(n - len(ids), num_segments)])
    ids = np.broadcast_to(ids, (batch, n)).astype(np.int32)
    vals = rng.normal(size=(batch, n)).astype(np.float32)
    return vals, np.ascontiguousarray(ids)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12 * 2048, 12 * 2048 + 3])
def test_segment_sum_kernel_deterministic_across_tiles(cuda, n):
    """Sorted ids, segments across tile edges, non-integer values: two
    launches are bit-identical (one addend a segment), and within 1e-5
    of the plain version relative to each segment's sum of |values|:
    the two add up to 6,144 float32 values in different orders, which
    moves a sum by up to about n · 2^-24 of that scale.  n % 4 == 3
    takes the scalar loads."""
    vals, ids = long_segments_case(n, 3, n, 500)
    v, i = torch.as_tensor(vals, device=cuda), torch.as_tensor(ids, device=cuda)
    before = ops.LAUNCHES["segment_sum"]
    first = tss.segment_sum(v, i, 500)
    second = tss.segment_sum(v, i, 500)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_sum"] == before + 2
    assert torch.equal(first, second)
    want = tss.segment_sum(v, i, 500, backend="ref")
    scale = tss.segment_sum(v.abs(), i, 500, backend="ref")
    assert bool(((first - want).abs() <= 1e-5 * scale + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("nq,nr,n_valid_r", [(1, 1, 1), (96, 128, 128),
                                             (5000, 777, 500), (33, 300, 0)])
def test_probe_counts_kernel_matches_plain(cuda, dtype, nq, nr, n_valid_r):
    queries, keys = probe_case(nq + nr, 4, nq, nr, 1000, n_valid_r)
    q = torch.as_tensor(queries, device=cuda).to(dtype)
    k = torch.as_tensor(keys, device=cuda).to(dtype)
    before = ops.LAUNCHES["probe_counts"]
    lo, hi = tfj.probe_counts(q, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["probe_counts"] == before + 1
    lo_r, hi_r = tfj.probe_counts(q, k, backend="ref")
    assert torch.equal(lo, lo_r) and torch.equal(hi, hi_r)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    v = torch.ones(2, 8, device=cuda)
    with pytest.raises(TypeError):
        tss.segment_sum(v.double(), torch.zeros(2, 8, dtype=torch.int32,
                                                device=cuda), 4)
    with pytest.raises(ValueError, match="contiguous"):
        tss.segment_sum(v.t(), torch.zeros(8, 2, dtype=torch.int32,
                                           device=cuda), 4)
    with pytest.raises(TypeError):      # int64 ids are not narrowed
        tss.segment_sum(v, torch.zeros(2, 8, dtype=torch.int64,
                                       device=cuda), 4)
    with pytest.raises(TypeError):
        tfj.probe_counts(torch.zeros(4, device=cuda),
                         torch.zeros(4, device=cuda), backend="kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("batch,n,n_buckets,block", [
    (1, 1, 1, 1024), (2, 100, 3, 1024), (3, 777, 130, 256),
    (4, 5000, 4096, 1024), (16, 3000, 16, 1024)])
def test_hash_histogram_kernel_matches_plain(cuda, dtype, batch, n,
                                             n_buckets, block):
    """Equal as integers, per-block layout included, for every salt; the
    kernel's native uint32 hash equals the plain version's emulation."""
    rng = np.random.default_rng(n + n_buckets)
    hi = 1 << 31 if dtype == torch.int32 else 1 << 62
    keys = torch.as_tensor(rng.integers(-hi, hi, (batch, n)),
                           device=cuda).to(dtype)
    valid = torch.as_tensor(rng.random((batch, n)) < 0.8, device=cuda)
    for salt in range(4):
        before = ops.LAUNCHES["hash_histogram"]
        got = thp.hash_histogram(keys, valid, n_buckets, salt=salt,
                                 block=block)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["hash_histogram"] == before + 1
        want = thp.hash_histogram(keys, valid, n_buckets, salt=salt,
                                  block=block, backend="ref")
        assert got.shape == want.shape and torch.equal(got, want)
        assert torch.equal(thp.bucket_counts(keys, valid, n_buckets,
                                             salt=salt),
                           thp.bucket_counts(keys, valid, n_buckets,
                                             salt=salt, backend="ref"))


PROBE_TILE = 256           # queries of a warp tile of csrc/probe_counts.cu
I64_MAX = np.iinfo(np.int64).max


def probe_once(q, k):
    """The kernel's counts, held bit-equal to the plain version's, from
    exactly one launch."""
    before = ops.LAUNCHES["probe_counts"]
    lo, hi = tfj.probe_counts(q, k)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["probe_counts"] == before + 1
    lo_r, hi_r = tfj.probe_counts(q, k, backend="ref")
    assert torch.equal(lo, lo_r) and torch.equal(hi, hi_r)


def sorted_with_tail(rng, batch, n, n_live, domain, sentinel):
    """Rows of ``n_live`` sorted draws from [0, domain) and a sentinel
    tail: the fused join's key columns and queries."""
    out = np.full((batch, n), sentinel, np.int64)
    out[:, :n_live] = np.sort(rng.integers(0, domain, (batch, n_live)), -1)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("case", [
    "all_sentinel", "sorted_tail", "tile_minus_1", "tile", "tile_plus_1",
    "cta_plus_1", "unsorted_wide_window", "misaligned_view"])
def test_probe_counts_tile_window_paths(cuda, dtype, case):
    """Each path of the tile-window kernel: one-value tiles (the
    sentinel tail, with live sentinel-valued keys), windows staged in
    shared memory, windows past the shared-memory budget (unsorted
    queries over 100,000 distinct keys), ragged tiles at the warp tile's
    and the CTA's edges, rows and views that are not 16-byte aligned;
    batch 3 throughout."""
    rng = np.random.default_rng(len(case))
    big = I32_MAX if dtype == torch.int32 else I64_MAX
    batch, nr, n_live_r = 3, 20_000, 12_000
    keys = sorted_with_tail(rng, batch, nr, n_live_r, 16_384, big)
    keys[1, n_live_r - 40:n_live_r] = big          # live sentinel keys
    nq, n_live_q = {"all_sentinel": (9_000, 0), "sorted_tail": (70_000, 5_000),
                    "tile_minus_1": (PROBE_TILE - 1, 100),
                    "tile": (PROBE_TILE, 100),
                    "tile_plus_1": (PROBE_TILE + 1, PROBE_TILE + 1),
                    "cta_plus_1": (8 * PROBE_TILE + 1, 700),
                    "unsorted_wide_window": (50_000, 50_000),
                    "misaligned_view": (30_001, 4_000)}[case]
    queries = sorted_with_tail(rng, batch, nq, n_live_q, 16_500, big)
    if case == "unsorted_wide_window":
        nr = 150_000
        keys = np.sort(rng.permutation(10 ** 6)[:batch * nr]
                       .reshape(batch, nr), -1)
        queries = rng.integers(-5, 10 ** 6 + 5, (batch, nq))
        queries[:, ::11] = big
    k = torch.as_tensor(keys, device=cuda).to(dtype)
    q = torch.as_tensor(queries, device=cuda).to(dtype)
    if case == "misaligned_view":
        flat = torch.empty(batch * nq + 1, dtype=dtype, device=cuda)
        q = flat[1:].view(batch, nq)
        q.copy_(torch.as_tensor(queries, device=cuda).to(dtype))
        assert q.data_ptr() % 16 != 0
    probe_once(q, k)


@pytest.mark.cuda
def test_probe_counts_int64_keys_above_2_32(cuda):
    """int64 keys and queries above 2^32, at INT64_MAX and around it,
    sorted and unsorted, batch 2."""
    rng = np.random.default_rng(64)
    base = np.int64(1) << 40
    keys = np.sort(base + rng.integers(0, 1 << 34, (2, 9_000)), -1)
    keys[:, -100:] = I64_MAX
    queries = sorted_with_tail(rng, 2, 40_000, 6_000, 1 << 34, I64_MAX)
    queries[:, :6_000] += base
    queries[1, 6_000:7_000] = I64_MAX - 1
    queries[1] = np.sort(queries[1])
    k = torch.as_tensor(keys, device=cuda)
    probe_once(torch.as_tensor(queries, device=cuda), k)
    probe_once(torch.as_tensor(rng.permutation(queries.T).T.copy(),
                               device=cuda), k)


def bucket_counts_once(keys, valid, n_buckets, salt=0):
    """``bucket_counts`` from exactly one launch, equal as integers to
    the plain version (``ref.hash_histogram`` summed over blocks)."""
    before = ops.LAUNCHES["hash_histogram"]
    got = thp.bucket_counts(keys, valid, n_buckets, salt=salt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hash_histogram"] == before + 1
    want = thp.bucket_counts(keys, valid, n_buckets, salt=salt,
                             backend="ref")
    assert got.dtype == torch.int32 and torch.equal(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("n_buckets", [1, 4, 16, 130, 4096, 12288])
def test_bucket_counts_kernel_matches_plain(cuda, dtype, n_buckets):
    """The one-launch totals kernel on a warp a row (rows of 1,007
    with at most 384 buckets: stored directly), one CTA a row (stored
    directly) and many (atomics onto the zeroed output): a mask with a live
    prefix, a random mask, an all-false mask, n not a multiple of 16, a
    mask view whose base is not 16-byte aligned; and the per-block
    ``hash_histogram`` on the same inputs."""
    rng = np.random.default_rng(n_buckets)
    hi = 1 << 31 if dtype == torch.int32 else 1 << 62
    for batch, n in ((3, 1_007), (4, 200_003)):
        keys = torch.as_tensor(rng.integers(-hi, hi, (batch, n)),
                               device=cuda).to(dtype)
        prefix = torch.arange(n, device=cuda).expand(batch, n) < n // 3
        random = torch.as_tensor(rng.random((batch, n)) < 0.6, device=cuda)
        none = torch.zeros(batch, n, dtype=torch.bool, device=cuda)
        flat = torch.empty(batch * n + 3, dtype=torch.bool, device=cuda)
        shifted = flat[3:].view(batch, n)
        shifted.copy_(random)
        assert shifted.data_ptr() % 16 != 0
        for salt, valid in enumerate((prefix, random, none, shifted)):
            got = bucket_counts_once(keys, valid, n_buckets, salt=salt)
            if valid is none:
                assert int(got.abs().sum()) == 0
        before = ops.LAUNCHES["hash_histogram"]
        per_block = thp.hash_histogram(keys, shifted, n_buckets, salt=1)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["hash_histogram"] == before + 1
        want = thp.hash_histogram(keys, shifted, n_buckets, salt=1,
                                  backend="ref")
        assert per_block.shape == want.shape and torch.equal(per_block, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,block_q,block_kv", [
    (1, 4, 4, 128, 128, 64, 128, 128),
    (2, 8, 2, 64, 64, 64, 32, 32),
    (1, 4, 1, 32, 32, 128, 128, 128),
    (1, 8, 2, 1, 256, 64, 128, 128),
    (1, 4, 2, 17, 40, 64, 16, 64),
    (1, 4, 2, 40, 17, 128, 128, 128),     # causal rows that see no key
    (1, 28, 4, 300, 300, 128, 128, 128),
    (1, 28, 4, 1024, 1024, 128, 128, 128),   # prefill
    (1, 4, 2, 200, 1000, 64, 128, 128),      # chunked prefill
    (2, 28, 4, 1, 4096, 128, 128, 128),      # decode
    (1, 8, 8, 1, 1, 64, 128, 128),           # decode, one key
    (1, 8, 2, 4, 300, 128, 128, 128)])       # short chunk
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, causal, b, hq,
                                              hkv, sq, skv, d, block_q,
                                              block_kv):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = attention_case(cuda, dtype, b, hq, hkv, sq, skv, d)
    before = ops.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal, block_q=block_q,
                              block_kv=block_kv)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = tfa.flash_attention(q, k, v, causal=causal, backend="ref")
    assert got.dtype == dtype and not got.float().isnan().any()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def attention_case(dev, dtype, b, hq, hkv, sq, skv, d):
    gen = torch.Generator(device=dev).manual_seed(sq + skv)
    return [torch.randn(b, h, s, d, generator=gen, device=dev).to(dtype)
            for h, s in ((hq, sq), (hkv, skv), (hkv, skv))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,path", [
    (torch.bfloat16, (1, 28, 4, 1024, 1024, 128), "wgmma"),
    (torch.bfloat16, (1, 4, 2, 200, 1000, 64), "wgmma"),
    (torch.bfloat16, (2, 28, 4, 1, 4096, 128), "split"),
    (torch.float32, (1, 8, 2, 4, 300, 64), "split"),
    (torch.float32, (1, 4, 2, 300, 300, 128), "simt"),
    (torch.float16, (1, 28, 4, 300, 300, 128), "wgmma"),
    (torch.bfloat16, (1, 4, 2, 300, 300, 192), "simt"),
    (torch.float32, (1, 4, 2, 300, 300, 20), "simt")])
def test_flash_attention_kernel_deterministic(cuda, dtype, shape, path):
    """Each path gives the same bits on two calls (no atomics; the splits
    merge in a fixed order)."""
    b, hq, hkv, sq, skv, d = shape
    assert tfa._plan(sq, skv, hq, hkv, d, dtype, batch=b).path == path
    q, k, v = attention_case(cuda, dtype, *shape)
    first = tfa.flash_attention(q, k, v, causal=True)
    second = tfa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_flash_attention_refuses_a_misaligned_tensor(cuda):
    """TMA reads from 16-byte aligned addresses: the wrapper raises, it
    does not copy."""
    q = torch.zeros(1 * 2 * 32 * 64 + 1, device=cuda,
                    dtype=torch.bfloat16)[1:].view(1, 2, 32, 64)
    k = torch.zeros(1, 2, 32, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(q, k, k)


@pytest.mark.cuda
def test_new_kernels_refuse_what_they_do_not_take(cuda):
    """What the kernels still refuse after the shape limits were lifted:
    a float key, no bucket, a head dim past 256, integer attention."""
    keys = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    valid = torch.ones(2, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        thp.hash_histogram(keys.float(), valid, 4, backend="kernel")
    with pytest.raises(ValueError, match="buckets"):
        thp.hash_histogram(keys, valid, 0, backend="kernel")
    q = torch.zeros(1, 2, 4, tfa.MAX_HEAD_DIM + 1, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)
    q = torch.zeros(1, 2, 4, 32, device=cuda)
    with pytest.raises(TypeError):
        tfa.flash_attention(q.int(), q.int(), q.int())


# ---------------------------------------------------------------------------
# The shapes past the kernels' first limits (ROADMAP C3), on the card
# ---------------------------------------------------------------------------

ROWS = 65_536          # one past the grid's y limit


@pytest.mark.cuda
def test_segment_sum_kernel_past_65535_rows(cuda):
    rng = np.random.default_rng(1)
    ids = np.sort(rng.integers(0, 40, (ROWS, 48)), -1).astype(np.int32)
    ids[::7, -5:] = 40                             # dropped
    vals = rng.integers(0, 5, (ROWS, 48)).astype(np.float32)
    v, i = torch.as_tensor(vals, device=cuda), torch.as_tensor(ids, device=cuda)
    before = ops.LAUNCHES["segment_sum"]
    got = tss.segment_sum(v, i, 40)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segment_sum"] == before + 1
    assert torch.equal(got, tss.segment_sum(v, i, 40, backend="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("nq", [96, 2_100])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_probe_counts_kernel_past_65535_rows(cuda, dtype, nq):
    """Rows of 96 queries (a thread a query) and of 2,100 (warp tiles,
    the batch's (row, tile) pairs walked over a 1-D grid)."""
    rng = np.random.default_rng(2)
    keys = sorted_with_tail(rng, ROWS, 64, 48, 100, I32_MAX)
    queries = sorted_with_tail(rng, ROWS, nq, 80, 110, I32_MAX)
    probe_once(torch.as_tensor(queries, device=cuda).to(dtype),
               torch.as_tensor(keys, device=cuda).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [50, 2_100])
@pytest.mark.parametrize("n_buckets", [4, 16])
def test_hash_histogram_kernels_past_65535_rows(cuda, n_buckets, n):
    """Rows of 50 (``bucket_counts`` a warp a row) and of 2,100 (a CTA a
    row, walking the grid's y axis)."""
    rng = np.random.default_rng(n_buckets)
    keys = torch.as_tensor(rng.integers(0, 1 << 20, (ROWS, n)),
                           device=cuda).to(torch.int32)
    valid = torch.as_tensor(rng.random((ROWS, n)) < 0.7, device=cuda)
    bucket_counts_once(keys, valid, n_buckets, salt=1)
    got = thp.hash_histogram(keys, valid, n_buckets, salt=2)
    assert torch.equal(got, thp.hash_histogram(keys, valid, n_buckets,
                                                salt=2, backend="ref"))


@pytest.mark.cuda
@pytest.mark.parametrize("n_buckets", [16_384, 100_000])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_hash_histogram_kernels_past_the_shared_histogram(cuda, n_buckets,
                                                          dtype):
    """More buckets than a shared histogram holds: global atomics into
    a zeroed output, one CTA a row and many."""
    rng = np.random.default_rng(n_buckets)
    for batch, n in ((2, 3_000), (3, 300_001)):
        keys = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, (batch, n)),
                               device=cuda).to(dtype)
        valid = torch.as_tensor(rng.random((batch, n)) < 0.8, device=cuda)
        bucket_counts_once(keys, valid, n_buckets, salt=3)
    keys, valid = keys[:1, :5_000].contiguous(), valid[:1, :5_000].contiguous()
    before = ops.LAUNCHES["hash_histogram"]
    got = thp.hash_histogram(keys, valid, n_buckets)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["hash_histogram"] == before + 1
    assert torch.equal(got, thp.hash_histogram(keys, valid, n_buckets,
                                               backend="ref"))


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-3}


def attention_once(q, k, v, path, causal=True):
    """One launch on ``path``, held to the plain version."""
    b, hq, sq, d = q.shape
    assert tfa._plan(sq, k.shape[2], hq, k.shape[1], d, q.dtype,
                     batch=b).path == path
    before = ops.LAUNCHES["flash_attention"]
    got = tfa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    want = tfa.flash_attention(q, k, v, causal=causal, backend="ref")
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = ATTN_TOL[q.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def prefill_path(d, dtype):
    """Where a prefill runs: 16-bit dtypes at d <= 128, d % 8 == 0 on the
    tensor cores, everything else on the CUDA cores."""
    return ("wgmma" if dtype != torch.float32 and d <= 128 and d % 8 == 0
            else "simt")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("d", [16, 32, 80, 192, 256])
def test_flash_attention_any_head_dim_and_dtype(cuda, d, dtype):
    """Prefill and decode ("split") at head dims past the first kernels'
    (80 runs the wider instance, masked; on "wgmma" the tensor maps read
    zeros past it), in float32, bfloat16 and float16: prefill in 16 bits
    on "wgmma" up to 128, on "simt" past it, float32 on "simt"; decode
    in float16 through float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for causal in (True, False):
        attention_once(*attention_case(cuda, dtype, 1, 6, 2, 70, 90, d),
                       prefill_path(d, dtype), causal)
        attention_once(*attention_case(cuda, dtype, 2, 6, 2, 3, 300, d),
                       "split", causal)


@pytest.mark.cuda
def test_flash_attention_float16_at_the_tensor_core_widths(cuda):
    attention_once(*attention_case(cuda, torch.float16, 1, 4, 2, 100, 100, 64),
                   "wgmma")
    attention_once(*attention_case(cuda, torch.float16, 1, 4, 2, 1, 100, 128),
                   "split")


@pytest.mark.cuda
def test_flash_attention_past_65535_heads(cuda):
    """(batch, head) rows past 65,535 on "simt" (B·Hq on a 1-D grid) and
    "split" (B·Hkv past the grid's y limit)."""
    attention_once(*attention_case(cuda, torch.float32, 1024, 64, 64, 17, 17,
                                   16), "simt")
    attention_once(*attention_case(cuda, torch.float32, 2048, 64, 32, 1, 8,
                                   32), "split")
