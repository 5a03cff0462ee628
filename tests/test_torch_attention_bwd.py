"""The attention backward's plan and log-sum-exp, on the CPU; on a GPU,
the forward's lse and the backward's traced launches.

``_bwd_plan`` and ``_bwd_walks`` (the "wgmma" backward's dK/dV grid:
one CTA per key tile, head slice and batch·kv head, the key tile
slowest in ``blockIdx.x``) are checked from the shapes alone: the head
slices divide every kv group's query heads, the walks match a brute
count of the query tiles that see each key tile and fall from the first
key tile to the last (heaviest CTAs first), and the CTAs are as many as
the plan promises.  The plain lse ``ref.attention_lse`` (what the forward kernel
stores for the backward) is held to ``jax.scipy.special.logsumexp`` of
the same masked, scaled scores, computed with numpy from the same
inputs, at 1e-5 (float32 sums in another order).  JAX is imported in a
fixture, so the ``cuda`` cases run where it is absent.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so a parallel run does not
    oversubscribe the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: (B, Hq, Hkv, Sq, Skv, causal): granite-3-2b's train call, the ragged
#: chunk of the chip phase, rows that see no key, no causal band, MHA.
PLAN_SHAPES = [
    (1, 32, 8, 2048, 2048, True),
    (1, 28, 4, 1000, 3000, True),
    (1, 4, 1, 40, 20, True),
    (2, 16, 2, 130, 130, False),
    (1, 4, 4, 300, 300, True),
    (2, 32, 8, 1024, 1024, True),
]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_bwd_plan_slices_partition_heads_heaviest_first(shape, d):
    b, hq, hkv, sq, skv, causal = shape
    g = hq // hkv
    plan = tfa._bwd_plan(b, hq, hkv, sq, skv, d, torch.bfloat16, causal)
    assert plan.path == "wgmma" and g % plan.slices == 0
    walks = tfa._bwd_walks(sq, skv, causal)
    n_kt = -(-skv // tfa.BWD_KEYS)
    assert len(walks) == n_kt
    assert plan.ctas == n_kt * plan.slices * b * hkv
    # A query tile walks a key tile where one of its rows (padding
    # included) reaches the tile's first key.
    tile = tfa.BWD_QUERY_TILE
    n_qt = -(-sq // tile)
    for t, walk in enumerate(walks):
        assert walk == sum(
            not causal or (qt + 1) * tile - 1 + skv - sq >= t * tfa.BWD_KEYS
            for qt in range(n_qt))
    assert walks == sorted(walks, reverse=True)
    # The fewest slices whose longest CTA fits an SM's share, else G.
    share = b * hkv * g * sum(walks) / tfa.SM_COUNT
    assert g // plan.slices * max(walks) <= share or plan.slices == g
    assert all(g // s * max(walks) > share for s in range(1, plan.slices)
               if g % s == 0)


def test_bwd_plan_at_granite_and_off_the_tensor_cores():
    """granite-3-2b's call: two slices, 256 CTAs, the longest walking
    4,096 query rows (two heads of 2,048; a whole group of four with one
    CTA a kv head's key tile), the last 256.  16-bit dtypes at head dims
    up to 128 in steps of 8 take "wgmma" too (bfloat16 d = 80, float16
    d = 128); float32 and the other head dims take "simt"."""
    plan = tfa._bwd_plan(1, 32, 8, 2048, 2048, 64, torch.bfloat16, True)
    assert plan == tfa.BwdPlan("wgmma", 2, 256)
    walks = tfa._bwd_walks(2048, 2048, True)
    rows = 32 // 8 // plan.slices * tfa.BWD_QUERY_TILE
    assert walks[0] * rows == 4096 and walks[-1] * rows == 256
    for dtype, d, path in ((torch.float32, 64, "simt"),
                           (torch.bfloat16, 80, "wgmma"),
                           (torch.float16, 128, "wgmma")):
        assert tfa._bwd_plan(1, 32, 8, 2048, 2048, d, dtype,
                             True).path == path


@pytest.mark.parametrize("dtype,d,path", [
    (torch.bfloat16, 16, "wgmma"), (torch.bfloat16, 80, "wgmma"),
    (torch.float16, 64, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.bfloat16, 192, "simt"), (torch.bfloat16, 20, "simt"),
    (torch.float16, 256, "simt"), (torch.float32, 64, "simt"),
    (torch.float32, 128, "simt")])
def test_bwd_plan_routes_as_the_forward(dtype, d, path):
    """The backward takes "wgmma" exactly where the forward's prefill
    does, and each path reads the dtype natively."""
    plan = tfa._bwd_plan(1, 8, 2, 300, 300, d, dtype, True)
    assert plan.path == path
    assert tfa._plan(300, 300, 8, 2, d, dtype).path == path
    assert dtype in tfa.BWD_DTYPES[path]


#: (B, Hq, Hkv, Sq, Skv, D) at the "simt" dK/dV grid: the D = 256 call
#: (32 CTAs before its parts), granite-3-2b in float32, a ragged causal
#: chunk, rows that see no key, one head.
SIMT_PLAN_SHAPES = [
    (1, 4, 2, 512, 512, 256),
    (1, 32, 8, 2048, 2048, 64),
    (1, 28, 4, 1000, 3000, 128),
    (1, 4, 1, 40, 20, 192),
    (1, 1, 1, 17, 17, 16),
]


@pytest.mark.parametrize("shape", SIMT_PLAN_SHAPES, ids=str)
def test_simt_bwd_plan_fills_the_sms(shape):
    """The "simt" dK/dV grid: (key tiles) x (parts) x (batch·kv heads),
    the fewest parts that give every SM two CTAs and keep the longest
    CTA within an SM's even share of the walks, never more parts than
    the longest walk; the dQ tile as the forward's."""
    b, hq, hkv, sq, skv, d = shape
    g, w = hq // hkv, tfa._simt_width(d)
    plan = tfa._bwd_plan(b, hq, hkv, sq, skv, d, torch.float32, True)
    walks = tfa._bwd_walks(sq, skv, True, tfa.SIMT_BWD_KEYS[w],
                           tfa.SIMT_BWD_ROWS[w])
    assert plan.path == "simt"
    assert plan.ctas == len(walks) * plan.slices * b * hkv
    assert plan.tile == tfa._query_tile(sq, b * hq, 64)
    longest = g * max(walks)
    share = b * hkv * g * sum(walks) / tfa.SM_COUNT
    assert plan.slices <= longest
    ok = (plan.ctas >= 2 * tfa.SM_COUNT and -(-longest // plan.slices) <= share)
    assert ok or plan.slices == longest
    fewer = plan.slices - 1
    assert fewer == 0 or (len(walks) * fewer * b * hkv < 2 * tfa.SM_COUNT
                          or -(-longest // fewer) > share)


def test_simt_bwd_grid_at_d256():
    """q (1, 4, 512, 256), kv (1, 2, 512, 256) float32: 32 dK/dV CTAs at
    one part (16 key tiles of 32 x 2 kv heads), 288 with the plan's 9;
    dQ's 128 CTAs of 16 rows split their key tiles in 4 parts."""
    plan = tfa._bwd_plan(1, 4, 2, 512, 512, 256, torch.float32, True)
    assert plan == tfa.BwdPlan("simt", 9, 288, 16, 4)


#: (Hq, Hkv, Skv, causal) at Sq = 24; the scores padded with -inf to
#: LSE_KEYS keys, so one jitted logsumexp serves every case.
LSE_CASES = [(4, 2, 40, True), (4, 1, 12, True), (4, 4, 48, False)]
LSE_Q, LSE_KEYS, LSE_D = 24, 48, 16


@pytest.fixture(scope="module")
def jax_logsumexp():
    jax = pytest.importorskip("jax")
    from _torch_jax import run_fast
    fn = jax.jit(lambda x: jax.scipy.special.logsumexp(x, axis=-1))
    return lambda x: np.asarray(run_fast(fn, x))


@pytest.mark.parametrize("case", LSE_CASES, ids=str)
def test_attention_lse_matches_jax_logsumexp(jax_logsumexp, case):
    hq, hkv, skv, causal = case
    rng = np.random.default_rng(sum(case))
    q = rng.normal(size=(1, hq, LSE_Q, LSE_D)).astype(np.float32)
    k = rng.normal(size=(1, hkv, skv, LSE_D)).astype(np.float32)
    scale = LSE_D ** -0.5
    scores = np.full((1, hq, LSE_Q, LSE_KEYS), -np.inf, np.float32)
    scores[..., :skv] = np.einsum("bhqd,bhkd->bhqk", q * scale,
                                  np.repeat(k, hq // hkv, axis=1))
    if causal:
        pos = np.arange(LSE_Q)[:, None] + (skv - LSE_Q)
        scores[..., :skv] = np.where(pos >= np.arange(skv)[None, :],
                                     scores[..., :skv], -np.inf)
    want = jax_logsumexp(scores) / math.log(2.0)
    got = ref.attention_lse(torch.from_numpy(q), torch.from_numpy(k),
                            causal=causal, scale=scale)
    assert got.dtype == torch.float32 and got.shape == (1, hq, LSE_Q)
    got = got.numpy()
    seen = np.isfinite(want)
    np.testing.assert_array_equal(np.isposinf(got), ~seen)
    np.testing.assert_allclose(got[seen], want[seen], rtol=1e-5, atol=1e-5)


def test_backward_with_an_lse_equals_without_it_on_the_cpu():
    """On CPU tensors the plain version runs and the lse changes
    nothing."""
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(1, 4, 10, 16, generator=gen)
    k = torch.randn(1, 2, 12, 16, generator=gen)
    v = torch.randn(1, 2, 12, 16, generator=gen)
    dout = torch.randn(1, 4, 10, 16, generator=gen)
    out = tfa.flash_attention(q, k, v)
    lse = ref.attention_lse(q, k)
    with_lse = tfa.flash_attention_backward(q, k, v, out, dout, lse=lse)
    without = tfa.flash_attention_backward(q, k, v, out, dout)
    assert all(torch.equal(a, b) for a, b in zip(with_lse, without))


# ---------------------------------------------------------------------------
# On the card (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


#: (B, Hq, Hkv, Sq, Skv, D, causal) and dtype: bfloat16 on the
#: forward's "wgmma" path, float32 on "simt" (D = 64, and 192 with rows
#: that see no key).
FWD_LSE_SHAPES = [((1, 8, 2, 300, 300, 64, True), torch.bfloat16),
                  ((2, 4, 4, 100, 260, 128, True), torch.bfloat16),
                  ((1, 4, 1, 70, 40, 64, True), torch.bfloat16),
                  ((1, 4, 2, 129, 200, 128, False), torch.bfloat16),
                  ((1, 8, 2, 300, 300, 64, True), torch.float32),
                  ((1, 4, 2, 130, 100, 192, True), torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", FWD_LSE_SHAPES, ids=str)
def test_forward_lse_equals_plain(cuda, shape, dtype):
    """The lse the forward kernel stores ("wgmma" and "simt") against
    ``ref.attention_lse`` (1e-3 on a log2 near 8: float32 sums in another
    order, the fast exp2 and log2), +inf on the same rows; storing it
    leaves the output's bits as they are."""
    b, hq, hkv, sq, skv, d, causal = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q = torch.randn(b, hq, sq, d, generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn(b, hkv, skv, d, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    assert tfa._plan(sq, skv, hq, hkv, d, dtype).path == (
        "wgmma" if dtype == torch.bfloat16 else "simt")
    out, lse = tfa._flash_attention_cuda(q, k, v, causal, d ** -0.5, 128,
                                         128, with_lse=True)
    plain = tfa._flash_attention_cuda(q, k, v, causal, d ** -0.5, 128, 128)
    assert torch.equal(out, plain)
    want = ref.attention_lse(q, k, causal=causal)
    assert lse.shape == want.shape and lse.dtype == torch.float32
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    seen = torch.isfinite(want)
    torch.testing.assert_close(lse[seen], want[seen], rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    ((1, 32, 8, 300, 300, 64), torch.bfloat16),     # "wgmma", slices > 1
    ((1, 4, 4, 200, 200, 128), torch.bfloat16),     # "wgmma", one slice
    ((1, 8, 2, 100, 100, 64), torch.float32),       # "simt"
], ids=str)
def test_traced_backward_counts_one_record_a_call(cuda, shape, dtype):
    """``ops.traced_launches`` counts one ``flash_attention_bwd`` record a
    backward call on both paths, as the wrapper counts one launch.  The
    traced call is the second: traces of a kernel instance's first call
    in the process have come back without its records (the profiler
    drops records, ROADMAP C9)."""
    b, hq, hkv, sq, skv, d = shape
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, dout = (torch.randn(b, hq, sq, d, generator=gen, device=cuda)
               .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, hkv, skv, d, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    out = tfa.flash_attention(q, k, v)
    tfa.flash_attention_backward(q, k, v, out, dout)
    torch.cuda.synchronize()
    ops.reset_launches()
    _, traced, _ = ops.traced_launches(
        lambda: tfa.flash_attention_backward(q, k, v, out, dout))
    assert traced["flash_attention_bwd"] == 1
    assert ops.LAUNCHES["flash_attention_bwd"] == 1


@pytest.mark.cuda
def test_backward_refuses_an_lse_off_the_forward_layout(cuda):
    """The kernel reads the lse in the forward's padded rows: the plain
    ``ref.attention_lse`` (Sq = 100 rows a head, unpadded) raises
    ``ValueError``, the forward's own gives the plain gradient within
    phase 2's 2e-2."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, dout = (torch.randn(1, 8, 100, 64, generator=gen, device=cuda)
               .bfloat16() for _ in range(2))
    k, v = (torch.randn(1, 2, 150, 64, generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
    out, lse = tfa._flash_attention_cuda(q, k, v, True, 64 ** -0.5, 128,
                                         128, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_backward(q, k, v, out, dout,
                                     lse=ref.attention_lse(q, k))
    got = tfa.flash_attention_backward(q, k, v, out, dout, lse=lse)
    for g, w in zip(got, ref.attention_backward(q, k, v, dout)):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2)


#: (B, Hq, Hkv, Sq, Skv, D), dtype, path, tolerance: the calls this
#: path change moved (bfloat16 d = 80 and float16 d = 128 onto the
#: tensor cores) and the redesigned "simt" (bfloat16 d = 192, float32
#: d = 256: its parts summed in order).
ROUTE_CASES = [
    ((1, 8, 2, 200, 200, 80), torch.bfloat16, "wgmma", 2e-2),
    ((1, 8, 2, 200, 200, 128), torch.float16, "wgmma", 2e-3),
    ((1, 4, 2, 150, 150, 192), torch.bfloat16, "simt", 2e-2),
    ((1, 4, 2, 256, 256, 256), torch.float32, "simt", 1e-4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,path,tol", ROUTE_CASES, ids=str)
def test_backward_equals_plain_on_each_route(cuda, shape, dtype, path, tol):
    """The backward on its path, given the forward's lse, against
    ``ref.attention_backward`` (2e-2 bf16, 2e-3 fp16, 1e-4 f32), in the
    dtype natively (no float32 copy), and the same bits on two
    launches."""
    b, hq, hkv, sq, skv, d = shape
    assert tfa._bwd_plan(b, hq, hkv, sq, skv, d, dtype, True).path == path
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, dout = (torch.randn(b, hq, sq, d, generator=gen, device=cuda)
               .to(dtype) for _ in range(2))
    k, v = (torch.randn(b, hkv, skv, d, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    out, lse = tfa._flash_attention_cuda(q, k, v, True, d ** -0.5, 128, 128,
                                         with_lse=True)
    assert lse is not None
    got = tfa.flash_attention_backward(q, k, v, out, dout, lse=lse)
    again = tfa.flash_attention_backward(q, k, v, out, dout, lse=lse)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, ref.attention_backward(q, k, v, dout)):
        assert g.dtype == dtype and torch.equal(g, a)
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.float32, 200),
                                     (torch.bfloat16, 192)])
def test_simt_backward_with_the_forward_lse_equals_recomputing_it(cuda,
                                                                  dtype, d):
    """On "simt" the backward given the forward's lse launches no lse
    pass (``attention_bwd_lse`` absent from the trace) and equals the
    call that recomputes it, both at the plain version's tolerance (1e-4
    f32, 2e-2 bf16): the forward here splits each query tile's keys in
    parts, and its lse from their merge may differ from the one-pass
    lse in the last bit."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q, dout = (torch.randn(1, 8, 130, d, generator=gen, device=cuda)
               .to(dtype) for _ in range(2))
    k, v = (torch.randn(1, 2, 170, d, generator=gen, device=cuda)
            .to(dtype) for _ in range(2))
    assert tfa._bwd_plan(1, 8, 2, 130, 170, d, dtype, True).path == "simt"
    out, lse = tfa._flash_attention_cuda(q, k, v, True, d ** -0.5, 128, 128,
                                         with_lse=True)
    given = tfa.flash_attention_backward(q, k, v, out, dout, lse=lse)
    recomputed = tfa.flash_attention_backward(q, k, v, out, dout)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b, w in zip(given, recomputed,
                       ref.attention_backward(q, k, v, dout)):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(a.float(), w.float(), rtol=tol, atol=tol)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        tfa.flash_attention_backward(q, k, v, out, dout, lse=lse)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert any("attention_bwd_dkdv_simt" in n for n in names)
    assert not any("attention_bwd_lse" in n for n in names)
