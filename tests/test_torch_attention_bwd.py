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
    CTA a kv head's key tile), the last 256.  float32 and other head dims
    take "simt"."""
    plan = tfa._bwd_plan(1, 32, 8, 2048, 2048, 64, torch.bfloat16, True)
    assert plan == tfa.BwdPlan("wgmma", 2, 256)
    walks = tfa._bwd_walks(2048, 2048, True)
    rows = 32 // 8 // plan.slices * tfa.BWD_QUERY_TILE
    assert walks[0] * rows == 4096 and walks[-1] * rows == 256
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 80),
                     (torch.float16, 128)):
        assert tfa._bwd_plan(1, 32, 8, 2048, 2048, d, dtype,
                             True).path == "simt"


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


#: (B, Hq, Hkv, Sq, Skv, D, causal) on the forward's "wgmma" path.
FWD_LSE_SHAPES = [(1, 8, 2, 300, 300, 64, True),
                  (2, 4, 4, 100, 260, 128, True),
                  (1, 4, 1, 70, 40, 64, True),
                  (1, 4, 2, 129, 200, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FWD_LSE_SHAPES, ids=str)
def test_forward_lse_equals_plain(cuda, shape):
    """The lse the forward kernel stores against ``ref.attention_lse``
    (1e-3 on a log2 near 8: float32 sums in another order, the fast
    exp2 and log2), +inf on the same rows; storing it leaves the output's
    bits as they are."""
    b, hq, hkv, sq, skv, d, causal = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q = torch.randn(b, hq, sq, d, generator=gen, device=cuda).bfloat16()
    k, v = (torch.randn(b, hkv, skv, d, generator=gen, device=cuda)
            .bfloat16() for _ in range(2))
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
