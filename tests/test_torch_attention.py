"""The port's attention against the JAX package, on the CPU.

The plain version (``repro_torch.kernels.ref.attention``, what
``tfa.flash_attention`` runs on CPU tensors) is held to the JAX
package's ``ref.attention``, jitted, over the shapes of
``TestFlashAttention`` in ``tests/test_kernels.py`` (MHA, GQA, MQA,
single-token decode, padded shapes) × causal × dtype, at the tolerances
that test holds the Pallas kernel to: 2e-5 in float32, 2e-2 in
bfloat16.  A causal query row that sees no key (Sq > Skv) gives zeros,
as the Pallas kernel does in interpret mode — ``ref.attention`` gives
NaN there, so that case is held to the kernel.  ``_plan``, which picks
the CUDA kernel ("wgmma", "split" or "simt") from the shapes and dtype
alone, is checked here too; the kernels themselves run only on a GPU
(``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SHAPES = [
    (1, 4, 4, 128, 128, 64),     # MHA square
    (2, 8, 2, 64, 64, 64),       # GQA
    (1, 4, 1, 32, 32, 128),      # MQA, ragged block
    (1, 8, 2, 1, 256, 64),       # single-token decode vs KV cache
    (1, 4, 2, 17, 40, 64),       # non-pow2 shapes
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

jax_attention = jax.jit(jref.attention, static_argnames=("causal",))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tensors here are tiny.  Under a parallel test run the
    intra-op thread pool oversubscribes the CPU and slows each torch op
    by two orders of magnitude (measured: 0.14 s against 10.5 s for one
    case beside six busy processes), so this module runs on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def qkv(shape, seed):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_attention_plain_matches_jax_ref(shape, causal, dtype):
    j_dt, t_dt, tol = DTYPES[dtype]
    arrays = qkv(shape, sum(shape) + causal)
    want = jax_attention(*(jnp.asarray(a, j_dt) for a in arrays),
                         causal=causal)
    got = tfa.flash_attention(*(torch.as_tensor(a).to(t_dt) for a in arrays),
                              causal=causal)
    assert got.dtype == t_dt and got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_fully_masked_rows_are_zeros_as_in_the_pallas_kernel():
    """Causal with Sq > Skv: the first Sq − Skv query rows see no key."""
    arrays = qkv((1, 4, 2, 40, 17, 64), 3)
    want = np.asarray(jax_flash(*(jnp.asarray(a) for a in arrays),
                                causal=True, interpret=True))
    got = ref.attention(*(torch.as_tensor(a) for a in arrays),
                        causal=True).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got[:, :, :23], 0.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_gqa_shape_checks():
    q = torch.zeros(1, 6, 4, 64)
    kv = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="multiple"):
        ref.attention(q, kv, kv)


@pytest.mark.parametrize("sq,skv,hq,hkv,d,dtype,path", [
    (4096, 4096, 28, 4, 128, torch.bfloat16, "wgmma"),    # prefill
    (1000, 3000, 28, 4, 128, torch.bfloat16, "wgmma"),    # chunked prefill
    (200, 1000, 4, 2, 64, torch.bfloat16, "wgmma"),
    (17, 40, 4, 2, 64, torch.bfloat16, "wgmma"),
    (4096, 4096, 28, 4, 128, torch.float32, "simt"),
    (17, 40, 4, 2, 64, torch.float32, "simt"),
    (1, 4096, 28, 4, 128, torch.bfloat16, "split"),       # decode
    (1, 4096, 28, 4, 128, torch.float32, "split"),
    (16, 4096, 28, 4, 128, torch.bfloat16, "split"),      # short chunk
    (4, 300, 8, 2, 128, torch.float32, "split"),
    (1, 1, 8, 8, 64, torch.bfloat16, "split"),
    # 16-bit prefill at d <= 128, d % 8 == 0: the tensor cores, float16
    # too; d past 128 or off a multiple of 8, and float32: the CUDA cores.
    (1024, 1024, 28, 4, 16, torch.bfloat16, "wgmma"),
    (1024, 1024, 28, 4, 80, torch.bfloat16, "wgmma"),
    (1024, 1024, 28, 4, 64, torch.float16, "wgmma"),
    (1024, 1024, 28, 4, 128, torch.float16, "wgmma"),
    (1024, 1024, 4, 4, 192, torch.bfloat16, "simt"),
    (1024, 1024, 4, 2, 20, torch.bfloat16, "simt"),
    (1024, 1024, 4, 4, 192, torch.float32, "simt"),
    (1024, 1024, 4, 2, 16, torch.float32, "simt"),
    (1, 4096, 28, 4, 128, torch.float16, "split")])
def test_plan_picks_the_path(sq, skv, hq, hkv, d, dtype, path):
    plan = tfa._plan(sq, skv, hq, hkv, d, dtype)
    assert plan.path == path
    if path == "split":     # whole key tiles that cover the kv axis once
        assert plan.chunk % tfa.SPLIT_KEYS == 0
        assert (plan.splits - 1) * plan.chunk < skv <= plan.splits * plan.chunk
    elif path == "simt":    # parts of each query tile's key tiles
        assert 1 <= plan.splits <= tfa.SIMT_MAX_PARTS
    else:
        assert plan.splits == 1
    if path in ("wgmma", "simt"):
        assert tfa.NATIVE_DTYPES[path].count(dtype) == (dtype != torch.float32
                                                        or path == "simt")


@pytest.mark.parametrize("d,width", [(8, 64), (16, 64), (64, 64), (72, 128),
                                     (80, 128), (128, 128)])
def test_wgmma_width_holds_the_head_dim(d, width):
    """The tensor-core instance a head dim runs: 64 columns up to 64, else
    128, the tensor maps reading zeros past d."""
    assert tfa._on_tensor_cores(d, torch.bfloat16)
    assert tfa._wgmma_width(d) == width


@pytest.mark.parametrize("d,width", [(1, 16), (16, 16), (20, 32), (33, 64),
                                     (80, 128), (129, 192), (192, 192),
                                     (200, 256), (256, 256)])
def test_simt_width_holds_the_head_dim(d, width):
    assert tfa._simt_width(d) == width


@pytest.mark.parametrize("b,hq,sq,block_q,tile", [
    (1, 4, 1024, 128, 16),      # d = 192's call: 256 CTAs, the most it has
    (1, 28, 4096, 128, 64),     # 1,792 CTAs at the largest tile
    (1, 28, 1024, 128, 64),     # 448 CTAs at 64 rows
    (1, 16, 1024, 128, 32),     # 256 at 64 rows (short of 264), 512 at 32
    (1, 8, 1024, 128, 16),      # 128 at 64 rows, 256 at 32, 512 at 16
    (1, 4, 1024, 32, 16),       # block_q caps it
    (1024, 64, 17, 128, 32),    # 17 rows: a tile of 64 is never needed
    (1, 2, 20, 128, 16),        # too few rows to fill the SMs: the smallest
])
def test_simt_query_tile_fills_the_sms(b, hq, sq, block_q, tile):
    """The "simt" query tile: the largest within ``block_q`` and Sq that
    still puts two CTAs on each of the 132 SMs, else the smallest."""
    got = tfa._query_tile(sq, b * hq, block_q)
    assert got == tile and got <= max(16, block_q)
    ctas = -(-sq // got) * b * hq
    larger = [t for t in tfa.SIMT_TILES if got < t <= block_q and t // 2 < sq]
    assert all(-(-sq // t) * b * hq < 2 * tfa.SM_COUNT for t in larger)
    assert ctas >= 2 * tfa.SM_COUNT or got == 16
    plan = tfa._plan(sq, sq, hq, hq, 192, torch.float32, batch=b,
                     block_q=block_q)
    assert plan.path == "simt" and plan.tile == got


def test_simt_grid_at_the_d192_forward():
    """q (1, 4, 1,024, 192) float32: 64 CTAs at the old 64-row tile; 256
    of 64 threads at 16 rows (16,384 threads, 124 an SM), so each query
    tile's 64 key tiles split into 4 parts: 1,024 CTAs."""
    plan = tfa._plan(1024, 1024, 4, 4, 192, torch.float32)
    assert plan == tfa.Plan("simt", 4, 1024, 16)
    assert -(-1024 // plan.tile) * 4 * plan.splits == 1024


@pytest.mark.parametrize("sq,heads,tile,key_tiles,parts", [
    (1024, 4, 16, 64, 4),       # 16,384 threads: 4 parts (at most)
    (1024, 28, 16, 64, 1),      # 114,688 threads >= 512 x 132
    (1024, 16, 16, 64, 2),      # 65,536: 2 parts reach 67,584
    (4096, 28, 64, 64, 1),      # not the smallest tile
    (40, 2, 16, 2, 2),          # no more parts than key tiles
])
def test_simt_parts_fill_the_sms(sq, heads, tile, key_tiles, parts):
    """Key-tile parts only where even 16-row tiles leave the SMs short of
    512 threads each: enough to reach it, at most 4 and the key tiles."""
    assert tfa._simt_parts(sq, heads, tile, key_tiles) == parts


@pytest.mark.parametrize("batch", [1, 2])
def test_plan_gives_every_sm_two_ctas_at_decode(batch):
    """qwen2-7b decode over 4,096 keys: one CTA a (split, kv head) holds
    all 7 query heads of the group, and there are at least 2 × 132."""
    plan = tfa._plan(1, 4096, 28, 4, 128, torch.bfloat16, batch=batch)
    assert plan.path == "split"
    assert plan.splits * batch * 4 >= 2 * tfa.SM_COUNT
