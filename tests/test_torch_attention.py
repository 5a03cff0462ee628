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
    (1, 1, 8, 8, 64, torch.bfloat16, "split")])
def test_plan_picks_the_path(sq, skv, hq, hkv, d, dtype, path):
    plan = tfa._plan(sq, skv, hq, hkv, d, dtype)
    assert plan.path == path
    if path == "split":     # whole key tiles that cover the kv axis once
        assert plan.chunk % tfa.SPLIT_KEYS == 0
        assert (plan.splits - 1) * plan.chunk < skv <= plan.splits * plan.chunk
    else:
        assert plan.splits == 1


@pytest.mark.parametrize("batch", [1, 2])
def test_plan_gives_every_sm_two_ctas_at_decode(batch):
    """qwen2-7b decode over 4,096 keys: one CTA a (split, kv head) holds
    all 7 query heads of the group, and there are at least 2 × 132."""
    plan = tfa._plan(1, 4096, 28, 4, 128, torch.bfloat16, batch=batch)
    assert plan.path == "split"
    assert plan.splits * batch * 4 >= 2 * tfa.SM_COUNT
