"""The port's mixture-of-experts family against the JAX package, on the CPU.

``repro_torch.models.moe`` and the moe block of ``models/lm.py`` are
held to ``src/repro/models/moe.py`` and ``lm.py`` at the grok-1 and
kimi-k2 smoke configs (kimi adds a shared expert): the parameter trees,
the router's ids exactly (with exact ties among the gates: the lower
expert first, as ``jax.lax.top_k``) and its weights at 1e-6, the
dispatch plan as full arrays with and without dropped copies,
``_moe_local`` at float32 ``rtol = atol = 1e-5``, each model's loss, a
6-token prefill and two decode steps (float32 cache) at 1e-5, greedy
``Engine.generate`` token for token against the JAX ``Engine``, and the
loss's gradient against ``jax.grad`` (rtol 1e-4, atol 1e-6: float32
sums in another order, as ``tests/test_torch_train.py`` holds them).
The JAX references compile with ``_torch_jax.XLA_FAST``, one program a
model for the loss, its gradient and both prefills.  The ``cuda`` case
runs each smoke model on the card with ``backend="auto"`` against
``backend="ref"``.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import Planner  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

from test_torch_lm import close, def_fields, flat, np_params, t  # noqa: E402

MOE = ("grok-1-314b", "kimi-k2-1t-a32b")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
NULL = Planner.null()
CPU = torch.device("cpu")
B, PROMPT, MAX_LEN = 2, 6, 16
STEPS = ((0, PROMPT), (PROMPT, PROMPT + 1), (PROMPT + 1, PROMPT + 2))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the intra-op pool only oversubscribes the CPU under
    a parallel run (see ``tests/test_torch_skew.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    from repro.distributed import sharding
    from repro.models import lm, moe, params
    from repro.serving import engine

    from _torch_jax import fast, run_fast
    return types.SimpleNamespace(fast=fast, jax=jax, jnp=jnp, configs=configs,
                                 sharding=sharding, lm=lm, moe=moe,
                                 params=params, engine=engine,
                                 run_fast=run_fast)


def pair(J, arch, **changes):
    return (dataclasses.replace(get_config(arch, True), **changes),
            dataclasses.replace(J.configs.get_config(arch, True), **changes))


# ---------------------------------------------------------------------------
# The layer: defs, router, dispatch plan, _moe_local
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_moe_defs_match_reference(J, arch):
    cfg, jcfg = pair(J, arch)
    is_t = lambda x: isinstance(x, TP.ParamDef)  # noqa: E731
    is_j = lambda x: isinstance(x, J.params.ParamDef)  # noqa: E731
    got = {p: def_fields(d) for p, d in flat(TMOE.moe_defs(cfg), is_t).items()}
    want = {p: def_fields(d)
            for p, d in flat(J.moe.moe_defs(jcfg), is_j).items()}
    assert got == want
    assert ("shared_wg",) in got if arch.startswith("kimi") else \
        ("shared_wg",) not in got
    for n in (1, 7, 12, 4096):
        assert TMOE._capacity(cfg, n) == J.moe._capacity(jcfg, n)
    for shape in ({"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 4},
                  {"data": 3, "model": 2}, {"model": 16}):
        assert TMOE.ep_axes_for(cfg, shape) == J.moe.ep_axes_for(jcfg, shape)


def layer_inputs(J, jcfg, seed, n_tokens, tied=False):
    """Layer parameters and a (1, n_tokens, d) input.  ``tied``: the
    router's odd columns copy the even ones, so every token's gates
    come in exactly equal pairs."""
    p = np_params(J, J.moe.moe_defs(jcfg), seed)
    if tied:
        p["router"][:, 1::2] = p["router"][:, 0::2]
    x = np.random.default_rng(seed + 1).normal(
        size=(1, n_tokens, jcfg.d_model)).astype(np.float32)
    return p, x


@pytest.fixture(scope="module")
def route_refs(J):
    """The JAX ``_route`` of each case, one program a case."""
    done = {}

    def get(arch, tied):
        if (arch, tied) not in done:
            cfg, jcfg = pair(J, arch)
            p, x = layer_inputs(J, jcfg, 20, 24, tied)
            f = J.jax.jit(lambda p, x: J.moe._route(p, x, jcfg))
            want = J.run_fast(f, J.jax.tree.map(J.jnp.asarray, p),
                              J.jnp.asarray(x[0]))
            done[arch, tied] = (cfg, p, x, [np.asarray(w) for w in want])
        return done[arch, tied]
    return get


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("arch", MOE)
def test_route_matches_reference(route_refs, arch, tied):
    cfg, p, x, (ids, weights, aux) = route_refs(arch, tied)
    tp = interop.params_from_numpy(p, CPU)
    gates = torch.softmax((t(x[0]) @ tp["router"]).float(), -1)
    if tied:
        # Each token's top gates tie exactly: the order among equals
        # decides the ids.
        assert bool((gates[:, 0::2] == gates[:, 1::2]).all())
        assert (ids[:, 0] % 2 == 0).all() and (ids[:, 1] == ids[:, 0] + 1).all()
    got_ids, got_w, got_aux = TMOE._route(tp, t(x[0]), cfg)
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    np.testing.assert_allclose(got_w.numpy(), weights, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(got_aux), float(aux), rtol=1e-6)


@pytest.mark.parametrize("cf", [4.0, 0.5], ids=["kept", "drops"])
def test_dispatch_plan_matches_reference(J, cf):
    """The plan of 300 tokens' random top-2 ids over 8 experts (skewed to
    expert 3), as full arrays: the gather index, the valid mask, and so
    which copies are dropped over capacity."""
    cfg, jcfg = pair(J, "grok-1-314b", n_experts=8, capacity_factor=cf)
    rng = np.random.default_rng(21)
    ids = rng.integers(0, 8, (300, 2)).astype(np.int32)
    ids[rng.random(300) < 0.3, 0] = 3
    cap = TMOE._capacity(cfg, 300)
    f = J.jax.jit(lambda i: J.moe._dispatch_plan(i, 8, cap))
    w_gather, w_valid = (np.asarray(a) for a in J.run_fast(
        f, J.jnp.asarray(ids)))
    gather, valid = TMOE._dispatch_plan(t(ids), 8, cap)
    np.testing.assert_array_equal(valid.numpy(), w_valid)
    np.testing.assert_array_equal(gather.numpy(), w_gather)
    kept = int(valid.sum())
    assert (kept < ids.size) == (cf == 0.5)


@pytest.mark.parametrize("arch", MOE)
def test_moe_local_matches_reference(J, arch):
    cfg, jcfg = pair(J, arch)
    p, x = layer_inputs(J, jcfg, 22, 10)
    x = x.reshape(2, 5, -1)
    f = J.jax.jit(lambda p, x: J.moe._moe_local(p, x, jcfg))
    want = J.run_fast(f, J.jax.tree.map(J.jnp.asarray, p), J.jnp.asarray(x))
    got, aux = TMOE.moe_forward(interop.params_from_numpy(p, CPU), t(x), cfg)
    close(got, want)
    # One device: the reference returns a zero aux (ROADMAP C11).
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_combine_sums_each_tokens_copies_in_k_order():
    """Two tokens, top-2: rows for copies 0, 3 and 1 (copy 2 dropped)."""
    contrib = torch.tensor([[1.0, 2.0], [10.0, 20.0], [100.0, 200.0]])
    copy = torch.tensor([0, 3, 1])
    out = TMOE._combine(contrib, copy, torch.tensor([True, True, True]), 2, 2)
    np.testing.assert_array_equal(out.numpy(), [[101, 202], [10, 20]])
    out = TMOE._combine(contrib, copy, torch.tensor([True, False, True]), 2,
                        2)
    np.testing.assert_array_equal(out.numpy(), [[101, 202], [0, 0]])


# ---------------------------------------------------------------------------
# The models: loss, gradient, prefill and decode, Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_refs(J):
    """Per model: numpy parameters and tokens; the JAX loss, its gradient,
    and the prefill and two decode steps over a float32 cache."""
    done = {}

    def get(arch):
        if arch in done:
            return done[arch]
        cfg, jcfg = pair(J, arch)
        jmodel = J.lm.build_model(jcfg)
        params = np_params(J, jmodel.defs, 11)
        tokens = np.random.default_rng(12).integers(
            0, cfg.vocab_size, (B, PROMPT + 2), np.int32)
        jp = J.jax.tree.map(J.jnp.asarray, params)
        null = J.sharding.Planner.null()
        cache = J.params.zeros_of(jmodel.cache_defs(B, MAX_LEN), J.jnp.float32)

        def loss(p, tk):
            return jmodel.loss(p, {"tokens": tk}, null)

        def first(p, tk, c):
            return (J.jax.value_and_grad(loss)(p, tk),
                    jmodel.decode_step(p, c, tk[:, :PROMPT], 0, null))

        (lv, grads), out = J.run_fast(J.jax.jit(first), jp,
                                      J.jnp.asarray(tokens), cache)
        history = [out]
        step = J.fast(J.jax.jit(lambda p, c, tk, pos: jmodel.decode_step(
            p, c, tk, pos, null)))
        for lo, hi in STEPS[1:]:
            out = step(jp, out[1], J.jnp.asarray(tokens[:, lo:hi]),
                       J.jnp.asarray(lo, J.jnp.int32))
            history.append(out)
        done[arch] = dict(
            params=params, tokens=tokens, loss=np.asarray(lv),
            grads=J.jax.tree.map(np.asarray, grads),
            steps=[(np.asarray(lg), {n: np.asarray(c) for n, c in cc.items()})
                   for lg, cc in history])
        return done[arch]

    return get


@pytest.mark.parametrize("arch", MOE)
def test_model_loss_and_gradient_match_reference(J, model_refs, arch):
    ref = model_refs(arch)
    cfg, _ = pair(J, arch)
    model = TLM.build_model(cfg)
    params = interop.params_from_numpy(ref["params"], CPU)
    leaves = TP.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = model.loss(params, {"tokens": t(ref["tokens"])})
    close(loss, ref["loss"])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = TP.sorted_leaves(ref["grads"])
    got = dict(zip(map(id, leaves), grads))
    for leaf, w in zip(TP.sorted_leaves(params), want):
        g = got[id(leaf)]
        g = torch.zeros_like(leaf) if g is None else g
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("arch", MOE)
def test_model_decode_step_matches_reference(J, model_refs, arch):
    """A 6-token prefill, then 2 decode steps, float32 weights and cache:
    logits and cache at 1e-5 after every step."""
    ref = model_refs(arch)
    cfg, _ = pair(J, arch)
    model = TLM.build_model(cfg)
    params = interop.params_from_numpy(ref["params"], CPU)
    cache = TP.zeros_of(model.cache_defs(B, MAX_LEN), torch.float32,
                        device="cpu")
    tokens = t(ref["tokens"])
    for (lo, hi), (want, want_cache) in zip(STEPS, ref["steps"]):
        logits, cache = model.decode_step(params, cache, tokens[:, lo:hi], lo)
        assert logits.shape == (B, hi - lo, cfg.padded_vocab)
        close(logits, want)
        for n in ("k", "v"):
            np.testing.assert_allclose(cache[n].numpy(), want_cache[n], **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_generate_greedy_equals_jax_engine_token_for_token(J, model_refs,
                                                           arch):
    ref = model_refs(arch)
    cfg, jcfg = pair(J, arch)
    port = Engine(TLM.build_model(cfg),
                  interop.params_from_numpy(ref["params"], CPU),
                  ServeConfig(MAX_LEN))
    jax_eng = J.engine.Engine(J.lm.build_model(jcfg),
                              J.jax.tree.map(J.jnp.asarray, ref["params"]),
                              J.engine.ServeConfig(max_len=MAX_LEN))
    jax_eng._step = J.fast(jax_eng._step)
    prompts = ref["tokens"][:, :4]
    got, stats = port.generate(prompts, 6)
    want, want_stats = jax_eng.generate(prompts, 6)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == want_stats


# ---------------------------------------------------------------------------
# On the card (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE)
def test_moe_model_on_the_card_equals_plain(cuda, arch):
    """Each MoE smoke model in bfloat16 on the card: a prefill and a
    decode step with the attention kernel (once a layer a step) against
    ``backend="ref"`` on the same weights, logits at 5e-2 (bf16 over
    two layers), the dispatch plan of the card equal to the CPU's."""
    cfg = get_config(arch, smoke=True)
    model, ref_model = TLM.build_model(cfg), TLM.build_model(cfg, "ref")
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    outs = []
    for m in (model, ref_model):
        cache = TP.zeros_of(m.cache_defs(2, 16), device=cuda)
        ops.reset_launches()
        a, cache = m.decode_step(params, cache, tokens[:, :8], 0)
        b, cache = m.decode_step(params, cache, tokens[:, 8:], 8)
        torch.cuda.synchronize()
        outs.append((a, b, ops.LAUNCHES["flash_attention"]))
    assert outs[0][2] == 2 * cfg.n_layers and outs[1][2] == 0
    for got, want in zip(outs[0][:2], outs[1][:2]):
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                                   atol=5e-2)
    ids = torch.randint(0, cfg.n_experts, (64, cfg.top_k), device=cuda)
    g, v = TMOE._dispatch_plan(ids, cfg.n_experts, 8)
    gc, vc = TMOE._dispatch_plan(ids.cpu(), cfg.n_experts, 8)
    assert torch.equal(g.cpu(), gc) and torch.equal(v.cpu(), vc)
