"""The port's state-space families against the JAX package, on the CPU.

``repro_torch.models.ssm`` and ``xlstm`` and the two builders of
``models/lm.py`` (``build_xlstm_lm``: xlstm-125m; ``build_hybrid_lm``:
zamba2-1.2b) are held to ``src/repro/models`` at float32 on the same
numpy inputs: ``ssd_chunked`` with a padded last chunk and an
``init_state`` and without either, ``ssd_decode_step``, the Mamba2,
mLSTM and sLSTM forward (from no state and from a state) and decode
functions, then each smoke model's loss, a 6-token prefill and two
decode steps over a float32 cache (logits and every state), greedy
``Engine.generate`` token for token against the JAX ``Engine``, and
``examples/serve_lm_torch.py`` at each smoke config on the CPU.
Tolerance ``rtol = atol = 1e-5`` throughout.  The layer references
compile as one JAX program (``_torch_jax.XLA_FAST``), each model's loss
and prefill as another.  The ``cuda`` case runs zamba2's smoke model on
the card (its shared attention on the kernel) against ``backend="ref"``.
"""

import dataclasses
import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.sharding import Planner  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import xlstm as TX  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

from test_torch_lm import close, np_params, t  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODELS = ("xlstm-125m", "zamba2-1.2b")
NULL = Planner.null()
CPU = torch.device("cpu")
B, PROMPT, MAX_LEN = 2, 6, 16
STEPS = ((0, PROMPT), (PROMPT, PROMPT + 1), (PROMPT + 1, PROMPT + 2))
# ssd_chunked cases: (B, S, G, Hg, P, N, chunk, with init_state)
SSD_CASES = {"padded_init": (2, 20, 2, 3, 4, 5, 8, True),
             "whole_chunks": (1, 16, 1, 2, 3, 4, 8, False)}


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
    from repro.models import lm, params, ssm, xlstm
    from repro.serving import engine

    from _torch_jax import fast, run_fast
    return types.SimpleNamespace(fast=fast, jax=jax, jnp=jnp, configs=configs,
                                 sharding=sharding, lm=lm, params=params,
                                 ssm=ssm, xlstm=xlstm, engine=engine,
                                 run_fast=run_fast)


def tree_close(got, want):
    is_t = lambda x: isinstance(x, torch.Tensor)  # noqa: E731
    g, w = TP.sorted_leaves(got), [np.asarray(a) for a in
                                   TP.sorted_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert is_t(a) and tuple(a.shape) == b.shape
        close(a, b)


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------

def ssd_inputs(case):
    Bs, S, G, Hg, P, N, _, init = SSD_CASES[case]
    rng = np.random.default_rng(30)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(u=f(Bs, S, G, Hg, P), a=-np.abs(f(Bs, S, G, Hg)) * 0.3,
                b=f(Bs, S, G, N), c=f(Bs, S, G, N),
                init=f(Bs, G, Hg, P, N) if init else None)


def layer_inputs(J):
    """Parameters and inputs of every layer case (numpy)."""
    mcfg = J.configs.get_config("zamba2-1.2b", True)
    xcfg = J.configs.get_config("xlstm-125m", True)
    rng = np.random.default_rng(31)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    d_in, H, conv_dim = J.ssm.mamba_dims(mcfg)
    _, XH, XP = J.xlstm._dims(xcfg)
    d = xcfg.d_model
    return dict(
        ssd={c: ssd_inputs(c) for c in SSD_CASES},
        dec=dict(u=f(2, 2, 3, 4), a=-np.abs(f(2, 2, 3)), b=f(2, 2, 5),
                 c=f(2, 2, 5), state=f(2, 2, 3, 4, 5)),
        mamba=dict(p=np_params(J, J.ssm.mamba_defs(mcfg), 32),
                   x=f(2, 7, mcfg.d_model), x1=f(2, 1, mcfg.d_model),
                   st={"ssd": f(2, 1, H, mcfg.ssm_head_dim, mcfg.ssm_state),
                       "conv": f(2, mcfg.ssm_conv - 1, conv_dim)}),
        mlstm=dict(p=np_params(J, J.xlstm.mlstm_defs(xcfg), 33),
                   x=f(2, 20, d), x1=f(2, 1, d),
                   st={"mlstm": f(2, XH, 1, XP + 1, XP) * 0.1}),
        slstm=dict(p=np_params(J, J.xlstm.slstm_defs(xcfg), 34),
                   x=f(2, 5, d), x1=f(2, 1, d),
                   st={"slstm": (f(2, d), f(2, d), np.abs(f(2, d)),
                                 f(2, d))}))


@pytest.fixture(scope="module")
def layer_refs(J):
    """Every layer case's JAX outputs, one program."""
    mcfg = J.configs.get_config("zamba2-1.2b", True)
    xcfg = J.configs.get_config("xlstm-125m", True)
    null = J.sharding.Planner.null()
    inp = layer_inputs(J)

    def ref(inp):
        out = {"ssd": {c: J.ssm.ssd_chunked(
            v["u"], v["a"], v["b"], v["c"], SSD_CASES[c][6],
            init_state=v["init"]) for c, v in inp["ssd"].items()}}
        dc = inp["dec"]
        out["dec"] = J.ssm.ssd_decode_step(dc["u"], dc["a"], dc["b"],
                                           dc["c"], dc["state"])
        for name, fwd, dec, cfg in (
                ("mamba", J.ssm.mamba_forward, J.ssm.mamba_decode_step, mcfg),
                ("mlstm", J.xlstm.mlstm_forward, J.xlstm.mlstm_decode_step,
                 xcfg),
                ("slstm", J.xlstm.slstm_forward, J.xlstm.slstm_decode_step,
                 xcfg)):
            v = inp[name]
            fresh = fwd(v["p"], v["x"], cfg, null)
            out[name] = dict(fresh=fresh,
                             stated=fwd(v["p"], v["x"], cfg, null, v["st"]),
                             dec=dec(v["p"], v["x1"], cfg, fresh[1]))
        return out

    jinp = J.jax.tree.map(J.jnp.asarray, inp)
    return inp, J.run_fast(J.jax.jit(ref), jinp)


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_matches_reference(layer_refs, case):
    inp, refs = layer_refs
    v = inp["ssd"][case]
    y, final = TS.ssd_chunked(t(v["u"]), t(v["a"]), t(v["b"]), t(v["c"]),
                              SSD_CASES[case][6],
                              None if v["init"] is None else t(v["init"]))
    want_y, want_final = refs["ssd"][case]
    assert y.shape == v["u"].shape and final.dtype == torch.float32
    close(y, want_y)
    close(final, want_final)


def test_ssd_chunked_equals_the_recurrence():
    """The chunked form against the token-by-token recurrence it
    computes, on the padded case (float32 sums in another order: 1e-4)."""
    v = ssd_inputs("padded_init")
    u, a, b, c, init = (t(v[k]) for k in ("u", "a", "b", "c", "init"))
    y, final = TS.ssd_chunked(u, a, b, c, 8, init)
    st, ys = init, []
    for s in range(u.shape[1]):
        yt, st = TS.ssd_decode_step(u[:, s], a[:, s], b[:, s], c[:, s], st)
        ys.append(yt)
    np.testing.assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(final.numpy(), st.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ssd_decode_step_matches_reference(layer_refs):
    inp, refs = layer_refs
    dc = inp["dec"]
    y, st = TS.ssd_decode_step(*(t(dc[k]) for k in
                                 ("u", "a", "b", "c", "state")))
    close(y, refs["dec"][0])
    close(st, refs["dec"][1])


LAYERS = {"mamba": (TS.mamba_forward, TS.mamba_decode_step, "zamba2-1.2b"),
          "mlstm": (TX.mlstm_forward, TX.mlstm_decode_step, "xlstm-125m"),
          "slstm": (TX.slstm_forward, TX.slstm_decode_step, "xlstm-125m")}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_forward_and_decode_match_reference(layer_refs, name):
    """From no state and from a given state, then one decode step after
    the stateless forward (its state carried over)."""
    inp, refs = layer_refs
    fwd, dec, arch = LAYERS[name]
    cfg = get_config(arch, True)
    v = inp[name]
    p = interop.params_from_numpy(v["p"], CPU)
    st = interop.params_from_numpy(v["st"], CPU)
    fresh = fwd(p, t(v["x"]), cfg, NULL)
    tree_close(fresh, refs[name]["fresh"])
    tree_close(fwd(p, t(v["x"]), cfg, NULL, st), refs[name]["stated"])
    tree_close(dec(p, t(v["x1"]), cfg, fresh[1]), refs[name]["dec"])


# ---------------------------------------------------------------------------
# The models: loss, prefill and decode, Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model_refs(J):
    """Per model: numpy parameters and tokens; the JAX loss, and the
    prefill and two decode steps over a float32 cache."""
    done = {}

    def get(arch):
        if arch in done:
            return done[arch]
        jmodel = J.lm.build_model(J.configs.get_config(arch, True))
        params = np_params(J, jmodel.defs, 41)
        tokens = np.random.default_rng(42).integers(
            0, 256, (B, PROMPT + 2), np.int32)
        jp = J.jax.tree.map(J.jnp.asarray, params)
        null = J.sharding.Planner.null()
        cache = J.params.zeros_of(jmodel.cache_defs(B, MAX_LEN),
                                  J.jnp.float32)

        def first(p, tk, c):
            return (jmodel.loss(p, {"tokens": tk}, null),
                    jmodel.decode_step(p, c, tk[:, :PROMPT], 0, null))

        loss, out = J.run_fast(J.jax.jit(first), jp, J.jnp.asarray(tokens),
                               cache)
        history = [out]
        step = J.fast(J.jax.jit(lambda p, c, tk, pos: jmodel.decode_step(
            p, c, tk, pos, null)))
        for lo, hi in STEPS[1:]:
            out = step(jp, out[1], J.jnp.asarray(tokens[:, lo:hi]),
                       J.jnp.asarray(lo, J.jnp.int32))
            history.append(out)
        done[arch] = dict(params=params, tokens=tokens, loss=np.asarray(loss),
                          steps=history)
        return done[arch]

    return get


@pytest.mark.parametrize("arch", MODELS)
def test_model_loss_matches_reference(model_refs, arch):
    ref = model_refs(arch)
    model = TLM.build_model(get_config(arch, True))
    params = interop.params_from_numpy(ref["params"], CPU)
    close(model.loss(params, {"tokens": t(ref["tokens"])}), ref["loss"])


@pytest.mark.parametrize("arch", MODELS)
def test_model_decode_step_matches_reference(model_refs, arch):
    """A 6-token prefill, then 2 decode steps, float32 weights and cache:
    the logits and every cached state (and KV) after each step."""
    ref = model_refs(arch)
    cfg = get_config(arch, True)
    model = TLM.build_model(cfg)
    params = interop.params_from_numpy(ref["params"], CPU)
    cache = TP.zeros_of(model.cache_defs(B, MAX_LEN), torch.float32,
                        device="cpu")
    tokens = t(ref["tokens"])
    for (lo, hi), (want, want_cache) in zip(STEPS, ref["steps"]):
        logits, cache = model.decode_step(params, cache, tokens[:, lo:hi], lo)
        assert logits.shape == (B, hi - lo, cfg.padded_vocab)
        close(logits, want)
        tree_close(cache, want_cache)


@pytest.mark.parametrize("arch", MODELS)
def test_generate_greedy_equals_jax_engine_token_for_token(J, model_refs,
                                                           arch, monkeypatch):
    """Float32 weights; the port's engine over its own (bfloat16) cache,
    whose recurrent states go float32 on the first step.  The JAX
    ``Engine`` cannot serve xlstm so (its sLSTM scan needs the cached h
    in the weights' dtype: ROADMAP C13), so its cache is float32 there:
    the cache starts at zeros, which are the same in either dtype."""
    if arch == "xlstm-125m":
        monkeypatch.setattr(J.engine, "zeros_of", lambda defs: (
            J.params.zeros_of(defs, J.jnp.float32)))
    ref = model_refs(arch)
    cfg, jcfg = get_config(arch, True), J.configs.get_config(arch, True)
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


def test_hybrid_cache_layout():
    """zamba2's full config: 6 super-blocks of 6 Mamba2 layers sharing
    one attention block (a KV cache each), a tail of 2."""
    model = TLM.build_model(get_config("zamba2-1.2b"))
    defs = model.cache_defs(1, 8)
    assert defs["attn"]["k"].shape[0] == 6
    assert defs["states"]["mamba"]["ssd"].shape[:2] == (6, 6)
    assert defs["states"]["tail"]["conv"].shape[0] == 2


# ---------------------------------------------------------------------------
# examples/serve_lm_torch.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m",
                                  "kimi-k2-1t-a32b"])
def test_serve_example_on_the_cpu(arch, capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_lm_torch", ROOT / "examples" / "serve_lm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
              "--prompt-len", "5", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert f"arch={get_config(arch, True).arch}: served batch=2" in out
    assert "serve example done" in out


# ---------------------------------------------------------------------------
# On the card (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MODELS)
def test_ssm_model_on_the_card_equals_plain(cuda, arch):
    """Each smoke model in bfloat16 on the card: a prefill and a decode
    step (zamba2's shared attention on the kernel, once a super-block a
    step; xlstm has none) against ``backend="ref"``, logits at 5e-2."""
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
    n_attn = cfg.n_layers // cfg.shared_attn_every if cfg.family == "hybrid" \
        else 0
    assert outs[0][2] == 2 * n_attn and outs[1][2] == 0
    for got, want in zip(outs[0][:2], outs[1][:2]):
        torch.testing.assert_close(got.float(), want.float(), rtol=5e-2,
                                   atol=5e-2)
