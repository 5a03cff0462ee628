"""The port's LM serving path against the JAX package, on the CPU.

The configs, the sharding planner's specs, the ParamDef trees, every
layer, the dense model's ``loss`` / ``decode_step`` and greedy
``Engine.generate`` are held to the JAX package's (``src/repro/
models``, ``configs``, ``serving``) at the smoke sizes: the same
parameters (numpy draws, carried into the port by
``interop.params_from_numpy``) and the same inputs, float32 at
``rtol = atol = 1e-5``; a bfloat16 KV cache exactly.  The JAX side is
imported inside the fixtures that need it, so that on a machine without
JAX the ``cuda`` cases at the end still run: there the model's attention
launches the CUDA ``flash_attention`` kernel and is held to the plain
version (``backend="ref"``) at bfloat16's 2e-2.
"""

import dataclasses
import inspect
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.distributed import mesh as tmesh  # noqa: E402
from repro_torch.distributed.sharding import (Planner,  # noqa: E402
                                              rules_for_config)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import config as TC  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.serving import Engine, ServeConfig  # noqa: E402

DENSE = ("qwen2-7b", "qwen2.5-3b", "granite-3-2b", "phi4-mini-3.8b")
BUILT = DENSE + ("grok-1-314b", "kimi-k2-1t-a32b", "xlstm-125m",
                 "zamba2-1.2b")
OTHER = tuple(a for a in ARCHS if a not in BUILT)
TOL = dict(rtol=1e-5, atol=1e-5)
NULL = Planner.null()
CPU = torch.device("cpu")


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
    """The JAX package's modules (imported here, not at the top, so the
    ``cuda`` cases run where JAX is absent)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import configs
    from repro.distributed import sharding
    from repro.models import config, layers, lm, params
    from repro.serving import engine

    from _torch_jax import run_fast
    return types.SimpleNamespace(jax=jax, jnp=jnp, configs=configs,
                                 sharding=sharding, config=config,
                                 layers=layers, lm=lm, params=params,
                                 engine=engine, run_fast=run_fast)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def flat(tree, is_leaf, prefix=()):
    """{path: leaf} of nested dicts and tuples."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in flat(sub, is_leaf, prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)) and not is_leaf(tree):
        return {p: v for i, sub in enumerate(tree)
                for p, v in flat(sub, is_leaf, prefix + (i,)).items()}
    return {prefix: tree}


def def_fields(d):
    return (tuple(d.shape), tuple(d.axes), d.init, d.scale, d.dtype)


def np_params(J, jdefs, seed):
    """float32 numpy draws for a JAX ParamDef tree: every leaf nonzero
    (norm scales near 1, biases small), so each term of a layer shows."""
    rng = np.random.default_rng(seed)

    def draw(d):
        x = rng.normal(size=d.shape).astype(np.float32)
        if d.init == "ones":
            return 1.0 + 0.1 * x
        if d.init == "zeros":
            return 0.1 * x
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        return x * np.float32(d.scale * fan_in ** -0.5)

    return J.jax.tree.map(draw, jdefs,
                          is_leaf=lambda x: isinstance(x, J.params.ParamDef))


def both(J, tree):
    """A numpy tree as JAX arrays and as the port's CPU tensors."""
    return (J.jax.tree.map(J.jnp.asarray, tree),
            interop.params_from_numpy(tree, CPU))


# ---------------------------------------------------------------------------
# Configs, planner, parameter trees
# ---------------------------------------------------------------------------

DERIVED = ("padded_vocab", "padded_heads", "q_dim", "kv_dim",
           "is_attention_free", "supports_long_context", "n_params_analytic",
           "n_active_params_analytic")


@pytest.mark.parametrize("arch", list(ARCHS))
def test_config_matches_reference(J, arch):
    for smoke in (False, True):
        got, want = get_config(arch, smoke), J.configs.get_config(arch, smoke)
        assert isinstance(got, TC.ModelConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for name in DERIVED:
            assert getattr(got, name) == getattr(want, name), name
        for shape in TC.SHAPES.values():
            assert shape.applicable(got) == \
                J.config.SHAPES[shape.name].applicable(want)
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J.config.SHAPES.items()}


SPEC_CASES = [
    (("vocab", "embed"), (152064, 3584)),
    (("embed", "q_features"), (3584, 4096)),
    (("embed", "kv_features"), (3584, 512)),
    (("layers", "batch", "seq", "kv_heads", None), (28, 8, 64, 4, 128)),
    (("batch", None, "act_heads", None), (6, 16, 12, 64)),
    (("batch", "seq"), (2, 32)),
    (("experts", "embed", "expert_ff"), (8, 64, 48)),
    ((None, "ff"), (3, 17)),
]


@pytest.mark.parametrize("fsdp", [False, True])
def test_planner_spec_matches_reference(J, fsdp):
    """The port's ``Planner.spec`` makes the reference's choices, as a
    tuple, on a stand-in mesh both planners can read."""
    cfg = get_config("grok-1-314b" if fsdp else "qwen2-7b")
    for names, sizes in ((("pod", "data", "model"), (2, 4, 16)),
                         (("data", "model"), (16, 16)),
                         (("data", "model"), (1, 1))):
        mesh = types.SimpleNamespace(
            axis_names=names, devices=types.SimpleNamespace(shape=sizes),
            shape=dict(zip(names, sizes)))
        got = Planner(mesh, rules_for_config(cfg))
        want = J.sharding.Planner(mesh, J.sharding.rules_for_config(cfg))
        for axes, shape in SPEC_CASES:
            assert got.spec(axes, shape) == tuple(want.spec(axes, shape))
    assert NULL.spec(("vocab", "embed"), (8, 8)) == () == \
        tuple(J.sharding.Planner.null().spec(("vocab", "embed"), (8, 8)))


def test_constrain_is_the_identity_on_one_device():
    x = torch.zeros(4, 8)
    assert NULL.constrain(x, ("batch", "act_vocab")) is x
    one = Planner(types.SimpleNamespace(shape={"data": 1, "model": 1}))
    assert one.constrain(x, ("batch", "act_vocab")) is x
    two = Planner(types.SimpleNamespace(shape={"data": 1, "model": 2}))
    with pytest.raises(NotImplementedError, match="A15f"):
        two.constrain(x, ("batch", "act_vocab"))


@pytest.mark.parametrize("arch", BUILT)
def test_param_defs_match_reference(J, arch):
    cfg = get_config(arch, smoke=True)
    model = TLM.build_model(cfg)
    jmodel = J.lm.build_model(J.configs.get_config(arch, smoke=True))
    is_t = lambda x: isinstance(x, TP.ParamDef)  # noqa: E731
    is_j = lambda x: isinstance(x, J.params.ParamDef)  # noqa: E731
    got, want = flat(model.defs, is_t), flat(jmodel.defs, is_j)
    assert {p: def_fields(d) for p, d in got.items()} == \
        {p: def_fields(d) for p, d in want.items()}
    got_c = flat(model.cache_defs(2, 16), is_t)
    want_c = flat(jmodel.cache_defs(2, 16), is_j)
    assert {p: def_fields(d) for p, d in got_c.items()} == \
        {p: def_fields(d) for p, d in want_c.items()}
    assert flat(model.axes(), lambda x: isinstance(x, tuple)) == \
        flat(jmodel.axes(), lambda x: isinstance(x, tuple))

    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for p, d in got.items():
        leaf = flat(params, lambda x: isinstance(x, torch.Tensor))[p]
        assert tuple(leaf.shape) == d.shape and leaf.dtype == torch.bfloat16
        if d.init == "ones":
            assert bool((leaf == 1).all())
    abstract = flat(model.abstract(torch.float32),
                    lambda x: isinstance(x, torch.Tensor))
    assert all(a.is_meta and a.dtype == torch.float32
               for a in abstract.values())
    assert TP.param_count(params) == \
        sum(int(np.prod(d.shape)) for d in want.values())


def test_init_draws_on_the_card_unless_told_and_scales_by_fan_in():
    defs = {"w": TP.ParamDef((512, 64), ("embed", "ff"), scale=2.0),
            "b": TP.ParamDef((64,), ("ff",), init="zeros", dtype="float32")}
    assert inspect.signature(TP.init_params).parameters["device"].default \
        is None and TP._device(None) == torch.device("cuda")
    p = TP.init_params(defs, torch.Generator().manual_seed(1), device="cpu")
    assert p["w"].dtype == torch.bfloat16 and p["b"].dtype == torch.float32
    assert abs(float(p["w"].float().std()) - 2.0 / 512 ** 0.5) < 0.01
    z = TP.zeros_of(defs, device="cpu")
    assert z["w"].dtype == torch.bfloat16 and not z["w"].any()


def test_bf16_tree_crosses_bit_for_bit(J):
    jmodel = J.lm.build_model(J.configs.get_config("qwen2-7b", smoke=True))
    jparams = J.jax.tree.map(lambda a: J.jnp.asarray(a, J.jnp.bfloat16),
                             np_params(J, jmodel.defs, 3))
    tree = J.jax.tree.map(np.asarray, jparams)
    port = interop.params_from_numpy(tree, CPU)
    back = interop.params_to_numpy(port)
    is_np = lambda x: isinstance(x, np.ndarray)  # noqa: E731
    a, b = flat(tree, is_np), flat(back, is_np)
    tensors = flat(port, lambda x: isinstance(x, torch.Tensor))
    assert a.keys() == b.keys() == tensors.keys()
    for p in a:
        assert a[p].dtype.name == b[p].dtype.name == "bfloat16"
        assert tensors[p].dtype == torch.bfloat16
        np.testing.assert_array_equal(a[p].view(np.uint16),
                                      b[p].view(np.uint16))
        np.testing.assert_array_equal(
            tensors[p].view(torch.int16).numpy().view(np.uint16),
            a[p].view(np.uint16))


@pytest.mark.parametrize("arch", OTHER)
def test_other_families_name_their_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="A15e"):
        TLM.build_model(get_config(arch, smoke=True))


# ---------------------------------------------------------------------------
# Layers, float32
# ---------------------------------------------------------------------------

def rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_apply_norm(J, norm):
    x, scale, bias = rng_arrays(1, (2, 5, 64), (64,), (64,))
    p = {"scale": 1 + 0.1 * scale}
    if norm == "ln":
        p["bias"] = bias
    jp, tp = both(J, p)
    want = J.run_fast(J.jax.jit(J.layers.apply_norm), jp, J.jnp.asarray(x))
    close(TL.apply_norm(tp, t(x)), want)


def test_rope_and_sinusoidal_positions(J):
    (x,) = rng_arrays(2, (2, 7, 3, 16))
    pos = np.array([[0, 1, 2, 3, 4, 5, 6], [9, 10, 11, 12, 13, 14, 15]],
                   np.int32)
    want = J.run_fast(J.jax.jit(lambda x, p: J.layers.rope(x, p, 1e6)),
                      J.jnp.asarray(x), J.jnp.asarray(pos))
    close(TL.rope(t(x), t(pos), 1e6), want)
    close(TL.sinusoidal_positions(24, 64),
          J.run_fast(J.jax.jit(lambda: J.layers.sinusoidal_positions(24, 64))))


@pytest.mark.parametrize("arch", ["qwen2-7b", "whisper-small"])
def test_mlp_forward(J, arch):
    """swiglu (qwen2-7b) and gelu with biases (whisper-small)."""
    cfg = get_config(arch, smoke=True)
    jcfg = J.configs.get_config(arch, smoke=True)
    p = np_params(J, J.layers.mlp_defs(jcfg), 4)
    (x,) = rng_arrays(5, (2, 6, cfg.d_model))
    jp, tp = both(J, p)
    f = J.jax.jit(lambda p, x: J.layers.mlp_forward(
        p, x, jcfg, J.sharding.Planner.null()))
    close(TL.mlp_forward(tp, t(x), cfg, NULL),
          J.run_fast(f, jp, J.jnp.asarray(x)))


@pytest.mark.parametrize("chunk", [0, 4])
def test_cross_entropy_and_lm_loss(J, chunk):
    """``lm_loss`` unchunked and chunked (10 positions in chunks of 4:
    padded), and ``cross_entropy`` with and without a mask."""
    h, head, mask = rng_arrays(6, (2, 10, 16), (16, 40), (2, 10))
    targets = np.random.default_rng(7).integers(0, 40, (2, 10), np.int32)
    mask = (mask > 0).astype(np.float32)
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              logit_chunk=chunk)
    jcfg = dataclasses.replace(J.configs.get_config("qwen2-7b", smoke=True),
                               logit_chunk=chunk)
    jnp = J.jnp
    f = J.jax.jit(lambda h, w, tg, m: J.layers.lm_loss(
        h, w, tg, m, jcfg, J.sharding.Planner.null()))
    close(TL.lm_loss(t(h), t(head), t(targets), t(mask), cfg, NULL),
          J.run_fast(f, *(jnp.asarray(a) for a in (h, head, targets, mask))))
    logits = h @ head
    ce = J.jax.jit(J.layers.cross_entropy)
    close(TL.cross_entropy(t(logits), t(targets), t(mask)),
          J.run_fast(ce, jnp.asarray(logits), jnp.asarray(targets),
                     jnp.asarray(mask)))
    close(TL.cross_entropy(t(logits), t(targets)),
          J.run_fast(ce, jnp.asarray(logits), jnp.asarray(targets)))


# (impl, Sq, Skv, causal, q_offset, kv_len): chunked at attn_chunk 8 with
# Sq = 20 runs the padding path; a cache tail masked by kv_len.
ATTN_CASES = [
    ("chunked", 20, 30, True, 3, 23),
    ("chunked", 20, 20, True, 0, None),
    ("naive", 20, 30, True, 3, 23),
    ("naive", 1, 30, True, 12, 13),
    ("chunked", 20, 30, False, 0, 25),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=[str(c) for c in ATTN_CASES])
def test_multihead_attention(J, case):
    impl, sq, skv, causal, q_offset, kv_len = case
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              attn_impl=impl, attn_chunk=8)
    jcfg = dataclasses.replace(J.configs.get_config("qwen2-7b", smoke=True),
                               attn_impl=impl, attn_chunk=8)
    q, k, v = rng_arrays(8, (2, sq, 4, 16), (2, skv, 2, 16), (2, skv, 2, 16))
    f = J.jax.jit(lambda q, k, v: J.layers.multihead_attention(
        q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, cfg=jcfg))
    got = TL.multihead_attention(t(q), t(k), t(v), causal=causal,
                                 q_offset=q_offset, kv_len=kv_len, cfg=cfg)
    close(got, J.run_fast(f, *(J.jnp.asarray(a) for a in (q, k, v))))


def test_attention_forward_writes_a_bf16_cache(J):
    """Self-attention over a bfloat16 cache at ``cache_pos`` 5, float32
    weights: the output equals the reference's (which attends over the
    rounded keys), and the cache is written in place, bit for bit."""
    arch = "qwen2-7b"
    cfg, jcfg = get_config(arch, True), J.configs.get_config(arch, True)
    p = np_params(J, J.layers.attention_defs(jcfg), 9)
    x, c = rng_arrays(10, (2, 3, cfg.d_model), (2, 12, 2, 16))
    cache = {"k": c, "v": -c}
    positions = np.broadcast_to(5 + np.arange(3, dtype=np.int32), (2, 3))
    jp, tp = both(J, p)
    jcache = {n: J.jnp.asarray(a, J.jnp.bfloat16) for n, a in cache.items()}
    tcache = {n: t(a).to(torch.bfloat16) for n, a in cache.items()}
    f = J.jax.jit(lambda p, x, c, pos: J.layers.attention_forward(
        p, x, cfg=jcfg, planner=J.sharding.Planner.null(), positions=pos,
        cache=c, cache_pos=5))
    want, want_cache = J.run_fast(f, jp, J.jnp.asarray(x), jcache,
                                  J.jnp.asarray(positions))
    got, got_cache = TL.attention_forward(
        tp, t(x), cfg=cfg, planner=NULL, positions=t(positions),
        cache=tcache, cache_pos=5)
    close(got, want)
    assert got_cache is tcache
    for n in ("k", "v"):
        np.testing.assert_array_equal(
            got_cache[n].float().numpy(),
            np.asarray(want_cache[n].astype(J.jnp.float32)))


def test_attention_forward_cross_attention(J):
    """Cross-attention (whisper-smoke's widths): prefill over encoder
    states makes a fresh bf16 cross cache, decode reuses it."""
    arch = "whisper-small"
    cfg, jcfg = get_config(arch, True), J.configs.get_config(arch, True)
    p = np_params(J, J.layers.attention_defs(jcfg, cross=True), 15)
    x, x1, enc = rng_arrays(16, (2, 3, cfg.d_model), (2, 1, cfg.d_model),
                            (2, 7, cfg.d_model))
    pos = np.zeros((2, 3), np.int32)
    jp, tp = both(J, p)
    null = J.sharding.Planner.null()

    def jax_both(p, x, x1, enc, pos):
        out, cache = J.layers.attention_forward(
            p, x, cfg=jcfg, planner=null, positions=pos, causal=False,
            is_cross=True, kv_src=enc)
        out1, _ = J.layers.attention_forward(
            p, x1, cfg=jcfg, planner=null, positions=pos[:, :1],
            causal=False, is_cross=True, cache=cache)
        return out, cache, out1

    want, want_cache, want1 = J.run_fast(
        J.jax.jit(jax_both), jp, *(J.jnp.asarray(a) for a in (x, x1, enc)),
        J.jnp.asarray(pos))
    got, cache = TL.attention_forward(tp, t(x), cfg=cfg, planner=NULL,
                                      positions=t(pos), causal=False,
                                      is_cross=True, kv_src=t(enc))
    got1, same = TL.attention_forward(tp, t(x1), cfg=cfg, planner=NULL,
                                      positions=t(pos[:, :1]), causal=False,
                                      is_cross=True, cache=cache)
    close(got, want)
    close(got1, want1)
    assert same is cache
    for n in ("k", "v"):
        assert cache[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            cache[n].float().numpy(),
            np.asarray(want_cache[n].astype(J.jnp.float32)))


def test_kernel_path_refuses_a_misaligned_causal_call():
    """The kernel aligns the diagonal to the end of the keys: a causal
    call whose queries are not the last keys raises before any launch
    (here on CPU tensors, with the kernel asked for by name)."""
    cfg = get_config("qwen2-7b", smoke=True)
    q, k = torch.zeros(1, 4, 4, 16), torch.zeros(1, 12, 2, 16)
    for q_offset, kv_len in ((3, 8), (0, None), (5, 8)):
        with pytest.raises(ValueError, match="aligns the causal diagonal"):
            TL.multihead_attention(q, k, k, causal=True, q_offset=q_offset,
                                   kv_len=kv_len, cfg=cfg, backend="kernel")


# ---------------------------------------------------------------------------
# The dense model: loss and decode_step
# ---------------------------------------------------------------------------

MODELS = {"qwen2-7b": ("qwen2-7b", {}),            # qkv bias
          "granite-3-2b": ("granite-3-2b", {}),    # none
          "padded": ("qwen2-7b", dict(n_heads=20, n_kv_heads=4))}
B, PROMPT, MAX_LEN = 2, 6, 16


def model_pair(J, name):
    arch, changes = MODELS[name]
    cfg = dataclasses.replace(get_config(arch, True), **changes)
    jcfg = dataclasses.replace(J.configs.get_config(arch, True), **changes)
    return cfg, jcfg


STEPS = ((0, PROMPT), (PROMPT, PROMPT + 1), (PROMPT + 1, PROMPT + 2))
CACHE_DTYPES = {"float32": (torch.float32, "float32"),
                "bfloat16": (torch.bfloat16, "bfloat16")}


@pytest.fixture(scope="module")
def model_refs(J):
    """Per model: the numpy parameters, tokens, and the JAX model's loss,
    and its prefill and two decode steps over a cache of each dtype
    (logits, the cache after each as float32)."""
    done = {}

    def get(name):
        if name in done:
            return done[name]
        cfg, jcfg = model_pair(J, name)
        jmodel = J.lm.build_model(jcfg)
        params = np_params(J, jmodel.defs, 11)
        rng = np.random.default_rng(12)
        tokens = rng.integers(0, cfg.vocab_size, (B, PROMPT + 2), np.int32)
        jp = J.jax.tree.map(J.jnp.asarray, params)
        null = J.sharding.Planner.null()

        # Two programs (compiles are the cost): the loss and both
        # prefills, then one decode step over both caches.
        def first(p, tk, caches):
            return (jmodel.loss(p, {"tokens": tk}, null),
                    [jmodel.decode_step(p, c, tk[:, :PROMPT], 0, null)
                     for c in caches])

        def after(p, caches, tk, pos):
            return [jmodel.decode_step(p, c, tk, pos, null) for c in caches]

        caches = [J.params.zeros_of(jmodel.cache_defs(B, MAX_LEN),
                                    getattr(J.jnp, jdt))
                  for _, jdt in CACHE_DTYPES.values()]
        loss, outs = J.run_fast(J.jax.jit(first), jp, J.jnp.asarray(tokens),
                                caches)
        history = [outs]
        step = J.jax.jit(after)
        for lo, hi in STEPS[1:]:
            outs = J.run_fast(step, jp, [c for _, c in outs],
                              J.jnp.asarray(tokens[:, lo:hi]),
                              J.jnp.asarray(lo, J.jnp.int32))
            history.append(outs)
        steps = {key: [(np.asarray(outs[i][0]),
                        {n: np.asarray(c.astype(J.jnp.float32))
                         for n, c in outs[i][1].items()})
                       for outs in history]
                 for i, key in enumerate(CACHE_DTYPES)}
        done[name] = dict(params=params, tokens=tokens,
                          loss=np.asarray(loss), steps=steps)
        return done[name]

    return get


@pytest.mark.parametrize("name", list(MODELS))
def test_model_loss_matches_reference(J, model_refs, name):
    ref = model_refs(name)
    cfg, _ = model_pair(J, name)
    model = TLM.build_model(cfg)
    params = interop.params_from_numpy(ref["params"], CPU)
    got = model.loss(params, {"tokens": t(ref["tokens"])})
    close(got, ref["loss"])


@pytest.mark.parametrize("cache_dtype", list(CACHE_DTYPES))
@pytest.mark.parametrize("name", list(MODELS))
def test_model_decode_step_matches_reference(J, model_refs, name,
                                             cache_dtype):
    """A 6-token prefill, then 2 decode steps, float32 weights.

    With a float32 cache both packages run the same arithmetic: logits
    and cache at 1e-5 after every step.  With the bfloat16 cache (the
    default, ``zeros_of``), each package rounds its own float32 keys:
    XLA's and torch's float32 ``sin`` / ``cos`` differ by one float32
    ulp on a few percent of RoPE's angles, and a key that lands on a
    bfloat16 rounding boundary then rounds the other way (ROADMAP C8).
    So there at most 1 % of the cached values differ, each by at most
    one bfloat16 ulp (relative 2^-7) beyond float32's 1e-5; the logits,
    which attend over those keys, are held at 1e-5 in the float32
    case."""
    ref = model_refs(name)
    cfg, _ = model_pair(J, name)
    if name == "padded":
        assert cfg.padded_heads == 32 and cfg.n_heads == 20
    dtype = CACHE_DTYPES[cache_dtype][0]
    model = TLM.build_model(cfg)
    params = interop.params_from_numpy(ref["params"], CPU)
    cache = TP.zeros_of(model.cache_defs(B, MAX_LEN), dtype, device="cpu")
    tokens = t(ref["tokens"])
    for (lo, hi), (want, want_cache) in zip(STEPS, ref["steps"][cache_dtype]):
        logits, cache = model.decode_step(params, cache, tokens[:, lo:hi], lo)
        assert logits.shape == (B, hi - lo, cfg.padded_vocab)
        for n in ("k", "v"):
            assert cache[n].dtype == dtype
            got = cache[n].float().numpy()
            if dtype == torch.float32:
                np.testing.assert_allclose(got, want_cache[n], **TOL)
                continue
            assert (got != want_cache[n]).mean() <= 0.01
            np.testing.assert_allclose(got, want_cache[n], rtol=2 ** -7,
                                       atol=TOL["atol"])
        if dtype == torch.float32:
            close(logits, want)
        else:
            assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines(J, model_refs):
    """The port's and the JAX package's engines on qwen2-7b-smoke, float32
    weights, ``max_len`` 16."""
    ref = model_refs("qwen2-7b")
    cfg, jcfg = model_pair(J, "qwen2-7b")
    params = ref["params"]
    port = Engine(TLM.build_model(cfg),
                  interop.params_from_numpy(params, CPU), ServeConfig(16))
    jax_eng = J.engine.Engine(J.lm.build_model(jcfg),
                              J.jax.tree.map(J.jnp.asarray, params),
                              J.engine.ServeConfig(max_len=16))
    jitted = jax_eng._step
    jax_eng._step = lambda *args: J.run_fast(jitted, *args)
    return port, jax_eng


def test_generate_greedy_equals_jax_engine_token_for_token(engines):
    port, jax_eng = engines
    prompts = np.random.default_rng(13).integers(0, 256, (2, 4), np.int32)
    got, stats = port.generate(prompts, 8)
    want, want_stats = jax_eng.generate(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats == want_stats


def test_generate_n_new_zero_returns_empty(engines):
    out, stats = engines[0].generate(np.ones((2, 4), np.int32), 0)
    assert out.shape == (2, 0) and out.dtype == np.int32
    assert stats["generated"] == 0.0 and stats["prompt_len"] == 4.0


def test_generate_negative_n_new_rejected(engines):
    with pytest.raises(ValueError, match="n_new"):
        engines[0].generate(np.ones((1, 4), np.int32), -1)


def test_generate_kv_cache_bound_enforced(engines):
    with pytest.raises(ValueError, match="max_len"):
        engines[0].generate(np.ones((1, 10), np.int32), 7)   # 10 + 7 > 16
    out, _ = engines[0].generate(np.ones((1, 14), np.int32), 2)  # == max_len
    assert out.shape == (1, 2)


def test_generate_temperature_is_seeded(engines):
    """Sampling at temperature 0.7 draws from a torch.Generator seeded by
    ``ServeConfig.seed``: one seed gives the same tokens twice, two seeds
    differ.  (Not the JAX package's ``categorical`` stream: ROADMAP C7.)"""
    port = engines[0]
    prompts = np.random.default_rng(14).integers(0, 256, (2, 4), np.int32)

    def sample(seed):
        eng = Engine(port.model, port.params,
                     ServeConfig(max_len=16, temperature=0.7, seed=seed))
        out, _ = eng.generate(prompts, 8)
        assert out.shape == (2, 8) and ((0 <= out) & (out < 256)).all()
        return out

    np.testing.assert_array_equal(sample(1), sample(1))
    assert (sample(1) != sample(2)).any()


# ---------------------------------------------------------------------------
# The mesh chooses the card
# ---------------------------------------------------------------------------

def test_mesh_refuses_the_cpu_unless_asked(monkeypatch):
    monkeypatch.setattr(tmesh, "_DEVICE", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.current_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.single_device_mesh()
    for fn in (tmesh.spawn, tmesh.start):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ---------------------------------------------------------------------------
# On the card: the model's attention launches the kernel (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("head_dim,prompt", [(16, 6), (128, 64)])
def test_model_attention_launches_the_kernel_and_equals_plain(
        cuda, monkeypatch, head_dim, prompt):
    """qwen2-7b-smoke in bfloat16 on the card (head dim 16: "wgmma"
    prefill, the width-64 instance reading zeros past 16, and "split"
    decode; 128 with a 64-token prompt: "wgmma" prefill): every
    attention call of a prefill and a decode step launches
    ``flash_attention`` once and equals the plain version on the same
    inputs at rtol = atol = 2e-2 (the kernel tests' bf16 tolerance)."""
    cfg = dataclasses.replace(get_config("qwen2-7b", smoke=True),
                              head_dim=head_dim)
    model = TLM.build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        device=cuda)
    errs = []
    kernel_attention = TL.multihead_attention

    def hooked(q, k, v, **kw):
        got = kernel_attention(q, k, v, **kw)
        want = kernel_attention(q, k, v, **dict(kw, backend="ref"))
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        errs.append(float((got.float() - want.float()).abs().max()))
        return got

    monkeypatch.setattr(TL, "multihead_attention", hooked)
    cache = TP.zeros_of(model.cache_defs(2, prompt + 4), device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, prompt + 1), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    ops.reset_launches()
    logits, cache = model.decode_step(params, cache, tokens[:, :prompt], 0)
    logits2, cache = model.decode_step(params, cache, tokens[:, prompt:],
                                       prompt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == 2 * cfg.n_layers
    assert len(errs) == 2 * cfg.n_layers
    assert bool(torch.isfinite(logits).all() and torch.isfinite(logits2).all())


@pytest.mark.cuda
def test_misaligned_causal_call_raises_on_the_card(cuda):
    cfg = get_config("qwen2-7b", smoke=True)
    q = torch.zeros(1, 4, 4, 16, device=cuda, dtype=torch.bfloat16)
    k = torch.zeros(1, 12, 2, 16, device=cuda, dtype=torch.bfloat16)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="aligns the causal diagonal"):
        TL.multihead_attention(q, k, k, causal=True, q_offset=3, kv_len=8,
                               cfg=cfg)
    assert ops.LAUNCHES["flash_attention"] == before
    out = TL.multihead_attention(q, k, k, causal=True, q_offset=4, kv_len=8,
                                 cfg=cfg)
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert out.shape == q.shape
