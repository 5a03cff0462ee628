"""The port's LM training path against the JAX package, on the CPU.

Each training module of ``src/repro_torch`` is held to its JAX
counterpart on the same numpy inputs: the optimizers (AdamW and
Adafactor over three updates on a tree with a stacked (4, 8, 16) leaf,
whose Adafactor RMS clip is per layer slice), ``clip_by_global_norm``,
both schedules, the int8 codes and error-feedback residuals of
``distributed/compression.py``, the token pipeline bit for bit,
``compute_grads`` at float32 on the qwen2.5-3b and granite-3-2b smoke
configs (microbatch 1 and 2; remat off, on and "dots": the JAX
reference is the microbatch-2 ``compute_grads`` of each config, since
``jax.checkpoint`` changes what is saved and not the function, and
equal microbatches do not change it either), three ``make_train_step`` steps with and
without gradient compression, and six ``Trainer`` steps.  The JAX
references compile with ``_torch_jax.XLA_FAST``; the two train steps
are the JAX ``Trainer``'s own ``step_fn``, compiled once and shared.
Tolerances: losses rtol 1e-5; gradients and parameters rtol 1e-4, atol
1e-6 (float32 sums in another order); integer codes, token batches and
checkpoint bits exactly.

Then the mirrors of ``tests/test_fault_tolerance.py`` on the port
(checkpoint store, data determinism, a killed run resuming bitwise, the
loss falling), checkpoints crossing between the packages both ways bit
for bit (bfloat16 leaves and an ``OptState`` included), and the plain
attention gradient ``ref.attention_backward`` against ``jax.vjp`` of the
JAX package's ``ref.attention``.  The JAX side is imported in a
fixture, so that the ``cuda`` cases at the end run where JAX is absent:
there the backward kernel is held to its plain version and the model's
gradient on the card to the plain-attention model's.
"""

import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore, save)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import tokens as TT  # noqa: E402
from repro_torch.distributed import compression as TCMP  # noqa: E402
from repro_torch.distributed.sharding import Planner  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import lm as TLM  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import (OptState, apply_updates,  # noqa: E402
                               clip_by_global_norm, cosine_with_warmup,
                               linear_warmup, make_optimizer,
                               state_logical_axes)
from repro_torch.train import (TrainConfig, Trainer,  # noqa: E402
                               compute_grads, make_train_step)

CPU = torch.device("cpu")
NULL = Planner.null()
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=0)


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
    from repro import checkpoint, optim
    from repro.configs import get_config as jax_config
    from repro.data import tokens
    from repro.distributed import compression
    from repro.distributed.sharding import Planner as JPlanner
    from repro.kernels import ref as jref
    from repro.models import lm, params
    from repro.optim import optimizers
    from repro.train import loop

    from _torch_jax import XLA_FAST, run_fast
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, checkpoint=checkpoint, optim=optim,
        optimizers=optimizers, config=jax_config, tokens=tokens,
        compression=compression, planner=JPlanner.null(), ref=jref, lm=lm,
        params=params, loop=loop, XLA_FAST=XLA_FAST, run_fast=run_fast)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def close(got, want, **tol):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got, np.float32),
        np.asarray(want, np.float32), **(tol or GRAD_TOL))


def flat(tree, prefix=()):
    """{path: leaf} of nested dicts, tuples and named tuples."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in flat(sub, prefix + (k,)).items()}
    if isinstance(tree, (tuple, list)):
        return {p: v for i, sub in enumerate(tree)
                for p, v in flat(sub, prefix + (i,)).items()}
    return {prefix: tree}


def close_trees(got, want, **tol):
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    for path in w:
        close(g[path], w[path], err_msg=str(path), **(tol or GRAD_TOL))


def close_but_flipped_codes(got, want, flip, **tol):
    """:func:`close_trees` under int8 gradient compression: an element
    whose gradient sits at a rounding boundary of its block's int8 code
    (a difference of 1e-7 between the packages' float32 gradients) may
    round to the neighbouring code in one package.  Such an element may
    differ by up to ``flip`` (one code step carried through, at most the
    gradient norm / 127), and at most one element in 1,000 may."""
    g, w = flat(got), flat(want)
    assert set(g) == set(w)
    n_out = n_all = 0
    for path in w:
        a = g[path].detach().float().numpy()
        b = np.asarray(w[path], np.float32)
        out = ~np.isclose(a, b, **tol)
        assert np.all(np.abs(a - b)[out] <= flip), path
        n_out, n_all = n_out + int(out.sum()), n_all + a.size
    assert n_out <= n_all // 1000, (n_out, n_all)


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


def jnp_tree(J, tree):
    return J.jax.tree.map(J.jnp.asarray, tree)


def port_tree(tree):
    """The port's CPU tensors for a numpy tree, copies: the optimizers
    update in place, and ``params_from_numpy`` shares a CPU tensor's
    memory with its array."""
    return tree_map(torch.clone, interop.params_from_numpy(tree, CPU))


def jax_opt_state(J, state: OptState):
    """A port OptState as the JAX package's."""
    np_state = interop.opt_state_to_numpy(state)
    return J.optimizers.OptState(J.jnp.asarray(np_state.step),
                                 jnp_tree(J, np_state.inner))


# ---------------------------------------------------------------------------
# Optimizers, clipping, schedules
# ---------------------------------------------------------------------------

def opt_tree(seed):
    """A stacked (4, 8, 16) leaf (streamed slice by slice), a 2-D, a 1-D
    and a (2, 1, 5) leaf (streamed, not factored)."""
    rng = np.random.default_rng(seed)
    shapes = {"stack": (4, 8, 16), "w": (8, 16), "b": (16,),
              "odd": (2, 1, 5)}
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_reference(J, name):
    """Three updates from the same parameters, gradients and schedule:
    the parameters, every state leaf and the step equal the JAX
    package's after each."""
    params = opt_tree(0)
    grads = [opt_tree(s) for s in (1, 2, 3)]
    for g in grads:                       # a slice with a large gradient
        g["stack"][2] *= 30.0             # clips harder (Adafactor)
    j_init, j_update, _ = J.optim.make_optimizer(
        name, J.optim.cosine_with_warmup(1e-2, 2, 10))
    t_init, t_update, _ = make_optimizer(
        name, cosine_with_warmup(1e-2, 2, 10))
    j_update = J.jax.jit(j_update)
    jp = jnp_tree(J, params)
    js = j_init(jp)
    tp = port_tree(params)
    ts = t_init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    close_trees(ts.inner, js.inner)
    for g in grads:
        jp, js = J.run_fast(j_update, jnp_tree(J, g), js, jp)
        tp, ts = t_update(port_tree(g), ts, tp)
        assert int(ts.step) == int(js.step)
        close_trees(tp, jp, rtol=1e-5, atol=1e-7)
        close_trees(ts.inner, js.inner, rtol=1e-5, atol=1e-12)


def test_optimizer_updates_in_place_and_constant_lr():
    """``update`` writes the parameters and moments it is given; a
    constant rate is the schedule that returns it at every step."""
    params, g = port_tree(opt_tree(4)), port_tree(opt_tree(5))
    const = lambda step: torch.full((), 1e-3, dtype=torch.float32)
    for name in ("adamw", "adafactor"):
        outs = []
        for lr in (1e-3, const):
            init, update, _ = make_optimizer(name, lr)
            tp = tree_map(torch.clone, params)
            ts = init(tp)
            new_p, new_s = update(g, ts, tp)
            assert all(a is b for a, b in zip(tree_leaves(new_p),
                                               tree_leaves(tp)))
            assert all(a is b for a, b in zip(tree_leaves(new_s.inner),
                                               tree_leaves(ts.inner)))
            assert int(new_s.step) == 1 and int(ts.step) == 0
            outs.append(new_p)
        close_trees(outs[0], outs[1], rtol=0, atol=0)


def test_apply_updates_and_state_axes(J):
    params, upd = opt_tree(6), opt_tree(7)
    close_trees(apply_updates(port_tree(params), port_tree(upd)),
                J.optim.apply_updates(jnp_tree(J, params),
                                      jnp_tree(J, upd)), rtol=0, atol=0)
    for arch in ("granite-3-2b", "qwen2.5-3b"):
        tdefs = TLM.build_model(get_config(arch, smoke=True)).defs
        jdefs = J.lm.build_model(J.config(arch, smoke=True)).defs
        for name in ("adamw", "adafactor"):
            assert state_logical_axes(name, tdefs) == \
                J.optimizers.state_logical_axes(name, jdefs)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd", 1e-3)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(J, max_norm):
    grads = opt_tree(8)
    got, gn = clip_by_global_norm(port_tree(grads), max_norm)
    want, jgn = J.run_fast(J.jax.jit(
        lambda g: J.optim.clip_by_global_norm(g, max_norm)),
        jnp_tree(J, grads))
    close(gn, jgn, rtol=1e-6)
    close_trees(got, want, rtol=1e-6, atol=0)
    mine = port_tree(grads)
    same, _ = clip_by_global_norm(mine, max_norm, inplace=True)
    assert same is mine
    close_trees(mine, got, rtol=0, atol=0)


def test_schedules_match_reference(J):
    """Both schedules at steps 0..13, to an ulp of the float32 cosine
    (XLA's and torch's cos may differ by one, as their sin do: C8)."""
    steps = np.arange(0, 14, dtype=np.int32)
    for peak, port, jax_fn in (
            (3e-4, linear_warmup(3e-4, 4), J.optim.linear_warmup(3e-4, 4)),
            (3e-4, cosine_with_warmup(3e-4, 2, 8),
             J.optim.cosine_with_warmup(3e-4, 2, 8)),
            (1.0, cosine_with_warmup(1.0, 0, 10, floor=0.0),
             J.optim.cosine_with_warmup(1.0, 0, 10, floor=0.0))):
        got = port(torch.as_tensor(steps))
        assert got.dtype == torch.float32
        close(got, J.run_fast(J.jax.jit(jax_fn), J.jnp.asarray(steps)),
              rtol=1e-6, atol=1.2e-7 * peak)


# ---------------------------------------------------------------------------
# Gradient compression, the token pipeline
# ---------------------------------------------------------------------------

def test_quantize_codes_exact(J):
    """int8 codes equal, ties included (both round half to even); scales
    and dequantized values to float32 rounding."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(3, 300)).astype(np.float32)
    x[0, :256] = np.arange(-127.5, 128.5, 1.0)[:256]   # scale 1: ties
    x[0, 0] = 127.0
    q, scale, pad = TCMP.quantize(t(x))
    jpad = -x.size % TCMP.BLOCK

    def round_trip(x):
        jq, jscale, _ = J.compression.quantize(x)
        return jq, jscale, J.compression.dequantize(jq, jscale, jpad,
                                                    x.shape, J.jnp.float32)

    jq, jscale, jdeq = J.run_fast(J.jax.jit(round_trip), J.jnp.asarray(x))
    assert pad == jpad and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    close(scale, jscale, rtol=1e-7, atol=0)
    np.testing.assert_array_equal(
        TCMP.dequantize(q, scale, pad, x.shape, torch.float32).numpy(),
        np.asarray(jdeq))
    assert TCMP.compression_ratio() == J.compression.compression_ratio()


def test_ef_compress_residuals_match_reference(J):
    grads = [opt_tree(s) for s in (10, 11)]
    tres = TCMP.ef_init(port_tree(grads[0]))
    jres = J.compression.ef_init(jnp_tree(J, grads[0]))
    jit_compress = J.jax.jit(J.compression.ef_compress)
    for g in grads:                       # the residual carries over
        tg, tres = TCMP.ef_compress(port_tree(g), tres)
        jg, jres = J.run_fast(jit_compress, jnp_tree(J, g), jres)
        close_trees(tg, jg, rtol=1e-6, atol=1e-7)
        close_trees(tres, jres, rtol=1e-5, atol=1e-7)


def test_token_batches_bitwise(J):
    for cfg_kw in (dict(vocab_size=100, seq_len=8, global_batch=4, seed=1),
                   dict(vocab_size=49155, seq_len=33, global_batch=8)):
        cfg, jcfg = TT.DataConfig(**cfg_kw), J.tokens.DataConfig(**cfg_kw)
        for step, shard, n in ((0, 0, 1), (5, 1, 2), (9, 3, 4)):
            got = TT.shard_batch(cfg, step, shard, n)["tokens"]
            want = J.tokens.shard_batch(jcfg, step, shard, n)["tokens"]
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            TT.global_batch(cfg, 3)["tokens"],
            J.tokens.global_batch(jcfg, 3)["tokens"])
    pf = TT.Prefetcher(cfg, start_step=2)
    try:
        for step in (2, 3):
            s, batch = pf.next()
            assert s == step
            np.testing.assert_array_equal(
                batch["tokens"], J.tokens.shard_batch(jcfg, step, 0, 1)
                ["tokens"])
    finally:
        pf.close()


# ---------------------------------------------------------------------------
# compute_grads, the train step and the Trainer against the JAX package
# ---------------------------------------------------------------------------

ARCHS = ("qwen2.5-3b", "granite-3-2b")


def smoke(arch, **kw):
    return dataclasses.replace(get_config(arch, smoke=True), **kw)


@pytest.fixture(scope="module")
def grad_refs(J):
    """Per arch: float32 numpy parameters, a (4, 16) token batch, and the
    JAX ``compute_grads`` at microbatch 2, both archs in one program.
    It is the reference at microbatch 1 too: the loss is a mean over
    tokens and the halves hold as many each, so the two are one function
    of the batch (and the JAX microbatch-1 path runs in the train-step
    and Trainer tests below)."""
    models, params, tokens = {}, {}, {}
    for i, arch in enumerate(ARCHS):
        models[arch] = J.lm.build_model(J.config(arch, smoke=True))
        params[arch] = np_params(J, models[arch].defs, 20 + i)
        tokens[arch] = np.random.default_rng(30 + i).integers(
            0, models[arch].cfg.vocab_size, (4, 16), dtype=np.int32)

    def grads(p, b):
        return {arch: J.loop.compute_grads(
            models[arch], J.planner, p[arch], {"tokens": b[arch]}, 2)
            for arch in ARCHS}

    got = J.run_fast(J.jax.jit(grads), jnp_tree(J, params),
                     jnp_tree(J, tokens))
    return {arch: (params[arch], tokens[arch], got[arch]) for arch in ARCHS}


@pytest.mark.parametrize("remat", [False, True, "dots"])
@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_compute_grads_matches_jax(grad_refs, arch, microbatch, remat):
    params, tokens, (jloss, jgrads) = grad_refs[arch]
    cfg = smoke(arch, remat=bool(remat), microbatch=microbatch,
                remat_policy="dots" if remat == "dots" else "nothing")
    tp = port_tree(params)
    loss, grads = compute_grads(TLM.build_model(cfg), NULL, tp,
                                {"tokens": t(tokens)}, microbatch)
    assert loss.dtype == torch.float32 and loss.grad_fn is None
    close(loss, jloss, **LOSS_TOL)
    close_trees(grads, jgrads)
    for g in tree_leaves(grads):
        assert g.dtype == torch.float32 and not g.requires_grad
    assert not any(p.requires_grad for p in tree_leaves(tp))


def test_chunked_loss_is_differentiable_end_to_end():
    """``lm_loss``'s chunked branch (``logit_chunk``) gives the unchunked
    loss's value and gradient: the same function, computed a chunk of
    positions at a time (float32, rtol = atol = 1e-6)."""
    tokens = {"tokens": torch.randint(0, 256, (2, 16),
                                      generator=torch.Generator().manual_seed(2))}
    out = []
    for chunk in (0, 5):
        model = TLM.build_model(smoke("granite-3-2b", logit_chunk=chunk))
        params = model.init(torch.Generator().manual_seed(0),
                            dtype=torch.float32, device=CPU)
        out.append(compute_grads(model, NULL, params, tokens, 1))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-6, atol=1e-6)
    for a, b in zip(tree_leaves(out[1][1]), tree_leaves(out[0][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_compute_grads_accumulates_in_grad_acc_dtype():
    """bfloat16 parameters: one microbatch gives bfloat16 gradients (the
    reference's ``value_and_grad``), two accumulate in float32."""
    cfg = smoke("granite-3-2b", microbatch=2)
    model = TLM.build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 8),
                                     generator=torch.Generator().manual_seed(1))}
    _, g1 = compute_grads(model, NULL, params, batch, 1)
    _, g2 = compute_grads(model, NULL, params, batch, 2)
    assert {g.dtype for g in tree_leaves(g1)} == {torch.bfloat16}
    assert {g.dtype for g in tree_leaves(g2)} == {torch.float32}


TRAIN = dict(steps=6, lr=1e-3, warmup=2, checkpoint_every=4)
#: AdamW's eps in the train-step and Trainer comparisons, both packages.
#: At the default 1e-8 an element whose gradient is float32 noise (~1e-8,
#: e.g. some of ``bk``'s) takes an update of any size up to the learning
#: rate, differently in each package: 1.8e-4 apart after three steps.
#: At 1e-3 the update of a small gradient is linear in it.
EPS = 1e-3


def eps_optimizer(make):
    """``make_optimizer`` with :data:`EPS` (a loop module's, patched)."""
    return lambda name, lr, **kw: make(name, lr, eps=EPS, **kw)


@pytest.fixture(scope="module")
def jax_train(J, tmp_path_factory):
    """qwen2.5-3b's smoke model at float32 and the JAX ``Trainer``'s own
    ``step_fn`` (``jax.jit(make_train_step(...))``, AdamW at
    :data:`EPS`), with and without gradient compression, each compiled
    once with ``XLA_FAST``."""
    jmodel = J.lm.build_model(J.config("qwen2.5-3b", smoke=True))
    params = np_params(J, jmodel.defs, 40)
    data_cfg = dict(vocab_size=jmodel.cfg.vocab_size, seq_len=16,
                    global_batch=4, seed=7)
    jdata = J.tokens.DataConfig(**data_cfg)
    steps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(J.loop, "make_optimizer",
                   eps_optimizer(J.optim.make_optimizer))
        trainers = {comp: J.loop.Trainer(jmodel, jdata, J.loop.TrainConfig(
            **TRAIN, grad_compression=comp, log_every=100,
            checkpoint_dir=str(tmp_path_factory.mktemp("jax_compile"))))
            for comp in (False, True)}
    for comp, tr in trainers.items():
        jp = jnp_tree(J, params)
        ef = (J.compression.ef_init(jp) if comp else
              J.jax.tree.map(lambda p: J.jnp.zeros((1,), J.jnp.float32), jp))
        batch = {"tokens": J.jnp.asarray(
            J.tokens.shard_batch(jdata, 0, 0, 1)["tokens"])}
        steps[comp] = tr.step_fn.lower(jp, tr.opt_init(jp), batch, ef
                                       ).compile(compiler_options=J.XLA_FAST)
    return types.SimpleNamespace(jmodel=jmodel, params=params,
                                 data_cfg=data_cfg, jdata=jdata, steps=steps)


@pytest.mark.parametrize("compression", [False, True])
def test_train_steps_match_jax(J, jax_train, compression):
    """Three steps of ``make_train_step`` (compress, clip, AdamW update)
    from the same state: loss, grad norm, parameters, moments and the
    error-feedback residuals equal the JAX step's after each."""
    jt = jax_train
    cfg = smoke("qwen2.5-3b")
    init, update, _ = make_optimizer(cfg.optimizer, cosine_with_warmup(
        TRAIN["lr"], TRAIN["warmup"], TRAIN["steps"]), eps=EPS)
    step_fn = make_train_step(TLM.build_model(cfg), NULL, update, 1.0,
                              compression)
    tp = port_tree(jt.params)
    ts = init(tp)
    tef = TCMP.ef_init(tp) if compression else None
    jp = jnp_tree(J, jt.params)
    js = jax_opt_state(J, ts)
    jef = (J.compression.ef_init(jp) if compression else
           J.jax.tree.map(lambda p: J.jnp.zeros((1,), J.jnp.float32), jp))
    for step in range(3):
        toks = TT.shard_batch(TT.DataConfig(**jt.data_cfg), step, 0, 1)
        tp, ts, tef, m = step_fn(tp, ts, {"tokens": t(toks["tokens"])}, tef)
        jp, js, jef, jm = jt.steps[compression](
            jp, js, {"tokens": J.jnp.asarray(toks["tokens"])}, jef)
        close(m["loss"], jm["loss"], **LOSS_TOL)
        close(m["grad_norm"], jm["grad_norm"], rtol=1e-4)
        assert int(ts.step) == int(js.step) == step + 1
        # m = Σ 0.1·g-terms and v = Σ 0.05·g²-terms: the gradients'
        # tolerance carried through (|g| < 1e-2 here).
        pairs = [(tp, jp, GRAD_TOL, 2 * TRAIN["lr"] * (step + 1)),
                 (ts.inner["m"], js.inner["m"], dict(rtol=1e-4, atol=1e-7),
                  0.1 * float(jm["grad_norm"]) / 127),
                 (ts.inner["v"], js.inner["v"], dict(rtol=1e-4, atol=1e-9),
                  0.1 * float(jm["grad_norm"]) ** 2 / 127)]
        if compression:
            # A residual carries its gradient's error whole.
            pairs.append((tef, jef, GRAD_TOL, float(jm["grad_norm"]) / 127))
        for got, want, tol, flip in pairs:
            if compression:
                close_but_flipped_codes(got, want, flip, **tol)
            else:
                close_trees(got, want, **tol)


def test_trainer_matches_jax_trainer(J, jax_train, tmp_path, monkeypatch):
    """Six ``Trainer`` steps (cosine schedule, checkpoints at step 3 and
    the end) from the same float32 parameters, AdamW at :data:`EPS` in
    both: the losses, grad norms and final parameters equal the JAX
    ``Trainer``'s."""
    from repro_torch.train import loop as port_loop
    monkeypatch.setattr(port_loop, "make_optimizer",
                        eps_optimizer(make_optimizer))
    jt = jax_train
    jtr = J.loop.Trainer(jt.jmodel, jt.jdata, J.loop.TrainConfig(
        **TRAIN, log_every=100, checkpoint_dir=str(tmp_path / "jax")))
    jtr.step_fn = jt.steps[False]
    jout = jtr.run(init_params=jnp_tree(J, jt.params), resume=False)
    tr = Trainer(TLM.build_model(smoke("qwen2.5-3b")),
                 TT.DataConfig(**jt.data_cfg), TrainConfig(
                     **TRAIN, log_every=100,
                     checkpoint_dir=str(tmp_path / "port")), device=CPU)
    tout = tr.run(init_params=port_tree(jt.params), resume=False)
    assert [m["step"] for m in tout["metrics"]] == list(range(6))
    close([m["loss"] for m in tout["metrics"]],
          [m["loss"] for m in jout["metrics"]], **LOSS_TOL)
    close([m["grad_norm"] for m in tout["metrics"]],
          [m["grad_norm"] for m in jout["metrics"]], rtol=1e-4)
    close_trees(tout["params"], jout["params"])
    assert latest_step(str(tmp_path / "port")) == \
        J.checkpoint.latest_step(str(tmp_path / "jax")) == 5


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

def mixed_tree(seed):
    """float32, bfloat16 and int32 leaves, a 0-d step, nested out of key
    order: ``(params, OptState)`` as a trainer saves it."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    params = {"w": f(3, 4), "b": f(5), "stack": {"z": f(2, 3), "a": f(4)}}
    inner = {"v": {"w": f(3, 4)}, "m": {"w": f(3, 4)}}
    return params, np.int32(seed), inner


def port_mixed(seed):
    params, step, inner = mixed_tree(seed)
    tp = port_tree(params)
    tp["b"] = tp["b"].to(torch.bfloat16)
    tp["stack"]["a"] = (tp["stack"]["a"] * 100).to(torch.int32)
    return tp, OptState(torch.tensor(step), port_tree(inner))


def jax_mixed(J, seed):
    params, step, inner = mixed_tree(seed)
    jp = jnp_tree(J, params)
    jp["b"] = jp["b"].astype(J.jnp.bfloat16)
    jp["stack"]["a"] = (jp["stack"]["a"] * 100).astype(J.jnp.int32)
    return jp, J.optimizers.OptState(J.jnp.asarray(step),
                                     jnp_tree(J, inner))


def bits(x) -> np.ndarray:
    """A leaf's raw bytes as uint8, whichever package made it."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def test_checkpoints_cross_between_packages(J, tmp_path):
    """A checkpoint the JAX package writes restores in the port, and one
    the port writes restores in the JAX package, every leaf (bfloat16,
    int32, the 0-d step) equal bit for bit and of its dtype."""
    tp, jp = port_mixed(1), jax_mixed(J, 1)
    J.checkpoint.save(str(tmp_path / "jax"), 3, jp, {"from": "jax"})
    save(str(tmp_path / "port"), 3, tp, {"from": "port"})
    with open(tmp_path / "jax" / "step_3" / "manifest.json") as f:
        jman = __import__("json").load(f)
    with open(tmp_path / "port" / "step_3" / "manifest.json") as f:
        tman = __import__("json").load(f)
    for key in ("crc", "shapes", "dtypes", "n_leaves", "step"):
        assert jman[key] == tman[key], key
    like = port_mixed(2)
    got, extra = restore(str(tmp_path / "jax"), 3, like)
    assert extra == {"from": "jax"} and isinstance(got[1], OptState)
    jgot, jextra = J.checkpoint.restore(str(tmp_path / "port"), 3,
                                        jax_mixed(J, 2))
    assert jextra == {"from": "port"}
    for a, b in zip(J.jax.tree.leaves(jgot), J.jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(bits(a), bits(b))
    want = dict(flat(tp))
    for path, leaf in flat(got).items():
        assert leaf.dtype == want[path].dtype
        assert np.array_equal(bits(leaf), bits(want[path])), path


# ---------------------------------------------------------------------------
# Mirrors of tests/test_fault_tolerance.py on the port
# ---------------------------------------------------------------------------

def tiny_setup(tmp, steps=12, ckpt_every=5):
    cfg = get_config("qwen2.5-3b", smoke=True)
    model = TLM.build_model(cfg)
    data_cfg = TT.DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                             global_batch=4, seed=7)
    train_cfg = TrainConfig(steps=steps, lr=1e-3, warmup=2,
                            checkpoint_every=ckpt_every,
                            checkpoint_dir=tmp, log_every=100)
    return model, data_cfg, train_cfg


class TestCheckpointStore:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": (torch.ones(4, dtype=torch.bfloat16),
                      torch.zeros((), dtype=torch.int32))}
        save(str(tmp_path), 3, tree, {"note": "x"})
        assert latest_step(str(tmp_path)) == 3
        got, extra = restore(str(tmp_path), 3, tree)
        assert extra == {"note": "x"}
        for a, b in zip(tree_leaves(tree), tree_leaves(got)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)

    def test_corruption_detected(self, tmp_path):
        tree = {"a": torch.ones(8, dtype=torch.float32)}
        path = save(str(tmp_path), 0, tree)
        npz = os.path.join(path, "arrays.npz")
        raw = bytearray(open(npz, "rb").read())
        raw[-5] ^= 0xFF  # flip a bit inside the stored array data
        open(npz, "wb").write(bytes(raw))
        with pytest.raises(Exception):
            restore(str(tmp_path), 0, tree)
        assert latest_step(str(tmp_path)) is None

    def test_keep_n_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_n=2, async_write=False)
        tree = {"a": torch.zeros(2, dtype=torch.float32)}
        for s in range(5):
            mgr.save(s, tree)
        steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
        assert steps == [3, 4]

    def test_async_save_copies_before_returning(self, tmp_path):
        """The manager's async write reads a host copy: the caller's
        in-place update right after ``save`` does not reach the disk."""
        mgr = CheckpointManager(str(tmp_path))
        a = torch.zeros(1 << 16, dtype=torch.float32)
        mgr.save(0, {"a": a})
        a.fill_(1.0)
        mgr.wait()
        got, _ = restore(str(tmp_path), 0, {"a": a})
        assert float(got["a"].abs().sum()) == 0.0


class TestDataDeterminism:
    def test_pure_function_of_step_and_shard(self):
        cfg = TT.DataConfig(vocab_size=100, seq_len=8, global_batch=4,
                            seed=1)
        a = TT.shard_batch(cfg, 5, 0, 2)["tokens"]
        b = TT.shard_batch(cfg, 5, 0, 2)["tokens"]
        np.testing.assert_array_equal(a, b)
        assert not np.array_equal(a, TT.shard_batch(cfg, 6, 0, 2)["tokens"])
        assert not np.array_equal(a, TT.shard_batch(cfg, 5, 1, 2)["tokens"])

    def test_elastic_resharding_covers_same_global_batch(self):
        """Re-sharding at a new world size keeps per-shard batch shape."""
        cfg = TT.DataConfig(vocab_size=100, seq_len=8, global_batch=8)
        b2 = [TT.shard_batch(cfg, 3, i, 2)["tokens"] for i in range(2)]
        b4 = [TT.shard_batch(cfg, 3, i, 4)["tokens"] for i in range(4)]
        assert b2[0].shape == (4, 8) and b4[0].shape == (2, 8)


class TestRestartExactness:
    def test_killed_run_resumes_bitwise(self, tmp_path):
        model, data_cfg, cfg_a = tiny_setup(str(tmp_path / "a"))
        params0 = model.init(torch.Generator().manual_seed(5), device=CPU)

        # Uninterrupted reference run.
        out_a = Trainer(model, data_cfg, cfg_a, device=CPU).run(
            init_params=params0, resume=False)
        losses_a = [m["loss"] for m in out_a["metrics"]]

        # Run B: dies at step 7 (after the checkpoint at step 4).
        _, _, cfg_b = tiny_setup(str(tmp_path / "b"))
        tr_b = Trainer(model, data_cfg, cfg_b, device=CPU)
        with pytest.raises(RuntimeError, match="simulated node failure"):
            tr_b.run(init_params=params0, resume=False, fail_at_step=7)
        losses_b = [m["loss"] for m in tr_b.metrics]
        assert len(losses_b) == 7
        tr_b.ckpt.wait()

        # Run C: restarts from B's checkpoint dir, resumes at step 5.
        out_c = Trainer(model, data_cfg, cfg_b, device=CPU).run(
            init_params=params0, resume=True)
        losses_c = [m["loss"] for m in out_c["metrics"]]
        assert out_c["metrics"][0]["step"] == 5

        stitched = losses_b[:5] + losses_c
        np.testing.assert_allclose(stitched, losses_a, rtol=0, atol=0)
        for a, c in zip(tree_leaves(out_a["params"]),
                        tree_leaves(out_c["params"])):
            assert torch.equal(a, c)

    def test_preemption_checkpoint(self, tmp_path):
        model, data_cfg, cfg = tiny_setup(str(tmp_path / "p"), steps=50)
        tr = Trainer(model, data_cfg, cfg, device=CPU)
        # Preempt after construction: loop should save and exit at once.
        tr.request_preemption()
        out = tr.run(resume=False)
        assert out["preempted"] is True
        assert latest_step(cfg.checkpoint_dir) is not None


class TestTrainingLearns:
    def test_loss_decreases(self, tmp_path):
        model, data_cfg, cfg = tiny_setup(str(tmp_path / "l"), steps=30,
                                          ckpt_every=1000)
        out = Trainer(model, data_cfg, cfg, device=CPU).run(resume=False)
        losses = [m["loss"] for m in out["metrics"]]
        first = np.mean(losses[:5])
        last = np.mean(losses[-5:])
        assert last < first - 0.3, (first, last)


# ---------------------------------------------------------------------------
# The attention gradient
# ---------------------------------------------------------------------------

VJP_SHAPES = [(2, 8, 2, 12, 30, 16, True),     # GQA, causal, Sq < Skv
              (1, 4, 1, 9, 9, 64, False)]      # MQA, not causal


@pytest.mark.parametrize("shape,dtype", [(s, "float32") for s in VJP_SHAPES]
                         + [(VJP_SHAPES[0], "bfloat16")], ids=str)
def test_attention_backward_matches_jax_vjp(J, shape, dtype):
    b, hq, hkv, sq, skv, d, causal = shape
    rng = np.random.default_rng(sum(shape))
    q, dout = (rng.normal(size=(b, hq, sq, d)).astype(np.float32)
               for _ in range(2))
    k, v = (rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
            for _ in range(2))
    jdt, tdt, tol = {"float32": (J.jnp.float32, torch.float32, 2e-5),
                     "bfloat16": (J.jnp.bfloat16, torch.bfloat16, 2e-2)}[dtype]

    def vjp(q, k, v, dout):
        _, pull = J.jax.vjp(lambda *a: J.ref.attention(*a, causal=causal),
                            q, k, v)
        return pull(dout)

    want = J.run_fast(J.jax.jit(vjp), *(J.jnp.asarray(a, jdt)
                                        for a in (q, k, v, dout)))
    got = ref.attention_backward(*(t(a).to(tdt) for a in (q, k, v, dout)),
                                 causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        close(g, np.asarray(w, np.float32), rtol=tol, atol=tol)


def test_attention_gradient_on_cpu_is_the_plain_versions():
    """On CPU tensors ``flash_attention`` is ``ref.attention`` under
    autograd, its gradient ``ref.attention_backward``'s; asking the
    kernel of a CPU tensor raises, forward or backward, and launches
    nothing."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(1, 4, 10, 16, generator=gen, requires_grad=True)
    k = torch.randn(1, 2, 12, 16, generator=gen, requires_grad=True)
    v = torch.randn(1, 2, 12, 16, generator=gen, requires_grad=True)
    dout = torch.randn(1, 4, 10, 16, generator=gen)
    out = tfa.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    auto = torch.autograd.grad(out, (q, k, v), dout)
    plain = tfa.flash_attention_backward(q.detach(), k.detach(), v.detach(),
                                         out.detach(), dout, causal=True)
    for a, p in zip(auto, plain):
        torch.testing.assert_close(a, p, rtol=1e-5, atol=1e-6)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v, backend="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_backward(q.detach(), k.detach(), v.detach(),
                                     out.detach(), dout, backend="kernel")
    assert ops.LAUNCHES == before


def test_interop_carries_optimizer_state(J):
    params = opt_tree(12)
    js = J.optim.make_optimizer("adafactor", 1e-3)[0](jnp_tree(J, params))
    np_state = J.jax.tree.map(np.asarray, js)
    ts = interop.opt_state_from_numpy(np_state, CPU)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    back = interop.opt_state_to_numpy(ts)
    assert back.step == np_state.step
    for a, b in zip(J.jax.tree.leaves(back.inner),
                    J.jax.tree.leaves(np_state.inner)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# On the card: the backward kernel and the model's gradient (GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


#: (B, Hq, Hkv, Sq, Skv, D, causal): GQA, ragged tiles, Sq < Skv (a
#: chunk after cached keys, a decode row), Sq > Skv (rows that see no
#: key), every instance width and a masked width between two.  On the
#: bf16 "wgmma" path (D = 64, 128): groups of 1, 4 and 8 query heads,
#: batch 2, Skv not a multiple of 128 and Sq not of 64, rows that see no
#: key at both widths, a decode row (its forward takes "split", so the
#: backward recomputes the lse), one head slice (G = 1) and several
#: (``_bwd_plan``: every group under 132 CTAs splits to single heads;
#: the last shape splits its groups of 4 in two).
BWD_SHAPES = [
    (1, 4, 4, 128, 128, 64, True),
    (2, 8, 2, 100, 100, 64, True),
    (1, 8, 2, 37, 300, 128, True),
    (1, 4, 1, 1, 77, 32, True),
    (1, 4, 2, 70, 70, 16, False),
    (1, 2, 1, 50, 50, 256, True),
    (1, 4, 2, 65, 65, 80, True),
    (1, 4, 2, 40, 20, 64, True),
    (1, 8, 1, 200, 333, 128, True),
    (2, 16, 2, 130, 130, 64, False),
    (1, 4, 4, 300, 300, 128, True),
    (1, 8, 2, 40, 20, 128, True),
    (2, 8, 1, 1, 90, 64, True),
    (2, 32, 8, 1024, 1024, 64, True),
]
#: float32 to 1e-4; bfloat16 at phase 2's 2e-2 (its output rounding).
BWD_DTYPES = {"float32": (torch.float32, 1e-4),
              "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(BWD_DTYPES))
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
def test_backward_kernel_equals_plain(cuda, shape, dtype):
    """``flash_attention_backward`` on the card, given the forward's lse
    as the train step gives it, against ``ref.attention_backward`` on the
    same inputs, one launch a call; the call that recomputes the lse to
    the same tolerance; and autograd through ``flash_attention`` gives
    the direct call's bits."""
    b, hq, hkv, sq, skv, d, causal = shape
    dt, tol = BWD_DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    q, k, v, dout = (torch.randn(s, generator=gen, device=cuda).to(dt)
                     for s in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d), (b, hq, sq, d)))
    out, lse = tfa._flash_attention_cuda(q, k, v, causal, d ** -0.5, 128,
                                         128, with_lse=True)
    ops.reset_launches()
    got = tfa.flash_attention_backward(q, k, v, out, dout, causal=causal,
                                       lse=lse)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    want = ref.attention_backward(q, k, v, dout, causal=causal)
    recomputed = tfa.flash_attention_backward(q, k, v, out, dout,
                                              causal=causal)
    for grads in (got, recomputed):
        for g, w in zip(grads, want):
            assert g.dtype == dt and g.shape == w.shape
            torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                       atol=tol)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = tfa.flash_attention(*leaves, causal=causal)
    assert o.grad_fn is not None
    auto = torch.autograd.grad(o, leaves, dout)
    for a, g in zip(auto, got):
        assert torch.equal(a, g)            # deterministic: no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True, "dots"])
def test_model_loss_gradient_on_the_card_equals_plain(cuda, remat):
    """The repaired fault: ``Model.loss`` on the card under
    ``backend="auto"`` runs the attention kernels forward and backward
    and gives every leaf a gradient, equal to the ``backend="ref"``
    model's at float32 (rtol = atol = 1e-4); with remat the forward
    kernel runs twice a layer (the recompute)."""
    cfg = dataclasses.replace(
        get_config("granite-3-2b", smoke=True), head_dim=64,
        remat=bool(remat), remat_policy="dots" if remat == "dots"
        else "nothing")
    model, plain = TLM.build_model(cfg), TLM.build_model(cfg, backend="ref")
    params = model.init(torch.Generator(device=cuda).manual_seed(0),
                        dtype=torch.float32, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 48), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(1))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    ops.reset_launches()
    loss = model.loss(params, {"tokens": tokens})
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert ops.LAUNCHES["flash_attention"] == (2 * n if remat else n)
    assert ops.LAUNCHES["flash_attention_bwd"] == n
    want_loss = plain.loss(params, {"tokens": tokens})
    want = torch.autograd.grad(want_loss, leaves)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-5)
    for g, w in zip(grads, want):
        assert g is not None and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert all(float(g.abs().sum()) > 0 for g in grads)
