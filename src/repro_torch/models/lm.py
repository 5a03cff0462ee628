"""Model assembly: the decoder LMs behind one interface.

Port of ``src/repro/models/lm.py``.  A built model exposes:
  defs / init / axes      — ParamDef tree, materializer, logical axes
  loss(params, batch, planner)           -> scalar loss (forward)
  decode_step(params, cache, tokens, pos, planner) -> (logits, cache)
  cache_defs(batch, max_len)             -> ParamDef tree for the KV and
                                            recurrent-state cache

Layer stacks are stacked on a leading axis; the reference's
``lax.scan`` over them is a Python loop over each layer's views of the
stacked tensors, the KV cache's views written in place.  The model's
attention runs on the CUDA ``flash_attention`` kernel on the card and
on the plain version on the CPU (``build_model(cfg, backend=...)``;
``models/layers.py``).

The families built here: dense and moe (``build_decoder_lm``; the moe
block's expert layer is ``models/moe.py``, its auxiliary loss summed
over the layers into the loss at 0.01), ssm (``build_xlstm_lm``: mLSTM
and sLSTM cells, ``models/xlstm.py``) and hybrid (``build_hybrid_lm``:
Mamba2 super-blocks sharing one attention block, ``models/ssm.py``).
A recurrent state is replaced, not written in place: each step returns
new state tensors, as the reference's scan does.  encdec and vlm raise
``NotImplementedError`` naming ROADMAP A15e.

The loss is differentiable end to end: on the card the attention's
gradient is the ``flash_attention_bwd`` kernel
(``kernels.flash_attention.FlashAttentionFn``).  With ``cfg.remat`` the
decoder's train path (the loss, no cache) recomputes each block in the
backward pass (``torch.utils.checkpoint``, non-reentrant), as the
reference's ``jax.checkpoint``; ``remat_policy="dots"`` keeps the
products with no batch dims (the weight matmuls, ``aten.mm`` /
``aten.addmm``) and recomputes the rest, as
``dots_with_no_batch_dims_saveable`` does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from ..distributed.sharding import Planner
from ..kernels import _build
from . import layers as L
from . import moe as MOE
from . import ssm as SSM
from . import xlstm as XL
from .config import ModelConfig
from .params import (ParamDef, abstract_params, axes_of, init_params,
                     stack_layers, tree_leaves, tree_map, zeros_of)


# ---------------------------------------------------------------------------
# Block definitions
# ---------------------------------------------------------------------------

def _dense_block_defs(cfg: ModelConfig) -> Dict:
    return {"ln1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
            "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}


def _moe_block_defs(cfg: ModelConfig) -> Dict:
    return {"ln1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
            "ln2": L.norm_defs(cfg), "moe": MOE.moe_defs(cfg)}


def _attention_residual(p, x, cfg, planner, positions, cache, cache_pos,
                        backend, angles):
    h, _ = L.attention_forward(
        p["attn"], L.apply_norm(p["ln1"], x), cfg=cfg, planner=planner,
        positions=positions, causal=True, cache=cache, cache_pos=cache_pos,
        backend=backend, angles=angles)
    return x + h


def _dense_block(p, x, cfg, planner, positions, cache, cache_pos,
                 backend="auto", angles=None):
    """The block's output and its auxiliary loss (none: ``None``)."""
    x = _attention_residual(p, x, cfg, planner, positions, cache, cache_pos,
                            backend, angles)
    x = x + L.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], x), cfg, planner)
    return x, None


def _moe_block(p, x, cfg, planner, positions, cache, cache_pos,
               backend="auto", angles=None):
    x = _attention_residual(p, x, cfg, planner, positions, cache, cache_pos,
                            backend, angles)
    m, aux = MOE.moe_forward(p["moe"], L.apply_norm(p["ln2"], x), cfg,
                             planner)
    return x + m, aux


# ---------------------------------------------------------------------------
# Base decoder-only model (dense), a loop over layers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    defs: Any
    _loss: Callable
    _decode: Callable
    _cache_defs: Callable

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.bfloat16, device=None):
        """Weights drawn from ``generator``, on the card unless ``device``
        says otherwise."""
        return init_params(self.defs, generator, dtype, device=device)

    def abstract(self, dtype: torch.dtype = torch.bfloat16):
        return abstract_params(self.defs, dtype)

    def axes(self):
        return axes_of(self.defs)

    def loss(self, params, batch, planner: Optional[Planner] = None):
        return self._loss(params, batch, planner or Planner.null())

    def decode_step(self, params, cache, tokens, pos,
                    planner: Optional[Planner] = None,
                    extras: Optional[Dict] = None, last_only: bool = False):
        """Logits (B, S, padded_vocab) of ``tokens`` (B, S) at positions
        ``pos``.. (an int), and the cache, written in place."""
        return self._decode(params, cache, tokens, pos,
                            planner or Planner.null(), extras or {},
                            last_only)

    def cache_defs(self, batch_size: int, max_len: int):
        return self._cache_defs(batch_size, max_len)


def _embed_defs(cfg: ModelConfig) -> Dict:
    out = {"embedding": ParamDef((cfg.padded_vocab, cfg.d_model),
                                 ("vocab", "embed"), scale=1.0),
           "ln_f": L.norm_defs(cfg),
           "lm_head": ParamDef((cfg.d_model, cfg.padded_vocab),
                               ("embed", "vocab"))}
    if cfg.pos == "learned":
        out["pos_embedding"] = ParamDef((8192, cfg.d_model), (None, "embed"),
                                        scale=0.02)
    return out


def _embed(params, tokens, cfg, planner, positions=None):
    x = params["embedding"][tokens.long()]
    if cfg.pos == "learned":
        x = x + params["pos_embedding"][positions.clamp(max=8191).long()]
    elif cfg.pos == "sinusoidal":
        x = x + L.sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                       device=x.device).to(x.dtype)[None]
    return planner.constrain(x, ("batch", None, "act_embed"))


def _shift_loss(hidden, params, tokens, cfg, planner):
    h = L.apply_norm(params["ln_f"], hidden)
    targets = tokens[:, 1:]
    mask = torch.ones(targets.shape, dtype=torch.float32,
                      device=targets.device)
    return L.lm_loss(h[:, :-1], params["lm_head"], targets, mask, cfg, planner)


def _kv_cache_defs(cfg: ModelConfig, n_layers: int, batch: int, max_len: int):
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "seq", "kv_heads", None)
    return {"k": ParamDef(shape, axes, init="zeros"),
            "v": ParamDef(shape, axes, init="zeros")}


def _positions(tokens: torch.Tensor, pos: int = 0) -> torch.Tensor:
    B, S = tokens.shape
    return (pos + torch.arange(S, device=tokens.device))[None].expand(B, S)


def _layer(tree, i: int):
    """Layer ``i``'s views of a tree of stacked tensors."""
    return tree_map(lambda t: t[i], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers' views of a tree of stacked tensors, each leaf cut
    by one ``unbind``: under autograd its backward stacks the layers'
    gradients once, where a view per layer (``t[i]``) would add a
    zero-filled stack-sized gradient per layer (O(n²) bytes)."""
    leaves = tree_leaves(tree)
    parts = [t.unbind(0) for t in leaves]

    def layer(i):
        it = iter([p[i] for p in parts])
        return tree_map(lambda _: next(it), tree)

    return [layer(i) for i in range(n)]


#: The products a "dots" remat keeps: matmuls with no batch dims.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn: Callable) -> Callable:
    """``fn`` recomputed in the backward pass (the reference's
    ``jax.checkpoint`` with ``cfg.remat_policy``)."""
    kw = dict(use_reentrant=False)
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: ckpt.checkpoint(fn, *args, **kw)


def _check_backend(backend: str) -> None:
    if backend not in _build.BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{_build.BACKENDS}")


def _rope_angles(cfg: ModelConfig, positions):
    """RoPE's angles once for all layers (the reference recomputes them
    in every layer; the values are the same)."""
    return L.rope_angles(positions, cfg.head_dim, cfg.rope_theta) \
        if cfg.pos == "rope" else None


def build_decoder_lm(cfg: ModelConfig, backend: str = "auto") -> Model:
    """Uniform decoder stacks: the dense and moe families."""
    _check_backend(backend)
    moe = cfg.family == "moe"
    block_defs = _moe_block_defs(cfg) if moe else _dense_block_defs(cfg)
    block_fn = _moe_block if moe else _dense_block
    defs = dict(_embed_defs(cfg), blocks=stack_layers(cfg.n_layers,
                                                      block_defs))

    def run_stack(params, x, planner, positions, caches=None, cache_pos=None):
        """The stack's output and its auxiliary loss summed over the
        layers (None for the dense block, which has none: the
        reference adds 0.01 x its zeros, which changes no bit)."""
        angles = _rope_angles(cfg, positions)

        def block(p_l, h, cache_l=None):
            return block_fn(p_l, h, cfg, planner, positions, cache_l,
                            cache_pos, backend, angles)

        # remat only on the train path (no cache), where a backward runs.
        fn = _remat(cfg, block) if (cfg.remat and caches is None
                                    and torch.is_grad_enabled()) else block
        aux = None
        for i, p_l in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            x, aux_l = fn(p_l, x) if caches is None else \
                fn(p_l, x, _layer(caches, i))
            if aux_l is not None:
                aux = aux_l if aux is None else aux + aux_l
        return x, aux

    def loss_fn(params, batch, planner):
        tokens = batch["tokens"]
        positions = _positions(tokens)
        x = _embed(params, tokens, cfg, planner, positions)
        h, aux = run_stack(params, x, planner, positions)
        loss = _shift_loss(h, params, tokens, cfg, planner)
        return loss if aux is None else loss + 0.01 * aux

    def decode_fn(params, cache, tokens, pos, planner, extras,
                  last_only=False):
        pos = int(pos)
        positions = _positions(tokens, pos)
        x = _embed(params, tokens, cfg, planner, positions)
        h, _ = run_stack(params, x, planner, positions, caches=cache,
                         cache_pos=pos)
        if last_only:
            h = h[:, -1:]
        h = L.apply_norm(params["ln_f"], h)
        logits = h @ params["lm_head"]
        return planner.constrain(logits, ("batch", None, "act_vocab")), cache

    def cache_defs(batch, max_len):
        return _kv_cache_defs(cfg, cfg.n_layers, batch, max_len)

    return Model(cfg, defs, loss_fn, decode_fn, cache_defs)


# ---------------------------------------------------------------------------
# xLSTM (mixed mLSTM/sLSTM stack, unrolled — small models)
# ---------------------------------------------------------------------------

def _xlstm_layer_kinds(cfg: ModelConfig):
    return ["slstm" if cfg.slstm_every and (i + 1) % cfg.slstm_every == 0
            else "mlstm" for i in range(cfg.n_layers)]


def build_xlstm_lm(cfg: ModelConfig, backend: str = "auto") -> Model:
    """The ssm family: an unrolled stack of mLSTM and sLSTM blocks (no
    attention, so ``backend`` has nothing to pick)."""
    _check_backend(backend)
    kinds = _xlstm_layer_kinds(cfg)
    blocks = tuple({"ln": L.norm_defs(cfg),
                    "cell": XL.mlstm_defs(cfg) if kind == "mlstm"
                    else XL.slstm_defs(cfg)} for kind in kinds)
    defs = dict(_embed_defs(cfg), blocks=blocks)

    def run(params, x, planner, states=None):
        new_states = []
        for i, kind in enumerate(kinds):
            p = params["blocks"][i]
            st = None if states is None else states[i]
            xin = L.apply_norm(p["ln"], x)
            forward, decode = (
                (XL.mlstm_forward, XL.mlstm_decode_step) if kind == "mlstm"
                else (XL.slstm_forward, XL.slstm_decode_step))
            if x.shape[1] == 1 and st is not None:
                h, ns = decode(p["cell"], xin, cfg, st)
            else:
                h, ns = forward(p["cell"], xin, cfg, planner, st)
            x = x + h
            new_states.append(ns)
        return x, tuple(new_states)

    def loss_fn(params, batch, planner):
        tokens = batch["tokens"]
        x = _embed(params, tokens, cfg, planner)
        h, _ = run(params, x, planner)
        return _shift_loss(h, params, tokens, cfg, planner)

    def decode_fn(params, cache, tokens, pos, planner, extras,
                  last_only=False):
        x = _embed(params, tokens, cfg, planner)
        h, new_states = run(params, x, planner, states=cache)
        if last_only:
            h = h[:, -1:]
        h = L.apply_norm(params["ln_f"], h)
        return h @ params["lm_head"], new_states

    def cache_defs(batch, max_len):
        d_in, H, P = XL._dims(cfg)
        d = cfg.d_model
        row = ("batch", None)
        out = []
        for kind in kinds:
            if kind == "mlstm":
                out.append({"mlstm": ParamDef(
                    (batch, H, 1, P + 1, P),
                    ("batch", "ssm_heads", None, None, None),
                    init="zeros", dtype="float32")})
            else:
                out.append({"slstm": (
                    ParamDef((batch, d), row, init="zeros"),
                    *(ParamDef((batch, d), row, init="zeros",
                               dtype="float32") for _ in range(3)))})
        return tuple(out)

    return Model(cfg, defs, loss_fn, decode_fn, cache_defs)


# ---------------------------------------------------------------------------
# Zamba-style hybrid: Mamba2 super-blocks + one shared attention block
# ---------------------------------------------------------------------------

def build_hybrid_lm(cfg: ModelConfig, backend: str = "auto") -> Model:
    """The hybrid family: ``n_layers // shared_attn_every`` super-blocks
    of ``shared_attn_every`` Mamba2 layers, each followed by the one
    shared attention block (its own KV cache a super-block), then a tail
    of the remaining Mamba2 layers."""
    _check_backend(backend)
    k = cfg.shared_attn_every
    n_super = cfg.n_layers // k
    tail = cfg.n_layers % k
    mamba_defs_one = {"ln": L.norm_defs(cfg), "mix": SSM.mamba_defs(cfg)}
    defs = dict(
        _embed_defs(cfg),
        super_blocks=stack_layers(n_super, stack_layers(k, mamba_defs_one)),
        tail_blocks=stack_layers(tail, mamba_defs_one) if tail else {},
        shared_attn={"ln": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
                     "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)},
    )

    def mamba_stack(blocks, n, states, x, planner, decode):
        """``n`` stacked Mamba2 layers; their new states stacked."""
        new = []
        for p_l, st_l in zip(_unstack(blocks, n), _unstack(states, n)):
            xin = L.apply_norm(p_l["ln"], x)
            if decode:
                h, ns = SSM.mamba_decode_step(p_l["mix"], xin, cfg, st_l)
            else:
                h, ns = SSM.mamba_forward(p_l["mix"], xin, cfg, planner,
                                          st_l)
            x = x + h
            new.append(ns)
        return x, {name: torch.stack([ns[name] for ns in new])
                   for name in ("ssd", "conv")}

    def shared_apply(p, x, planner, positions, cache, cache_pos, angles):
        h, _ = L.attention_forward(
            p["attn"], L.apply_norm(p["ln"], x), cfg=cfg, planner=planner,
            positions=positions, causal=True, cache=cache,
            cache_pos=cache_pos, backend=backend, angles=angles)
        x = x + h
        return x + L.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], x), cfg,
                                 planner)

    def mamba_state_defs(batch):
        d_in, H, conv_dim = SSM.mamba_dims(cfg)
        # stack_layers keeps no dtype: the stacked ssd state is made in
        # the cache's dtype, as the reference's is, and the first step
        # replaces it with its float32 state.
        return {"ssd": ParamDef((batch, 1, H, cfg.ssm_head_dim,
                                 cfg.ssm_state),
                                ("batch", None, "ssm_heads", None, None),
                                init="zeros", dtype="float32"),
                "conv": ParamDef((batch, cfg.ssm_conv - 1, conv_dim),
                                 ("batch", None, "ff"), init="zeros")}

    def state_defs(batch):
        one = mamba_state_defs(batch)
        return {"mamba": stack_layers(n_super, stack_layers(k, one)),
                "tail": stack_layers(tail, one) if tail else {}}

    def run(params, x, planner, positions, states, attn_caches, cache_pos,
            decode):
        angles = _rope_angles(cfg, positions)
        supers = _unstack(params["super_blocks"], n_super)
        sts = _unstack(states["mamba"], n_super)
        new_states = []
        for i in range(n_super):
            x, ns = mamba_stack(supers[i], k, sts[i], x, planner, decode)
            new_states.append(ns)
            x = shared_apply(params["shared_attn"], x, planner, positions,
                             None if attn_caches is None
                             else _layer(attn_caches, i), cache_pos, angles)
        new = {"mamba": {name: torch.stack([ns[name] for ns in new_states])
                         for name in ("ssd", "conv")},
               "tail": states["tail"]}
        if tail:
            x, new["tail"] = mamba_stack(params["tail_blocks"], tail,
                                         states["tail"], x, planner, decode)
        return x, new

    def loss_fn(params, batch_d, planner):
        tokens = batch_d["tokens"]
        positions = _positions(tokens)
        x = _embed(params, tokens, cfg, planner, positions)
        states = zeros_of(state_defs(tokens.shape[0]), device=x.device)
        h, _ = run(params, x, planner, positions, states, None, None,
                   decode=False)
        return _shift_loss(h, params, tokens, cfg, planner)

    def decode_fn(params, cache, tokens, pos, planner, extras,
                  last_only=False):
        pos = int(pos)
        positions = _positions(tokens, pos)
        x = _embed(params, tokens, cfg, planner, positions)
        # a full-sequence prefill runs the chunked scan
        h, new_states = run(params, x, planner, positions, cache["states"],
                            cache["attn"], pos, decode=tokens.shape[1] == 1)
        if last_only:
            h = h[:, -1:]
        h = L.apply_norm(params["ln_f"], h)
        return h @ params["lm_head"], {"states": new_states,
                                       "attn": cache["attn"]}

    def cache_defs(batch, max_len):
        kv = (n_super, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        axes = ("layers", "batch", "seq", "kv_heads", None)
        return {"states": state_defs(batch),
                "attn": {"k": ParamDef(kv, axes, init="zeros"),
                         "v": ParamDef(kv, axes, init="zeros")}}

    return Model(cfg, defs, loss_fn, decode_fn, cache_defs)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_NOT_PORTED = {"encdec": "A15e (the encoder-decoder builder)",
               "vlm": "A15e (the cross-attention VLM builder)"}


def build_model(cfg: ModelConfig, backend: str = "auto") -> Model:
    """The model of ``cfg``.  ``backend`` picks its attention: "auto"
    (the CUDA kernel on CUDA tensors, the plain version on CPU ones),
    "kernel" or "ref" (the plain version on any device)."""
    if cfg.family in ("dense", "moe"):
        return build_decoder_lm(cfg, backend)
    if cfg.family == "ssm":
        return build_xlstm_lm(cfg, backend)
    if cfg.family == "hybrid":
        return build_hybrid_lm(cfg, backend)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.arch}: the {cfg.family} family is ROADMAP "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
