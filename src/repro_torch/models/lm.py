"""Model assembly: the decoder LMs behind one interface.

Port of ``src/repro/models/lm.py``.  A built model exposes:
  defs / init / axes      — ParamDef tree, materializer, logical axes
  loss(params, batch, planner)           -> scalar loss (forward)
  decode_step(params, cache, tokens, pos, planner) -> (logits, cache)
  cache_defs(batch, max_len)             -> ParamDef tree for the KV cache

Layer stacks are stacked on a leading axis; the reference's
``lax.scan`` over them is a Python loop over each layer's views of the
stacked tensors, the KV cache's views written in place.  The model's
attention runs on the CUDA ``flash_attention`` kernel on the card and
on the plain version on the CPU (``build_model(cfg, backend=...)``;
``models/layers.py``).

The loss is differentiable end to end: on the card the attention's
gradient is the ``flash_attention_bwd`` kernel
(``kernels.flash_attention.FlashAttentionFn``).  With ``cfg.remat`` the
train path (the loss, no cache) recomputes each block in the backward
pass (``torch.utils.checkpoint``, non-reentrant), as the reference's
``jax.checkpoint``; ``remat_policy="dots"`` keeps the products with no
batch dims (the weight matmuls, ``aten.mm`` / ``aten.addmm``) and
recomputes the rest, as ``dots_with_no_batch_dims_saveable`` does.

This slice builds the dense family (ROADMAP A15a, A15b).  The other
families raise ``NotImplementedError`` naming the ROADMAP item that
ports them: moe A15c, ssm and hybrid A15d, encdec and vlm A15e.
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
from .config import ModelConfig
from .params import (ParamDef, abstract_params, axes_of, init_params,
                     stack_layers, tree_leaves, tree_map)


# ---------------------------------------------------------------------------
# Block definitions
# ---------------------------------------------------------------------------

def _dense_block_defs(cfg: ModelConfig) -> Dict:
    return {"ln1": L.norm_defs(cfg), "attn": L.attention_defs(cfg),
            "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}


def _dense_block(p, x, cfg, planner, positions, cache, cache_pos,
                 backend="auto", angles=None):
    h, new_cache = L.attention_forward(
        p["attn"], L.apply_norm(p["ln1"], x), cfg=cfg, planner=planner,
        positions=positions, causal=True, cache=cache, cache_pos=cache_pos,
        backend=backend, angles=angles)
    x = x + h
    x = x + L.mlp_forward(p["mlp"], L.apply_norm(p["ln2"], x), cfg, planner)
    return x, new_cache


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


def build_decoder_lm(cfg: ModelConfig, backend: str = "auto") -> Model:
    """Uniform decoder stacks: the dense family."""
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.arch}: the moe block (models/moe.py) is ROADMAP A15c")
    if backend not in _build.BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of "
                         f"{_build.BACKENDS}")
    block_defs = _dense_block_defs(cfg)
    defs = dict(_embed_defs(cfg), blocks=stack_layers(cfg.n_layers,
                                                      block_defs))

    # The dense block has no auxiliary loss: the reference adds
    # 0.01 x its zeros, which changes no bit of the loss.
    def run_stack(params, x, planner, positions, caches=None, cache_pos=None):
        # RoPE's angles once for all layers (the reference's scan
        # recomputes them in every layer; the values are the same).
        angles = L.rope_angles(positions, cfg.head_dim, cfg.rope_theta) \
            if cfg.pos == "rope" else None

        def block(p_l, h, cache_l=None):
            return _dense_block(p_l, h, cfg, planner, positions, cache_l,
                                cache_pos, backend, angles)[0]

        # remat only on the train path (no cache), where a backward runs.
        fn = _remat(cfg, block) if (cfg.remat and caches is None
                                    and torch.is_grad_enabled()) else block
        for i, p_l in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            x = fn(p_l, x) if caches is None else fn(p_l, x,
                                                     _layer(caches, i))
        return x

    def loss_fn(params, batch, planner):
        tokens = batch["tokens"]
        positions = _positions(tokens)
        x = _embed(params, tokens, cfg, planner, positions)
        h = run_stack(params, x, planner, positions)
        return _shift_loss(h, params, tokens, cfg, planner)

    def decode_fn(params, cache, tokens, pos, planner, extras,
                  last_only=False):
        pos = int(pos)
        positions = _positions(tokens, pos)
        x = _embed(params, tokens, cfg, planner, positions)
        h = run_stack(params, x, planner, positions, caches=cache,
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
# Registry
# ---------------------------------------------------------------------------

_NOT_PORTED = {"ssm": "A15d (models/xlstm.py)",
               "hybrid": "A15d (models/ssm.py and the hybrid builder)",
               "encdec": "A15e (the encoder-decoder builder)",
               "vlm": "A15e (the cross-attention VLM builder)"}


def build_model(cfg: ModelConfig, backend: str = "auto") -> Model:
    """The model of ``cfg``.  ``backend`` picks its attention: "auto"
    (the CUDA kernel on CUDA tensors, the plain version on CPU ones),
    "kernel" or "ref" (the plain version on any device)."""
    if cfg.family in ("dense", "moe"):
        return build_decoder_lm(cfg, backend)
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.arch}: the {cfg.family} family is ROADMAP "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(f"unknown family {cfg.family!r}")
