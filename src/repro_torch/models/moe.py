"""Mixture-of-Experts layer built on the paper's join machinery.

Port of ``src/repro/models/moe.py``.  Token→expert dispatch is a join,

  Tokens(tid, expert, weight) ⋈ Experts(expert, params),

and the combine is the paper's aggregation, a group-by-``tid`` weighted
SUM.  The dispatch places each routed copy in its expert's capacity
buffer with the map-phase counting sort (``core.local.partition_ranks``):
over capacity, the copies kept are the first in its stable order of the
flat (token-major, k-minor) copy index, as the reference keeps them.

The combine sums each token's routed copies in a fixed order, its k
order (:func:`_combine`), where the reference scatter-adds them: the
same sum up to float32 rounding, and on the card the same bits on every
run (an ``index_add_`` there runs on atomics, in an order that varies).

Two dispatch strategies on a mesh (the paper's 1,3J-vs-2,3J trade-off):

* "replicated" (default): activations replicated across the model axis,
  every shard gathers the tokens its local experts need with no
  collective, and one all-reduce combines (1,3J's broadcast).  Where the
  expert count does not divide the model axis, the expert ffn dim is
  split over it instead (tensor-parallel).
* "a2a": routed copies travel point-to-point with an all-to-all over
  the data axes, which hold the experts (2,3J: each tuple moves once).

On one device (a null planner) :func:`moe_forward` runs
:func:`_moe_local` and returns a zero auxiliary loss, as the reference
does (ROADMAP C11).  On a :class:`~repro_torch.distributed.Mesh` each
rank takes the global inputs, cuts its block by the reference's
``shard_map`` specs, runs the body with ``torch.distributed``
collectives and returns its own block of the output and the replicated
auxiliary loss.

Top-k ties: ``jax.lax.top_k`` puts the lower expert first, where
``torch.topk`` does not promise an order, so the router takes the first
k of a stable descending sort (ROADMAP C12).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.local import partition_ranks
from ..core.relation import scatter_drop
from ..core.shuffle import ShardGrid
from ..distributed.sharding import Planner
from .config import ModelConfig
from .params import ParamDef


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    out = {
        "router": ParamDef((d, E), ("embed", "experts"), scale=0.02),
        "wg": ParamDef((E, d, f), ("experts", "embed", "expert_ff")),
        "wu": ParamDef((E, d, f), ("experts", "embed", "expert_ff")),
        "wd": ParamDef((E, f, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.n_shared_experts:
        fs = cfg.expert_d_ff * cfg.n_shared_experts
        out["shared_wg"] = ParamDef((d, fs), ("embed", "ff"))
        out["shared_wu"] = ParamDef((d, fs), ("embed", "ff"))
        out["shared_wd"] = ParamDef((fs, d), ("ff", "embed"))
    return out


def _ceil8(c: int) -> int:
    return max(8, -(-c // 8) * 8)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    return _ceil8(int(n_tokens * cfg.top_k * cfg.capacity_factor
                      / max(cfg.n_experts, 1)))


def _route(p, x_flat, cfg: ModelConfig):
    """Router: top-k expert ids (N, K) int64, renormalized float32
    weights (N, K), and the Switch load-balancing loss."""
    logits = (x_flat @ p["router"]).float()                    # (N, E)
    gates = torch.softmax(logits, dim=-1)
    # The lower expert first on ties, as jax.lax.top_k.
    weights, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :cfg.top_k], ids[:, :cfg.top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    density = gates.mean(0)
    frac = F.one_hot(ids[:, 0], cfg.n_experts).float().mean(0)
    aux = cfg.n_experts * (density * frac).sum()
    return ids, weights, aux


def _dispatch_plan_from_flat(flat_e: torch.Tensor, n_experts: int,
                             capacity: int):
    """The (E, C) gather plan of a flat expert-id array (ids of
    ``n_experts`` or more are dropped): each slot's index into the flat
    array, and whether the slot holds a copy."""
    n = flat_e.shape[0]
    order, sorted_bucket, rank = partition_ranks(
        flat_e, torch.ones(n, dtype=torch.bool, device=flat_e.device),
        n_experts)
    keep = (rank < capacity) & (sorted_bucket < n_experts)
    total = n_experts * capacity
    dest = torch.where(keep, sorted_bucket.long() * capacity + rank, total)
    return (scatter_drop(order, dest, total).view(n_experts, capacity),
            scatter_drop(keep, dest, total).view(n_experts, capacity))


def _dispatch_plan(ids: torch.Tensor, n_experts: int, capacity: int):
    """Map-phase counting sort (paper §III): for each routed copy, its
    slot in the destination expert's capacity buffer.

    ids: (N, K) -> gather index (E, C) into the flat (N*K,) routed copies
    and the valid mask (E, C)."""
    return _dispatch_plan_from_flat(ids.reshape(-1), n_experts, capacity)


def _expert_ffn(wg, wu, wd, xin):
    """xin: (E_local, C, d) -> (E_local, C, d); SwiGLU per expert."""
    h = F.silu(torch.bmm(xin, wg)) * torch.bmm(xin, wu)
    return torch.bmm(h, wd)


def _combine(contrib: torch.Tensor, copy_idx: torch.Tensor,
             valid: torch.Tensor, n_tokens: int, k: int) -> torch.Tensor:
    """Group-by-token sum of routed copies: ``contrib`` (M, d) float32
    rows, ``copy_idx`` (M,) each row's flat copy index (token·k + j),
    ``valid`` (M,).  A copy has at most one valid row.  Returns (N, d):
    each token's copies summed in j order, a dropped copy as zero."""
    m, d = contrib.shape
    n_copies = n_tokens * k
    dest = torch.where(valid, copy_idx.long(), n_copies)
    row = torch.arange(m, device=contrib.device)
    inv = scatter_drop(row, dest, n_copies)
    # Copies with no row point at the zero row appended at m.
    has = scatter_drop(valid, dest, n_copies)
    inv = torch.where(has, inv, m)
    rows = torch.cat([contrib, contrib.new_zeros(1, d)])[inv]
    return rows.view(n_tokens, k, d).sum(1)


def _shared_ffn(p, xf):
    h = F.silu(xf @ p["shared_wg"]) * (xf @ p["shared_wu"])
    return (h @ p["shared_wd"]).float()


def _experts_combine(p, xf, weights, gather, valid, cfg):
    """Gather the tokens of plan (gather, valid), run the experts of
    ``p`` on them and combine: (N, d) float32."""
    n = xf.shape[0]
    tok_idx = gather // cfg.top_k                  # routed copy -> token
    xin = torch.where(valid[..., None], xf[tok_idx], 0.0).to(xf.dtype)
    yout = _expert_ffn(p["wg"], p["wu"], p["wd"], xin)       # (E_l, C, d)
    wflat = weights.reshape(-1)[gather]
    contrib = yout.float() * (wflat * valid)[..., None]
    d = xf.shape[1]
    return _combine(contrib.reshape(-1, d), gather.reshape(-1),
                    valid.reshape(-1), n, cfg.top_k)


def _moe_local(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Single-device path: every expert on this device."""
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    ids, weights, _ = _route(p, xf, cfg)
    gather, valid = _dispatch_plan(ids, cfg.n_experts, _capacity(cfg, N))
    out = _experts_combine(p, xf, weights, gather, valid, cfg)
    if "shared_wg" in p:
        out = out + _shared_ffn(p, xf)
    return out.reshape(B, S, d).to(x.dtype)


def ep_axes_for(cfg: ModelConfig, mesh_shape: Dict[str, int]):
    """The mesh axes the a2a dispatch routes over (experts sharded there).
    Prefer the full DP extent (pod×data) so expert params divide by the
    whole chip count; fall back to data-only, then to None (=> use the
    replicated strategy)."""
    for axes in (("pod", "data"), ("data",)):
        if all(a in mesh_shape for a in axes):
            n = 1
            for a in axes:
                n *= mesh_shape[a]
            if n > 1 and cfg.n_experts % n == 0:
                return axes, n
    return None, 1


# ---------------------------------------------------------------------------
# On a mesh of ranks
# ---------------------------------------------------------------------------

def moe_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                planner: Optional[Planner] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss scalar).

    With a null planner: (the whole output, a zero aux).  On a mesh
    (``planner.mesh`` a :class:`~repro_torch.distributed.Mesh`; every
    rank calls this with the same global ``p`` and ``x``): this rank's
    block of the output (its batch rows over the data axes) and the
    aux loss averaged over every rank.

    * replicated: experts sharded on the model axis (or their ffn dim
      split over it when the count doesn't divide — grok's 8 experts);
      no dispatch collective, one all-reduce over "model" to combine.
    * a2a: experts sharded over the DP axes (pod·data), ffn dim over
      model; each routed copy travels with an all-to-all over the DP
      axes and comes back the same way.
    """
    planner = planner or Planner.null()
    mesh = planner.mesh
    if mesh is None:
        return _moe_local(p, x, cfg), torch.zeros((), dtype=torch.float32,
                                                  device=x.device)

    axis_names = tuple(mesh.axis_names)
    batch_axes = tuple(a for a in ("pod", "data") if a in axis_names)
    model_axis = "model"
    n_model = planner.mesh_shape.get(model_axis, 1)
    xspec = (batch_axes, None, None)

    ep_axes, n_ep = ep_axes_for(cfg, planner.mesh_shape)
    use_a2a = cfg.moe_dispatch == "a2a" and ep_axes is not None
    shard_experts = False
    if use_a2a:
        wspec = (ep_axes, None, model_axis)
        wdspec = (ep_axes, model_axis, None)
    else:
        shard_experts = cfg.n_experts % max(n_model, 1) == 0 and n_model > 1
        if shard_experts:
            wspec = wdspec = (model_axis, None, None)
        else:
            wspec = (None, None, model_axis)
            wdspec = (None, model_axis, None)
    pspec = {"router": (None, None), "wg": wspec, "wu": wspec, "wd": wdspec,
             "shared_wg": (None, model_axis), "shared_wu": (None, model_axis),
             "shared_wd": (model_axis, None)}

    # Building a grid is collective: every rank builds these in order.
    psum_model = ShardGrid(mesh, (model_axis,)).reduce_sum
    every = ShardGrid(mesh, (axis_names,))
    pmean_all = lambda a: every.reduce_sum(a) / mesh.size  # noqa: E731
    if use_a2a:
        ep = ShardGrid(mesh, (ep_axes,))
        body = functools.partial(
            _moe_a2a_body, cfg=cfg, n_ep=n_ep,
            ep_index=mesh.axis_index(ep_axes),
            all_to_all=lambda a: ep.all_to_all_tensor(a, 0))
    else:
        body = functools.partial(
            _moe_shard_body, cfg=cfg, shard_experts=shard_experts,
            n_model=n_model, model_index=mesh.axis_index(model_axis))
    keys = list(p)

    def run(grid, x_block, *p_blocks):
        return body(dict(zip(keys, p_blocks)), x_block, psum=psum_model,
                    pmean=pmean_all)

    # The reference's shard_map: each argument cut to this rank's block.
    return every.run(run, x, *(p[k] for k in keys),
                     in_specs=(xspec, *(pspec[k] for k in keys)))


def _moe_a2a_body(p, x, *, cfg: ModelConfig, n_ep: int, ep_index: int,
                  all_to_all, psum, pmean):
    """all_to_all expert parallelism: route token copies to the DP shard
    owning their expert, compute, route back, combine, psum over model
    (the expert ffn is split there)."""
    B, S, d = x.shape
    N = B * S
    K = cfg.top_k
    e_local = cfg.n_experts // n_ep
    xf = x.reshape(N, d)
    ids, weights, aux = _route(p, xf, cfg)                   # (N, K)

    # ---- send plan: route copies by destination EP shard ------------------
    flat_ids = ids.reshape(-1)                                # (N*K,)
    dest = flat_ids // e_local
    cap_send = _ceil8(int(N * K * cfg.capacity_factor / n_ep))
    order, sorted_dest, rank = partition_ranks(
        dest, torch.ones_like(dest, dtype=torch.bool), n_ep)
    keep = (rank < cap_send) & (sorted_dest < n_ep)
    total = n_ep * cap_send
    slot = torch.where(keep, sorted_dest.long() * cap_send + rank, total)

    def to_slots(v):
        return scatter_drop(v, slot, total)

    copy_flat = to_slots(order)                # the flat copy in each slot
    copy_token = copy_flat // K
    copy_expert = to_slots(flat_ids[order])
    copy_valid = to_slots(keep)
    send_x = torch.where(copy_valid[:, None], xf[copy_token], 0.0
                         ).to(x.dtype)

    # ---- exchange: copies travel to their expert's shard -------------------
    def a2a(a):
        return all_to_all(a.reshape((n_ep, cap_send) + a.shape[1:]))

    recv_x = a2a(send_x)                                      # (n_ep, cap, d)
    recv_expert = a2a(copy_expert)
    recv_valid = a2a(copy_valid)

    # ---- local expert grouping (map-phase counting sort again) ------------
    my_base = ep_index * e_local
    flat_recv_e = torch.where(recv_valid.reshape(-1),
                              recv_expert.reshape(-1) - my_base, e_local)
    cap_loc = _ceil8(int(n_ep * cap_send * cfg.capacity_factor
                         / max(e_local, 1)))
    g_idx, g_valid = _dispatch_plan_from_flat(flat_recv_e, e_local, cap_loc)
    xin = torch.where(g_valid[..., None], recv_x.reshape(-1, d)[g_idx], 0.0
                      ).to(x.dtype)
    yout = _expert_ffn(p["wg"], p["wu"], p["wd"], xin)        # partial sums

    # ---- return path: inverse scatter, reverse a2a -------------------------
    # A received slot feeds at most one (expert, slot): a scatter, no
    # sum; the dropped ones go to a dump row, cut off.
    back = yout.new_zeros(total + 1, d).index_copy_(
        0, torch.where(g_valid, g_idx, total).reshape(-1),
        (yout * g_valid[..., None]).reshape(-1, d))[:total]
    recv_back = all_to_all(back.reshape(n_ep, cap_send, d)).reshape(-1, d)

    # ---- combine at source: group-by-token weighted sum --------------------
    wcopy = weights.reshape(-1)[copy_flat]
    contrib = recv_back.float() * (wcopy * copy_valid)[:, None]
    out = psum(_combine(contrib, copy_flat, copy_valid, N, K))
    if "shared_wg" in p:
        out = out + psum(_shared_ffn(p, xf))
    return out.reshape(B, S, d).to(x.dtype), pmean(aux)


def _moe_shard_body(p, x, *, cfg: ModelConfig, shard_experts: bool,
                    n_model: int, model_index: int, psum, pmean):
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    ids, weights, aux = _route(p, xf, cfg)
    gather, valid = _dispatch_plan(ids, cfg.n_experts, _capacity(cfg, N))
    if shard_experts:
        e_local = cfg.n_experts // n_model
        my = model_index * e_local
        gather, valid = gather[my:my + e_local], valid[my:my + e_local]
    # else: all experts here, their ffn dim split over "model".
    out = psum(_experts_combine(p, xf, weights, gather, valid, cfg))
    if "shared_wg" in p:
        # The shared expert's ffn dim is split over "model": partial sums.
        out = out + psum(_shared_ffn(p, xf))
    # aux is replicated: the mean over every rank.
    return out.reshape(B, S, d).to(x.dtype), pmean(aux)
