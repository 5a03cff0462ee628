"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``src/repro/models/xlstm.py``.  mLSTM's recurrence
C_t = f_t·C_{t-1} + i_t·v_t k_tᵀ,  h_t = (C_t q_t)/max(|n_t q_t|,1) is
the same linear form as SSD, so the chunked scan of ``ssm.py`` is
reused with (b, c) = (k, q) per head and the normalizer n tracked as an
extra payload column (u augmented with a constant-1 channel).

sLSTM is sequential (its recurrent gate depends on h_{t-1}): the
reference's ``lax.scan`` over time is a Python loop here, one cell a
token, eager on the card (host-bound: O(S) steps of a dozen small
launches).  Exponential gating is stabilized with the max-state m_t.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import Planner
from .config import ModelConfig
from .params import ParamDef
from .ssm import gated_rms_norm, ssd_chunked, ssd_decode_step


def _dims(cfg: ModelConfig):
    d_in = int(cfg.d_model * cfg.xlstm_proj_factor)
    H = cfg.n_heads
    P = d_in // H
    return d_in, H, P


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    d_in, H, P = _dims(cfg)
    return {
        "up_proj": ParamDef((d, 2 * d_in), ("embed", "ff")),
        "wq": ParamDef((d_in, d_in), ("ff", "q_features")),
        "wk": ParamDef((d_in, d_in), ("ff", "q_features")),
        "wv": ParamDef((d_in, d_in), ("ff", "q_features")),
        "wi": ParamDef((d_in, H), ("ff", "ssm_heads"), scale=0.1),
        "wf": ParamDef((d_in, H), ("ff", "ssm_heads"), scale=0.1),
        "bi": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "bf": ParamDef((H,), ("ssm_heads",), init="ones"),
        "norm": ParamDef((d_in,), ("ff",), init="ones"),
        "down_proj": ParamDef((d_in, d), ("ff", "embed")),
    }


def _mlstm_gates_qkv(p, xs, cfg):
    Bsz, S, _ = xs.shape
    d_in, H, P = _dims(cfg)
    q = (xs @ p["wq"]).reshape(Bsz, S, H, P)
    k = (xs @ p["wk"]).reshape(Bsz, S, H, P) * (P ** -0.5)
    v = (xs @ p["wv"]).reshape(Bsz, S, H, P)
    # log-sigmoid forget gate + exponential input gate (capped at e^8).
    logf = F.logsigmoid((xs @ p["wf"]).float() + p["bf"].float())  # (B,S,H)
    i = torch.exp(torch.clamp((xs @ p["wi"]).float() + p["bi"].float(),
                              max=8.0))
    return q, k, v, logf, i


def _mlstm_out(p, y, z, P: int, dtype):
    """The normalized readout of the (…, H, P+1) scan output, gated and
    RMS-normed, projected down."""
    num, den = y[..., :P], y[..., P:]
    h = num / torch.clamp(den.abs(), min=1.0)
    h = h.reshape(*z.shape[:-1], -1)
    return gated_rms_norm(h, z, p["norm"], dtype) @ p["down_proj"]


def mlstm_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  planner: Optional[Planner] = None,
                  state: Optional[Dict] = None,
                  ) -> Tuple[torch.Tensor, Dict]:
    Bsz, S, d = x.shape
    d_in, H, P = _dims(cfg)
    xs, z = (x @ p["up_proj"]).chunk(2, dim=-1)
    q, k, v, logf, i = _mlstm_gates_qkv(p, xs, cfg)

    # payload = [i·v ; i·1]: the extra channel accumulates the normalizer n.
    u = torch.cat([v * i[..., None], i[..., None]], dim=-1)  # (B,S,H,P+1)
    y, final = ssd_chunked(
        u.reshape(Bsz, S, H, 1, P + 1),
        logf.reshape(Bsz, S, H, 1),
        k.reshape(Bsz, S, H, P), q.reshape(Bsz, S, H, P),
        cfg.ssm_chunk,
        init_state=None if state is None else state["mlstm"])
    y = y.reshape(Bsz, S, H, P + 1)
    return _mlstm_out(p, y, z, P, x.dtype), {"mlstm": final}


def mlstm_decode_step(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      state: Dict) -> Tuple[torch.Tensor, Dict]:
    Bsz, _, d = x.shape
    d_in, H, P = _dims(cfg)
    xs, z = (x @ p["up_proj"]).chunk(2, dim=-1)
    q, k, v, logf, i = _mlstm_gates_qkv(p, xs, cfg)
    u = torch.cat([v * i[..., None], i[..., None]], dim=-1)
    y, st = ssd_decode_step(
        u[:, 0].reshape(Bsz, H, 1, P + 1), logf[:, 0].reshape(Bsz, H, 1),
        k[:, 0].reshape(Bsz, H, P), q[:, 0].reshape(Bsz, H, P),
        state["mlstm"])
    y = y.reshape(Bsz, 1, H, P + 1)
    return _mlstm_out(p, y, z, P, x.dtype), {"mlstm": st}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    return {
        "wx": ParamDef((d, 4 * d), ("embed", "ff")),
        "wh": ParamDef((d, 4 * d), ("embed", "ff"), scale=0.5),
        "b": ParamDef((4 * d,), ("ff",), init="zeros"),
        "norm": ParamDef((d,), ("embed",), init="ones"),
    }


def _slstm_cell(p, xt, carry):
    """One sLSTM step with stabilizer state m.  xt: (B, d)."""
    h, cst, nst, m = carry
    # A cached h may be stored in another dtype than the weights (the
    # cache's bfloat16 beside float32 weights): the product is taken in
    # the wider one, as the reference's type promotion takes it.
    wide = torch.promote_types(h.dtype, p["wh"].dtype)
    gates = xt @ p["wx"] + h.to(wide) @ p["wh"].to(wide) + p["b"]
    zt, it, ft, ot = gates.float().chunk(4, dim=-1)
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * cst + i_s * torch.tanh(zt)
    n_new = f_s * nst + i_s
    h_new = (torch.sigmoid(ot) * c_new
             / torch.clamp(n_new, min=1.0)).to(xt.dtype)
    return h_new, c_new, n_new, m_new


def _slstm_out(p, hs, dtype):
    hf = hs.float()
    ms = hf.square().mean(-1, keepdim=True)
    return (hf * torch.rsqrt(ms + 1e-6) * p["norm"].float()).to(dtype)


def slstm_forward(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                  planner: Optional[Planner] = None,
                  state: Optional[Dict] = None,
                  ) -> Tuple[torch.Tensor, Dict]:
    Bsz, S, d = x.shape
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        carry = (torch.zeros((Bsz, d), dtype=x.dtype, device=x.device),
                 torch.zeros((Bsz, d), **f32), torch.zeros((Bsz, d), **f32),
                 torch.full((Bsz, d), -1e30, **f32))
    else:
        carry = tuple(state["slstm"])
    hs = []
    for t in range(S):
        carry = _slstm_cell(p, x[:, t], carry)
        hs.append(carry[0])
    out = _slstm_out(p, torch.stack(hs, dim=1), x.dtype)       # (B,S,d)
    return out, {"slstm": carry}


def slstm_decode_step(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      state: Dict) -> Tuple[torch.Tensor, Dict]:
    carry = _slstm_cell(p, x[:, 0], tuple(state["slstm"]))
    return _slstm_out(p, carry[0], x.dtype)[:, None], {"slstm": carry}
