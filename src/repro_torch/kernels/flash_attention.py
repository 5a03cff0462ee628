"""Blocked online-softmax (flash) attention with GQA.

Port of ``src/repro/kernels/flash_attention.py``.  On CUDA tensors
:func:`flash_attention` launches one of the kernels of
``csrc/flash_attention.cu`` (port of the TPU kernel ``flash_attention``),
as :func:`_plan` picks it:

  * ``"wgmma"`` — bfloat16 prefill at head dims 64 and 128 on the
    tensor cores, fed by TMA;
  * ``"split"`` — short query blocks (Sq <= ``SPLIT_MAX_SQ``: decode and
    short chunks), the kv axis split over CTAs and the splits merged by
    a second kernel;
  * ``"simt"`` — every other prefill on the CUDA cores (wgmma has no
    full-float32 mode).

"split" and "simt" take any head dim up to ``MAX_HEAD_DIM``; float32
and (on "split") bfloat16 run natively, and every other float dtype
runs through float32: cast in, float32 inside, cast out, as the
reference accumulates.

With no key (Skv = 0) every row sees nothing: zeros, and no launch.

Under autograd (grad mode on and an input that requires grad) the
kernel path runs inside :class:`FlashAttentionFn`: its forward is the
kernel above, its backward the kernel of ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_backward`), which replaces no TPU kernel (the
JAX package differentiates its jnp attention) and computes what the
gradient of ``ref.attention`` computes: on the tensor cores ("wgmma") in
bfloat16 at head dims 64 and 128, on the CUDA cores ("simt") otherwise.
A forward that took "wgmma" also stores each row's log-sum-exp, which
the backward then reads instead of recomputing it: float32 (B, Hq, Sq),
in base 2 of the scaled scores, ``log2 sum_j 2^(scale·log2(e)·q_i·k_j)``
over the keys the row sees (``ref.attention_lse``), +inf for a row that
sees no key.  An output of the kernel path under autograd always has a
``grad_fn``.

On CPU tensors, or with ``backend="ref"``, it runs the plain version
``ref.attention``, which autograd differentiates.  All align the causal
diagonal to the end of the kv axis, compute in float32, return
``q.dtype``, and give zeros for a query row that sees no key.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build, ref

__all__ = ["flash_attention", "flash_attention_backward"]

#: Head widths of the tensor-core path; "simt" and "split" take any
#: head dim up to MAX_HEAD_DIM.
WGMMA_HEAD_DIMS = (64, 128)
MAX_HEAD_DIM = 256
#: Dtypes each path runs natively; other float dtypes run as float32.
NATIVE_DTYPES = {"wgmma": (torch.bfloat16,),
                 "split": (torch.float32, torch.bfloat16),
                 "simt": (torch.float32,)}
#: The "simt" kernel's kv tile, whatever ``block_kv`` asks for.
KV_TILE = 64
#: Query blocks up to this length take the split path.
SPLIT_MAX_SQ = 16
#: The split kernel's key tile and query rows a CTA (csrc: split::kKeys,
#: split::kRows); splits are whole key tiles.
SPLIT_KEYS = 32
SPLIT_ROWS = 64
#: Streaming multiprocessors of the H100; the split path aims at two
#: CTAs on each at least.
SM_COUNT = 132
#: TMA reads each tensor from a 16-byte aligned address.
TMA_ALIGN = 16
#: The kernels keep lse (and the backward's delta) in rows of Sq
#: rounded up to this (csrc: wg::kLsePad, the forward's query tile).
LSE_PAD = 128


class Plan(NamedTuple):
    path: str       # "wgmma", "split" or "simt"
    splits: int     # kv splits (1 off the split path)
    chunk: int      # keys a split (Skv off the split path)


def _plan(sq: int, skv: int, hq: int, hkv: int, d: int,
          dtype: torch.dtype, batch: int = 1) -> Plan:
    """The kernel for one call with Skv >= 1.  Short query blocks split
    the kv axis into whole key tiles, as many as give every SM two CTAs
    where Skv allows it; bfloat16 prefill at the tensor cores' head dims
    takes "wgmma"; every other prefill "simt"."""
    if sq <= SPLIT_MAX_SQ:
        row_blocks = -(-(hq // hkv) * sq // SPLIT_ROWS)
        target = -(-2 * SM_COUNT // (batch * hkv * row_blocks))
        chunk = SPLIT_KEYS * max(1, skv // (SPLIT_KEYS * target))
        return Plan("split", -(-skv // chunk), chunk)
    if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS:
        return Plan("wgmma", 1, skv)
    return Plan("simt", 1, skv)


def _query_tile(sq: int, block_q: int) -> int:
    """The "simt" kernel's query tile: 64 rows where ``block_q`` and the
    next power of two of Sq both reach 64, else 16."""
    need = min(block_q, 1 << max(0, sq - 1).bit_length())
    return 64 if need >= 64 else 16


def _lse_rows(sq: int) -> int:
    return -(-sq // LSE_PAD) * LSE_PAD


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, scale: float, block_q: int,
                          block_kv: int, with_lse: bool = False):
    """The CUDA kernels.  Raises on anything they do not take — it never
    falls back to the plain version.  With ``with_lse``, returns
    ``(out, lse)``: the rows' log-sum-exp (see the module's docstring)
    where the "wgmma" kernel ran, else None."""
    _check_inputs(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.numel() == 0 or skv == 0:
        out = torch.zeros_like(q)       # no query or no key: no launch
        return (out, None) if with_lse else out
    plan = _plan(sq, skv, hq, hkv, d, q.dtype, batch=b)
    if q.dtype not in NATIVE_DTYPES[plan.path]:
        # float32 inside either way: cast in, run the float32 kernel,
        # round once on the way out.
        out = _flash_attention_cuda(q.float(), k.float(), v.float(), causal,
                                    scale, block_q, block_kv).to(q.dtype)
        return (out, None) if with_lse else out
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"flash_attention kernel needs {name} at a "
                             f"{TMA_ALIGN}-byte aligned address")
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tag = "f32" if q.dtype == torch.float32 else "bf16"
    lse = None
    if plan.path == "wgmma":
        if with_lse:
            lse = torch.empty(b, hq, _lse_rows(sq), dtype=torch.float32,
                              device=q.device)
        rc = lib.flash_attention_wgmma_bf16(
            *ptrs, 0 if lse is None else lse.data_ptr(),
            0 if lse is None else lse.shape[-1], b, hq, hkv, sq, skv, d,
            scale, int(causal), stream)
    elif plan.path == "split":
        # One workspace: acc (splits, rows, D), then (m, l) (splits, rows).
        rows = plan.splits * b * hq * sq
        ws = torch.empty(rows * (d + 2), dtype=torch.float32,
                         device=q.device)
        rc = getattr(lib, f"flash_attention_split_{tag}")(
            *ptrs, ws.data_ptr(), ws.data_ptr() + rows * d * 4, b, hq, hkv,
            sq, skv, d, scale, int(causal), plan.splits, plan.chunk, stream)
    else:
        rc = lib.flash_attention_f32(*ptrs, b, hq, hkv, sq, skv, d, scale,
                                     int(causal), _query_tile(sq, block_q),
                                     KV_TILE, stream)
    _build.check(lib, "flash_attention", rc)
    _build.count_launch("flash_attention")
    if not with_lse:
        return out
    return out, None if lse is None else lse[..., :sq]


def _check_inputs(q, k, v) -> None:
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v are on different devices")
    if not q.dtype.is_floating_point or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes float q, k, v of one "
                        f"dtype, got {q.dtype} / {k.dtype} / {v.dtype}")
    if not 1 <= q.shape[-1] <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dim 1.."
                         f"{MAX_HEAD_DIM}, got {q.shape[-1]}")


#: Dtypes the backward kernel runs natively; other float dtypes run as
#: float32.
BWD_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: The backward's "wgmma" path: a dK/dV CTA's keys and query tile
#: (csrc: wg::kKeys, wg::kBQ).
BWD_KEYS = 128
BWD_QUERY_TILE = 64


class BwdPlan(NamedTuple):
    path: str       # "wgmma" or "simt"
    slices: int     # query-head slices of a kv group (1 off "wgmma")
    ctas: int       # dK/dV CTAs on "wgmma" (0 off it)


def _bwd_walks(sq: int, skv: int, causal: bool) -> list:
    """Query tiles (of ``BWD_QUERY_TILE`` rows) that see key tile t, for
    each key tile of ``BWD_KEYS``: all of them, or, causal, those whose
    last row's position i + (Skv - Sq) reaches the tile's first key."""
    n_qt = -(-sq // BWD_QUERY_TILE)
    walks = []
    for t in range(-(-skv // BWD_KEYS)):
        first = t * BWD_KEYS - (skv - sq)
        qt0 = 0 if not causal or first <= 0 else \
            min(n_qt, first // BWD_QUERY_TILE)
        walks.append(n_qt - qt0)
    return walks


@functools.lru_cache(maxsize=256)
def _bwd_plan(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
              dtype: torch.dtype, causal: bool) -> BwdPlan:
    """The backward kernel's path for a call (Sq, Skv >= 1), and on
    "wgmma" its dK/dV grid: one CTA per (key tile, query-head slice,
    batch·kv head).  A CTA walks its slice's heads times the query tiles
    that see its keys, so under the causal band the first key tiles walk
    the most.  The slices split each kv group's G query heads evenly: the
    fewest (a divisor of G) for which the longest CTA walks no more than
    an SM's even share of all the walks (over ``SM_COUNT``), else G."""
    if dtype != torch.bfloat16 or d not in WGMMA_HEAD_DIMS:
        return BwdPlan("simt", 1, 0)
    g = hq // hkv
    walks = _bwd_walks(sq, skv, causal)
    share = b * hkv * g * sum(walks) / SM_COUNT
    slices = next((s for s in range(1, g + 1)
                   if g % s == 0 and g // s * max(walks) <= share), g)
    return BwdPlan("wgmma", slices, len(walks) * slices * b * hkv)


def _check_lse(lse: torch.Tensor, q: torch.Tensor) -> None:
    """``lse`` must be the forward's own tensor (``_flash_attention_cuda(
    ..., with_lse=True)``): (B, Hq, Sq), float32 on q's device, a view of
    rows of ``_lse_rows(Sq)``, which the kernels read whole."""
    b, hq, sq, _ = q.shape
    rows = _lse_rows(sq)
    if tuple(lse.shape) != (b, hq, sq):
        raise ValueError(f"lse {tuple(lse.shape)} must be (B, Hq, Sq) = "
                         f"{(b, hq, sq)}")
    if not (lse.dtype == torch.float32 and lse.device == q.device
            and lse.stride() == (hq * rows, rows, 1)
            and lse.untyped_storage().nbytes()
            >= (lse.storage_offset() + b * hq * rows) * 4
            and lse.data_ptr() % TMA_ALIGN == 0):
        raise ValueError("lse must be the forward kernel's own: float32 "
                         f"rows of {rows} on {q.device}, 16-byte aligned")


def _bwd_wgmma(q, k, v, out, dout, causal: bool, scale: float,
               lse, plan: BwdPlan) -> tuple:
    """The "wgmma" backward: bf16, contiguous, 16-byte aligned (TMA)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    q, k, v, out, dout = (t if t.data_ptr() % TMA_ALIGN == 0 else t.clone()
                          for t in (q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rows = _lse_rows(sq)
    # One float32 workspace: delta, then the lse when it is recomputed,
    # then the slices' partial dK and dV.
    n_rows = b * hq * rows
    n_ws = 2 * plan.slices * b * hkv * skv * d if plan.slices > 1 else 0
    ws = torch.empty(n_rows * (1 if lse is not None else 2) + n_ws,
                     dtype=torch.float32, device=q.device)
    delta = ws.data_ptr()
    if lse is not None:
        _check_lse(lse, q)
        lse_ptr, tail = lse.data_ptr(), n_rows
    else:
        lse_ptr, tail = delta + n_rows * 4, 2 * n_rows
    lib = _build.library("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_bwd_wgmma_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse_ptr, delta, ws.data_ptr() + tail * 4 if n_ws else 0, b, hq, hkv,
        sq, skv, d, rows, scale, int(causal), int(lse is not None),
        plan.slices, stream)
    _build.check(lib, "flash_attention_bwd", rc)
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv


def _flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, causal: bool, scale: float,
                              lse: torch.Tensor | None = None) -> tuple:
    """The backward kernels: ``(dq, dk, dv)`` in the dtypes of q, k, v.
    ``lse``, the forward's (see the module's docstring), is read on
    "wgmma" and recomputed where it is None; "simt" always recomputes
    it.  Raises on anything the kernels do not take; never the plain
    version."""
    _check_inputs(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must match q "
                         f"{tuple(q.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.numel() == 0 or skv == 0:      # no query or no key: no launch
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    plan = _bwd_plan(b, hq, hkv, sq, skv, d, q.dtype, causal)
    if plan.path == "wgmma":
        return _bwd_wgmma(q, k, v, out.to(q.dtype), dout.to(q.dtype), causal,
                          scale, lse, plan)
    tag = BWD_DTYPES.get(q.dtype)
    if tag is None:
        # float32 inside either way: cast in, round once on the way out.
        grads = _flash_attention_bwd_cuda(q.float(), k.float(), v.float(),
                                          out.float(), dout.float(), causal,
                                          scale)
        return tuple(g.to(q.dtype) for g in grads)
    dt = q.dtype
    q, k, v, out, dout = (t.to(dt).contiguous()
                          for t in (q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # lse and delta, B·Hq·Sq float32 each.
    rows = b * hq * sq
    ws = torch.empty(2 * rows, dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = getattr(lib, f"flash_attention_bwd_{tag}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws.data_ptr(), ws.data_ptr() + rows * 4, b, hq, hkv, sq, skv, d,
        scale, int(causal), stream)
    _build.check(lib, "flash_attention_bwd", rc)
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             dout: torch.Tensor, *, causal: bool = True,
                             scale: float | None = None,
                             backend: str = "auto",
                             lse: torch.Tensor | None = None) -> tuple:
    """``(dq, dk, dv)``: the gradient of :func:`flash_attention` at
    ``(q, k, v)``, given its output ``out`` and the output's cotangent
    ``dout``; dk and dv summed over each kv head's query heads.  ``lse``,
    the rows' log-sum-exp as the forward kernel returns it
    (``_flash_attention_cuda(..., with_lse=True)``; see the module's
    docstring), spares the kernel its recomputation; an lse in any other
    layout raises ``ValueError``.  The
    CUDA kernel on CUDA tensors ("auto", "kernel"), the plain version
    ``ref.attention_backward`` on CPU tensors or with ``backend="ref"``
    (which ignores ``out`` and ``lse``)."""
    scale = scale if scale is not None else float(q.shape[-1]) ** -0.5
    if _build.resolve(backend, q) == "ref":
        return ref.attention_backward(q, k, v, dout, causal=causal,
                                      scale=scale)
    return _flash_attention_bwd_cuda(q, k, v, out, dout, causal, scale,
                                     lse=lse)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel path under autograd: forward the attention kernel,
    backward the ``flash_attention_bwd`` kernel.  Saves q, k, v, the
    output and, where the forward took "wgmma", each row's log-sum-exp,
    which the backward reads; else the backward recomputes it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, block_q: int,
                block_kv: int):
        out, lse = _flash_attention_cuda(q, k, v, causal, scale, block_q,
                                         block_kv, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_attention_bwd_cuda(q, k, v, out, dout,
                                               ctx.causal, ctx.scale,
                                               lse=lse)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    backend: str = "auto", block_q: int = 128,
                    block_kv: int = 128) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in q.dtype.  ``block_q`` caps the "simt"
    kernel's query tile (64 rows, or 16 below 64); the "wgmma" and
    "split" tiles are fixed, and ``block_kv`` is taken for the
    reference's signature.  Under autograd the kernel path is
    :class:`FlashAttentionFn`, whose backward is a kernel too."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: need (B, H, S, D) and k == v")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={k.shape[1]}")
    scale = scale if scale is not None else float(d) ** -0.5
    if _build.resolve(backend, q) == "ref":
        return ref.attention(q, k, v, causal=causal, scale=scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, scale, block_q,
                                      block_kv)
    return _flash_attention_cuda(q, k, v, causal, scale, block_q, block_kv)
