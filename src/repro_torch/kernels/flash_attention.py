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
gradient of ``ref.attention`` computes: on the tensor cores ("mma") in
bfloat16 at head dims 64 and 128, on the CUDA cores ("simt") otherwise.  An output of the kernel path
under autograd always has a ``grad_fn``.

On CPU tensors, or with ``backend="ref"``, it runs the plain version
``ref.attention``, which autograd differentiates.  All align the causal diagonal to the end of the kv
axis, compute in float32, return ``q.dtype``, and give zeros for a
query row that sees no key.
"""

from __future__ import annotations

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


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, scale: float, block_q: int,
                          block_kv: int) -> torch.Tensor:
    """The CUDA kernels.  Raises on anything they do not take — it never
    falls back to the plain version."""
    _check_inputs(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.numel() == 0 or skv == 0:
        return torch.zeros_like(q)      # no query or no key: no launch
    plan = _plan(sq, skv, hq, hkv, d, q.dtype, batch=b)
    if q.dtype not in NATIVE_DTYPES[plan.path]:
        # float32 inside either way: cast in, run the float32 kernel,
        # round once on the way out.
        return _flash_attention_cuda(q.float(), k.float(), v.float(), causal,
                                     scale, block_q, block_kv).to(q.dtype)
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
    if plan.path == "wgmma":
        rc = lib.flash_attention_wgmma_bf16(*ptrs, b, hq, hkv, sq, skv, d,
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
    return out


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
#: Head dims of the backward's tensor-core path (bfloat16, mma.sync);
#: every other call takes its CUDA-core path ("simt").
MMA_HEAD_DIMS = (64, 128)


def _bwd_path(dtype: torch.dtype, d: int) -> str:
    """The backward kernel's path for a call: "mma" or "simt"."""
    return "mma" if dtype == torch.bfloat16 and d in MMA_HEAD_DIMS \
        else "simt"


def _flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, causal: bool, scale: float
                              ) -> tuple:
    """The backward kernels: ``(dq, dk, dv)`` in the dtypes of q, k, v.
    Raises on anything they do not take; never the plain version."""
    _check_inputs(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must match q "
                         f"{tuple(q.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.numel() == 0 or skv == 0:      # no query or no key: no launch
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
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
    if _bwd_path(q.dtype, d) == "mma":
        # The tensor-core path reads rows 16 bytes at a time.
        q, k, v, out, dout = (t if t.data_ptr() % TMA_ALIGN == 0
                              else t.clone() for t in (q, k, v, out, dout))
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
                             backend: str = "auto") -> tuple:
    """``(dq, dk, dv)``: the gradient of :func:`flash_attention` at
    ``(q, k, v)``, given its output ``out`` and the output's cotangent
    ``dout``; dk and dv summed over each kv head's query heads.  The
    CUDA kernel on CUDA tensors ("auto", "kernel"), the plain version
    ``ref.attention_backward`` on CPU tensors or with ``backend="ref"``
    (which ignores ``out``)."""
    scale = scale if scale is not None else float(q.shape[-1]) ** -0.5
    if _build.resolve(backend, q) == "ref":
        return ref.attention_backward(q, k, v, dout, causal=causal,
                                      scale=scale)
    return _flash_attention_bwd_cuda(q, k, v, out, dout, causal, scale)


class FlashAttentionFn(torch.autograd.Function):
    """The kernel path under autograd: forward the attention kernel,
    backward the ``flash_attention_bwd`` kernel.  Saves q, k, v and the
    output; the backward recomputes each row's log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, block_q: int,
                block_kv: int):
        out = _flash_attention_cuda(q, k, v, causal, scale, block_q,
                                    block_kv)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _flash_attention_bwd_cuda(q, k, v, out, dout,
                                               ctx.causal, ctx.scale)
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
