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

On CPU tensors, or with ``backend="ref"``, it runs the plain version
``ref.attention``.  All align the causal diagonal to the end of the kv
axis, compute in float32, return ``q.dtype``, and give zeros for a
query row that sees no key.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build, ref

__all__ = ["flash_attention"]

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
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v are on different devices")
    if not q.dtype.is_floating_point or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes float q, k, v of one "
                        f"dtype, got {q.dtype} / {k.dtype} / {v.dtype}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dim 1.."
                         f"{MAX_HEAD_DIM}, got {d}")
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    backend: str = "auto", block_q: int = 128,
                    block_kv: int = 128) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in q.dtype.  ``block_q`` caps the "simt"
    kernel's query tile (64 rows, or 16 below 64); the "wgmma" and
    "split" tiles are fixed, and ``block_kv`` is taken for the
    reference's signature."""
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
    return _flash_attention_cuda(q, k, v, causal, scale, block_q, block_kv)
