"""Blocked online-softmax (flash) attention with GQA.

Port of ``src/repro/kernels/flash_attention.py``.  On CUDA tensors
:func:`flash_attention` launches the kernel of
``csrc/flash_attention.cu`` (port of the TPU kernel
``flash_attention``); on CPU tensors, or with ``backend="ref"``, it runs
the plain version ``ref.attention``.  Both align the causal diagonal to
the end of the kv axis, compute in float32, return ``q.dtype``, and
give zeros for a query row that sees no key.
"""

from __future__ import annotations

import torch

from . import _build, ref

__all__ = ["flash_attention"]

#: Head widths and input dtypes the kernel is compiled for.
HEAD_DIMS = (64, 128)
DTYPES = (torch.float32, torch.bfloat16)
#: The kernel's kv tile, whatever ``block_kv`` asks for.
KV_TILE = 64


def _query_tile(sq: int, block_q: int) -> int:
    """The kernel's query tile: 64 rows where ``block_q`` and the next
    power of two of Sq both reach 64, else 16 (decode, short prompts)."""
    need = min(block_q, 1 << max(0, sq - 1).bit_length())
    return 64 if need >= 64 else 16


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, scale: float, block_q: int,
                          block_kv: int) -> torch.Tensor:
    """The CUDA kernel.  Raises on anything the kernel does not take —
    it never falls back to the plain version."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention kernel needs CUDA tensors")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v are on different devices")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype} / {k.dtype} / "
                        f"{v.dtype}")
    b, hq, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dim in "
                         f"{HEAD_DIMS}, got {d}")
    if b * hq > 65535:
        raise ValueError(f"flash_attention kernel takes at most 65535 "
                         f"(batch, head) rows, got {b * hq}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out                      # nothing to attend: no launch
    bq = _query_tile(sq, block_q)
    lib = _build.library("flash_attention")
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 \
        else lib.flash_attention_bf16
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq,
            k.shape[1], sq, k.shape[2], d, scale, int(causal), bq, KV_TILE,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention", rc)
    _build.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    backend: str = "auto", block_q: int = 128,
                    block_kv: int = 128) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) with Hq % Hkv == 0.
    Returns (B, Hq, Sq, D) in q.dtype.  ``block_q`` caps the kernel's
    query tile (64 rows, or 16 below 64); ``block_kv`` is taken for the
    reference's signature and the kv tile is always ``KV_TILE`` rows."""
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
