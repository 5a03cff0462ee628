"""Blocked online-softmax (flash) attention with GQA.

Port of ``src/repro/kernels/flash_attention.py``.  On CUDA tensors
:func:`flash_attention` launches one of the kernels of
``csrc/flash_attention.cu`` (port of the TPU kernel ``flash_attention``),
as :func:`_plan` picks it:

  * ``"wgmma"`` — bfloat16 and float16 prefill at head dims d <= 128
    with d % 8 == 0 on the tensor cores, fed by TMA (instances of width
    64 and 128; the tensor maps read zeros past d);
  * ``"split"`` — short query blocks (Sq <= ``SPLIT_MAX_SQ``: decode and
    short chunks), the kv axis split over CTAs and the splits merged by
    a second kernel;
  * ``"simt"`` — every other prefill (float32; bfloat16 and float16 at
    d > 128 or d % 8 != 0) on the CUDA cores in float32, register-tiled
    and fed by a cp.async ring (wgmma has no full-float32 mode).

"split" and "simt" take any head dim up to ``MAX_HEAD_DIM``.
``NATIVE_DTYPES`` lists the dtypes each path reads and writes natively;
every other float dtype runs through float32: cast in, float32 inside,
cast out, as the reference accumulates.

With no key (Skv = 0) every row sees nothing: zeros, and no launch.

Under autograd (grad mode on and an input that requires grad) the
kernel path runs inside :class:`FlashAttentionFn`: its forward is the
kernel above, its backward the kernel of ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_backward`), which replaces no TPU kernel (the
JAX package differentiates its jnp attention) and computes what the
gradient of ``ref.attention`` computes, on the path :func:`_bwd_plan`
picks: on the tensor cores ("wgmma") for the calls the forward's
"wgmma" takes, on the CUDA cores ("simt") otherwise (``BWD_DTYPES``).
A forward that took "wgmma" or "simt" also stores each row's
log-sum-exp, which the backward then reads instead of recomputing it:
float32 (B, Hq, Sq), in base 2 of the scaled scores,
``log2 sum_j 2^(scale·log2(e)·q_i·k_j)`` over the keys the row sees
(``ref.attention_lse``), +inf for a row that sees no key.  An output of
the kernel path under autograd always has a ``grad_fn``.

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

#: The tensor-core path: 16-bit dtypes at head dims up to this, a
#: multiple of WGMMA_DIM_STEP (TMA's 16-byte row pitch), through
#: instances of these widths.
WGMMA_DTYPES = (torch.bfloat16, torch.float16)
WGMMA_MAX_DIM = 128
WGMMA_DIM_STEP = 8
WGMMA_WIDTHS = (64, 128)
MAX_HEAD_DIM = 256
#: The "simt" and "split" instances' widths (split's: those from 32).
SIMT_WIDTHS = (16, 32, 64, 128, 192, 256)
#: Dtypes each path runs natively; other float dtypes run as float32.
NATIVE_DTYPES = {"wgmma": WGMMA_DTYPES,
                 "split": (torch.float32, torch.bfloat16),
                 "simt": (torch.float32, torch.bfloat16, torch.float16)}
_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16"}
#: The "simt" kernels' query tiles (rows a CTA of 4 a thread), largest
#: first.
SIMT_TILES = (64, 32, 16)
#: Where even the smallest tile leaves an SM fewer than SIMT_SM_THREADS
#: threads, the "simt" forward and dQ split each query tile's key tiles
#: into up to SIMT_MAX_PARTS parts (forward from width 32: the split
#: path's merge).
SIMT_SM_THREADS = 512
SIMT_MAX_PARTS = 4
#: Keys a ring tile of the "simt" forward and dQ kernels, by instance
#: width (csrc: simt::Cfg<D>::kFwdKeys, kDqKeys).
SIMT_FWD_KEYS = {16: 64, 32: 64, 64: 64, 128: 32, 192: 16, 256: 16}
SIMT_DQ_KEYS = {16: 32, 32: 32, 64: 32, 128: 32, 192: 16, 256: 16}
#: Query blocks up to this length take the split path.
SPLIT_MAX_SQ = 16
#: The split kernel's key tile and query rows a CTA (csrc: split::kKeys,
#: split::kRows); splits are whole key tiles.
SPLIT_KEYS = 32
SPLIT_ROWS = 64
#: Streaming multiprocessors of the H100; the split path, the "simt"
#: query tiles and the "simt" backward's parts aim at two CTAs on each
#: at least.
SM_COUNT = 132
#: TMA reads each tensor from a 16-byte aligned address.
TMA_ALIGN = 16
#: The kernels keep lse (and the backward's delta) in rows of Sq
#: rounded up to this (csrc: wg::kLsePad, the forward's query tile).
LSE_PAD = 128
#: The "wgmma" forward's query rows a CTA (csrc: wg::kBQ).
WGMMA_QUERY_TILE = 128


class Plan(NamedTuple):
    path: str       # "wgmma", "split" or "simt"
    splits: int     # kv splits ("split"), parts of each query tile's key
                    # tiles ("simt"), 1 on "wgmma"
    chunk: int      # keys a split (Skv off the split path)
    tile: int = 0   # query rows a CTA ("wgmma", "simt"; 0 on "split")


def _on_tensor_cores(d: int, dtype: torch.dtype) -> bool:
    """Whether "wgmma" takes head dim d in this dtype."""
    return (dtype in WGMMA_DTYPES and d <= WGMMA_MAX_DIM
            and d % WGMMA_DIM_STEP == 0)


def _wgmma_width(d: int) -> int:
    """The "wgmma" instance a head dim runs: 64 up to 64, else 128."""
    return next(w for w in WGMMA_WIDTHS if d <= w)


def _simt_width(d: int) -> int:
    """The "simt" instance a head dim runs: the narrowest that holds it."""
    return next(w for w in SIMT_WIDTHS if d <= w)


def _query_tile(sq: int, heads: int, block_q: int = 128) -> int:
    """A "simt" kernel's query tile for Sq rows of ``heads`` (batch ·
    query heads): the largest of ``SIMT_TILES`` within ``block_q`` (16
    below that) and not past Sq's next power of two that still gives
    every SM two CTAs, else the smallest."""
    tiles = [t for t in SIMT_TILES
             if t <= max(block_q, SIMT_TILES[-1])
             and (t == SIMT_TILES[-1] or t // 2 < sq)]
    return next((t for t in tiles if -(-sq // t) * heads >= 2 * SM_COUNT),
                tiles[-1])


def _simt_parts(sq: int, heads: int, tile: int, key_tiles: int) -> int:
    """Parts of each query tile's ``key_tiles`` key tiles for a "simt"
    grid of ``tile``-row query tiles (4 rows a thread): 1 unless the
    smallest tile leaves the SMs short of ``SIMT_SM_THREADS`` threads
    each, then enough to reach that, at most ``SIMT_MAX_PARTS`` and the
    key tiles."""
    threads = -(-sq // tile) * heads * 4 * tile
    if tile != SIMT_TILES[-1] or threads >= SIMT_SM_THREADS * SM_COUNT:
        return 1
    want = -(-SIMT_SM_THREADS * SM_COUNT // threads)
    return max(1, min(SIMT_MAX_PARTS, key_tiles, want))


def _plan(sq: int, skv: int, hq: int, hkv: int, d: int,
          dtype: torch.dtype, batch: int = 1, block_q: int = 128) -> Plan:
    """The kernel for one call with Skv >= 1.  Short query blocks split
    the kv axis into whole key tiles, as many as give every SM two CTAs
    where Skv allows it; 16-bit prefill at the tensor cores' head dims
    takes "wgmma"; every other prefill "simt", its query tile from
    :func:`_query_tile` and its parts from :func:`_simt_parts` (from
    width 32)."""
    if sq <= SPLIT_MAX_SQ:
        row_blocks = -(-(hq // hkv) * sq // SPLIT_ROWS)
        target = -(-2 * SM_COUNT // (batch * hkv * row_blocks))
        chunk = SPLIT_KEYS * max(1, skv // (SPLIT_KEYS * target))
        return Plan("split", -(-skv // chunk), chunk)
    if _on_tensor_cores(d, dtype):
        return Plan("wgmma", 1, skv, WGMMA_QUERY_TILE)
    tile, w = _query_tile(sq, batch * hq, block_q), _simt_width(d)
    parts = 1 if w < 32 else _simt_parts(sq, batch * hq, tile,
                                         -(-skv // SIMT_FWD_KEYS[w]))
    return Plan("simt", parts, skv, tile)


def _lse_rows(sq: int) -> int:
    return -(-sq // LSE_PAD) * LSE_PAD


def _flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool, scale: float, block_q: int,
                          block_kv: int, with_lse: bool = False):
    """The CUDA kernels.  Raises on anything they do not take — it never
    falls back to the plain version.  With ``with_lse``, returns
    ``(out, lse)``: the rows' log-sum-exp (see the module's docstring)
    where the "wgmma" or "simt" kernel ran, else None."""
    _check_inputs(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if q.numel() == 0 or skv == 0:
        out = torch.zeros_like(q)       # no query or no key: no launch
        return (out, None) if with_lse else out
    plan = _plan(sq, skv, hq, hkv, d, q.dtype, batch=b, block_q=block_q)
    if q.dtype not in NATIVE_DTYPES[plan.path]:
        # float32 inside either way: cast in, run the float32 kernel,
        # round once on the way out.
        res = _flash_attention_cuda(q.float(), k.float(), v.float(), causal,
                                    scale, block_q, block_kv, with_lse)
        if not with_lse:
            return res.to(q.dtype)
        return res[0].to(q.dtype), res[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % TMA_ALIGN:
            raise ValueError(f"flash_attention kernel needs {name} at a "
                             f"{TMA_ALIGN}-byte aligned address")
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    tag = _TAGS[q.dtype]
    lse = None
    if with_lse and plan.path != "split":
        lse = torch.empty(b, hq, _lse_rows(sq), dtype=torch.float32,
                          device=q.device)
    lse_args = (0, 0) if lse is None else (lse.data_ptr(), lse.shape[-1])
    if plan.path == "wgmma":
        rc = getattr(lib, f"flash_attention_wgmma_{tag}")(
            *ptrs, *lse_args, b, hq, hkv, sq, skv, d, scale, int(causal),
            stream)
    elif plan.path == "split":
        # One workspace: acc (splits, rows, D), then (m, l) (splits, rows).
        rows = plan.splits * b * hq * sq
        ws = torch.empty(rows * (d + 2), dtype=torch.float32,
                         device=q.device)
        rc = getattr(lib, f"flash_attention_split_{tag}")(
            *ptrs, ws.data_ptr(), ws.data_ptr() + rows * d * 4, b, hq, hkv,
            sq, skv, d, scale, int(causal), plan.splits, plan.chunk, stream)
    else:
        # The parts' partials: acc (parts, rows, d), then (m, l).
        rows = plan.splits * b * hq * sq if plan.splits > 1 else 0
        ws = torch.empty(rows * (d + 2), dtype=torch.float32,
                         device=q.device)
        ws_args = ((ws.data_ptr(), ws.data_ptr() + rows * d * 4) if rows
                   else (0, 0))
        rc = getattr(lib, f"flash_attention_simt_{tag}")(
            *ptrs, *lse_args, b, hq, hkv, sq, skv, d, scale, int(causal),
            plan.tile, plan.splits, *ws_args, stream)
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


#: Dtypes each backward path runs natively; other float dtypes run as
#: float32.
BWD_DTYPES = {"wgmma": WGMMA_DTYPES,
              "simt": (torch.float32, torch.bfloat16, torch.float16)}
#: The backward's "wgmma" path: a dK/dV CTA's keys and query tile
#: (csrc: wg::kKeys, wg::kBQ).
BWD_KEYS = 128
BWD_QUERY_TILE = 64
#: The backward's "simt" path, by instance width: a dK/dV CTA's keys and
#: its ring's query tile (csrc: simt::Cfg<D>::kKeys, kQRows).
SIMT_BWD_KEYS = {16: 64, 32: 64, 64: 64, 128: 32, 192: 32, 256: 32}
SIMT_BWD_ROWS = {16: 64, 32: 64, 64: 32, 128: 32, 192: 16, 256: 16}


class BwdPlan(NamedTuple):
    path: str       # "wgmma" or "simt"
    slices: int     # dK/dV partials summed in order: "wgmma" query-head
                    # slices of a kv group, "simt" parts of each key
                    # tile's (head, query tile) walk
    ctas: int       # dK/dV CTAs
    tile: int = 0   # the "simt" dQ kernel's query tile (0 on "wgmma")
    q_parts: int = 1  # the "simt" dQ kernel's parts of its key tiles


def _bwd_walks(sq: int, skv: int, causal: bool, keys: int = BWD_KEYS,
               tile: int = BWD_QUERY_TILE) -> list:
    """Query tiles (of ``tile`` rows) that see key tile t, for each key
    tile of ``keys``: all of them, or, causal, those whose last row's
    position i + (Skv - Sq) reaches the tile's first key."""
    n_qt = -(-sq // tile)
    walks = []
    for t in range(-(-skv // keys)):
        first = t * keys - (skv - sq)
        qt0 = 0 if not causal or first <= 0 else min(n_qt, first // tile)
        walks.append(n_qt - qt0)
    return walks


def _dkdv_parts(b: int, hkv: int, g: int, walks: list) -> int:
    """The "simt" dK/dV kernel's parts: each key tile's walk (its G
    heads times the query tiles that see it) split evenly, the fewest
    parts that give every SM two CTAs and keep the longest CTA within an
    SM's even share of all the walks, at most the longest walk."""
    bases = b * hkv * len(walks)
    longest = max(1, g * max(walks))
    share = b * hkv * g * sum(walks) / SM_COUNT
    parts = 1
    while parts < longest and (bases * parts < 2 * SM_COUNT
                               or -(-longest // parts) > share):
        parts += 1
    return parts


@functools.lru_cache(maxsize=256)
def _bwd_plan(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
              dtype: torch.dtype, causal: bool) -> BwdPlan:
    """The backward kernel's path for a call (Sq, Skv >= 1): "wgmma"
    where the forward's "wgmma" takes the call, else "simt"; and the
    dK/dV grid.  On "wgmma" one CTA per (key tile, query-head slice,
    batch·kv head).  A CTA walks its slice's heads times the query tiles
    that see its keys, so under the causal band the first key tiles walk
    the most.  The slices split each kv group's G query heads evenly: the
    fewest (a divisor of G) for which the longest CTA walks no more than
    an SM's even share of all the walks (over ``SM_COUNT``), else G.  On
    "simt" one CTA per (key tile, part, batch·kv head), the parts from
    :func:`_dkdv_parts`, and the dQ kernel's query tile and parts from
    :func:`_query_tile` and :func:`_simt_parts`."""
    g = hq // hkv
    if not _on_tensor_cores(d, dtype):
        w = _simt_width(d)
        walks = _bwd_walks(sq, skv, causal, SIMT_BWD_KEYS[w],
                           SIMT_BWD_ROWS[w])
        parts = _dkdv_parts(b, hkv, g, walks)
        tile = _query_tile(sq, b * hq, SIMT_TILES[0])
        return BwdPlan("simt", parts, len(walks) * parts * b * hkv, tile,
                       _simt_parts(sq, b * hq, tile,
                                   -(-skv // SIMT_DQ_KEYS[w])))
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


def _bwd_launch(q, k, v, out, dout, causal: bool, scale: float, lse,
                plan: BwdPlan) -> tuple:
    """The backward kernels of ``plan.path`` in q's dtype: contiguous,
    16-byte aligned (TMA; the "simt" ring's 16-byte copies)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    q, k, v, out, dout = (t if t.data_ptr() % TMA_ALIGN == 0 else t.clone()
                          for t in (q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    rows = _lse_rows(sq)
    # One float32 workspace: delta, then the lse when it is recomputed,
    # then the slices' (parts') partial dK and dV, then the dQ parts'.
    n_rows = b * hq * rows
    n_ws = 2 * plan.slices * b * hkv * skv * d if plan.slices > 1 else 0
    n_ws += plan.q_parts * b * hq * sq * d if plan.q_parts > 1 else 0
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
    tiles = (plan.tile, plan.q_parts) if plan.path == "simt" else ()
    rc = getattr(lib, f"flash_attention_bwd_{plan.path}_{_TAGS[q.dtype]}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        lse_ptr, delta, ws.data_ptr() + tail * 4 if n_ws else 0, b, hq, hkv,
        sq, skv, d, rows, scale, int(causal), int(lse is not None),
        plan.slices, *tiles, stream)
    _build.check(lib, "flash_attention_bwd", rc)
    _build.count_launch("flash_attention_bwd")
    return dq, dk, dv


def _flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor, causal: bool, scale: float,
                              lse: torch.Tensor | None = None) -> tuple:
    """The backward kernels: ``(dq, dk, dv)`` in the dtypes of q, k, v.
    ``lse``, the forward's (see the module's docstring), is read on
    either path and recomputed where it is None.  Raises on anything the
    kernels do not take; never the plain version."""
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
    if q.dtype not in BWD_DTYPES[plan.path]:
        # float32 inside either way: cast in, round once on the way out.
        grads = _flash_attention_bwd_cuda(q.float(), k.float(), v.float(),
                                          out.float(), dout.float(), causal,
                                          scale, lse=lse)
        return tuple(g.to(q.dtype) for g in grads)
    return _bwd_launch(q, k, v, out.to(q.dtype), dout.to(q.dtype), causal,
                       scale, lse, plan)


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
    output and, where the forward took "wgmma" or "simt", each row's
    log-sum-exp, which the backward reads; after "split" the backward
    recomputes it."""

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
    kernel's query tile (64, 32 or 16 rows: see :func:`_query_tile`; 16
    below 16); the "wgmma" and "split" tiles are fixed, and
    ``block_kv`` is taken for the reference's signature.  Under autograd
    the kernel path is :class:`FlashAttentionFn`, whose backward is a
    kernel too."""
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
