"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first CUDA use,
``nvcc`` compiles it for Hopper (``sm_90a``) into its own shared
library under ``build/kernels/`` at the repository root (override with
``REPRO_TORCH_BUILD_DIR``), named by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags so an edited source or header
rebuilds; the library is then loaded with ``ctypes``.
:func:`build` starts one ``nvcc`` per source, all at once.

Nothing here touches CUDA at import time, so the package imports on a
machine with no GPU and no compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

_P, _LL, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
_HIST = (_P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P)
_TOTALS = (_P, _P, _P, _LL, _LL, _LL, _LL, _P)
_ATTN_SIMT = (_P,) * 5 + (_LL,) * 7 + (_F, _LL, _LL, _LL, _P, _P, _P)
_ATTN_WGMMA = (_P,) * 5 + (_LL,) * 7 + (_F, _LL, _P)
_ATTN_SPLIT = (_P, _P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _F, _LL,
               _LL, _LL, _P)
_ATTN_BWD_SIMT = (_P,) * 11 + (_LL,) * 7 + (_F, _LL, _LL, _LL, _LL, _LL, _P)
_ATTN_BWD_WGMMA = (_P,) * 11 + (_LL,) * 7 + (_F, _LL, _LL, _LL, _P)
#: One library per ``csrc/<name>.cu``, and its C entry points:
#: (pointers..., sizes..., stream) -> ``cudaGetLastError()`` as int.
SIGNATURES = {
    "segment_sum": {"segment_sum_f32": (_P, _P, _P, _P, _LL, _LL, _LL, _P)},
    "probe_counts": {
        "probe_counts_i32": (_P, _P, _P, _P, _LL, _LL, _LL, _P),
        "probe_counts_i64": (_P, _P, _P, _P, _LL, _LL, _LL, _P),
    },
    "hash_histogram": {"hash_histogram_i32": _HIST,
                       "hash_histogram_i64": _HIST,
                       "bucket_counts_i32": _TOTALS,
                       "bucket_counts_i64": _TOTALS},
    "flash_attention": {"flash_attention_simt_f32": _ATTN_SIMT,
                        "flash_attention_simt_bf16": _ATTN_SIMT,
                        "flash_attention_simt_f16": _ATTN_SIMT,
                        "flash_attention_wgmma_bf16": _ATTN_WGMMA,
                        "flash_attention_wgmma_f16": _ATTN_WGMMA,
                        "flash_attention_split_f32": _ATTN_SPLIT,
                        "flash_attention_split_bf16": _ATTN_SPLIT},
    "flash_attention_bwd": {"flash_attention_bwd_simt_f32": _ATTN_BWD_SIMT,
                            "flash_attention_bwd_simt_bf16": _ATTN_BWD_SIMT,
                            "flash_attention_bwd_simt_f16": _ATTN_BWD_SIMT,
                            "flash_attention_bwd_wgmma_bf16":
                                _ATTN_BWD_WGMMA,
                            "flash_attention_bwd_wgmma_f16":
                                _ATTN_BWD_WGMMA},
}

SOURCES = tuple(SIGNATURES)
CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches per kernel, counted by each wrapper where it launches
#: its kernel (:func:`count_launch`) and nowhere else.  Callers reset the
#: counts to 0 before the run they want to read.
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name``; a wrapper calls it right
    after its launch.  Under CUDA-graph capture the launch is recorded
    into the graph, not run, so it is not counted; a replay runs no
    Python, and its launches are read from the device trace
    (:func:`repro_torch.kernels.ops.traced_launches`)."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1

_LIBS: Dict[str, ctypes.CDLL] = {}

BACKENDS = ("auto", "kernel", "ref")


def resolve(backend: str, t) -> str:
    """``"kernel"`` or ``"ref"`` for a call on tensor ``t``: "auto" is
    the kernel on a CUDA tensor and the plain version on a CPU one."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if backend == "auto":
        return "kernel" if t.is_cuda else "ref"
    return backend


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put the "
                       "CUDA toolkit's bin directory on PATH")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every ``csrc/*.cuh`` header (any source may include them) and the
    flags, so an edited source or header rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library that is not built yet — one ``nvcc`` per
    source, all started together — and return the library paths.  The
    compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) is kept beside each library as ``.log``."""
    names = tuple(names)
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((name, out, tmp, proc))
    failed = []
    for name, out, tmp, proc in running:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        for fn, args in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(args)
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` returned by a launch."""
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{code} ({msg})")
