"""The launch counts of the port's kernels.

Each kernel module dispatches its own kernel, with one backend policy
(``_build.resolve``, the JAX package's ``repro/kernels/ops.py`` for
CUDA):

  * "kernel" — the hand-written CUDA kernel; raises unless the tensors
               are on a CUDA device.
  * "ref"    — the plain PyTorch version, on any device.
  * "auto"   — the kernel on a CUDA tensor, the plain version on a CPU
               tensor.  There is no fallback: a kernel that fails to
               build or launch raises.

The entry points are ``segment_sum.segment_sum``,
``fused_join.probe_counts``, ``hash_partition.hash_histogram`` /
``bucket_counts`` and ``flash_attention.flash_attention`` (the JAX
package's ``ops.flash_attention``; its gradient under autograd is the
``flash_attention_bwd`` kernel).  :data:`LAUNCHES` counts each
kernel's launches: a wrapper adds one where it launches its kernel.
A CUDA-graph replay runs no wrapper; :func:`traced_launches` counts
the launches that ran on the card from the profiler's device trace.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Tuple

import torch

from ._build import LAUNCHES

__all__ = ["KERNEL_SYMBOLS", "LAUNCHES", "reset_launches", "traced_launches"]

#: The device functions of each kernel that its wrapper launches once a
#: call (one of them, by path), as they appear in a device trace.  The
#: other functions of the same call (``segment_sum_fixup``,
#: ``attention_combine``, the backward's ``attention_bwd_delta``,
#: ``attention_bwd_lse``, ``attention_bwd_dq_simt``,
#: ``attention_bwd_dq_wgmma`` and ``attention_bwd_slice_sum``) are left
#: out, so a trace counts in the unit of :data:`LAUNCHES`: the backward
#: by its dK/dV function, ``attention_bwd_dkdv_simt`` ("simt") or
#: ``attention_bwd_dkdv_wgmma`` ("wgmma").  Past 65,535 leading rows the
#: per-block histogram and the "split" attention kernel launch once per
#: 65,535 rows (the grid's y limit), so there a trace counts more than
#: the wrappers; ``probe_counts``, ``segment_sum``, ``bucket_counts``
#: and the "simt" and "wgmma" attention kernels (1-D grids) stay one
#: launch a call.
KERNEL_SYMBOLS = {
    "segment_sum": ("segment_sum_tiles",),
    "probe_counts": ("probe_counts_kernel", "probe_counts_tiles_kernel",
                     "probe_counts_queries_kernel"),
    "hash_histogram": ("hist_blocks", "bucket_totals", "bucket_totals_rows"),
    "flash_attention": ("attention_simt", "attention_wgmma",
                        "attention_split"),
    "flash_attention_bwd": ("attention_bwd_dkdv_simt",
                            "attention_bwd_dkdv_wgmma"),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def traced_launches(fn: Callable[[], Any]
                    ) -> Tuple[Any, Dict[str, int], int]:
    """Run ``fn()`` under ``torch.profiler`` and count each kernel's
    records in the device trace (:data:`KERNEL_SYMBOLS`): the launches
    that ran on the card during the call, those of a CUDA-graph replay
    included.  Returns ``(fn(), counts, n_kernels)``, ``n_kernels`` the
    records of any kernel in the trace: copies and memsets left out,
    also those the driver runs as kernels of its own (``memset32``,
    ``memcpy32_post``: a CUDA graph's memset and copy nodes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pattern = {name: re.compile(r"\b(?:%s)\b" % "|".join(symbols))
               for name, symbols in KERNEL_SYMBOLS.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    counts = {name: 0 for name in KERNEL_SYMBOLS}
    n_kernels = 0
    for event in prof.key_averages():
        if (event.device_type != DeviceType.CUDA
                or event.key.lower().startswith(("memcpy", "memset"))):
            continue
        n_kernels += event.count
        for name, pat in pattern.items():
            if pat.search(event.key):
                counts[name] += event.count
    return result, counts, n_kernels
