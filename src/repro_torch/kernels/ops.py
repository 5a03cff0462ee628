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
package's ``ops.flash_attention``).  :data:`LAUNCHES` counts each
kernel's launches: a wrapper adds one where it launches its kernel.
"""

from __future__ import annotations

from ._build import LAUNCHES

__all__ = ["LAUNCHES", "reset_launches"]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
