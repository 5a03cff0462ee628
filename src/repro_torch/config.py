"""Runtime configuration: the join-key dtype and the device.

Keys are int32 by default; billion-vertex graphs alias int32 node ids
(2^31 distinct keys), so 64-bit keys are opt-in through
:func:`enable_x64`.  The ``JAX_ENABLE_X64`` environment variable wins
over the in-code setting, the same switch the JAX package reads, so one
launcher setting gives both packages the same key dtype.

:func:`resolve_device` is the device policy of every entry point: CUDA
unless the caller names another device, and an error, not a silent
CPU run, when no GPU is present.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_x64: Optional[bool] = None


def _env_x64() -> Optional[bool]:
    env = os.getenv("JAX_ENABLE_X64")
    if env is None:
        return None
    return env not in ("0", "false", "False", "")


def enable_x64(use_x64: bool = True) -> bool:
    """Enable (or disable) 64-bit join keys, honoring ``JAX_ENABLE_X64``.
    Returns the mode actually set."""
    global _x64
    env = _env_x64()
    _x64 = bool(use_x64) if env is None else env
    return _x64


def x64_enabled() -> bool:
    if _x64 is not None:
        return _x64
    return bool(_env_x64())


def default_key_dtype() -> torch.dtype:
    """Join-key dtype for newly built relations: int64 once x64 is on,
    int32 otherwise."""
    return torch.int64 if x64_enabled() else torch.int32


def key_dtype_name() -> str:
    """Canonical name of the current key dtype (``"int32"`` /
    ``"int64"``)."""
    return "int64" if x64_enabled() else "int32"


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on: ``cuda`` unless
    the caller asks for another.  Raises when CUDA is asked for (or
    defaulted to) and no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


#: Largest flat pair index the all-pairs join oracle can form in int32
#: arithmetic — ``nl * nr`` must stay below this (the JAX package's
#: limit; ``local.local_join_allpairs`` enforces it, the plan verifier
#: checks plans against it).
INT32_PAIR_LIMIT = 2 ** 31

#: Exclusive upper bound on sort-merge output capacities (the JAX
#: package's int32 position arithmetic needs out_capacity < 2**30 - 1;
#: the port keeps it so both packages accept the same capacities).
SORT_MERGE_MAX_CAP = 2 ** 30 - 1
