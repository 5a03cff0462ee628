"""Deterministic, seeded fault injection — the chaos harness.

Port of ``src/repro/resilience/faults.py`` (host-side numpy, the same
sites, kinds, counters and RNG stream).

MapReduce's signature property is transparent recovery from worker
failure; this module makes failure *reproducible* so the recovery
machinery (``recovery.py``, the serving admission control) can be
tested and measured instead of trusted.  A :class:`FaultInjector`
installs itself as the fault hook of the instrumented layers and, at
each **site**, draws from one seeded RNG stream to decide whether to
fire a **fault kind**:

===============  ====================================================
site             where the hook fires
===============  ====================================================
``shuffle``      every Grid shuffle/broadcast hop, on the payload the
                 reducers are about to receive (core/shuffle.py)
``partition_read``  every partition loaded from the relation store,
                 on the freshly-read arrays (checkpoint/store.py)
``submit``       every request entering the serving engine
                 (serving/engine.py)
``reducer``      every reducer coordinate of a one-round Shares
                 reduce phase (fired by recovery.py itself)
===============  ====================================================

===========  ========================================================
kind         effect at the site
===========  ========================================================
``crash``    raise :class:`InjectedCrash` — the worker died mid-step
``delay``    sleep ``delay_ms`` — a straggler, not an error
``corrupt``  damage the payload.  Numpy payloads are *actually*
             bit-flipped and returned, so the caller's real CRC
             verification catches them (the partition-read path);
             payloads without caller-side checksums (in-flight shuffle
             relations, submit requests) model a checksummed
             transport: the corruption is detected at the receive
             point and surfaces as :class:`DataCorrupt` directly.
             Either way corruption is always *detected*, never
             silently propagated — the invariant the chaos suite
             pins is "bit-identical result or typed error".
===========  ========================================================

Determinism: one ``numpy`` Generator seeded at construction drives
every fire decision in call order, so a given (specs, seed, workload)
replays the exact same fault pattern.  Calls made inside a compiled
plan (a ``jit_execute_*`` call: its warm-up, its CUDA-graph capture,
its replay, or its eager run on the CPU —
:func:`repro_torch.core.executor.in_compiled_plan`; every CUDA-graph
capture of the port runs inside one), neither fire nor consume RNG state:
a compiled plan can never bake a fault in, and whether an executable
was cached can never shift the fault pattern of the eager path.  The
JAX package gets the same from its tracers.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..checkpoint.store import DataCorrupt

__all__ = ["SITES", "KINDS", "FaultSpec", "FaultInjector", "InjectedCrash",
           "HopFailed", "DataCorrupt", "fire", "active_injector"]

#: The instrumented sites, in hook order.
SITES: Tuple[str, ...] = ("shuffle", "partition_read", "submit", "reducer")

#: The fault kinds every site understands.
KINDS: Tuple[str, ...] = ("crash", "delay", "corrupt")


class InjectedCrash(RuntimeError):
    """A seeded worker crash: the step died mid-flight and produced
    nothing.  Recovery re-executes from the step's inputs."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected crash at site {site!r}"
                         + (f" ({detail})" if detail else ""))
        self.site = site
        self.detail = detail


class HopFailed(RuntimeError):
    """A recoverable step exhausted its retry budget.  Carries the
    failing site/hop and the last underlying error — the typed terminal
    failure of lineage recovery (never a wrong answer)."""

    def __init__(self, where: str, attempts: int, last: BaseException):
        super().__init__(f"{where} failed after {attempts} attempt(s): "
                         f"{type(last).__name__}: {last}")
        self.where = where
        self.attempts = attempts
        self.last = last


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One injection rule: at ``site``, fire ``kind`` with probability
    ``rate`` per opportunity.  ``delay_ms`` sizes the straggler sleep;
    ``max_fires`` caps how often the rule fires (``None`` = unbounded)
    — rate 1.0 with ``max_fires=1`` is "kill exactly the first hop",
    the deterministic kill switch the checkpoint-resume tests use.
    ``skip_first`` arms the rule only after that many opportunities at
    its site have passed (skipped opportunities draw no RNG), so "kill
    exactly the Nth shuffle" is expressible deterministically."""

    site: str
    kind: str
    rate: float
    delay_ms: float = 1.0
    max_fires: Optional[int] = None
    skip_first: int = 0

    def __post_init__(self) -> None:
        if self.skip_first < 0:
            raise ValueError(f"skip_first must be >= 0, got "
                             f"{self.skip_first}")
        if self.site not in SITES:
            raise ValueError(f"unknown site {self.site!r}; one of {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; one of {KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")


def _compiling() -> bool:
    """True inside a compiled plan's call (every CUDA-graph capture of
    the port is one): the calls a traced JAX program would make with
    tracers."""
    from ..core.executor import in_compiled_plan
    return in_compiled_plan()


def _bit_flip(a: np.ndarray) -> np.ndarray:
    """Return a copy of ``a`` with one byte bit-flipped (the classic
    storage fault a CRC exists to catch).  Empty arrays pass through —
    nothing to damage."""
    raw = bytearray(a.tobytes())
    if not raw:
        return a
    raw[len(raw) // 2] ^= 0xFF
    return np.frombuffer(bytes(raw), dtype=a.dtype).reshape(a.shape)


class FaultInjector:
    """The seeded chaos harness.  Use as a context manager::

        specs = [FaultSpec("shuffle", "crash", rate=0.2)]
        with FaultInjector(specs, seed=7) as inj:
            out, stats, ovf, rec = resilient_cascade_query(...)
        assert inj.fired[("shuffle", "crash")] > 0

    ``install()`` registers the injector as the fault hook of every
    instrumented module and as the process-wide active injector (for
    the ``reducer`` site recovery.py drives itself); ``uninstall()``
    restores the clean hooks.  Counters: ``observed[site]`` is how many
    opportunities each site offered, ``fired[(site, kind)]`` how many
    faults actually fired.
    """

    def __init__(self, specs: Iterable[FaultSpec], seed: int = 0):
        self.specs: List[FaultSpec] = list(specs)
        self.seed = int(seed)
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)
        self._rng = np.random.default_rng(self.seed)
        self._fires_left: Dict[int, Optional[int]] = {
            i: s.max_fires for i, s in enumerate(self.specs)}
        self._skips_left: Dict[int, int] = {
            i: s.skip_first for i, s in enumerate(self.specs)}
        self.observed: Counter = Counter()
        self.fired: Counter = Counter()
        self._installed = False

    # -- the hook ----------------------------------------------------------

    def __call__(self, site: str, payload: Any = None) -> Any:
        rules = self._by_site.get(site)
        if not rules:
            return payload
        if _compiling():
            # Inside a compiled plan: never fire, never consume RNG state.
            return payload
        self.observed[site] += 1
        for i, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if self._skips_left[i] > 0:
                self._skips_left[i] -= 1
                continue
            left = self._fires_left[i]
            if left is not None and left <= 0:
                continue
            if float(self._rng.random()) >= spec.rate:
                continue
            if left is not None:
                self._fires_left[i] = left - 1
            self.fired[(site, spec.kind)] += 1
            if spec.kind == "crash":
                raise InjectedCrash(site)
            if spec.kind == "delay":
                time.sleep(spec.delay_ms * 1e-3)
                continue
            # corrupt
            payload = self._corrupt(site, payload)
        return payload

    def _corrupt(self, site: str, payload: Any) -> Any:
        """Damage the payload.  Real byte damage where the caller
        verifies CRCs (numpy arrays from storage); a detected-transport
        fault (:class:`DataCorrupt`) everywhere else — see the module
        docstring's invariant."""
        if isinstance(payload, np.ndarray):
            return _bit_flip(payload)
        if isinstance(payload, dict) and payload and all(
                isinstance(v, np.ndarray) for v in payload.values()):
            name = next(k for k in payload
                        if payload[k].size)  # first non-empty array
            out = dict(payload)
            out[name] = _bit_flip(out[name])
            return out
        raise DataCorrupt(
            f"injected payload corruption detected at site {site!r} "
            f"(checksum mismatch at receive)", detail=site)

    # -- installation ------------------------------------------------------

    def install(self) -> "FaultInjector":
        global _ACTIVE
        from ..checkpoint import store as _ckpt_store
        from ..core import shuffle as _shuffle
        from ..serving import engine as _engine
        _shuffle.set_fault_hook(self)
        _ckpt_store.set_fault_hook(self)
        _engine.set_fault_hook(self)
        _ACTIVE = self
        self._installed = True
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        from ..checkpoint import store as _ckpt_store
        from ..core import shuffle as _shuffle
        from ..serving import engine as _engine
        _shuffle.set_fault_hook(None)
        _ckpt_store.set_fault_hook(None)
        _engine.set_fault_hook(None)
        _ACTIVE = None
        self._installed = False

    def __enter__(self) -> "FaultInjector":
        return self.install()

    def __exit__(self, *exc: Any) -> None:
        self.uninstall()

    def counters(self) -> Dict[str, int]:
        """Flat fire counters for reports: ``"<site>/<kind>" -> n``."""
        return {f"{site}/{kind}": int(n)
                for (site, kind), n in sorted(self.fired.items())}


#: The installed injector (or None) — what :func:`fire` consults.
_ACTIVE: Optional[FaultInjector] = None


def active_injector() -> Optional[FaultInjector]:
    return _ACTIVE


def fire(site: str, payload: Any = None) -> Any:
    """Offer one fault opportunity at ``site`` to the active injector
    (no-op when none is installed).  recovery.py calls this per reducer
    coordinate; the instrumented modules use their own hook variables
    so importing them never imports this package."""
    if _ACTIVE is None:
        return payload
    return _ACTIVE(site, payload)
