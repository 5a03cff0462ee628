"""Resilient execution: deterministic fault injection and
lineage-based recovery for the join engine.

Port of ``src/repro/resilience/``.  ``faults`` is the seeded chaos
harness (install a :class:`FaultInjector` over the instrumented sites);
``recovery`` holds the resilient executors — hop-granular cascade
recovery with CRC-verified materialized intermediates,
reducer-granular one-round recovery, retried partition reads — plus
the :class:`RecoveryPolicy` / :class:`RecoveryMeta` the static
verifier pass (:func:`repro_torch.analysis.verify_recovery_meta`)
checks for coverage.  Host-driven by design; nothing here runs inside
a compiled plan, and no fault fires inside one.
"""

from .faults import (KINDS, SITES, DataCorrupt, FaultInjector, FaultSpec,
                     HopFailed, InjectedCrash, active_injector, fire)
from .recovery import (RecoveryMeta, RecoveryPolicy, RecoveryReport,
                       recovery_meta_for, resilient_cascade_query,
                       resilient_load_partitioned, resilient_one_round_query)

__all__ = [
    "SITES", "KINDS", "FaultSpec", "FaultInjector", "InjectedCrash",
    "HopFailed", "DataCorrupt", "fire", "active_injector",
    "RecoveryPolicy", "RecoveryMeta", "RecoveryReport", "recovery_meta_for",
    "resilient_cascade_query", "resilient_one_round_query",
    "resilient_load_partitioned",
]
