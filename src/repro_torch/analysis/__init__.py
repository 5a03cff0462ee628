"""Static analysis: certify every plan before it runs.

The port of ``src/repro/analysis/``, three passes over the planner's
output and the executor's lowerings:

1. **Plan checker** (:mod:`.plan_verifier`, a copy of the JAX
   package's) — grid/budget arithmetic, capacity pigeonhole floors,
   cycle-closing filters, int32 pair-index overflow,
   partitioning-certificate soundness, and Afrati–Ullman replication
   lower bounds with per-plan gap metrics.  The query engine runs it
   on every cache miss when ``QueryServeConfig.verify_plans`` is set.
2. **Op audit** (:mod:`.op_audit`, the counterpart of the JAX
   package's jaxpr audit) — every lowering run at a tiny size under a
   dispatch mode that walks its aten ops for key-dtype narrowing,
   float count accumulation, donation violations, and
   ``jit_execute_*`` cache-key coverage; and, on a ``ShardGrid`` rank,
   its collectives (``audit_collectives``: no full-relation gather).
3. **Recovery metadata** (:mod:`.resilience_verifier`, a copy) — every
   non-final hop of a resilient plan has a recovery point.

``python -m repro_torch.analysis.cli`` (:mod:`.cli`) drives passes 1–3
over the bench corpus (:mod:`.bench_targets`, a copy: the plans the
port's benchmarks run); findings are :class:`.report.Finding`\\ s in
:class:`.report.VerifierReport`\\ s.
"""

from .report import (ERROR, WARNING, Finding, VerifierReport,
                     reports_to_json)
from .plan_verifier import (COST_RTOL, GAP_WARN_FACTOR,
                            verify_chain_caps, verify_chain_costs,
                            verify_chain_plan, verify_grid,
                            verify_join_steps, verify_partitioning,
                            verify_query_caps, verify_query_plan,
                            verify_replication_bound)
from .bench_targets import BenchTarget, TARGET_BUILDERS, all_bench_targets
from .op_audit import (audit_collectives, audit_donation, audit_jit_cache,
                       audit_lowerings, audit_run)
from .resilience_verifier import verify_recovery_meta
from .cli import main as verify_main, verify_bench_targets

__all__ = [
    "ERROR", "WARNING", "Finding", "VerifierReport", "reports_to_json",
    "COST_RTOL", "GAP_WARN_FACTOR",
    "verify_grid", "verify_join_steps", "verify_chain_caps",
    "verify_query_caps", "verify_partitioning",
    "verify_replication_bound", "verify_chain_costs",
    "verify_chain_plan", "verify_query_plan",
    "BenchTarget", "TARGET_BUILDERS", "all_bench_targets",
    "audit_run", "audit_collectives", "audit_donation", "audit_jit_cache",
    "audit_lowerings",
    "verify_recovery_meta", "verify_main", "verify_bench_targets",
]
