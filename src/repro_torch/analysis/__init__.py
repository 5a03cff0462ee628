"""Static analysis: certify a plan before it runs.

The plan checker (:mod:`.plan_verifier`) — grid/budget arithmetic,
capacity pigeonhole floors, cycle-closing filters, int32 pair-index
overflow, partitioning-certificate soundness, and Afrati–Ullman
replication lower bounds with per-plan gap metrics — speaks in
:class:`.report.Finding`\\ s collected into
:class:`.report.VerifierReport`\\ s.  Both modules are copies of the
JAX package's; the query engine runs the checker on every cache miss
when ``QueryServeConfig.verify_plans`` is set.

The recovery-metadata pass (:mod:`.resilience_verifier`,
:func:`verify_recovery_meta`) is a copy too.  Not ported yet (ROADMAP
A14): the bench-target corpus, the jaxpr audit (its checks become
tests over the port's operators) and the ``repro-verify`` command
line.
"""

from .report import (ERROR, WARNING, Finding, VerifierReport,
                     reports_to_json)
from .plan_verifier import (COST_RTOL, GAP_WARN_FACTOR,
                            verify_chain_caps, verify_chain_costs,
                            verify_chain_plan, verify_grid,
                            verify_join_steps, verify_partitioning,
                            verify_query_caps, verify_query_plan,
                            verify_replication_bound)
from .resilience_verifier import verify_recovery_meta

__all__ = [
    "ERROR", "WARNING", "Finding", "VerifierReport", "reports_to_json",
    "COST_RTOL", "GAP_WARN_FACTOR",
    "verify_grid", "verify_join_steps", "verify_chain_caps",
    "verify_query_caps", "verify_partitioning",
    "verify_replication_bound", "verify_chain_costs",
    "verify_chain_plan", "verify_query_plan", "verify_recovery_meta",
]
