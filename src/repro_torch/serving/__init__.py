"""Query serving: plan/executable caching and batched multi-tenant
execution over the join engine.

  QueryEngine / QueryServeConfig   — cached, batching front end over
                                     plan_query + jit_execute_query
  QueryRequest / ServeResult       — the request/response surface
  ServingStats                     — hits, latency percentiles, qps

Chain requests with a current partitioning certificate run map-side
over prebuilt ``PartitionedRelation`` inputs (``submit(rels=...)``).
Not ported yet: ``ServingStore`` (streaming ingest over the partitioned
store, ROADMAP A13) and the LM ``Engine`` / ``ServeConfig`` (A15).
"""

from .engine import (CachedPlan, CircuitOpen, DeadlineExceeded, PlanRejected,
                     QueryEngine, QueryRequest, QueryServeConfig,
                     RequestShed, ServeResult, ServingStats, set_fault_hook,
                     stats_signature, weighted_total)

__all__ = [
    "QueryEngine", "QueryServeConfig", "QueryRequest", "ServeResult",
    "ServingStats", "CachedPlan", "PlanRejected", "RequestShed",
    "DeadlineExceeded", "CircuitOpen", "set_fault_hook", "stats_signature",
    "weighted_total",
]
