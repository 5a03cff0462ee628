"""Serving: the LM engine, and plan/executable caching and batched
multi-tenant execution over the join engine.

  Engine / ServeConfig             — LM prefill + decode with a static
                                     KV cache (greedy or sampled)
  QueryEngine / QueryServeConfig   — cached, batching front end over
                                     plan_query + jit_execute_query
  QueryRequest / ServeResult       — the request/response surface
  ServingStats                     — hits, latency percentiles, qps,
                                     delta-vs-recompute savings
  ServingStore / StandingAggregate — durable edges + delta-maintained
                                     triangle / path counts (streaming
                                     ingest over the partitioned store)

Chain requests with a current partitioning certificate run map-side
over prebuilt ``PartitionedRelation`` inputs (``submit(rels=...)``).
"""

from .engine import (CachedPlan, CircuitOpen, DeadlineExceeded, Engine,
                     PlanRejected, QueryEngine, QueryRequest, QueryServeConfig,
                     RequestShed, ServeConfig, ServeResult, ServingStats,
                     set_fault_hook, stats_signature, weighted_total)
from .store import (IngestError, ServingStore, StandingAggregate,
                    delta_terms)

__all__ = [
    "Engine", "ServeConfig",
    "QueryEngine", "QueryServeConfig", "QueryRequest", "ServeResult",
    "ServingStats", "CachedPlan", "PlanRejected", "RequestShed",
    "DeadlineExceeded", "CircuitOpen", "set_fault_hook", "stats_signature",
    "weighted_total",
    "ServingStore", "StandingAggregate", "IngestError", "delta_terms",
]
