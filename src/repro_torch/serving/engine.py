"""Serving: the LM engine and the query-serving engine.

Port of ``src/repro/serving/engine.py``.  Two front ends live here:

* :class:`Engine` — batched LM prefill + decode with a static KV cache
  (``Model.decode_step`` handles both phases: prefill is one call with
  S = prompt length at pos 0, decode is S = 1 calls at advancing pos;
  sampling is greedy or temperature-based, batched).  Eager: a decode
  step is the layers' launches, the cache written in place.

* :class:`QueryEngine` — the query-serving front end over the join
  engine.

Production query serving re-answers the same query *shapes*
continuously; planning (``plan_query``) and capture
(``jit_execute_query``: the whole plan as one CUDA graph on the GPU)
are the per-request costs worth amortizing, so the engine keeps a
bounded LRU **plan-and-executable cache** keyed on

    (query structure, stats-sketch signature, caps, strategy,
     join order, partitioning certificate, key dtype, k, join_impl)

— the key discipline of the executor's own ``jit_execute_*`` cache:
identical resubmission must hit, every option flip must miss.
Concurrent same-shape requests with different parameters batch through
one execution of the cached plan over ``SimGrid(grid_shape, lanes=L)``
(the JAX engine's ``jax.vmap``): one graph replay on the card for the
whole group.  A poisoned request in a batch fails alone (its input-prep
error or per-lane overflow flag never touches co-batched lanes).
:class:`ServingStats` surfaces cache hits/misses/evictions, p50/p99
latency, and throughput.

Both engines' devices are explicit: an ``Engine`` runs where its
parameters lie (``Model.init`` puts them on the GPU unless asked for
another device); ``QueryEngine(cfg, device=None)``
builds every input on the GPU unless the caller asks for another
device (``device="cpu"`` runs the plain versions of the kernels).  A
chain request with a current partitioning certificate runs the map-side
cascade over prebuilt
:class:`~repro_torch.core.partition.PartitionedRelation` inputs; one
whose certificate is stale degrades to the shuffle cascade, its
prebuilt partitions flattened back.  Streaming ingest
(:class:`~repro_torch.serving.store.ServingStore`) runs its delta terms
through this engine.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import config
from ..core import (ChainQuery, JoinQuery, SimGrid, default_chain_caps,
                    default_mapside_caps, default_query_caps, integer_shares,
                    jit_execute_chain, jit_execute_query, plan_chain,
                    plan_query, query_stats_exact, scatter_to_grid)
from ..core.cost_model import ChainPartitioning, ChainStats, QueryStats
from ..core.executor import ChainCaps, CompiledPlan, input_signature
from ..core.partition import PartitionedRelation
from ..core.relation import Relation
from ..distributed.sharding import Planner
from ..models.params import zeros_of

AnyStats = Union[QueryStats, ChainStats]


# ---------------------------------------------------------------------------
# LM serving
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    temperature: float = 0.0       # 0 => greedy
    seed: int = 0


class Engine:
    """Generate tokens from a model of ``repro_torch.models.lm`` and its
    parameters, on the parameters' device."""

    def __init__(self, model, params, serve_cfg: ServeConfig,
                 planner: Optional[Planner] = None):
        self.model = model
        self.params = params
        self.cfg = serve_cfg
        self.planner = planner or Planner.null()
        self.device = params["embedding"].device

    def _step(self, params, cache, tokens, pos: int):
        return self.model.decode_step(params, cache, tokens, pos,
                                      self.planner)

    def _sample(self, logits: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        logits = logits[:, -1, :self.model.cfg.vocab_size].float()
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # Not the reference's jax.random.categorical stream: the same
        # distribution, drawn from a torch.Generator (ROADMAP C7).
        probs = torch.softmax(logits / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, n_new: int,
                 ) -> Tuple[np.ndarray, Dict[str, float]]:
        """prompts: (B, P) int32.  Returns (B, n_new) generated tokens."""
        B, P = prompts.shape
        if n_new < 0:
            raise ValueError(f"n_new must be >= 0, got {n_new}")
        if P + n_new > self.cfg.max_len:
            raise ValueError(
                f"prompt length {P} + n_new {n_new} exceeds the static KV "
                f"cache (max_len {self.cfg.max_len})")
        if n_new == 0:
            return (np.zeros((B, 0), np.int32),
                    {"prompt_len": float(P), "generated": 0.0})
        cache = zeros_of(self.model.cache_defs(B, self.cfg.max_len),
                         device=self.device)
        gen = None
        if self.cfg.temperature > 0.0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cfg.seed)

        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                 device=self.device)
        logits, cache = self._step(self.params, cache, tokens, 0)
        tok = self._sample(logits, gen)
        out = [tok]
        pos = P
        for _ in range(n_new - 1):
            logits, cache = self._step(self.params, cache, tok[:, None], pos)
            tok = self._sample(logits, gen)
            out.append(tok)
            pos += 1
        gen_tokens = torch.stack(out, dim=1).cpu().numpy()
        return gen_tokens, {"prompt_len": float(P), "generated": float(n_new)}


# ---------------------------------------------------------------------------
# Fault-injection hook
# ---------------------------------------------------------------------------

#: When a fault injector is installed, every request entering the
#: engine offers it a fault opportunity at the "submit" site (crash =
#: the request died in transit, corrupt = a transport checksum
#: mismatch): ``hook(site, payload)`` returns the payload or raises.
#: ``None`` (the default) costs one attribute read per submission.
_fault_hook = None


def set_fault_hook(hook) -> None:
    """Install (or, with ``None``, remove) the module's fault hook."""
    global _fault_hook
    _fault_hook = hook


def _inject(site: str, payload):
    if _fault_hook is None:
        return payload
    return _fault_hook(site, payload)


def stats_signature(stats: Any) -> Any:
    """Hashable signature of a statistics object: every numeric field,
    recursively, as nested tuples.  Two statistics objects share a
    signature iff they describe the same cardinality profile — the
    planner is a pure function of (query, signature, k, certificate),
    which is what makes the signature a sound plan-cache key
    component."""
    if dataclasses.is_dataclass(stats) and not isinstance(stats, type):
        return (type(stats).__name__,) + tuple(
            (f.name, stats_signature(getattr(stats, f.name)))
            for f in dataclasses.fields(stats))
    if isinstance(stats, dict):
        return tuple(sorted((k, stats_signature(v)) for k, v in stats.items()))
    if isinstance(stats, (tuple, list)):
        return tuple(stats_signature(v) for v in stats)
    return stats


def weighted_total(query: JoinQuery, out: Relation) -> float:
    """Σ over valid output rows of ∏ value columns.

    With unit weights this is the plain result count; with signed ±1
    delta weights it is the multilinear term the incremental
    maintenance cascade sums — deletions flow through the join as −1
    factors, no special-casing.  Each row's product is float32, as in
    the JAX package; the sum runs in float64, so a count stays exact
    past 2^24 rows (a graph's 3-paths at R-MAT scale 14)."""
    w = torch.ones_like(out.valid, dtype=torch.float32)
    for v in query.values:
        if v is not None:
            w = w * out.cols[v]
    return float(torch.where(out.valid, w, torch.zeros_like(w)).sum(
        dtype=torch.float64))


class PlanRejected(RuntimeError):
    """The static verifier refused to certify a plan the engine was
    about to cache (``QueryServeConfig.verify_plans``).  Carries the
    :class:`~repro_torch.analysis.report.VerifierReport`."""

    def __init__(self, report: Any):
        super().__init__(report.summary())
        self.report = report


class RequestShed(RuntimeError):
    """Admission control refused the request *before* doing any work —
    the queue bound was hit or the engine is over its latency SLO.  A
    typed, retryable rejection: the client saw no partial answer."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline elapsed — during admission, planning, or
    execution.  Any computed result is discarded (never a partial or
    stale answer)."""


class CircuitOpen(RuntimeError):
    """The plan/compile circuit breaker is open after repeated
    :class:`PlanRejected`/compile failures: cache *misses* fail fast
    instead of burning planning work that keeps failing.  Cache hits
    are still served."""


@dataclasses.dataclass(frozen=True)
class QueryServeConfig:
    """Engine-wide serving knobs.

    k:              reducer budget handed to the planner on every miss.
    cache_capacity: bounded LRU size — the (plan, executable) entries.
    caps_slack:     slack factor for derived ChainCaps.
    join_impl:      reduce-side kernel, as everywhere in the executor.
    verify_plans:   run the static plan verifier on every cache miss
                    and refuse to cache a rejected plan
                    (:class:`PlanRejected`).
    quantize_caps:  round derived capacities up to the next power of
                    two, so small cardinality drift between otherwise
                    identical requests lands on the same executable
                    instead of recapturing.  Explicit request caps are
                    quantized the same way (the cache key pins the
                    *requested* caps, pre-quantization).

    Admission control (all off by default):

    max_queue:      bound on requests admitted per ``submit_many``
                    call (the synchronous engine's request queue);
                    excess requests shed with a typed
                    :class:`RequestShed` instead of growing latency
                    unboundedly.
    deadline_ms:    default per-request deadline; elapsed during
                    admission, planning, or execution =>
                    :class:`DeadlineExceeded` (any computed result is
                    discarded, never returned late).
    slo_ms:         latency SLO — when the mean of the last
                    ``shed_window`` executed-request latencies exceeds
                    it, new requests shed until the window recovers
                    (every ``shed_window``-th request is admitted as a
                    probe so recovery is observable).
    breaker_threshold / breaker_cooldown: the plan/compile circuit
                    breaker opens after ``threshold`` consecutive
                    build failures; while open, cache misses fail fast
                    (:class:`CircuitOpen`).  After ``cooldown``
                    fast-failures one half-open probe build is allowed
                    — success closes the breaker, failure reopens it.
    submit_retries: transient submit-site faults (a crashed or
                    corrupted request in transit) are retried this many
                    times within the deadline before surfacing as a
                    typed fault error.
    """

    k: int = 8
    cache_capacity: int = 64
    caps_slack: int = 8
    join_impl: str = "sort_merge"
    verify_plans: bool = False
    quantize_caps: bool = True
    max_queue: Optional[int] = None
    deadline_ms: Optional[float] = None
    slo_ms: Optional[float] = None
    shed_window: int = 16
    breaker_threshold: int = 3
    breaker_cooldown: int = 8
    submit_retries: int = 2


@dataclasses.dataclass
class ServingStats:
    """Counters and latency surface of one :class:`QueryEngine`.

    ``delta_tuples`` / ``recompute_tuples`` are the streaming ingest
    store's (:class:`~repro_torch.serving.store.ServingStore`): tuples
    its delta cascades moved against those the avoided recomputes would
    have moved."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    queries: int = 0
    batches: int = 0
    errors: int = 0
    shed: int = 0
    deadline_exceeded: int = 0
    circuit_open: int = 0
    degraded: int = 0
    fault_retries: int = 0
    delta_tuples: float = 0.0
    recompute_tuples: float = 0.0
    latencies_ms: List[float] = dataclasses.field(default_factory=list)
    started_at: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def latency_percentile(self, q: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), q))

    def snapshot(self) -> Dict[str, float]:
        """One flat dict for reports.  Latency/throughput keys avoid
        the pinned accounting names (read/shuffled/max_bucket_load/
        total) on purpose: wall-clock numbers must never land under the
        bit-identical tuple-count gate."""
        elapsed = max(time.perf_counter() - self.started_at, 1e-9)
        return {
            "cache_hits": float(self.hits),
            "cache_misses": float(self.misses),
            "cache_evictions": float(self.evictions),
            "hit_rate": self.hit_rate,
            "queries": float(self.queries),
            "batches": float(self.batches),
            "errors": float(self.errors),
            "p50_ms": self.latency_percentile(50),
            "p99_ms": self.latency_percentile(99),
            "qps": self.queries / elapsed,
            "shed": float(self.shed),
            "deadline_exceeded": float(self.deadline_exceeded),
            "circuit_open": float(self.circuit_open),
            "degraded": float(self.degraded),
            "fault_retries": float(self.fault_retries),
            "delta_tuples": self.delta_tuples,
            "recompute_tuples": self.recompute_tuples,
        }


@dataclasses.dataclass
class QueryRequest:
    """One tenant's submission.

    tables[j] is relation j's column tuple — key columns matching the
    query's attribute tuple, plus an optional trailing float value
    column (signed delta weights ride here).  ``capacities[j]`` pads
    relation j to a fixed capacity (invalid rows — they never join and
    never count), so differently-sized parameters of the same shape
    share one executable.  ``stats`` should be passed whenever known:
    without it the engine computes exact statistics on the host per
    submission, which is the cost serving exists to avoid."""

    query: JoinQuery
    tables: Sequence[Tuple[Any, ...]]
    stats: Optional[AnyStats] = None
    caps: Optional[ChainCaps] = None
    strategy: Optional[str] = None
    join_order: Optional[Tuple[int, ...]] = None
    partitioning: Optional[ChainPartitioning] = None
    capacities: Optional[Sequence[Optional[int]]] = None
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class ServeResult:
    """Per-request outcome.  ``ok`` is False for a poisoned request
    (input-prep error, rejected plan, or buffer overflow) — co-batched
    requests are unaffected either way.

    ``error_kind`` types the failure for clients: ``"shed"`` /
    ``"deadline"`` / ``"circuit"`` / ``"fault"`` (admission control and
    injected transport faults) or ``"error"`` (planning/input errors,
    overflow).  ``degraded`` names a graceful degradation the answer
    took (``"stale_certificate"`` — the map-side certificate no longer
    applies, so the request ran the shuffle cascade instead); the
    answer itself is still exact."""

    ok: bool
    cache_hit: bool
    latency_ms: float
    output: Optional[Relation] = None
    measured: Optional[Dict[str, float]] = None
    overflow: bool = False
    plan: Any = None
    error: Optional[str] = None
    error_kind: Optional[str] = None
    degraded: Optional[str] = None


@dataclasses.dataclass
class CachedPlan:
    """One LRU entry: the resolved physical plan and its executable
    (``run``).  ``run`` comes out of the executor's program cache, so
    two entries whose physical parameters coincide (same grid shape,
    strategy, caps, options) hold the *same* executable — the engine
    batches across such entries by ``run`` identity."""

    plan: Any
    strategy: str
    grid_shape: Tuple[int, ...]
    join_order: Optional[Tuple[int, ...]]
    caps: ChainCaps
    run: CompiledPlan
    chain_exec: bool = False
    exec_opts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    report: Any = None
    degraded: Optional[str] = None


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n) - 1).bit_length()


def _stack(rels: Sequence[Tuple[Any, ...]]) -> Tuple[Any, ...]:
    """The members' inputs on a new leading lane axis, relation by
    relation; partitioned inputs stack their parts to (L, P, cap) under
    the one spec their group shares (a group's inputs share their
    executor signature: shapes, dtypes, specs)."""
    def stack(members):
        first = members[0]
        if isinstance(first, PartitionedRelation):
            return PartitionedRelation(stack([m.parts for m in members]),
                                       first.spec)
        return Relation({n: torch.stack([m.cols[n] for m in members])
                         for n in first.cols},
                        torch.stack([m.valid for m in members]))
    return tuple(stack([m[j] for m in rels]) for j in range(len(rels[0])))


class QueryEngine:
    """Multi-tenant query-serving front end over the join engine.

    ``submit`` answers one query; ``submit_many`` answers a micro-batch,
    grouping same-key same-shape requests through one laned execution.
    Repeat shapes skip ``plan_query`` *and* capture: the first
    submission of a shape plans, (optionally) verifies, and compiles;
    every later submission is a cache hit that goes straight to the
    executable.  ``device`` defaults to the GPU
    (:func:`repro_torch.config.resolve_device`).
    """

    def __init__(self, cfg: Optional[QueryServeConfig] = None, device=None):
        self.cfg = cfg or QueryServeConfig()
        self.device = config.resolve_device(device)
        self._cache: "collections.OrderedDict[Tuple, CachedPlan]" = \
            collections.OrderedDict()
        self.stats = ServingStats()
        # Admission-control state: consecutive build failures (circuit
        # breaker), fast-failures since it opened (half-open probing),
        # and the SLO probe counter (shed trickle).
        self._breaker_failures = 0
        self._breaker_fastfails = 0
        self._slo_probe = 0

    # -- cache ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._cache)

    def cached_keys(self) -> List[Tuple]:
        """LRU order, oldest first (introspection / tests)."""
        return list(self._cache)

    def cache_key(self, query: JoinQuery, stats: AnyStats,
                  caps: Optional[ChainCaps] = None, *,
                  strategy: Optional[str] = None,
                  join_order: Optional[Tuple[int, ...]] = None,
                  partitioning: Optional[ChainPartitioning] = None,
                  key_dtype: Optional[str] = None) -> Tuple:
        """The plan-cache key.  ``None`` option values mean "planner's
        choice" and are part of the key as such: the planner is
        deterministic in (query, stats signature, k, certificate), so
        two None-strategy submissions with equal signatures resolve to
        the same physical plan.  ``key_dtype`` defaults to the process
        key dtype (``repro_torch.config.key_dtype_name()``): a cache
        minted under 32-bit keys can never serve a 64-bit process."""
        key_dtype = config.key_dtype_name() if key_dtype is None else key_dtype
        return (query, stats_signature(stats), caps, strategy,
                None if join_order is None else tuple(join_order),
                partitioning, key_dtype, self.cfg.k, self.cfg.join_impl)

    def _lookup(self, key: Tuple) -> Optional[CachedPlan]:
        entry = self._cache.get(key)
        if entry is None:
            self.stats.misses += 1
            return None
        self._cache.move_to_end(key)
        self.stats.hits += 1
        return entry

    def _insert(self, key: Tuple, entry: CachedPlan) -> None:
        self._cache[key] = entry
        self._cache.move_to_end(key)
        while len(self._cache) > self.cfg.cache_capacity:
            self._cache.popitem(last=False)
            self.stats.evictions += 1

    def _quantize(self, caps: ChainCaps) -> ChainCaps:
        if not self.cfg.quantize_caps:
            return caps
        opt = lambda v: None if v is None else _pow2(v)  # noqa: E731
        return ChainCaps(recv=_pow2(caps.recv), mid=_pow2(caps.mid),
                         out=_pow2(caps.out), local=opt(caps.local),
                         agg=opt(caps.agg), join=opt(caps.join))

    # -- planning (cache misses only) -------------------------------------

    def _verify(self, kind: str, query: JoinQuery, stats: AnyStats,
                plan: Any, caps: ChainCaps, specs: Any = None) -> Any:
        from ..analysis import verify_chain_plan, verify_query_plan
        if kind == "chain":
            report = verify_chain_plan(query, stats, plan, caps, specs=specs,
                                       target="serving")
        else:
            report = verify_query_plan(query, stats, plan, caps,
                                       target="serving")
        if not report.ok:
            raise PlanRejected(report)
        return report

    def _build_entry(self, req: QueryRequest, stats: AnyStats) -> CachedPlan:
        """The miss path: plan, size caps, (optionally) verify, and
        compile one executable for the resolved configuration."""
        query = req.query
        if req.partitioning is not None:
            return self._build_chain_entry(req, stats)
        if not isinstance(stats, QueryStats):
            raise ValueError("submit() needs QueryStats (query_stats_exact); "
                             "ChainStats only pair with a partitioning "
                             "certificate on a ChainQuery")
        plan = plan_query(query, stats, self.cfg.k)
        strategy = req.strategy or plan.strategy
        if strategy in ("shares_skew", "mapside"):
            # SharesSkew runs per-combination grids and map-side needs
            # stored partitions; neither fits the generic laned serving
            # path — fall back to the cascade, which every query
            # supports.
            strategy = "cascade"
        n = query.n_relations
        suffix = "A" if query.aggregate is not None else ""
        grid_shape = plan.grid_shape if strategy == "one_round" \
            else (self.cfg.k,)
        if req.join_order is not None:
            join_order = tuple(req.join_order)
        elif strategy.startswith("cascade") and plan.strategy == "one_round":
            # The one-round winner carries the DEFAULT order (order is
            # irrelevant on the hypercube); a forced cascade must pick
            # the cheapest left-deep order itself.
            join_order = tuple(stats.best_order()[0])
        else:
            join_order = tuple(plan.join_order)
        caps = self._quantize(
            req.caps if req.caps is not None
            else default_query_caps(query, stats, grid_shape,
                                    slack=self.cfg.caps_slack))
        alg = {"one_round": f"1,{n}J{suffix}",
               "cascade": f"{n - 1},{n}J{suffix}",
               "cascade_pushdown": f"{n - 1},{n}JA"}.get(strategy,
                                                         plan.algorithm)
        exec_plan = dataclasses.replace(
            plan, algorithm=alg, strategy=strategy, grid_shape=grid_shape,
            join_order=join_order,
            costs={**plan.costs, alg: plan.costs.get(alg, plan.predicted_cost)})
        report = None
        if self.cfg.verify_plans:
            report = self._verify("query", query, stats, exec_plan, caps)
        opts = dict(join_order=join_order, join_impl=self.cfg.join_impl)
        run = jit_execute_query(SimGrid(grid_shape), query,
                                strategy=strategy, caps=caps, donate=False,
                                **opts)
        return CachedPlan(plan=exec_plan, strategy=strategy,
                          grid_shape=grid_shape, join_order=join_order,
                          caps=caps, run=run, report=report)

    def _build_chain_entry(self, req: QueryRequest,
                           stats: AnyStats) -> CachedPlan:
        """Chain queries with a partitioning certificate: plan with the
        certificate so the map-side candidate is priced, execute
        through the chain surface."""
        query = req.query
        cstats = stats.chain if isinstance(stats, QueryStats) else stats
        if not isinstance(query, ChainQuery) or cstats is None:
            raise ValueError("a partitioning certificate needs a ChainQuery "
                             "with chain statistics")
        part = req.partitioning
        plan = plan_chain(cstats, self.cfg.k,
                          aggregate=query.aggregate is not None,
                          partitioning=part)
        strategy = req.strategy or plan.strategy
        if strategy == "shares_skew":
            strategy = "cascade"
        degraded = None
        if (strategy == "mapside" and part.key_dtype is not None
                and part.key_dtype != config.key_dtype_name()):
            # Graceful degradation: the stored layout was partitioned
            # under a different key dtype, so the co-partitioning
            # certificate proves nothing here.  Instead of failing the
            # request, serve it through the shuffle cascade (exact, just
            # slower) and say so in the result.
            strategy = "cascade"
            degraded = "stale_certificate"
            self.stats.degraded += 1
        n = query.n_relations
        suffix = "A" if query.aggregate is not None else ""
        opts: Dict[str, Any] = {"join_impl": self.cfg.join_impl}
        if strategy == "mapside":
            grid_shape: Tuple[int, ...] = (part.num_partitions,)
            caps = self._quantize(
                req.caps if req.caps is not None
                else default_mapside_caps(cstats, part.num_partitions,
                                          slack=self.cfg.caps_slack))
            opts.update(partitioning=part, hop_modes=plan.hop_modes,
                        place_output=True)
        elif strategy == "one_round":
            grid_shape = (plan.grid_shape if plan.strategy == "one_round"
                          else tuple(integer_shares(cstats.sizes,
                                                    self.cfg.k)))
            caps = self._quantize(
                req.caps if req.caps is not None
                else default_chain_caps(cstats, grid_shape,
                                        slack=self.cfg.caps_slack))
        else:
            grid_shape = (self.cfg.k,)
            caps = self._quantize(
                req.caps if req.caps is not None
                else default_chain_caps(cstats, grid_shape,
                                        slack=self.cfg.caps_slack))
        # Forcing a strategy re-derives the dependent plan fields so the
        # stored plan stays self-consistent (the verifier checks them).
        alg = {"one_round": f"1,{n}J{suffix}",
               "cascade": f"{n - 1},{n}J{suffix}",
               "cascade_pushdown": f"{n - 1},{n}JA",
               "mapside": f"MS,{n}J{suffix}"}.get(strategy, plan.algorithm)
        exec_plan = dataclasses.replace(
            plan, algorithm=alg, strategy=strategy, grid_shape=grid_shape,
            costs={**plan.costs, alg: plan.costs.get(alg,
                                                     plan.predicted_cost)})
        report = None
        if self.cfg.verify_plans:
            report = self._verify("chain", query, cstats, exec_plan, caps)
        run = jit_execute_chain(SimGrid(grid_shape), query,
                                strategy=strategy, caps=caps, donate=False,
                                **opts)
        return CachedPlan(plan=exec_plan, strategy=strategy,
                          grid_shape=grid_shape, join_order=None, caps=caps,
                          run=run, chain_exec=True, exec_opts=opts,
                          report=report, degraded=degraded)

    def _resolve(self, req: QueryRequest) -> Tuple[Tuple, CachedPlan, bool]:
        stats = req.stats
        if stats is None:
            arities = [len(r) for r in req.query.relations]
            stats = query_stats_exact(
                req.query, [tuple(t[:a]) for t, a in zip(req.tables, arities)])
        key = self.cache_key(req.query, stats, req.caps,
                             strategy=req.strategy, join_order=req.join_order,
                             partitioning=req.partitioning)
        entry = self._lookup(key)
        if entry is not None:
            return key, entry, True
        if self._breaker_is_open():
            raise CircuitOpen(
                f"plan/compile circuit breaker open after "
                f"{self._breaker_failures} consecutive build failures; "
                f"cache misses fail fast (hits still serve)")
        try:
            entry = self._build_entry(dataclasses.replace(req, stats=stats),
                                      stats)
        except Exception:
            self._breaker_failures += 1
            raise
        self._insert(key, entry)
        return key, entry, False

    def _breaker_is_open(self) -> bool:
        """Consult (and advance) the plan/compile circuit breaker.
        After ``breaker_cooldown`` fast-failures one half-open probe
        build is let through — it closes the breaker on success and
        reopens it on failure."""
        if self._breaker_failures < self.cfg.breaker_threshold:
            return False
        self._breaker_fastfails += 1
        if self._breaker_fastfails > self.cfg.breaker_cooldown:
            self._breaker_fastfails = 0
            return False                       # half-open probe
        return True

    def _should_shed(self) -> bool:
        """Latency-SLO load shedding: shed when the trailing
        ``shed_window`` executed-request latencies average over
        ``slo_ms``, letting every ``shed_window``-th request through as
        a probe so the window can recover."""
        if self.cfg.slo_ms is None:
            return False
        window = self.stats.latencies_ms[-self.cfg.shed_window:]
        if len(window) < self.cfg.shed_window:
            return False
        if float(np.mean(window)) <= self.cfg.slo_ms:
            return False
        self._slo_probe += 1
        if self._slo_probe >= self.cfg.shed_window:
            self._slo_probe = 0
            return False                       # probe trickle
        return True

    def _admit(self, req: QueryRequest, t0: float,
               deadline: Optional[float]) -> None:
        """Offer the submit-site fault opportunity, retrying transient
        faults within the deadline (a crashed/corrupted request in
        transit is resubmitted, not failed)."""
        retries = max(self.cfg.submit_retries, 0)
        for attempt in range(retries + 1):
            try:
                _inject("submit", req)
                return
            except Exception as e:
                if (deadline is not None
                        and (time.perf_counter() - t0) * 1e3 > deadline):
                    raise DeadlineExceeded(
                        f"deadline {deadline:g} ms elapsed while retrying "
                        f"a submit-site fault") from e
                if attempt == retries:
                    raise
                self.stats.fault_retries += 1

    def _reject(self, t0: float, kind: str, exc: BaseException) -> ServeResult:
        dt = (time.perf_counter() - t0) * 1e3
        self.stats.queries += 1
        self.stats.errors += 1
        if kind == "shed":
            self.stats.shed += 1
        elif kind == "deadline":
            self.stats.deadline_exceeded += 1
        elif kind == "circuit":
            self.stats.circuit_open += 1
        return ServeResult(ok=False, cache_hit=False, latency_ms=dt,
                           error=f"{type(exc).__name__}: {exc}",
                           error_kind=kind)

    # -- input preparation -------------------------------------------------

    def _prep_inputs(self, req: QueryRequest,
                     grid_shape: Tuple[int, ...]) -> Tuple[Relation, ...]:
        """Column tables -> scattered per-relation inputs named by the
        query schema, on the engine's device, padded to ``capacities``
        with invalid rows (the generalization of ``query_table_inputs``
        the fixed-capacity serving path needs)."""
        query = req.query
        key_dtype = config.default_key_dtype()
        if len(req.tables) != query.n_relations:
            raise ValueError(f"{query.n_relations} relations need "
                             f"{query.n_relations} tables, got "
                             f"{len(req.tables)}")
        rels = []
        for j, cols in enumerate(req.tables):
            names = query.schema(j)
            arity = len(query.relations[j])
            if len(cols) not in (arity, len(names)):
                raise ValueError(f"relation {j} needs {arity} key columns "
                                 f"(+ optional value), got {len(cols)}")
            arrays = {names[i]: torch.as_tensor(np.asarray(c),
                                                dtype=key_dtype,
                                                device=self.device)
                      for i, c in enumerate(cols[:arity])}
            if query.values[j] is not None:
                val = (torch.as_tensor(np.asarray(cols[arity]),
                                       dtype=torch.float32,
                                       device=self.device)
                       if len(cols) > arity
                       else torch.ones_like(arrays[names[0]],
                                            dtype=torch.float32))
                arrays[query.values[j]] = val
            cap = None if req.capacities is None else req.capacities[j]
            rels.append(scatter_to_grid(Relation.from_arrays(cap, **arrays),
                                        grid_shape))
        return tuple(rels)

    # -- submission --------------------------------------------------------

    def submit(self, query: JoinQuery, tables: Sequence[Tuple[Any, ...]]
               = (), *, rels: Optional[Sequence[Any]] = None,
               **opts: Any) -> ServeResult:
        """Answer one query.  ``rels`` bypasses table preparation with
        pre-built relation inputs, already scattered onto the plan's
        grid, or stored :class:`PartitionedRelation` inputs — the
        map-side path.  Remaining keywords populate
        :class:`QueryRequest`."""
        req = QueryRequest(query=query, tables=tables, **opts)
        return self.submit_many([req], prebuilt=[rels])[0]

    def submit_many(self, requests: Sequence[QueryRequest],
                    prebuilt: Optional[Sequence[Optional[Sequence[Any]]]]
                    = None) -> List[ServeResult]:
        """Serve a micro-batch.  Requests that resolve to the same
        *executable* (by ``run`` identity — distinct tenants with
        distinct statistics still coincide whenever their physical
        plans do) and the same input shapes run as ONE laned execution;
        each lane keeps its own measured stats and overflow flag, so a
        poisoned lane (overflow) or a request that fails before
        execution (bad tables, rejected plan) never corrupts its
        co-batched peers."""
        results: List[Optional[ServeResult]] = [None] * len(requests)
        groups: "collections.OrderedDict[Tuple, List]" = \
            collections.OrderedDict()
        admitted = 0
        for i, req in enumerate(requests):
            t0 = time.perf_counter()
            deadline = req.deadline_ms if req.deadline_ms is not None \
                else self.cfg.deadline_ms
            # Admission control: queue bound, then the latency SLO.
            if (self.cfg.max_queue is not None
                    and admitted >= self.cfg.max_queue):
                results[i] = self._reject(t0, "shed", RequestShed(
                    f"request queue full ({self.cfg.max_queue})"))
                continue
            if self._should_shed():
                results[i] = self._reject(t0, "shed", RequestShed(
                    f"over latency SLO ({self.cfg.slo_ms:g} ms)"))
                continue
            # Submit-site faults (retried within the deadline).
            try:
                self._admit(req, t0, deadline)
            except DeadlineExceeded as e:
                results[i] = self._reject(t0, "deadline", e)
                continue
            except Exception as e:  # noqa: BLE001 — typed fault surfaces
                results[i] = self._reject(t0, "fault", e)
                continue
            entry = None
            try:
                key, entry, hit = self._resolve(req)
                if prebuilt is not None and prebuilt[i] is not None:
                    rels = self._adapt_prebuilt(tuple(prebuilt[i]), entry)
                else:
                    rels = self._prep_inputs(req, entry.grid_shape)
            except CircuitOpen as e:
                results[i] = self._reject(t0, "circuit", e)
                continue
            except Exception as e:  # noqa: BLE001 — poisoned request
                self.stats.errors += 1
                self.stats.queries += 1
                results[i] = ServeResult(
                    ok=False, cache_hit=entry is not None and hit,
                    latency_ms=(time.perf_counter() - t0) * 1e3,
                    plan=None if entry is None else entry.plan,
                    error=f"{type(e).__name__}: {e}", error_kind="error")
                continue
            if (deadline is not None
                    and (time.perf_counter() - t0) * 1e3 > deadline):
                results[i] = self._reject(t0, "deadline", DeadlineExceeded(
                    f"deadline {deadline:g} ms elapsed during planning"))
                continue
            admitted += 1
            gkey = (id(entry.run), input_signature(rels))
            groups.setdefault(gkey, []).append(
                (i, hit, entry, rels, t0, deadline, key))

        for members in groups.values():
            self._run_group(members, results)
        return results  # type: ignore[return-value]  # every slot is filled

    def _adapt_prebuilt(self, rels: Tuple[Any, ...],
                        entry: CachedPlan) -> Tuple[Any, ...]:
        """Prebuilt inputs for a map-side plan are
        :class:`PartitionedRelation`; when the entry degraded to a
        shuffle strategy they flatten back to plain grid-scattered
        relations (exactly the same tuples, no certificate needed)."""
        if entry.strategy == "mapside":
            return rels
        return tuple(scatter_to_grid(r.to_flat(), entry.grid_shape)
                     if isinstance(r, PartitionedRelation) else r
                     for r in rels)

    def _run_group(self, members: List,
                   results: List[Optional[ServeResult]]) -> None:
        self.stats.batches += 1
        try:
            self._run_group_inner(members, results)
        except Exception as e:  # noqa: BLE001 — capture/compile failure
            # A failure at first execution is a compile failure: evict
            # the poisoned entries, fail the group's lanes with a typed
            # error, and feed the circuit breaker.
            self._breaker_failures += 1
            for (i, hit, entry, rels, t0, deadline, key) in members:
                self._cache.pop(key, None)
                self.stats.errors += 1
                self.stats.queries += 1
                results[i] = ServeResult(
                    ok=False, cache_hit=hit,
                    latency_ms=(time.perf_counter() - t0) * 1e3,
                    plan=entry.plan, error=f"{type(e).__name__}: {e}",
                    error_kind="error")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_group_inner(self, members: List,
                         results: List[Optional[ServeResult]]) -> None:
        # A successful fresh build+capture closes the breaker; a served
        # cache hit says nothing about build health and leaves it.
        fresh = any(not m[1] for m in members)
        if len(members) == 1:
            i, hit, entry, rels, t0, deadline, _key = members[0]
            out, st, ovf = entry.run(rels)
            self._sync()
            if fresh:
                self._breaker_failures = 0
                self._breaker_fastfails = 0
            dt = (time.perf_counter() - t0) * 1e3
            results[i] = self._lane_result(entry, out, st, ovf, hit, dt,
                                           deadline)
            self.stats.queries += 1
            self.stats.latencies_ms.append(dt)
            return
        # One execution of the plan over SimGrid(lanes=L), from the
        # executor's program cache (keyed by L): one replay on the card.
        batched = members[0][2].run.with_lanes(len(members))
        stacked = _stack([m[3] for m in members])
        t0 = min(m[4] for m in members)
        outs, sts, ovfs = batched(stacked)
        self._sync()
        if fresh:
            self._breaker_failures = 0
            self._breaker_fastfails = 0
        dt = (time.perf_counter() - t0) * 1e3
        for lane, (i, hit, entry, rels, _, deadline, _key) \
                in enumerate(members):
            out = outs.map(lambda x, lane=lane: x[lane])
            st = {k: v[lane] for k, v in sts.items()}
            results[i] = self._lane_result(entry, out, st, ovfs[lane], hit,
                                           dt, deadline)
            self.stats.queries += 1
            self.stats.latencies_ms.append(dt)

    def _lane_result(self, entry: CachedPlan, out: Relation, st: Dict,
                     ovf: Any, hit: bool, dt: float,
                     deadline: Optional[float] = None) -> ServeResult:
        overflow = bool(ovf)
        # scalar counters become floats; per-hop vectors become tuples
        # of floats
        measured = {k: (float(v) if v.dim() == 0
                        else tuple(float(x) for x in v))
                    for k, v in st.items()}
        if overflow:
            self.stats.errors += 1
            return ServeResult(ok=False, cache_hit=hit, latency_ms=dt,
                               output=None, measured=measured, overflow=True,
                               plan=entry.plan,
                               error="overflow: a buffer capacity spilled — "
                                     "resubmit with larger caps",
                               error_kind="error")
        if deadline is not None and dt > deadline:
            # The answer exists but arrived late: a typed deadline
            # error, never a late result the client already gave up on.
            self.stats.errors += 1
            self.stats.deadline_exceeded += 1
            return ServeResult(ok=False, cache_hit=hit, latency_ms=dt,
                               output=None, measured=measured,
                               overflow=False, plan=entry.plan,
                               error=f"DeadlineExceeded: deadline "
                                     f"{deadline:g} ms, finished at "
                                     f"{dt:.2f} ms",
                               error_kind="deadline")
        return ServeResult(ok=True, cache_hit=hit, latency_ms=dt,
                           output=out, measured=measured, overflow=False,
                           plan=entry.plan, degraded=entry.degraded)
