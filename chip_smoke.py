#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to
their plain versions.

    python3 chip_smoke.py [--scale 14] [--seed 0] [--iters 10]
                          [--profile DIR]

Run from the root of a checkout (the script puts ``src/`` on the path).
It needs one CUDA device and ``nvcc``; with no GPU, or without the
repository beside it, it exits non-zero and prints no result.

Phases, each failing the run on any error:

1. The card's name and power limit (``nvidia-smi``), then the build of
   every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together), the build seconds, each kernel's
   ``ptxas`` registers and spills, and the count of ``HGMMA`` (wgmma)
   instructions in the built attention libraries, forward and backward,
   which must be nonzero.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it: the max abs difference, the kernel's
   time, the plain version's, one PyTorch library call's for the same
   function, and the least time the card could take (bytes moved at
   3.35 TB/s; operations at 67 TFLOP/s in float32 outside the tensor
   cores, 989 TFLOP/s in bfloat16 and float16 — the H100 SXM data
   sheet).
   ``segment_sum`` adds a sorted case with non-integer values that must
   give the same bits on two launches.  ``probe_counts`` adds hop 2's
   queries shuffled within each row (windows too wide for shared
   memory) and 64-bit keys above 2^32, each case with its device time
   (``torch.profiler``).  ``hash_histogram`` times the per-block counts
   and, at 2,3JA's hop 2, 1,3J's placement and skew detection,
   ``bucket_counts`` (the totals both callers read, one launch; hop 2
   is the kernels line's headline), each with its device time.
   ``flash_attention`` runs at
   qwen2-7b's attention widths (28 query heads, 4 kv heads, head dim
   128) over 4,096 positions: bfloat16 prefill, a ragged chunk (1,000
   queries after 2,000 cached keys) and head dim 64 on the tensor
   cores, decode in bfloat16 and float32 split over the kv axis, and
   float32 prefill on the CUDA cores ("simt"); each case logs the path,
   query tile and parts ``_plan`` chose.  A granite-3-2b bf16 prefill
   (the train step's forward) joins them, and every ``wgmma`` and
   ``simt`` case is timed again with the lse store the backward reads,
   that lse held to ``ref.attention_lse``.  The C3 16-bit prefills
   (bfloat16 at head dim 80, float16 at 128) must take ``wgmma`` in
   their own dtype, the float32 prefills ``simt``.  Phase 3j adds two
   cases at the model's shapes.
   ``flash_attention_bwd`` (the gradient, port-only: the JAX package
   differentiates its jnp attention) runs at granite-3-2b's attention
   as phase 3k's train step calls it (32 query heads over 8 kv heads,
   head dim 64, 2,048 positions, causal) in bfloat16 and float32, a
   ragged chunk at head dim 128, head dim 256 in float32, and qwen2-7b's
   heads at 1,024 positions in bfloat16 at head dim 80, float16 at 128
   (both ``wgmma``) and bfloat16 at 192 (``simt``); each against
   ``ref.attention_backward`` (2e-2 bf16, 2e-3 fp16, 1e-4 f32), with
   the forward's lse (timed: the train step's call; no lse pass in its
   trace) and recomputing it (timed too), two launches bit-equal, with
   SDPA's backward as the library time; each case must take its path.
3. The main path at full size: R-MAT ``amazon`` at ``--scale`` (edge
   factor 3, a = 0.50), planned with ``chain_stats_exact`` and
   ``plan_chain(k=16)``, sized by ``default_chain_caps``, and run by
   ``execute_chain`` on ``SimGrid((4, 4))`` for 1,3J, 2,3J, 2,3JA and
   1,3JA (``sort_merge``), then 1,3J and 2,3JA again with ``fused``,
   which must be bit-identical, then 1,3J and 2,3JA with
   ``measure_skew=True``; a warm-up of the first run goes before them,
   its time printed apart.  Each run checks: no overflow; measured
   read/shuffled equal to the cost model; the enumeration's (a, d)
   path counts, and the aggregation's (a, d, p) groups, equal to A³
   computed on the host with ``scipy.sparse`` — a reference
   independent of the code under test.  A measured run also checks its
   ``max_bucket_load`` (1,3J: equal to a recount of the edge lists on
   the host).  The kernel launch counts are set to 0 just before each
   run and read just after.
3b. The same eight runs compiled: ``jit_execute_chain`` captures each
   plan as one CUDA graph (one pool for all), then ``REPLAYS`` replays,
   each equal to an eager run of the plan array for array (output,
   stats, overflow); logged: capture ms, the replays' median beside the
   eager ms, the graph pool's bytes.  A replay runs no Python, so its
   launches are read from the device trace of one more replay
   (``ops.traced_launches``) and held to the eager run's; the trace of
   an eager run is held to the wrappers' counts first, so both count in
   one unit.  Then the caches are cleared and the pool returned.
3c. Serving through ``QueryEngine(QueryServeConfig(k=16))``, once with
   each reduce-side join: A³ (the planner's 2,3JA) and the triangle
   query (cascade along (0, 1, 2)) solo, one cold and ``SERVE_WARM``
   warm submissions each (every warm one a cache hit; results equal to
   A³ and to trace(A³), the closed 3-walks the triangle query counts,
   measured equal to the cost model; cold ms, warm p50 and p99 logged),
   then ``SERVE_TENANTS`` R-MAT seeds' triangle queries in one
   ``submit_many`` (exactly one execution; each lane exact on its own
   statistics and equal to its own solo submission).  One more warm
   submission of each and one more batch run under the device trace:
   their launches, held to the cold submission's (its eager warm-up;
   capture launches nothing).  Each request's bytes are reckoned from its
   caps first (the bytes a slot of its strategy took in phase 3), and
   its scale is cut, with a line saying so, while they do not fit
   beside the graph pool.
3d–3g. The map-side cascade over the partitioned store, the paper's
   entry points, streaming ingest and lineage recovery (see each
   ``run_*`` function).
3h. The overlapped shuffle schedule: 1,3J, 2,3J, 2,3JA and 1,3JA with
   ``overlap_chunks=2`` and both joins (2,3J ``sort_merge`` again at 4
   chunks where its reckoned bytes fit), each eager and through
   ``jit_execute_chain``, one plan captured at a time: no overflow,
   stats bit-equal to phase 3's unchunked run, results equal to A³
   (the enumerations' tuple multiset to phase 3's), every replay equal
   to eager array for array; eager ms, replay ms beside 3b's unchunked
   replay, peak and pool bytes.  Then ``op_audit.audit_lowerings`` on
   the card, every report clean.
3i. The ShardGrid: ``spawn`` starts 8 ranks on a (2, 2, 2) ``("pod",
   "data", "model")`` mesh, their shards in CUDA memory (``nccl`` with 8
   cards, else ``gloo`` with every rank on this card), at the largest
   scale <= 14 whose reckoned bytes fit.  They run the triangle query
   ``one_round`` on (2, 2, 2); 2,3J and 2,3JA on the flat (8,) at
   ``overlap_chunks`` 1 and 2, one 2,3JA ``fused`` with
   ``measure_skew=True`` (every rank launches ``segment_sum``,
   ``probe_counts`` and ``bucket_counts``); MS,3J from a store of 8
   partitions; 1,3JA through ``one_round_three_way_agg`` on (4, 2).
   Each rank's relation (SHA-256 of every column), stats and flag
   equal the SimGrid run's slice, which was run here first and held to
   A³ / trace(A³) / the tuple multiset and the cost model; the
   cascades' ``audit_collectives`` count more all-to-alls overlapped
   than staged and find no full-relation gather.  Wall ms per run is
   the max over the ranks (ranks sharing one card).  Then a one-rank
   ``nccl`` group: ``jit_execute_chain`` of 2,3J on ``ShardGrid`` (1,)
   captured, its replay equal to eager and to ``SimGrid((1,))``.
4. The skew path at full size: ``zipf_edges(131072, 8192, 1.0)`` as all
   three relations at k = 256, ``detect_chain_skew`` then
   ``shares_skew_chain`` (``measure_skew=True``) for enumeration
   (1,3JS) and aggregation (1,3JSA), each combination's caps sized from
   exact statistics of its parts.  Checks: no overflow; the four
   combinations and their grids; the results equal to A³; the stats
   equal to the plan's cost.
5. The attention entry point ``flash_attention.flash_attention`` once for prefill
   and once for decode (bfloat16), its launches counted.
3j. LM serving, last, after phase 5 and ``--profile``'s pass (phase
   3's graph pools are returned by then): phase 2's attention cases
   at the model's shapes (32 padded query heads: request 1's 4 x 1,024
   prefill, a decode step over 1,088 keys), then qwen2-7b at full
   width and depth (28 layers, d_model 3,584, 32 padded query heads /
   4 kv heads, head dim 128, d_ff 18,944, vocab 152,064; 7,718,391,296
   parameters) drawn in bf16 on the card from ``--seed``, two greedy
   requests through ``repro_torch.serving.Engine`` (``LM_REQUESTS``:
   4 x 1,024 prompt tokens + 64 new, 1 x 4,096 + 32 new), the counts
   set to 0 before each and read after (``flash_attention`` once a
   layer a step).  Each checks tokens in range, finite logits and the
   reference's stats, and logs prefill ms, the median decode-step ms,
   tokens/s and ``_plan``'s paths beside the bounds (a decode step
   reads every weight and the cache; the prefill's operations at 989
   TFLOP/s).  Then every attention call of request 1's prefill and
   first decode step against the plain version on the same inputs
   (phase 2's ``assert_close``, rtol = atol = 2e-2), the whole prefill
   against a ``backend="ref"`` model sharing the weights (max abs logit
   difference, top-1 agreement: logged, no bound), the phase's peak
   bytes, and one decode step's device ms and largest kernels; it
   frees all it made.  It runs last because, run before phase 3 (even
   in a process of its own, without the profiler), its GEMMs left the
   profiler dropping kernel records from phase 3b's traces (ROADMAP
   C9).
3k. LM training, after 3j: granite-3-2b at full width and depth (40
   layers, d_model 2,048, 32 heads / 8 kv heads, head dim 64, d_ff
   8,192, vocab 49,155 padded to 49,280; 2,634,713,088 parameters;
   remat, microbatch 8, AdamW), bf16 weights drawn on the card from
   ``--seed``, its bytes reckoned first and held to the card.  One
   microbatch's gradient (1 x 2,048 tokens) with the attention kernels
   against a ``backend="ref"`` model's: the cosine of the flattened
   gradient (>= 0.99) and the lowest leaf cosine (logged); the host µs
   of granite's attention call forward and backward under autograd.
   Then ``make_train_step`` with ``cosine_with_warmup(3e-4, 2, 8)`` on
   ``DataConfig(49155, 2048, 8)``: one warm-up step and 8 timed ones
   (CUDA events around each step), the counts set to 0 before the timed
   steps and read after (``flash_attention`` twice a layer a
   microbatch under remat, ``flash_attention_bwd`` once), every loss
   logged, the mean of the last two below the first; step ms against
   the step's reckoned bound, tokens/s, peak bytes; a microbatch's and
   the update's wall ms (median of 3) and device ms by kernel group.
   Then ``Trainer.run`` at the smoke config on the card: 6 steps, a
   simulated failure at step 4, the restart from the step-3 checkpoint,
   the resumed losses within 1e-5 relative of an uninterrupted run.
   ``--train-only`` runs this phase alone and prints its numbers as
   JSON: a tree and its parent compared turn about on one card.
3l. The MoE and state-space families, after 3k, one model at a time,
   each built at full width, its bytes reckoned against the card first
   (``family_reckoning``), its bf16 weights drawn on the card from
   ``--seed``, and everything freed after it (``FAMILY_MODELS``):
   grok-1 (8 experts x 32,768, top-2; d_model 6,144, 48 / 8 heads,
   depth cut to 4 of 64 layers) with 4 x 1,024 prompt tokens + 32 new,
   kimi-k2 (384 experts x 2,048, top-8, one shared expert; d_model
   7,168, 64 / 8 heads; depth cut to 1 of 61 layers) with 1 x 1,024 +
   16, zamba2-1.2b (38 Mamba2 layers, 6 super-blocks sharing one
   attention block) with 2 x 1,024 + 32 and xlstm-125m (12 mLSTM /
   sLSTM layers, no attention) with 1 x 1,024 + 32, uncut.  Each greedy
   request through ``Engine.generate``, the counts set to 0 before it
   and read after: tokens in range, finite logits, the stats, and
   ``flash_attention`` once an attention layer a step (zamba2: once a
   super-block); prefill ms and the median decode-step ms beside their
   bounds (``family_bounds``), tokens/s.  Then every attention call of
   the prefill and first decode step against the plain version (rtol =
   atol = 2e-2), the MoE's layer-0 dispatch plan of the prefill's router
   ids built on the card and on the CPU and equal as full arrays (the
   share of copies dropped logged), the xLSTM's sLSTM prefill walls,
   the prefill against a ``backend="ref"`` model sharing the weights
   (max logit difference and top-1 agreement, no bound) and the peak
   bytes.
6. One JSON line with every kernel's numbers (``flash_attention``'s
   launches include phase 3j's, 3k's and 3l's), the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import tempfile
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM, outside the tensor cores
HALF_OPS_PER_S = 989e12        # H100 SXM tensor cores, dense: bf16 and fp16
GRID = (4, 4)
K = 16
# qwen2-7b's attention (src/repro/configs/qwen2_7b.py): 28 query heads,
# 4 kv heads, head dim 128; prefill and decode over 4,096 positions.
ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM, ATTN_LEN = 28, 4, 128, 4096
# The model's query heads: 28 padded to 32 (ModelConfig.padded_heads).
LM_HEADS = 32
# A ragged chunked prefill: 1,000 new queries after 2,000 cached keys.
ATTN_CHUNK, ATTN_CHUNK_KV = 1000, 3000
# The skew workload: Zipf(1.0) endpoints, the same list for all three
# relations, k = 256 reducers.
SKEW_NODES, SKEW_EDGES, SKEW_ALPHA, SKEW_K = 131072, 8192, 1.0, 256
SKEW_GRIDS = [(16, 16), (16, 1), (1, 16), (1, 1)]
# Each combination's caps are its exact largest per-reducer load times
# this slack, + 256.  At 1.25, 1,3JSA peaked at 70.4 GB of the H100's
# 80 GB; the overflow check guards the smaller slack.
SKEW_CAP_SLACK = 1.05

# (paper name, aggregated query, strategy, join_impl, measure_skew)
RUNS = (
    ("1,3J", False, "one_round", "sort_merge", False),
    ("1,3J", False, "one_round", "fused", False),
    ("2,3J", False, "cascade", "sort_merge", False),
    ("2,3JA", True, "cascade_pushdown", "sort_merge", False),
    ("2,3JA", True, "cascade_pushdown", "fused", False),
    ("1,3JA", True, "one_round", "sort_merge", False),
    ("1,3J", False, "one_round", "sort_merge", True),
    ("2,3JA", True, "cascade_pushdown", "sort_merge", True),
)

FUSED_TWINS = {r[0] for r in RUNS if r[3] == "fused"}

# Phase 3b: replays per compiled run.  Phase 3c: warm submissions per
# solo query, tenants in the batch, the triangle's join order, and the
# device bytes kept free beside a reckoned request.
REPLAYS = 5
SERVE_WARM = 20
SERVE_TENANTS = 4
SERVE_ORDER = (0, 1, 2)
SERVE_MARGIN = 8 << 30
# Phase 2's shapes past the first kernels' limits: rows past the grid's
# 65,535, buckets past a shared histogram's 12,288.
C3_ROWS = 65536
C3_BUCKETS = 100_000

KERNELS = {
    "segment_sum": dict(source="src/repro_torch/csrc/segment_sum.cu",
                        replaces="src/repro/kernels/segment_sum.py:57"),
    "probe_counts": dict(source="src/repro_torch/csrc/probe_counts.cu",
                         replaces="src/repro/kernels/fused_join.py:181"),
    "hash_histogram": dict(source="src/repro_torch/csrc/hash_histogram.cu",
                           replaces="src/repro/kernels/hash_partition.py:53"),
    "flash_attention": dict(
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:88"),
    "flash_attention_bwd": dict(
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention.py:88",
        note="port-only: the gradient of that kernel's function; the JAX "
             "package has no backward kernel and differentiates its jnp "
             "attention (src/repro/models/layers.py:96)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    """Fail the run (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(msg)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time for the work: the larger of bytes over the memory
    rate and operations over the peak rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_kernels(fn, iters: int) -> list:
    """``(name, device ms a call, records)`` of each device function
    that ``fn()`` runs, over ``iters`` calls under ``torch.profiler``
    (after one call outside it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
             / iters / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms(fn, iters: int) -> float:
    """Device time of the kernels one ``fn()`` launches: their summed
    time over ``iters`` calls under ``torch.profiler``, per call.  Where
    it is well below ``time_ms``, the host's launches, not the card, set
    the time."""
    return sum(ms for _, ms, _ in device_kernels(fn, iters))


# ---------------------------------------------------------------------------
# The workload and its host-side reference
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Workload:
    n_nodes: int
    edges: list
    stats: object
    caps: object
    a3_keys: np.ndarray        # a·n + d of every nonzero of A³, sorted
    a3_vals: np.ndarray        # its path counts


def make_workload(scale: int, seed: int) -> Workload:
    import scipy.sparse as sp
    from repro_torch.core import (chain_stats_exact, default_chain_caps,
                                  plan_chain)
    from repro_torch.data.graphs import DATASETS, rmat_edges

    spec = dataclasses.replace(DATASETS["amazon"], scale=scale)
    src, dst = rmat_edges(spec, seed=seed)
    edges = [(src, dst)] * 3
    t0 = time.perf_counter()
    stats = chain_stats_exact(edges)
    plans = {agg: plan_chain(stats, k=K, aggregate=agg)
             for agg in (False, True)}
    caps = default_chain_caps(stats, GRID)
    n = spec.n_nodes
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    a3 = (adj @ adj @ adj).tocoo()
    keys = a3.row.astype(np.int64) * n + a3.col
    order = np.argsort(keys)
    log(f"workload: R-MAT amazon scale {scale} seed {seed}: "
        f"{n} nodes, {len(src)} edges; j1={stats.prefix_joins[0]:.0f} "
        f"a1={stats.prefix_aggs[0]:.0f} j3={stats.prefix_joins[-1]:.0f} "
        f"nnz(A^3)={a3.nnz}; plans: enumerate {plans[False].algorithm} "
        f"{plans[False].grid_shape}, aggregate {plans[True].algorithm}; "
        f"caps {dataclasses.asdict(caps)}; host stats+A^3 "
        f"{time.perf_counter() - t0:.1f} s")
    return Workload(n, edges, stats, caps, keys[order], a3.data[order])


def analytic(name: str, stats) -> float:
    from repro_torch.core import cost_model as cm
    sizes, pj = stats.sizes, stats.prefix_joins
    if name == "1,3J":
        return cm.cost_chain_one_round(sizes, K, shares=GRID)
    if name == "2,3J":
        return cm.cost_chain_cascade(sizes, pj)
    if name == "2,3JA":
        return cm.cost_chain_cascade_pushdown(sizes, pj, stats.prefix_aggs,
                                              stats.pushdown_joins)
    return cm.cost_chain_one_round_agg(sizes, K, pj[-1], shares=GRID)


def check_against_a3(w: Workload, out, aggregate: bool) -> int:
    """The (a, d) groups of the result equal A³: the aggregation's sums
    exactly, the enumeration's path counts per (a, d) exactly."""
    dev = out.valid.device
    a = out.cols["a"][out.valid].to(torch.int64)
    d = out.cols["d"][out.valid].to(torch.int64)
    keys = a * w.n_nodes + d
    want_keys = torch.as_tensor(w.a3_keys, device=dev)
    if aggregate:
        keys, order = torch.sort(keys)
        vals = out.cols["p"][out.valid][order]
        want = torch.as_tensor(w.a3_vals.astype(np.float32), device=dev)
    else:
        keys, vals = torch.unique(keys, sorted=True, return_counts=True)
        want = torch.as_tensor(w.a3_vals.astype(np.int64), device=dev)
    check(keys.numel() == want_keys.numel(),
          f"{keys.numel()} groups, A^3 has {want_keys.numel()}")
    check(torch.equal(keys, want_keys), "(a, d) groups differ from A^3")
    check(torch.equal(vals, want), "path counts differ from A^3")
    return int(keys.numel())


def host_hop_load(w: Workload, query) -> float:
    """``max_bucket_load`` of 1,3J recounted from the edge lists: every
    placement hop of relation j on dim d hashes all of j's tuples (a
    shuffle moves tuples, it does not drop or copy them), so the hop's
    global histogram is the histogram of the whole column — the port's
    hash on CPU tensors, counted with numpy."""
    from repro_torch.core.hashing import bucket_hash
    load = 0
    for j, (src, dst) in enumerate(w.edges):
        for d in query.hashed_dims(j):
            col = src if d + 1 == j else dst    # attr d+1 of relation j
            b = bucket_hash(torch.as_tensor(col), GRID[d], salt=d).numpy()
            load = max(load, int(np.bincount(b, minlength=GRID[d]).max()))
    return float(load)


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def run_main_path(w: Workload, device: torch.device) -> tuple[dict, dict]:
    """Every strategy through ``execute_chain``; returns the launches
    per kernel summed over the runs, and each strategy's peak bytes per
    slot of its largest per-device buffer (what phase 3c reckons a
    request's bytes from)."""
    from repro_torch.core import ChainQuery, SimGrid, chain_edge_inputs
    from repro_torch.core import execute_chain
    from repro_torch.kernels import ops

    on_gpu = device.type == "cuda"
    launches = {name: 0 for name in ops.LAUNCHES}
    per_slot: dict = {}
    staged = {}
    unmeasured = {}
    # A warm-up of the first run, outside the table: the first
    # execute_chain of a process pays one-time CUDA library and
    # allocator set-up.  Its time is printed, not hidden in a run's.
    name, aggregate, strategy, impl, _ = RUNS[0]
    query = ChainQuery.three_way(aggregate=aggregate)
    rels = chain_edge_inputs(query, w.edges, GRID, device=device)
    t0 = time.perf_counter()
    out, _, overflow = execute_chain(SimGrid(GRID), query, rels,
                                     strategy=strategy, caps=w.caps,
                                     join_impl=impl)
    check(not bool(overflow), f"warm-up {name} {impl}: overflow")
    log(f"warm-up {name} {impl}: wall_ms="
        f"{(time.perf_counter() - t0) * 1e3:.1f} (one-time set-up included)")
    del out, rels
    if on_gpu:
        torch.cuda.empty_cache()
    for name, aggregate, strategy, impl, measure in RUNS:
        query = ChainQuery.three_way(aggregate=aggregate)
        rels = chain_edge_inputs(query, w.edges, GRID, device=device)
        if on_gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        out, stats, overflow = execute_chain(
            SimGrid(GRID), query, rels, strategy=strategy, caps=w.caps,
            join_impl=impl, measure_skew=measure)
        if on_gpu:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        del rels

        check(not bool(overflow), f"{name} {impl}: overflow")
        read, shuffled = float(stats["read"]), float(stats["shuffled"])
        total = float(stats["total"]) if "total" in stats \
            else float(np.float32(read) + np.float32(shuffled))
        want = analytic(name, w.stats)
        # Stats are float32 sums: exact below 2^24; the 1,3JA charged
        # round (2·j3) may round to within one float32 ulp of the total.
        tol = float(np.spacing(np.float32(want))) if want >= 2 ** 24 else 0.0
        check(abs(total - want) <= tol,
              f"{name} {impl}: measured {total} != analytic {want}")
        rows = int(out.count().sum())
        check(aggregate or rows == w.stats.prefix_joins[-1],
              f"{name}: {rows} rows, j3 = {w.stats.prefix_joins[-1]}")
        groups = check_against_a3(w, out, aggregate)
        label = f"{impl}{' measure_skew' if measure else ''}"
        skew = ""
        if measure:
            # The measurement changes no other stat.
            check(unmeasured[(name, impl)] == (read, shuffled),
                  f"{name} {label}: read/shuffled differ from the run "
                  f"without measure_skew")
            load = float(stats["max_bucket_load"])
            check(0 < load <= read, f"{name} {label}: max_bucket_load "
                                    f"{load} outside (0, read={read}]")
            if strategy == "one_round":
                want_load = host_hop_load(w, query)
                check(load == want_load, f"{name} {label}: max_bucket_load "
                                         f"{load} != host recount {want_load}")
            skew = f" max_bucket_load={load:.0f}"
        else:
            unmeasured[(name, impl)] = (read, shuffled)
        expect = {"segment_sum": aggregate, "probe_counts": impl == "fused",
                  "hash_histogram": measure}
        if on_gpu:
            for kname, used in expect.items():
                check(counts[kname] > 0 or not used,
                      f"{name} {impl}: the {kname} kernel was never launched")
        for kname, c in counts.items():
            launches[kname] += c
        per_slot[strategy] = max(per_slot.get(strategy, 0.0),
                                 peak / largest_slots(w.caps, GRID))

        # The fused run must equal its sort_merge twin bit for bit; the
        # twin's result waits on the host, out of the peak-memory count.
        if impl == "fused":
            twin = staged.pop(name)
            check(torch.equal(out.valid.cpu(), twin.valid), f"{name}: mask")
            for n, c in out.cols.items():
                check(torch.equal(c.cpu(), twin.cols[n]), f"{name}: {n}")
        elif name in FUSED_TWINS and not measure:
            staged[name] = out.map(lambda t: t.cpu())
        if impl == "sort_merge" and not measure:
            UNCHUNKED[name] = {
                "stats": {k: v.cpu() for k, v in stats.items()},
                "rows": None if aggregate else packed_rows(w, out).cpu(),
                "peak": peak}
        del out
        if on_gpu:
            torch.cuda.empty_cache()
        log(f"main path {name:6s} {label:10s} ok: rows={rows} "
            f"groups={groups} read={read:.0f} shuffled={shuffled:.0f} "
            f"total={total:.0f} analytic={want:.0f}{skew} "
            f"wall_ms={wall_ms:.1f} peak_bytes={peak} launches={counts}")
    return launches, per_slot


# ---------------------------------------------------------------------------
# Phase 3b: the main path compiled (one CUDA graph per plan)
# ---------------------------------------------------------------------------

def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def largest_slots(caps, grid_shape, lanes: int = 1) -> int:
    """Slots of a plan's largest per-device buffer, over the grid and
    the lanes: the unit a run's device bytes are reckoned in."""
    return lanes * math.prod(grid_shape) * max(
        v for v in dataclasses.astuple(caps) if v)


def graph_pool_bytes() -> int:
    """Device bytes held by private memory pools (the executor's one
    CUDA-graph pool is the only one here)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def memory_line(device: torch.device) -> str:
    if device.type != "cuda":
        return "pool_bytes=0 reserved_bytes=0 (cpu)"
    return (f"pool_bytes={graph_pool_bytes()} "
            f"reserved_bytes={torch.cuda.memory_reserved()} "
            f"max_reserved_bytes={torch.cuda.max_memory_reserved()}")


# Traces taken again because the profiler's counts fell short of the
# eager run's: each attempt's counts (printed at the end of the run).
TRACE_RETRIES = []
# (what, kernel records, the graph's kernel nodes) of each traced
# replay of a plan's graph (printed at the end of the run).
TRACED_GRAPHS = []


def graph_kernel_nodes(plan) -> int:
    """The kernel nodes of the one CUDA graph a ``CompiledPlan`` holds,
    read from the graph itself (``cuGraphGetNodes``,
    ``cuGraphNodeGetType``), not from a trace."""
    import ctypes
    graphs = [g.graph for g in plan._graphs.values()]
    check(len(graphs) == 1, f"a plan holds {len(graphs)} graphs, not 1")
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graphs[0].raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kernels += kind.value == 0          # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def traced_launches(fn, device: torch.device, expect: dict, accept,
                    what: str, plan=None):
    """``(fn(), launches per kernel)`` from the device trace
    (``ops.traced_launches``); on the CPU (a rehearsal) no kernel runs,
    and every count is 0.  Every attempt's result must pass ``accept``.
    One symptom is traced again, twice at most: a trace whose counts
    fall short of ``expect`` for some kernel (on the card the profiler
    has dropped every kernel record of one graph replay, and once one
    ``probe_counts`` record of two, of replays whose outputs were
    right).  Where ``fn`` is one replay of ``plan``'s graph, a short
    trace is held to the graph's own kernel nodes first: a trace that
    holds a record of every one of them dropped nothing, so its
    shortfall is a launch the graph lacks, and fails at once.  Else a
    launch that is really missing is missing from every attempt, so the
    last attempt's counts go to the caller, to be held to ``expect``.
    Each short attempt's counts are logged, and those of each attempt
    traced again are kept in ``TRACE_RETRIES``."""
    from repro_torch.kernels import ops
    if device.type != "cuda":
        result = fn()
        check(accept(result), f"{what}: result differs")
        return result, {name: 0 for name in ops.LAUNCHES}
    nodes = None if plan is None else graph_kernel_nodes(plan)
    for attempt in range(3):
        result, counts, n_records = ops.traced_launches(fn)
        check(accept(result), f"{what}: traced result differs")
        if plan is not None:
            TRACED_GRAPHS.append((what, n_records, nodes))
        short = any(counts[k] < v for k, v in expect.items())
        if not short:
            return result, counts
        log(f"trace: {what}: attempt {attempt} traced {counts}, fewer "
            f"than {expect}; {n_records} kernel records, the graph's "
            f"kernel nodes {nodes}")
        check(nodes is None or n_records < nodes,
              f"{what}: the trace holds a record of each of the graph's "
              f"{nodes} kernel nodes, yet counts {counts} < {expect}")
        if attempt == 2:
            return result, counts
        TRACE_RETRIES.append(f"{what} (attempt {attempt}: {counts}, "
                             f"{n_records} kernel records, graph kernel "
                             f"nodes {nodes})")
        del result


def same_relation(a, b) -> bool:
    """Every column and the mask equal, padding and row order included."""
    return (torch.equal(a.valid, b.valid) and sorted(a.cols) == sorted(b.cols)
            and all(torch.equal(c, b.cols[n]) for n, c in a.cols.items()))


def same_result(got, want) -> bool:
    """Output relation, every stat and the overflow flag equal, array
    for array."""
    (out, stats, ovf), (w_out, w_stats, w_ovf) = got, want
    return (same_relation(out, w_out)
            and sorted(stats) == sorted(w_stats)
            and all(torch.equal(v, w_stats[k]) for k, v in stats.items())
            and torch.equal(ovf, w_ovf))


def run_compiled_path(w: Workload, device: torch.device
                      ) -> tuple[dict, dict]:
    """Every main-path run through ``jit_execute_chain``: the first call
    warms up, captures and replays, then ``REPLAYS`` replays, each equal
    to an eager run of the same plan array for array, and one traced
    replay that launches on the card what the eager run launched.
    Returns the traced replays' launches per kernel, and each run's
    median replay ms by ``(name, label)``."""
    from repro_torch.core import (ChainQuery, SimGrid, chain_edge_inputs,
                                  clear_compiled_caches, execute_chain,
                                  jit_execute_chain)
    from repro_torch.kernels import ops

    on_gpu = device.type == "cuda"
    launches = {name: 0 for name in ops.LAUNCHES}
    replays: dict = {}
    if on_gpu:
        torch.cuda.reset_peak_memory_stats()
    for name, aggregate, strategy, impl, measure in RUNS:
        label = f"{impl}{' measure_skew' if measure else ''}"
        query = ChainQuery.three_way(aggregate=aggregate)
        rels = chain_edge_inputs(query, w.edges, GRID, device=device)
        kw = dict(strategy=strategy, caps=w.caps, join_impl=impl,
                  measure_skew=measure)
        sync(device)
        ops.reset_launches()
        t0 = time.perf_counter()
        eager = execute_chain(SimGrid(GRID), query, rels, **kw)
        sync(device)
        eager_ms = (time.perf_counter() - t0) * 1e3
        per_run = dict(ops.LAUNCHES)
        check(not bool(eager[2]), f"compiled {name} {label}: overflow")
        # The device trace counts in the wrappers' unit: one launch of a
        # kernel's first device function a wrapper call.
        traced = traced_launches(      # its output dropped at once
            lambda: execute_chain(SimGrid(GRID), query, rels, **kw), device,
            per_run, lambda got: same_result(got, eager),
            f"compiled {name} {label} eager")[1]
        check(traced == per_run, f"compiled {name} {label}: traced eager "
                                 f"launches {traced} != counted {per_run}")
        if on_gpu:
            torch.cuda.empty_cache()   # the eager runs' cache, before capture
        run = jit_execute_chain(SimGrid(GRID), query, donate=False, **kw)
        ops.reset_launches()
        t0 = time.perf_counter()
        first = run(rels)
        sync(device)
        capture_ms = (time.perf_counter() - t0) * 1e3
        check(dict(ops.LAUNCHES) == per_run,
              f"compiled {name} {label}: warm-up launches "
              f"{dict(ops.LAUNCHES)} != eager {per_run}")
        check(same_result(first, eager),
              f"compiled {name} {label}: first call differs from eager")
        del first
        replay_ms = []
        for _ in range(REPLAYS):
            t0 = time.perf_counter()
            got = run(rels)
            sync(device)
            replay_ms.append((time.perf_counter() - t0) * 1e3)
            check(same_result(got, eager),
                  f"compiled {name} {label}: replay differs from eager")
            del got
        got, traced = traced_launches(
            lambda: run(rels), device, per_run,
            lambda got: same_result(got, eager),
            f"compiled {name} {label} replay", plan=run)
        check(traced == per_run, f"compiled {name} {label}: replay "
                                 f"launched {traced} != eager {per_run}")
        del got
        for kname, c in traced.items():
            launches[kname] += c
        expect = {"segment_sum": aggregate, "probe_counts": impl == "fused",
                  "hash_histogram": measure}
        for kname, used in expect.items():
            check(traced[kname] > 0 or not used or not on_gpu,
                  f"compiled {name} {label}: the {kname} kernel was "
                  f"never launched in a replay")
        replays[(name, label)] = statistics.median(replay_ms)
        log(f"compiled {name:6s} {label:10s} ok: capture_ms={capture_ms:.1f} "
            f"(warm-up + capture + replay) replay_ms={statistics.median(replay_ms):.1f} "
            f"(median of {REPLAYS}; {min(replay_ms):.1f}..{max(replay_ms):.1f}) "
            f"eager_ms={eager_ms:.1f} {memory_line(device)} "
            f"launches_per_replay={traced} (traced)")
        del eager, rels
    clear_compiled_caches()
    if on_gpu:
        torch.cuda.empty_cache()
    log(f"compiled path: caches cleared, {memory_line(device)}")
    return launches, replays


# ---------------------------------------------------------------------------
# Phase 3c: serving (QueryEngine)
# ---------------------------------------------------------------------------

def a3_query_stats(w: Workload):
    """Exact ``QueryStats`` of the aggregated three-way chain along its
    order (0, 1, 2), from the chain statistics and A³ on the host (the
    engine plans a chain with ``stats.chain``)."""
    from repro_torch.core import QueryStats
    st = w.stats
    j1, j3 = st.prefix_joins[0], st.prefix_joins[-1]
    return QueryStats(sizes=tuple(st.sizes), orders=(SERVE_ORDER,),
                      intermediates=((j1, j3),), hop_joins=((j1, j3),),
                      agg_groups=float(len(w.a3_keys)), chain=st)


def triangle_stats(src, dst, n_nodes: int):
    """Exact ``QueryStats`` of ``JoinQuery.triangle()`` along (0, 1, 2)
    and what the query counts: trace(A³), the closed 3-walks (self-loops
    and multi-edges included; the repo's ``oracle_triangles`` is this
    over 3), from ``scipy.sparse``
    (``query_stats_exact`` simulates every order in Python: too slow at
    scale 14).  Hop 1 joins on b (2-paths), hop 2 on c (3-paths, before
    the closing filter a = a'), leaving the closed ones."""
    import scipy.sparse as sp
    from repro_torch.core import QueryStats
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)),
                        shape=(n_nodes, n_nodes))
    a2 = adj @ adj
    a3 = a2 @ adj
    j1, raw2, closed = (float(a2.sum()), float(a3.sum()),
                        float(a3.diagonal().sum()))
    m = float(len(src))
    stats = QueryStats(sizes=(m, m, m), orders=(SERVE_ORDER,),
                       intermediates=((j1, closed),),
                       hop_joins=((j1, raw2),), agg_groups=None, chain=None)
    return stats, closed


def serve_caps(query, stats):
    """The caps the engine derives for a plan on (K,): power-of-two
    quantized ``default_query_caps``."""
    from repro_torch.core import ChainCaps, default_query_caps
    from repro_torch.serving import QueryServeConfig
    caps = default_query_caps(query, stats, (K,),
                              slack=QueryServeConfig().caps_slack)
    pow2 = {f: (None if v is None else 1 << (int(v) - 1).bit_length())
            for f, v in dataclasses.asdict(caps).items()}
    return ChainCaps(**pow2)


def fits(need: float, device: torch.device) -> tuple[bool, float]:
    """Whether ``need`` bytes fit in the card beside what is reserved
    now (the graph pool included), with ``SERVE_MARGIN`` to spare."""
    if device.type != "cuda":
        return True, float("inf")
    torch.cuda.empty_cache()
    free = (torch.cuda.get_device_properties(device).total_memory
            - torch.cuda.memory_reserved(device))
    return need + SERVE_MARGIN <= free, free


def serve_repeated(eng, label: str, query, tables, stats, check_result,
                   device: torch.device, **opts) -> tuple[dict, dict]:
    """One cold submission, then ``SERVE_WARM`` warm ones, each a cache
    hit, and one more under the device trace; the cold, last and traced
    results checked by ``check_result``.  Returns the timings and the
    traced submission's launches, held to the cold one's (its eager
    warm-up; the capture launches nothing)."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    cold = eng.submit(query, tables, stats=stats, **opts)
    cold_launches = dict(ops.LAUNCHES)
    check(cold.ok and not cold.cache_hit,
          f"serve {label}: cold submission: ok={cold.ok} hit="
          f"{cold.cache_hit} {cold.error}")
    check_result(cold)
    warm_ms = []
    for _ in range(SERVE_WARM):
        res = eng.submit(query, tables, stats=stats, **opts)
        check(res.ok and res.cache_hit,
              f"serve {label}: warm submission missed or failed: {res.error}")
        check(res.measured == cold.measured,
              f"serve {label}: warm stats {res.measured} != cold")
        warm_ms.append(res.latency_ms)
    check_result(res)

    def accept(r) -> bool:
        ok = r.ok and r.cache_hit and r.measured == cold.measured
        if ok:
            check_result(r)
        return ok

    res, traced = traced_launches(
        lambda: eng.submit(query, tables, stats=stats, **opts), device,
        cold_launches, accept, f"serve {label} warm submission")
    check(traced == cold_launches,
          f"serve {label}: a warm submission launched {traced} != the "
          f"cold one's {cold_launches}")
    return dict(cold_ms=cold.latency_ms,
                warm_p50_ms=float(np.percentile(warm_ms, 50)),
                warm_p99_ms=float(np.percentile(warm_ms, 99)),
                plan=f"{cold.plan.algorithm} {cold.plan.grid_shape}",
                measured=cold.measured, launches=traced), traced


def fitting_scale(label: str, top: int, reckon, device: torch.device,
                  phase: str = "serve"):
    """The largest scale from ``top`` down whose reckoned bytes fit
    beside the graph pool; ``reckon(scale) -> (bytes, payload)``.
    Returns ``(scale, payload)`` and logs every cut, under ``phase``."""
    scale = top
    while True:
        need, payload = reckon(scale)
        ok, free = fits(need, device)
        if ok:
            return scale, payload
        log(f"{phase} {label}: scale {scale} reckoned {need:.0f} bytes, "
            f"{free:.0f} free beside the pool: cut to scale {scale - 1}")
        scale -= 1


def serve_round(w: Workload, per_slot: dict, impl: str,
                device: torch.device) -> dict:
    """One engine (``join_impl=impl``): the aggregated chain and the
    triangle query solo (the triangle's bytes reckoned beside the
    chain's graph), then ``SERVE_TENANTS`` tenants' triangle queries in
    one batch on an emptied graph pool, each lane held to its own solo
    submission.  Returns the launches of the traced submissions (one
    warm submission of each solo query, one warm batch) per kernel."""
    from repro_torch.core import (ChainQuery, JoinQuery, clear_compiled_caches,
                                  cost_query_cascade)
    from repro_torch.data.graphs import DATASETS, rmat_edges
    from repro_torch.kernels import ops
    from repro_torch.serving import (QueryEngine, QueryRequest,
                                     QueryServeConfig, weighted_total)

    eng = QueryEngine(QueryServeConfig(k=K, join_impl=impl), device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    top = int(math.log2(w.n_nodes))
    a3q, tq = ChainQuery.three_way(aggregate=True), JoinQuery.triangle()

    def edges(scale, seed=0):
        if scale == top and seed == 0:
            return w.edges[0]
        return rmat_edges(dataclasses.replace(DATASETS["amazon"],
                                              scale=scale), seed=seed)

    def tenant(scale, seed):
        src, dst = edges(scale, seed)
        return ([(src, dst)] * 3,) + triangle_stats(src, dst, 1 << scale)

    # A³: the planner's choice (2,3JA) over the main path's edges.
    def reckon_a3(scale):
        sw = w if scale == top else make_workload(scale, 0)
        st = a3_query_stats(sw)
        return (per_slot["cascade_pushdown"]
                * largest_slots(serve_caps(a3q, st), (K,)), (sw, st))
    scale, (sw, st) = fitting_scale(f"{impl} A^3", top, reckon_a3, device)

    def check_a3(res):
        total = res.measured["total"]
        want = analytic("2,3JA", sw.stats)
        check(total == want, f"serve A^3: measured {total} != {want}")
        check_against_a3(sw, res.output, True)
    a3, counts = serve_repeated(eng, f"{impl} A^3", a3q, sw.edges, st,
                                check_a3, device)
    log(f"serve {impl:10s} A^3 (scale {scale}) ok: {a3} "
        f"{memory_line(device)}")

    # Triangles: the serving sweep's query, cascade along (0, 1, 2),
    # beside A³'s graph.
    def reckon_triangles(scale):
        t = tenant(scale, 0)
        return per_slot["cascade"] * largest_slots(serve_caps(tq, t[1]),
                                                   (K,)), t

    def check_triangles(res, st, walks):
        count = weighted_total(tq, res.output)
        check(count == walks, f"serve triangles: {count} closed 3-walks "
                              f"!= host trace(A^3) {walks}")
        want = cost_query_cascade(list(st.sizes), st.intermediates[0])
        check(res.measured["total"] == want,
              f"serve triangles: measured {res.measured['total']} != {want}")
    scale, (tables, st, walks) = fitting_scale(f"{impl} triangles", top,
                                               reckon_triangles, device)
    tri_res, traced = serve_repeated(
        eng, f"{impl} triangles", tq, tables, st,
        lambda res: check_triangles(res, st, walks), device,
        strategy="cascade", join_order=SERVE_ORDER)
    counts = {k: c + traced[k] for k, c in counts.items()}
    log(f"serve {impl:10s} triangles (scale {scale}) ok: closed_3walks="
        f"{walks:.0f} {tri_res} {memory_line(device)}")

    # The batch: the largest scale at which the tenants' lanes, and one
    # tenant's solo graph beside them, fit in the card, the solo
    # queries' graphs dropped first.
    clear_compiled_caches()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"serve {impl:10s} solo graphs dropped: {memory_line(device)}")

    def reckon_batch(scale):
        tenants = [tenant(scale, t) for t in range(SERVE_TENANTS)]
        caps = [serve_caps(tq, st_t) for _, st_t, _ in tenants]
        caps = dataclasses.replace(caps[0], **{
            f: max(getattr(c, f) for c in caps)
            for f in ("recv", "mid", "out", "local", "agg", "join")})
        return (per_slot["cascade"] * largest_slots(
            caps, (K,), lanes=SERVE_TENANTS + 1), (tenants, caps))
    scale, (tenants, caps) = fitting_scale(f"{impl} batch", top,
                                           reckon_batch, device)
    width = max(len(tables[0][0]) for tables, _, _ in tenants)
    kw = dict(caps=caps, strategy="cascade", join_order=SERVE_ORDER,
              capacities=[width] * 3)
    reqs = [QueryRequest(tq, tables, stats=st_t, **kw)
            for tables, st_t, _ in tenants]
    before = eng.stats.batches
    ops.reset_launches()
    t0 = time.perf_counter()
    results = eng.submit_many(reqs)
    batch_ms = (time.perf_counter() - t0) * 1e3
    cold_launches = dict(ops.LAUNCHES)
    check(eng.stats.batches == before + 1,
          f"serve batch: {eng.stats.batches - before} executions, want 1")
    # The warm batch, traced: one replay of the laned graph.
    retried = len(TRACE_RETRIES)
    again, traced = traced_launches(
        lambda: eng.submit_many(reqs), device, cold_launches,
        lambda rs: all(r.ok and r.cache_hit and r.measured == c.measured
                       and same_relation(r.output, c.output)
                       for r, c in zip(rs, results)),
        "serve batch warm batch")
    retried = len(TRACE_RETRIES) - retried
    check(eng.stats.batches == before + 2 + retried
          and all(r.cache_hit for r in again),
          "serve batch: the warm batch was not one execution of cached plans")
    check(traced == cold_launches, f"serve batch: the warm batch launched "
                                   f"{traced} != the cold one's {cold_launches}")
    counts = {k: c + traced[k] for k, c in counts.items()}
    for t, (res, warm, (tables, st_t, walks_t)) in enumerate(
            zip(results, again, tenants)):
        check(res.ok and warm.ok, f"serve batch lane {t}: {res.error} "
                                  f"{warm.error}")
        check_triangles(res, st_t, walks_t)
        solo = eng.submit(tq, tables, stats=st_t, **kw)
        check(solo.ok and solo.cache_hit,
              f"serve batch lane {t}: solo {solo.error} hit={solo.cache_hit}")
        check(solo.measured == res.measured == warm.measured
              and same_relation(solo.output, res.output)
              and same_relation(solo.output, warm.output),
              f"serve batch lane {t}: differs from its solo submission")
    log(f"serve {impl:10s} batch (scale {scale}) ok: {SERVE_TENANTS} tenants "
        f"in 1 execution, batch_ms={batch_ms:.1f} closed_3walks="
        f"{[t[2] for t in tenants]} launches={traced} (traced warm batch) "
        f"{memory_line(device)}")
    if device.type == "cuda":
        for kname, used in (("segment_sum", True),
                            ("probe_counts", impl == "fused")):
            check(counts[kname] > 0 or not used,
                  f"serve {impl}: the {kname} kernel was never launched")
    clear_compiled_caches()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    snap = eng.stats.snapshot()
    log(f"serve {impl:10s} ok: launches={counts} (traced) hits="
        f"{snap['cache_hits']:.0f} misses={snap['cache_misses']:.0f} "
        f"batches={snap['batches']:.0f} errors={snap['errors']:.0f}; caches "
        f"cleared, {memory_line(device)}")
    return counts


def run_serving(w: Workload, per_slot: dict, device: torch.device) -> dict:
    """Phase 3c with each reduce-side join; returns the traced
    launches."""
    launches: dict = {}
    for impl in ("sort_merge", "fused"):
        for kname, c in serve_round(w, per_slot, impl, device).items():
            launches[kname] = launches.get(kname, 0) + c
    return launches


# ---------------------------------------------------------------------------
# Phase 3d: the map-side cascade over the partitioned store
# ---------------------------------------------------------------------------

MS_P = 16                 # stored partitions == devices of SimGrid((16,))
# Every hop map-side: the proven hops' own mode (the planner's
# chain_mapside_modes may broadcast T instead, 16·|T| < j1 here).
ALL_MAPSIDE = ("mapside", "mapside")
# (run, aggregated query, join_impl, relations stored, hop modes (None:
#  chain_mapside_modes'), place_output, measure_skew, the 3b replay it
#  is shown beside)
MS_RUNS = (
    ("MS,3J", False, "sort_merge", (0, 1, 2), ALL_MAPSIDE, True, False,
     ("2,3J", "sort_merge")),
    ("MS,3J", False, "fused", (0, 1, 2), ALL_MAPSIDE, True, False,
     ("2,3J", "sort_merge")),
    ("MS,3JA", True, "fused", (0, 1, 2), None, True, False,
     ("2,3JA", "fused")),
    # R handed in plain and grid-scattered: hop 1 repartitions R, hop 2
    # (no place_output) the intermediate, by the stored hash.
    ("mixed", False, "fused", (1, 2), ALL_MAPSIDE, False, True,
     ("2,3J", "sort_merge")),
)


def store_key(query, j: int) -> str:
    """The attribute relation j is stored on: its hop's join key."""
    return query.attrs[1] if j == 0 else query.attrs[j]


def store_columns(edges):
    """Each relation's stored key column: R(a, b) on b, S(b, c) on b,
    T(c, d) on c."""
    (_, r_dst), (s_src, _), (t_src, _) = edges
    return r_dst, s_src, t_src


def part_capacity_for(edges, P: int = MS_P) -> tuple[int, str]:
    """``default_part_capacity``, unless R-MAT's hubs fill a partition
    past it: then the exact per-partition counts × 1.05 + 256."""
    from repro_torch.core import default_part_capacity
    from repro_torch.core.hashing import bucket_hash
    default = default_part_capacity(len(edges[0][0]), P)
    fullest = max(int(np.bincount(bucket_hash(torch.as_tensor(col),
                                              P).numpy(),
                                  minlength=P).max())
                  for col in store_columns(edges))
    if fullest <= default:
        return default, f"default_part_capacity {default} (fullest {fullest})"
    cap = int(fullest * 1.05) + 256
    return cap, f"exact per-partition counts x 1.05 + 256 = {cap}"


def store_and_load(edges, part_cap: int, directory: str, tag: str,
                   device: torch.device, P: int = MS_P):
    """``partition_relation`` on the card → ``save_partitioned`` →
    ``load_partitioned`` (CRCs checked) → ``verify_partition_layout``,
    each relation; the certificate from the manifests alone."""
    from repro_torch.checkpoint import (load_partition_spec,
                                        load_partitioned, save_partitioned)
    from repro_torch.core import (ChainQuery, chain_partitioning,
                                  edge_relation, partition_relation,
                                  verify_partition_layout)
    query = ChainQuery.three_way()
    prels = []
    for j, (src, dst) in enumerate(edges):
        rel = edge_relation(src, dst, names=query.schema(j), device=device)
        pr, ovf = partition_relation(rel, store_key(query, j), P,
                                     part_capacity=part_cap)
        check(not bool(ovf), f"store {tag} {j}: partition overflow")
        save_partitioned(directory, f"{tag}_{j}", pr)
        back = load_partitioned(directory, f"{tag}_{j}", device=device)
        check(back.spec == pr.spec and same_relation(back.parts, pr.parts),
              f"store {tag} {j}: the loaded relation differs")
        check(verify_partition_layout(back), f"store {tag} {j}: layout")
        prels.append(back)
    specs = [load_partition_spec(directory, f"{tag}_{j}") for j in range(3)]
    return prels, chain_partitioning(query, specs)


def mapside_caps(w: Workload, MS_P: int = MS_P):
    """``default_mapside_caps(stats, MS_P)``, held to the exact per-device
    loads of the runs (host numpy): the hop-1 join and its placement by
    c (and each (source, destination) placement slot), the hop-2 join,
    and the mixed run's repartition of R.  A load past its buffer sizes
    that buffer from the loads × 1.05 + 256 instead, and says so."""
    from repro_torch.core import default_mapside_caps
    from repro_torch.core.hashing import bucket_hash
    caps = default_mapside_caps(w.stats, MS_P)
    (r_src, r_dst), (s_src, s_dst), (t_src, _) = w.edges
    n = w.n_nodes

    def h(x):
        return bucket_hash(torch.as_tensor(x), MS_P).numpy()
    indeg_r = np.bincount(r_dst, minlength=n).astype(np.float64)
    outdeg_t = np.bincount(t_src, minlength=n).astype(np.float64)
    paths2 = np.bincount(s_dst, weights=indeg_r[s_src], minlength=n)
    node = h(np.arange(n))
    hb, hc = h(s_src), h(s_dst)
    per = -(-len(r_src) // MS_P)            # R's scattered blocks
    need = {
        "mid": max(np.bincount(hb, weights=indeg_r[s_src],
                               minlength=MS_P).max(),
                   np.bincount(node, weights=paths2, minlength=MS_P).max()),
        "out": np.bincount(node, weights=paths2 * outdeg_t,
                           minlength=MS_P).max(),
        "slot": np.bincount(hb * MS_P + hc, weights=indeg_r[s_src],
                            minlength=MS_P ** 2).max(),
        "recv": np.bincount(np.arange(len(r_src)) // per * MS_P + h(r_dst),
                            minlength=MS_P ** 2).max(),
        "local": np.bincount(h(r_dst), minlength=MS_P).max(),
    }
    have = dict(dataclasses.asdict(caps), slot=-(-caps.mid // MS_P) + 256)
    short = {k: v for k, v in need.items() if v > have[k]}
    loads = " ".join(f"{k}={v:.0f}/{have[k]}" for k, v in need.items())
    if not short:
        log(f"mapside caps: default_mapside_caps hold the exact loads "
            f"({loads}): {dataclasses.asdict(caps)}")
        return caps
    fix = {k: int(1.05 * v) + 256 for k, v in short.items()}
    if "slot" in fix:
        fix["mid"] = max(fix.get("mid", caps.mid),
                         MS_P * (fix.pop("slot") - 256))
    caps = dataclasses.replace(caps, **{k: max(v, getattr(caps, k))
                                        for k, v in fix.items()})
    log(f"mapside caps: the exact loads ({loads}) overflow "
        f"default_mapside_caps; sized from them x 1.05 + 256: "
        f"{dataclasses.asdict(caps)}")
    return caps


def mapside_run(w: Workload, prels, cert, caps, run, device):
    """``(query, inputs, execute_chain keywords)`` of one ``MS_RUNS``
    entry: stored relations as loaded, the others grid-scattered; the
    certificate of what is stored; the entry's hop modes, or
    ``chain_mapside_modes``'."""
    from repro_torch.core import (ChainQuery, chain_mapside_modes,
                                  chain_partitioning, edge_relation,
                                  scatter_to_grid)
    _, aggregate, impl, stored, modes, place, measure, _ = run
    query = ChainQuery.three_way(aggregate=aggregate)
    rels = [prels[j] if j in stored else scatter_to_grid(edge_relation(
                *w.edges[j], names=query.schema(j), device=device), (MS_P,))
            for j in range(3)]
    part = cert if stored == (0, 1, 2) else chain_partitioning(
        query, [prels[j].spec if j in stored else None for j in range(3)])
    if modes is None:
        modes = chain_mapside_modes(w.stats.sizes, w.stats.prefix_joins,
                                    part)
    return query, rels, dict(strategy="mapside", caps=caps,
                             partitioning=part, hop_modes=modes,
                             place_output=place, join_impl=impl,
                             measure_skew=measure)


def same_valid_rows(a, b) -> bool:
    """The valid rows of every device, in order: equal results held in
    buffers of different capacities."""
    return (torch.equal(a.count(), b.count())
            and sorted(a.cols) == sorted(b.cols)
            and all(torch.equal(c[a.valid], b.cols[n][b.valid])
                    for n, c in a.cols.items()))


def run_mapside_path(w: Workload, per_slot: dict, replays_3b: dict,
                     device: torch.device) -> dict:
    """Phase 3d: the store, the four eager map-side runs each captured
    and replayed, then the served A³.  Returns the launches per kernel
    (eager runs, traced replays, traced submissions)."""
    from repro_torch.core import (SimGrid, chain_mapside_placed,
                                  chain_mapside_shuffles,
                                  clear_compiled_caches, cost_chain_mapside,
                                  execute_chain, jit_execute_chain,
                                  plan_chain)
    from repro_torch.kernels import ops

    on_gpu = device.type == "cuda"
    launches = {name: 0 for name in ops.LAUNCHES}
    clear_compiled_caches()
    if on_gpu:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    part_cap, how = part_capacity_for(w.edges)
    with tempfile.TemporaryDirectory() as tmp:
        sync(device)
        t0 = time.perf_counter()
        prels, cert = store_and_load(w.edges, part_cap, tmp, "main", device)
        sync(device)
        log(f"mapside store ok: R on b, S on b, T on c; P={MS_P}, "
            f"part_capacity {how}; partition + save + load + verify "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms; certificate {cert}")
    caps = mapside_caps(w)
    sizes, pj = w.stats.sizes, w.stats.prefix_joins
    results = {}
    for run in MS_RUNS:
        name, aggregate, impl, _, _, place, measure, twin = run
        query, rels, kw = mapside_run(w, prels, cert, caps, run, device)
        part, modes = kw["partitioning"], kw["hop_modes"]
        plan = plan_chain(w.stats, k=MS_P, aggregate=aggregate,
                          partitioning=part)
        label = f"{name} {impl}"
        sync(device)
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        eager = execute_chain(SimGrid((MS_P,)), query, rels, **kw)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        out, stats, overflow = eager
        check(not bool(overflow), f"mapside {label}: overflow")
        shuffled = tuple(float(x) for x in stats["hop_shuffled"])
        placed = tuple(float(x) for x in stats["hop_placed"])
        want_sh = chain_mapside_shuffles(sizes, pj, part, modes,
                                         place_output=place)
        want_pl = (chain_mapside_placed(sizes, pj, part, modes) if place
                   else (0.0,) * len(modes))
        check(shuffled == want_sh, f"mapside {label}: hop_shuffled "
                                   f"{shuffled} != {want_sh}")
        check(not place or all(sh == 0.0 for sh, m in zip(shuffled, modes)
                               if m == "mapside"),
              f"mapside {label}: a map-side hop shuffled tuples")
        check(placed == want_pl, f"mapside {label}: hop_placed {placed} "
                                 f"!= {want_pl}")
        total = float(stats["total"])
        want = cost_chain_mapside(sizes, pj, part, modes)
        if aggregate:
            want += 2.0 * pj[-1]            # the final charged Γ round
        # float32 stats: exact below 2^24, one ulp of the total past it.
        tol = float(np.spacing(np.float32(want))) if want >= 2 ** 24 else 0.0
        check(abs(total - want) <= tol,
              f"mapside {label}: total {total} != analytic {want}")
        rows = int(out.count().sum())
        check(aggregate or rows == pj[-1], f"mapside {label}: {rows} rows")
        groups = check_against_a3(w, out, aggregate)
        expect = {"segment_sum": aggregate, "probe_counts": impl == "fused",
                  "hash_histogram": measure}
        if on_gpu:
            for kname, used in expect.items():
                check(counts[kname] > 0 or not used,
                      f"mapside {label}: the {kname} kernel was never "
                      f"launched")
        for kname, c in counts.items():
            launches[kname] += c
        per_slot["mapside"] = max(per_slot.get("mapside", 0.0),
                                  peak / largest_slots(caps, (MS_P,)))

        # Captured: the first call warms up and captures, then replays
        # equal to eager, one of them traced.
        if on_gpu:
            torch.cuda.empty_cache()
        compiled = jit_execute_chain(SimGrid((MS_P,)), query, donate=False,
                                     **kw)
        t0 = time.perf_counter()
        first = compiled(rels)
        sync(device)
        capture_ms = (time.perf_counter() - t0) * 1e3
        check(same_result(first, eager),
              f"mapside {label}: first compiled call differs from eager")
        del first
        replay_ms = []
        for _ in range(REPLAYS):
            t0 = time.perf_counter()
            got = compiled(rels)
            sync(device)
            replay_ms.append((time.perf_counter() - t0) * 1e3)
            check(same_result(got, eager),
                  f"mapside {label}: replay differs from eager")
            del got
        got, traced = traced_launches(
            lambda: compiled(rels), device, counts,
            lambda got: same_result(got, eager), f"mapside {label} replay",
            plan=compiled)
        check(traced == counts or not on_gpu,
              f"mapside {label}: replay launched {traced} != eager {counts}")
        del got
        for kname, c in traced.items():
            launches[kname] += c
        if aggregate:
            results[name] = (out.map(lambda t: t.clone()),
                             {k: float(v) if v.dim() == 0
                              else tuple(float(x) for x in v)
                              for k, v in stats.items()})
        del eager, out, stats, overflow, rels, compiled
        cmp_ms = replays_3b.get(twin)
        log(f"mapside {label:17s} ok: plan_chain picked {plan.algorithm} "
            f"{plan.hop_modes}; ran modes={modes} rows={rows} "
            f"groups={groups} hop_shuffled={shuffled} placed={sum(placed):.0f} "
            f"total={total:.0f} analytic={want:.0f} wall_ms={wall_ms:.1f} "
            f"replay_ms={statistics.median(replay_ms):.1f} (median of "
            f"{REPLAYS}; {min(replay_ms):.1f}..{max(replay_ms):.1f}) "
            f"capture_ms={capture_ms:.1f} peak_bytes={peak} "
            f"launches={counts} traced_replay={traced}; compare {twin[0]} "
            f"{twin[1]} replay_ms="
            f"{'not run' if cmp_ms is None else f'{cmp_ms:.1f}'} (3b, "
            f"not a claim) {memory_line(device)}")
    if on_gpu:
        reserved = torch.cuda.max_memory_reserved()
        total_mem = torch.cuda.get_device_properties(device).total_memory
        check(reserved < total_mem, f"mapside: max_memory_reserved "
                                    f"{reserved} >= the card's {total_mem}")
    clear_compiled_caches()
    if on_gpu:
        torch.cuda.empty_cache()
    log(f"mapside compiled: caches cleared, {memory_line(device)}")
    counts = serve_mapside(w, prels, cert, results["MS,3JA"], per_slot,
                           device)
    for kname, c in counts.items():
        launches[kname] += c
    return launches


def serve_mapside(w: Workload, prels, cert, eager, per_slot: dict,
                  device: torch.device) -> dict:
    """A³ through ``QueryEngine(QueryServeConfig(k=16))`` over the loaded
    partitions with a current certificate: 1 cold and ``SERVE_WARM``
    warm submissions, each equal to the eager MS,3JA (its valid rows in
    order: the engine's caps are its own), then two tenants in one
    ``submit_many``, each lane equal to its solo submission.  Returns
    the traced submissions' launches."""
    from repro_torch.core import (ChainQuery, chain_stats_exact,
                                  clear_compiled_caches, default_mapside_caps)
    from repro_torch.data.graphs import DATASETS, rmat_edges
    from repro_torch.kernels import ops
    from repro_torch.serving import QueryEngine, QueryRequest, QueryServeConfig

    cfg = QueryServeConfig(k=K)
    eng = QueryEngine(cfg, device=device)
    query = ChainQuery.three_way(aggregate=True)
    opts = dict(rels=prels, partitioning=cert, strategy="mapside")
    e_out, e_stats = eager

    def engine_caps(stats):
        caps = default_mapside_caps(stats, MS_P, slack=cfg.caps_slack)
        return dataclasses.replace(caps, **{
            f: None if v is None else 1 << (int(v) - 1).bit_length()
            for f, v in dataclasses.asdict(caps).items()})

    need = per_slot["mapside"] * largest_slots(engine_caps(w.stats),
                                               (MS_P,))
    ok, free = fits(need, device)
    check(ok, f"serve mapside A^3: reckoned {need:.0f} bytes, {free:.0f} "
              f"free")

    def check_a3(res):
        check(res.plan.strategy == "mapside" and res.degraded is None,
              f"serve mapside: ran {res.plan.strategy} ({res.degraded})")
        check(res.measured == e_stats,
              f"serve mapside: stats {res.measured} != eager {e_stats}")
        check(same_valid_rows(res.output, e_out),
              "serve mapside: result differs from the eager MS,3JA")
    a3, counts = serve_repeated(eng, "mapside A^3", query, (), w.stats,
                                check_a3, device, **opts)
    log(f"serve mapside A^3 (scale {int(math.log2(w.n_nodes))}) ok: {a3} "
        f"{memory_line(device)}")

    # Two tenants in one execution: seed 0's stores and seed 1's,
    # stored the same way, caps that hold both; the solo graph dropped
    # first.
    clear_compiled_caches()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    top = int(math.log2(w.n_nodes))

    def reckon(scale):
        tenants = []
        for seed in (0, 1):
            edges = w.edges if (scale, seed) == (top, 0) else [rmat_edges(
                dataclasses.replace(DATASETS["amazon"], scale=scale),
                seed=seed)] * 3
            tenants.append((edges, w.stats if edges is w.edges
                            else chain_stats_exact(edges)))
        caps = [engine_caps(st) for _, st in tenants]
        caps = dataclasses.replace(caps[0], **{
            f: max(getattr(c, f) for c in caps)
            for f in ("recv", "mid", "out", "local", "agg", "join")})
        return (per_slot["mapside"] * largest_slots(caps, (MS_P,), lanes=3),
                (tenants, caps))
    scale, (tenants, caps) = fitting_scale("mapside batch", top, reckon,
                                           device)
    part_cap = max(part_capacity_for(e)[0] for e, _ in tenants)
    with tempfile.TemporaryDirectory() as tmp:
        stores = [store_and_load(e, part_cap, tmp, f"tenant{t}", device)
                  for t, (e, _) in enumerate(tenants)]
    reqs = [QueryRequest(query, (), stats=st, caps=caps, strategy="mapside",
                         partitioning=c)
            for (_, st), (_, c) in zip(tenants, stores)]
    prebuilt = [p for p, _ in stores]
    before = eng.stats.batches
    ops.reset_launches()
    t0 = time.perf_counter()
    results = eng.submit_many(reqs, prebuilt=prebuilt)
    batch_ms = (time.perf_counter() - t0) * 1e3
    cold = dict(ops.LAUNCHES)
    check(eng.stats.batches == before + 1,
          f"serve mapside batch: {eng.stats.batches - before} executions")
    again, traced = traced_launches(
        lambda: eng.submit_many(reqs, prebuilt=prebuilt), device, cold,
        lambda rs: all(r.ok and r.cache_hit and r.measured == c.measured
                       and same_relation(r.output, c.output)
                       for r, c in zip(rs, results)),
        "serve mapside batch warm batch")
    check(all(r.cache_hit for r in again) and traced == cold,
          f"serve mapside batch: warm batch {traced} != cold {cold}")
    counts = {k: c + traced[k] for k, c in counts.items()}
    for t, (res, warm, req, p) in enumerate(zip(results, again, reqs,
                                                prebuilt)):
        check(res.ok and warm.ok, f"serve mapside lane {t}: {res.error}")
        solo = eng.submit_many([req], prebuilt=[p])[0]
        check(solo.ok and solo.measured == res.measured == warm.measured
              and same_relation(solo.output, res.output)
              and same_relation(solo.output, warm.output),
              f"serve mapside lane {t}: differs from its solo submission")
    log(f"serve mapside batch (scale {scale}) ok: 2 tenants in 1 execution, "
        f"batch_ms={batch_ms:.1f} launches={traced} (traced warm batch) "
        f"{memory_line(device)}")
    clear_compiled_caches()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 3e: the paper's entry points at full width
# ---------------------------------------------------------------------------

def host_matrix_groups(n: int, mat) -> tuple[np.ndarray, np.ndarray]:
    """(row·n + col of every nonzero, its value), sorted: a host matrix
    in the unit ``check_groups`` compares in."""
    coo = mat.tocoo()
    keys = coo.row.astype(np.int64) * n + coo.col
    order = np.argsort(keys)
    return keys[order], coo.data[order]


def check_groups(out, n: int, row: str, col: str, want, what: str) -> int:
    """The (row, col, p) groups of an aggregated result equal a host
    matrix's nonzeros, values exactly."""
    dev = out.valid.device
    keys = (out.cols[row][out.valid].to(torch.int64) * n
            + out.cols[col][out.valid].to(torch.int64))
    keys, order = torch.sort(keys)
    vals = out.cols["p"][out.valid][order]
    want_keys = torch.as_tensor(want[0], device=dev)
    check(torch.equal(keys, want_keys), f"{what}: groups differ from the host")
    check(torch.equal(vals, torch.as_tensor(want[1].astype(np.float32),
                                            device=dev)),
          f"{what}: values differ from the host")
    return int(keys.numel())


def closed_walks(w: Workload) -> float:
    """trace(A³): the closed 3-walks, from the host A³'s diagonal."""
    diag = w.a3_keys // w.n_nodes == w.a3_keys % w.n_nodes
    return float(w.a3_vals[diag].sum())


def run_entry_points(w: Workload, device: torch.device) -> dict:
    """Phase 3e: ``one_round_three_way`` and ``cascade_three_way`` equal
    to ``execute_chain``'s 1,3J and 2,3J (phase 3's runs) as arrays;
    ``a_cubed`` 2,3JA and 1,3JA equal to A³ on the host and to the cost
    model; ``cascade_three_way_agg(include_final_agg=True)`` charging
    exactly the final Γ's tuples more; ``spmm`` equal to A² on the host;
    ``triangle_count_cycle`` (k = 16) and ``triangle_count_chain_filter``
    equal to trace(A³)/3.  Returns the launches per kernel."""
    import scipy.sparse as sp
    from repro_torch.core import (ChainQuery, SimGrid, a_cubed,
                                  cascade_three_way, cascade_three_way_agg,
                                  chain_edge_inputs, edge_relation,
                                  execute_chain, one_round_three_way,
                                  scatter_to_grid, spmm,
                                  triangle_count_chain_filter,
                                  triangle_count_cycle)
    from repro_torch.kernels import ops

    launches = {name: 0 for name in ops.LAUNCHES}
    grid, c = SimGrid(GRID), w.caps
    src, dst = w.edges[0]
    n = w.n_nodes
    kw = dict(recv_capacity=c.recv, mid_capacity=c.mid,
              out_capacity=c.out, local_capacity=c.local)

    def counted(fn, what):
        sync(device)
        ops.reset_launches()
        t0 = time.perf_counter()
        result = fn()
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        for kname, k in ops.LAUNCHES.items():
            launches[kname] += k
        return result, ms, dict(ops.LAUNCHES)

    for name, wrapper, strategy in (("1,3J", one_round_three_way, "one_round"),
                                    ("2,3J", cascade_three_way, "cascade")):
        query = ChainQuery.three_way()
        rels = chain_edge_inputs(query, w.edges, GRID, device=device)
        got, ms, counts = counted(lambda: wrapper(grid, *rels, **kw), name)
        want = execute_chain(grid, query, rels, strategy=strategy, caps=c)
        check(not bool(got[2]), f"entry {name}: overflow")
        check(same_result(got, want), f"entry {wrapper.__name__}: differs "
                                      f"from execute_chain({strategy!r})")
        total = float(got[1]["read"]) + float(got[1]["shuffled"])
        check(total == analytic(name, w.stats),
              f"entry {name}: measured {total} != analytic")
        log(f"entry {wrapper.__name__} ok: equal to execute_chain "
            f"{strategy} (output, stats, overflow) total={total:.0f} "
            f"wall_ms={ms:.1f} launches={counts}")
        del got, want, rels
        if device.type == "cuda":
            torch.cuda.empty_cache()

    caps = dict(input=len(src), recv=c.recv, local=c.local, mid=c.mid,
                agg=c.agg, join=c.join, out=c.out)
    for name in ("2,3JA", "1,3JA"):
        (out, stats, ovf), ms, counts = counted(
            lambda: a_cubed(grid, src, dst, algorithm=name, caps=caps,
                            device=device), name)
        check(not bool(ovf), f"entry a_cubed {name}: overflow")
        groups = check_against_a3(w, out, True)
        total, want = float(stats["total"]), analytic(name, w.stats)
        tol = float(np.spacing(np.float32(want))) if want >= 2 ** 24 else 0.0
        check(abs(total - want) <= tol,
              f"entry a_cubed {name}: measured {total} != analytic {want}")
        check(device.type != "cuda" or counts["segment_sum"] > 0,
              f"entry a_cubed {name}: segment_sum never launched")
        log(f"entry a_cubed {name} ok: groups={groups} equal to A^3 "
            f"total={total:.0f} analytic={want:.0f} wall_ms={ms:.1f} "
            f"launches={counts}")
        del out, stats
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # include_final_agg: the final Γ reads and shuffles the second hop's
    # rows, one per nonzero (a, c) of A² and edge out of c.
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    a2 = adj @ adj
    hop2 = float((a2 > 0).astype(np.float64) @ np.asarray(
        adj.sum(axis=1)).ravel() @ np.ones(n))
    rels = [scatter_to_grid(edge_relation(src, dst, names=names,
                                          device=device), GRID)
            for names in (("a", "b", "v"), ("b", "c", "w"), ("c", "d", "x"))]
    runs = {}
    for flag in (False, True):
        runs[flag], ms, counts = counted(lambda: cascade_three_way_agg(
            grid, *rels, agg_capacity=c.agg, include_final_agg=flag,
            join_impl="fused", **kw), "2,3JA")
        check(not bool(runs[flag][2]), "entry include_final_agg: overflow")
    (out_f, st_f, _), (out_t, st_t, _) = runs[False], runs[True]
    check(same_relation(out_f, out_t),
          "entry include_final_agg: the result changed")
    # Stats are float32 sums: the charged run adds the final Γ's tuples
    # to the uncharged sum in float32.
    extra = {k: float(st_t[k]) - float(st_f[k]) for k in ("read", "shuffled")}
    check(all(float(st_t[k]) == float(np.float32(float(st_f[k]))
                                      + np.float32(hop2))
              for k in ("read", "shuffled")),
          f"entry include_final_agg: charged {extra} more, the final Γ "
          f"holds {hop2:.0f} tuples each way")
    check(device.type != "cuda" or counts["probe_counts"] > 0,
          "entry include_final_agg: probe_counts never launched")
    log(f"entry cascade_three_way_agg include_final_agg ok: True charges "
        f"read +{extra['read']:.0f} shuffled +{extra['shuffled']:.0f} (the "
        f"final Γ's {hop2:.0f} tuples each way, added in float32) total "
        f"{float(st_f['total']):.0f} -> {float(st_t['total']):.0f} "
        f"(fused) wall_ms={ms:.1f} launches={counts}")
    del runs, out_f, out_t, rels
    if device.type == "cuda":
        torch.cuda.empty_cache()

    a, b = (scatter_to_grid(edge_relation(src, dst, names=names,
                                          device=device), GRID)
            for names in (("a", "b", "v"), ("b", "c", "w")))
    (out, stats, ovf), ms, counts = counted(lambda: spmm(
        grid, a, b, recv_capacity=c.recv, mid_capacity=c.mid,
        out_capacity=c.agg, local_capacity=c.local, join_impl="fused"),
        "spmm")
    check(not bool(ovf), "entry spmm: overflow")
    groups = check_groups(out, n, "a", "c", host_matrix_groups(n, a2),
                          "entry spmm")
    log(f"entry spmm ok: groups={groups} equal to A^2 on the host "
        f"read={float(stats['read']):.0f} shuffled="
        f"{float(stats['shuffled']):.0f} wall_ms={ms:.1f} launches={counts}")
    del out, stats, a, b
    if device.type == "cuda":
        torch.cuda.empty_cache()

    walks = closed_walks(w)
    (count, plan, stats, ovf), ms, counts = counted(
        lambda: triangle_count_cycle(src, dst, k=K, device=device),
        "triangles")
    check(not bool(ovf), "entry triangle_count_cycle: overflow")
    check(3 * count == walks, f"entry triangle_count_cycle: {count} != "
                              f"trace(A^3)/3 = {walks / 3}")
    log(f"entry triangle_count_cycle ok: {count:.4f} = trace(A^3)/3 "
        f"({plan.algorithm} {plan.strategy} {plan.grid_shape}) "
        f"total={float(stats['read']) + float(stats['shuffled']):.0f} "
        f"wall_ms={ms:.1f} (host statistics and planning included) "
        f"launches={counts}")
    (tri, stats, ovf), ms, counts = counted(
        lambda: triangle_count_chain_filter(grid, src, dst, caps=caps,
                                            device=device), "chain filter")
    check(not bool(ovf), "entry triangle_count_chain_filter: overflow")
    check(round(3 * tri) == walks,
          f"entry triangle_count_chain_filter: {tri} != {walks / 3}")
    log(f"entry triangle_count_chain_filter ok: {tri:.4f} = trace(A^3)/3 "
        f"(2,3JA) wall_ms={ms:.1f} launches={counts}")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 3f: streaming ingest (ServingStore)
# ---------------------------------------------------------------------------

STORE_BATCHES = 4
STORE_INSERTS, STORE_DELETES = 256, 64


def host_counts(src, dst, n: int) -> tuple[float, float]:
    """(closed 3-walks / 3, 3-paths) of an edge list with multiplicities,
    from ``scipy.sparse``."""
    import scipy.sparse as sp
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    a2 = adj @ adj
    walks = float(a2.multiply(adj.T).sum())
    paths = float((adj @ (adj @ (adj @ np.ones(n)))).sum())
    return walks / 3.0, paths


def run_store(w: Workload, per_slot: dict, seed: int,
              device: torch.device) -> dict:
    """Phase 3f: a ``ServingStore`` over R-MAT ``amazon`` at the largest
    scale whose full triangle and 3-path counts' reckoned bytes fit in
    the card, with a triangle and a 3-path aggregate; ``STORE_BATCHES``
    micro-batches of inserts and deletes, each value held to a host
    recount and each delta cheaper than the recompute it avoids; then a
    failed batch and a failed reopen that leave the store as it was.
    Returns the launches per kernel."""
    from repro_torch.core import JoinQuery, clear_compiled_caches
    from repro_torch.core import query_stats_exact
    from repro_torch.data.graphs import DATASETS, rmat_edges
    from repro_torch.kernels import ops
    from repro_torch.resilience import FaultInjector, FaultSpec, InjectedCrash
    from repro_torch.serving import (IngestError, QueryEngine,
                                     QueryServeConfig, ServingStore)

    clear_compiled_caches()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    top = int(math.log2(w.n_nodes))

    # The load captures the triangle count's graph, then runs the
    # 3-path count's warm-up beside it: both plans' bytes must fit.
    def reckon(scale):
        edges = w.edges[0] if scale == top else rmat_edges(
            dataclasses.replace(DATASETS["amazon"], scale=scale), seed=seed)
        slots = sum(largest_slots(serve_caps(q, query_stats_exact(
            q, [edges] * 3)), (K,))
            for q in (JoinQuery.triangle(), JoinQuery.chain(3)))
        return per_slot["cascade"] * slots, edges
    scale, (src, dst) = fitting_scale("store", top, reckon, device)
    n = 1 << scale
    eng = QueryEngine(QueryServeConfig(k=K, join_impl="fused"), device=device)
    ops.reset_launches()
    rng = np.random.default_rng(seed)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        store = ServingStore(tmp, eng, num_partitions=K,
                             drift_threshold=None)
        store.register_aggregate("tri", "cycle", 3)
        store.register_aggregate("p3", "chain", 3)
        store.load_edges(src, dst)
        load_ms = (time.perf_counter() - t0) * 1e3

        def check_values(when):
            tri, paths = host_counts(store.src, store.dst, n)
            got = (store.aggregates["tri"].value,
                   store.aggregates["p3"].value)
            # the /3 of the triangle count accumulates float64 ulps
            check(math.isclose(got[0], tri, rel_tol=1e-9) and
                  got[1] == paths, f"store {when}: values {got} != host "
                                   f"recount ({tri}, {paths})")
            return tri, paths
        tri, paths = check_values("load")
        log(f"store ok: R-MAT amazon scale {scale}, {store.n_edges} edges, "
            f"P={K}; tri={tri:.4f} p3={paths:.0f} equal to the host "
            f"recount; load + two full counts {load_ms:.1f} ms "
            f"{memory_line(device)}")
        # 256 inserts and 64 deletes a batch; a graph under 16,384 edges
        # (a rehearsal's) takes a batch of a 64th of its edges.
        n_ins = min(STORE_INSERTS, store.n_edges // 64)
        n_del = n_ins * STORE_DELETES // STORE_INSERTS
        for step in range(STORE_BATCHES):
            cur = set(zip(store.src.tolist(), store.dst.tolist()))
            ins = set()
            while len(ins) < n_ins:
                e = (int(rng.integers(0, n)), int(rng.integers(0, n)))
                if e not in cur:
                    ins.add(e)
            ins = sorted(ins)
            pick = rng.choice(store.n_edges, size=n_del, replace=False)
            hits0 = eng.stats.hits
            t0 = time.perf_counter()
            rep = store.apply_deltas(
                inserts=(np.array([a for a, _ in ins]),
                         np.array([b for _, b in ins])),
                deletes=(store.src[pick], store.dst[pick]))
            ms = (time.perf_counter() - t0) * 1e3
            tri, paths = check_values(f"batch {step}")
            moved = {name: (a["total"], a["recompute_cost"])
                     for name, a in rep["aggregates"].items()
                     if a["mode"] == "delta"}
            modes = [a["mode"] for a in rep["aggregates"].values()]
            check(len(moved) == 2, f"store batch {step}: modes {modes}")
            # Each aggregate's delta cascades moved fewer tuples than its
            # own recompute, and so did both together since the load
            # (the engine's savings counters).
            for name, (delta, recompute) in moved.items():
                check(delta < recompute,
                      f"store batch {step}: {name} delta tuples {delta} "
                      f">= its recompute_cost {recompute}")
            check(eng.stats.delta_tuples < eng.stats.recompute_tuples,
                  f"store batch {step}: delta_tuples "
                  f"{eng.stats.delta_tuples} >= recompute_tuples "
                  f"{eng.stats.recompute_tuples}")
            log(f"store batch {step} ok: +{n_ins} -{n_del} "
                f"v{rep['version']} tri={tri:.4f} p3={paths:.0f} equal to the "
                f"host recount; delta/recompute tuples tri="
                f"{moved['tri'][0]:.0f}/{moved['tri'][1]:.0f} p3="
                f"{moved['p3'][0]:.0f}/{moved['p3'][1]:.0f}, engine "
                f"{eng.stats.delta_tuples:.0f}/"
                f"{eng.stats.recompute_tuples:.0f}; ingest_ms={ms:.1f} engine hits +{eng.stats.hits - hits0} "
                f"(misses {eng.stats.misses})")

        # A batch whose every submission dies (retries exhausted, and the
        # recompute fallback's too) raises and changes nothing; the
        # store's writes never read a partition, so a partition_read
        # crash can only hit a reopen, which it fails.
        snap = (store.version, store.aggregates["tri"].value,
                store.aggregates["p3"].value)
        with FaultInjector([FaultSpec("submit", "crash", 1.0)],
                           seed=seed) as inj:
            try:
                store.apply_deltas(inserts=(np.array([0]), np.array([1])))
                check(False, "store: a batch under submit crashes applied")
            except IngestError:
                pass
        fired = inj.counters()
        with FaultInjector([FaultSpec("partition_read", "crash", 1.0)],
                           seed=seed) as inj:
            try:
                ServingStore(tmp, eng)
                check(False, "store: a reopen under partition_read "
                             "crashes succeeded")
            except InjectedCrash:
                pass
        fired.update(inj.counters())
        reopened = ServingStore(tmp, eng)
        for s in (store, reopened):
            check((s.version, s.aggregates["tri"].value,
                   s.aggregates["p3"].value) == snap,
                  f"store: a failed batch or reopen changed the store")
        log(f"store faults ok: version {snap[0]} and both values unchanged "
            f"in memory and on reopen; fired {fired}")
    counts = dict(ops.LAUNCHES)
    check(device.type != "cuda" or counts["probe_counts"] > 0,
          "store: probe_counts never launched")
    snapshot = eng.stats.snapshot()
    clear_compiled_caches()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"store ok: launches={counts} (eager warm-ups) hits="
        f"{snapshot['cache_hits']:.0f} misses={snapshot['cache_misses']:.0f} "
        f"delta_tuples={snapshot['delta_tuples']:.0f} recompute_tuples="
        f"{snapshot['recompute_tuples']:.0f}; caches cleared, "
        f"{memory_line(device)}")
    return counts


# ---------------------------------------------------------------------------
# Phase 3g: lineage recovery
# ---------------------------------------------------------------------------

RECOVERY_RATE = 0.2


def run_recovery(w: Workload, seed: int, device: torch.device) -> dict:
    """Phase 3g at the main path's graph: ``resilient_cascade_query``
    (the aggregated chain, cascade then a charged Γ) and
    ``resilient_one_round_query`` (1,3J, ``fused``) bit-identical to the
    plain executors fault-free and under seeded crashes; a cascade
    killed in hop 1 resumes from hop 0's snapshot bit-identically; a
    compiled plan's capture and replay fire nothing.  Returns the
    launches per kernel (eager runs)."""
    from repro_torch.core import (ChainQuery, SimGrid, chain_edge_inputs,
                                  clear_compiled_caches, jit_execute_chain)
    from repro_torch.core.executor import cascade_query, one_round_query
    from repro_torch.checkpoint import latest_hop
    from repro_torch.kernels import ops
    from repro_torch.resilience import (FaultInjector, FaultSpec, HopFailed,
                                        resilient_cascade_query,
                                        resilient_one_round_query)

    grid = SimGrid(GRID)
    ops.reset_launches()
    # The cascade's one mid-sized buffer is hop 0's output (J1): sized
    # for j1, so its snapshot is not a j3-sized buffer of padding.
    j1 = w.stats.prefix_joins[0]
    caps_c = dataclasses.replace(w.caps, mid=int(j1 * 6 / math.prod(GRID))
                                 + 256)
    agg = ChainQuery.three_way(aggregate=True)
    rels = chain_edge_inputs(agg, w.edges, GRID, device=device)

    def timed_run(fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        return out, (time.perf_counter() - t0) * 1e3

    plain, plain_ms = timed_run(lambda: cascade_query(grid, agg, rels,
                                                      caps=caps_c))
    check(not bool(plain[2]), "recovery cascade: overflow")
    check_against_a3(w, plain[0], True)

    def cascade(**kw):
        return resilient_cascade_query(grid, agg, rels, caps=caps_c, **kw)
    got, ff_ms = timed_run(cascade)
    check(same_result(got[:3], plain) and got[3].retries == 0,
          "recovery cascade: fault-free run differs from cascade_query")
    with FaultInjector([FaultSpec("shuffle", "crash", RECOVERY_RATE)],
                       seed=seed) as inj:
        got, f_ms = timed_run(cascade)
    check(same_result(got[:3], plain), "recovery cascade: faulted run differs")
    check(sum(inj.fired.values()) > 0, "recovery cascade: nothing fired")
    rep = got[3].to_json()
    log(f"recovery cascade ok: bit-identical fault-free and under shuffle "
        f"crashes (rate {RECOVERY_RATE}, seed {seed}); fired "
        f"{inj.counters()} retries={rep['retries']} "
        f"recovery={rep['recovery']} "
        f"plain_ms={plain_ms:.1f} resilient_ms={ff_ms:.1f} "
        f"faulted_ms={f_ms:.1f}")
    del got
    with tempfile.TemporaryDirectory() as snap:
        # Hop 0 offers 2 shuffles a grid axis to the injector (left and
        # right); armed after them, every attempt of hop 1 dies.
        first = 2 * len(GRID)
        t0 = time.perf_counter()
        with FaultInjector([FaultSpec("shuffle", "crash", 1.0,
                                      skip_first=first)], seed=seed):
            try:
                cascade(snapshot_dir=snap)
                check(False, "recovery killed run: hop 1 survived")
            except HopFailed as e:
                check(e.where == "hop_1", f"recovery killed run: {e.where}")
        check(latest_hop(snap) == 0, "recovery killed run: no hop 0 "
                                     "snapshot")
        got = cascade(snapshot_dir=snap)
        ms = (time.perf_counter() - t0) * 1e3
        check(got[3].resumed_from == 0 and got[3].retries == 0
              and same_result(got[:3], plain),
              "recovery killed run: the resumed run differs")
        size = sum(p.stat().st_size for p in Path(snap).rglob("*")
                   if p.is_file())
    log(f"recovery resume ok: killed in hop 1, resumed from hop 0's "
        f"snapshot ({size} bytes) bit-identically; kill + resume "
        f"{ms:.1f} ms")
    del got, plain, rels
    if device.type == "cuda":
        torch.cuda.empty_cache()

    query = ChainQuery.three_way()
    rels = chain_edge_inputs(query, w.edges, GRID, device=device)
    plain, plain_ms = timed_run(lambda: one_round_query(
        grid, query, rels, caps=w.caps, join_impl="fused"))
    check(not bool(plain[2]), "recovery one_round: overflow")

    def one_round():
        return resilient_one_round_query(grid, query, rels, caps=w.caps,
                                         join_impl="fused")
    got, ff_ms = timed_run(one_round)
    check(same_result(got[:3], plain) and got[3].retries == 0,
          "recovery one_round: fault-free run differs from one_round_query")
    with FaultInjector([FaultSpec("shuffle", "crash", RECOVERY_RATE),
                        FaultSpec("reducer", "crash", RECOVERY_RATE)],
                       seed=seed) as inj:
        got, f_ms = timed_run(one_round)
    check(same_result(got[:3], plain),
          "recovery one_round: faulted run differs")
    check(inj.fired[("reducer", "crash")] > 0,
          "recovery one_round: no reducer failed")
    rep = got[3].to_json()
    log(f"recovery one_round ok: bit-identical fault-free and under "
        f"shuffle + reducer crashes (rate {RECOVERY_RATE}, seed {seed}); "
        f"fired {inj.counters()} failed_reducers={rep['failed_reducers']} "
        f"retries={rep['retries']} recovery={rep['recovery']} "
        f"plain_ms={plain_ms:.1f} resilient_ms={ff_ms:.1f} "
        f"faulted_ms={f_ms:.1f}")
    del got
    counts = dict(ops.LAUNCHES)

    # A compiled plan (warm-up, capture, replays) fires nothing and
    # draws nothing, with every rule at rate 1.
    run = jit_execute_chain(grid, query, strategy="one_round", caps=w.caps,
                            donate=False, join_impl="fused")
    with FaultInjector([FaultSpec("shuffle", "crash", 1.0),
                        FaultSpec("reducer", "crash", 1.0)],
                       seed=seed) as inj:
        for _ in range(2):
            got = run(rels)
            check(same_result(got[:3], plain), "recovery: the compiled plan "
                                           "differs from eager")
            del got
    check(not inj.observed and not inj.fired,
          f"recovery: a compiled plan fired or drew: {dict(inj.observed)}")
    del plain, rels, run
    clear_compiled_caches()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"recovery compiled ok: capture + replay under rate-1 rules "
        f"observed no opportunity; launches={counts} (eager runs); "
        f"caches cleared, {memory_line(device)}")
    return counts


# ---------------------------------------------------------------------------
# Phase 3h: the overlapped shuffle schedule
# ---------------------------------------------------------------------------

# (paper name, aggregated query, strategy) of the overlapped runs, each
# run with both joins at OVERLAP_CHUNKS; the 2,3J sort_merge run again
# at OVERLAP_MORE chunks where its reckoned bytes fit.
OVERLAP_RUNS = (("1,3J", False, "one_round"), ("2,3J", False, "cascade"),
                ("2,3JA", True, "cascade_pushdown"),
                ("1,3JA", True, "one_round"))
OVERLAP_CHUNKS = 2
OVERLAP_MORE = 4
# Phase 3's unchunked runs (sort_merge, without measure_skew; the fused
# twins are bit-identical to them): stats, and the enumerations' sorted
# packed (a, b, c, d) rows, kept on the host for phase 3h.
UNCHUNKED: dict = {}


def packed_rows(w: Workload, out) -> torch.Tensor:
    """The valid (a, b, c, d) rows of an enumeration, each packed into
    one int64 (node ids < 2^15), sorted: its tuple multiset."""
    bits = max(1, (w.n_nodes - 1).bit_length())
    key = torch.zeros_like(out.cols["a"][out.valid], dtype=torch.int64)
    for name in ("a", "b", "c", "d"):
        key = (key << bits) | out.cols[name][out.valid].to(torch.int64)
    return torch.sort(key).values


def run_overlap_path(w: Workload, replays_3b: dict, device: torch.device
                     ) -> dict:
    """Phase 3h: 1,3J, 2,3J, 2,3JA and 1,3JA with ``overlap_chunks=2``
    (both joins), eager and through ``jit_execute_chain``, one plan
    captured at a time.  Each run: no overflow, stats bit-equal to
    phase 3's unchunked run, the result equal to A³ (the enumerations'
    tuple multiset to phase 3's), every replay equal to eager; then
    ``op_audit.audit_lowerings`` on the device, every report clean.
    Returns the launches per kernel (eager runs and traced replays)."""
    from repro_torch.analysis import op_audit
    from repro_torch.core import (ChainQuery, SimGrid, chain_edge_inputs,
                                  clear_compiled_caches, execute_chain,
                                  jit_execute_chain)
    from repro_torch.kernels import ops

    on_gpu = device.type == "cuda"
    launches = {name: 0 for name in ops.LAUNCHES}
    clear_compiled_caches()
    if on_gpu:
        torch.cuda.empty_cache()
    runs = [(name, agg, strategy, impl, OVERLAP_CHUNKS)
            for name, agg, strategy in OVERLAP_RUNS
            for impl in ("sort_merge", "fused")]
    runs.insert(3, ("2,3J", False, "cascade", "sort_merge", OVERLAP_MORE))
    peaks: dict = {}
    for name, aggregate, strategy, impl, chunks in runs:
        label = f"{name} {impl} C={chunks}"
        query = ChainQuery.three_way(aggregate=aggregate)
        if chunks == OVERLAP_MORE and on_gpu:
            # Each chunk past the first adds one full out_capacity part
            # and its share of the concat and the compaction: the step
            # from phase 3's unchunked peak to the C=2 peak, once per
            # further chunk.  The eager run's cache and the capture's
            # warm-up (on another stream, and fragmenting: 2,3J's at 4
            # chunks ran out of memory on an H100 80GB with 14.4 GiB
            # reserved but unallocated) are each that large.
            step = peaks[(name, impl)] - UNCHUNKED[name]["peak"]
            need = 2 * (peaks[(name, impl)]
                        + (OVERLAP_MORE - OVERLAP_CHUNKS) * step)
            free = torch.cuda.mem_get_info(device)[0]
            if need > free:
                log(f"overlap {label}: not run: reckoned {need} bytes "
                    f"(eager run and warm-up, each the C={OVERLAP_CHUNKS} "
                    f"peak plus {OVERLAP_MORE - OVERLAP_CHUNKS} steps of "
                    f"{step}) against {free} free")
                continue
        rels = chain_edge_inputs(query, w.edges, GRID, device=device)
        kw = dict(strategy=strategy, caps=w.caps, join_impl=impl,
                  overlap_chunks=chunks)
        sync(device)
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        eager = execute_chain(SimGrid(GRID), query, rels, **kw)
        sync(device)
        eager_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        peaks[(name, impl)] = peak
        out, stats, overflow = eager
        check(not bool(overflow), f"overlap {label}: overflow")
        want = UNCHUNKED[name]
        got_stats = {k: v.cpu() for k, v in stats.items()}
        check(sorted(got_stats) == sorted(want["stats"])
              and all(torch.equal(v, want["stats"][k])
                      for k, v in got_stats.items()),
              f"overlap {label}: stats {got_stats} != unchunked "
              f"{want['stats']}")
        groups = check_against_a3(w, out, aggregate)
        if not aggregate:
            check(torch.equal(packed_rows(w, out).cpu(), want["rows"]),
                  f"overlap {label}: tuple multiset differs from the "
                  f"unchunked run")
        expect = {"segment_sum": aggregate, "probe_counts": impl == "fused",
                  "hash_histogram": False}
        for kname, used in expect.items():
            check(counts[kname] > 0 or not used or not on_gpu,
                  f"overlap {label}: the {kname} kernel was never launched")
        for kname, c in counts.items():
            launches[kname] += c
        if on_gpu:
            torch.cuda.empty_cache()

        run = jit_execute_chain(SimGrid(GRID), query, donate=False, **kw)
        t0 = time.perf_counter()
        first = run(rels)
        sync(device)
        capture_ms = (time.perf_counter() - t0) * 1e3
        check(same_result(first, eager),
              f"overlap {label}: first compiled call differs from eager")
        del first
        replay_ms = []
        for _ in range(REPLAYS):
            t0 = time.perf_counter()
            got = run(rels)
            sync(device)
            replay_ms.append((time.perf_counter() - t0) * 1e3)
            check(same_result(got, eager),
                  f"overlap {label}: replay differs from eager")
            del got
        got, traced = traced_launches(
            lambda: run(rels), device, counts,
            lambda got: same_result(got, eager), f"overlap {label} replay",
            plan=run)
        check(traced == counts or not on_gpu,
              f"overlap {label}: replay launched {traced} != eager {counts}")
        del got
        for kname, c in traced.items():
            launches[kname] += c
        pool = graph_pool_bytes() if on_gpu else 0
        twin = replays_3b.get((name, impl)) or replays_3b.get(
            (name, "sort_merge"))
        twin_label = impl if (name, impl) in replays_3b else "sort_merge"
        del eager, out, stats, overflow, run
        clear_compiled_caches()
        if on_gpu:
            torch.cuda.empty_cache()
        del rels
        log(f"overlap {label:22s} ok: groups={groups} stats bit-equal to "
            f"the unchunked run; eager_ms={eager_ms:.1f} "
            f"replay_ms={statistics.median(replay_ms):.1f} (median of "
            f"{REPLAYS}; {min(replay_ms):.1f}..{max(replay_ms):.1f}) beside "
            f"3b's unchunked {name} {twin_label} replay_ms="
            f"{'not run' if twin is None else f'{twin:.1f}'}; "
            f"capture_ms={capture_ms:.1f} peak_bytes={peak} "
            f"pool_bytes={pool} launches={counts} traced_replay={traced}")

    ops.reset_launches()
    reports = op_audit.audit_lowerings(device=device)
    counts = dict(ops.LAUNCHES)
    bad = [r.summary() for r in reports if not r.ok or r.findings]
    check(not bad, "op audit on the device: " + "; ".join(bad))
    check(not on_gpu or counts["probe_counts"] > 0,
          "op audit: fused lowerings launched no probe_counts kernel")
    for kname, c in counts.items():
        launches[kname] += c
    clear_compiled_caches()
    if on_gpu:
        torch.cuda.empty_cache()
    log(f"overlap op audit on {device.type} ok: {len(reports)} reports "
        f"clean ({', '.join(r.target for r in reports)}); ops walked "
        f"{sum(r.metrics.get('n_ops', 0) for r in reports)}; "
        f"launches={counts}")
    return launches


# ---------------------------------------------------------------------------
# Phase 3i: the ShardGrid — 8 ranks of torch.distributed on one card
# ---------------------------------------------------------------------------

SHARD_MESH = (2, 2, 2)
SHARD_AXES = ("pod", "data", "model")
SHARD_LAYOUTS = {"cube": SHARD_AXES, "flat": (SHARD_AXES,),
                 "pair": (("pod", "data"), "model")}
SHARD_SHAPES = {"cube": (2, 2, 2), "flat": (8,), "pair": (4, 2)}
SHARD_P = 8                    # the map-side store's partitions: (8,)
SHARD_TOP_SCALE = 14
# (run, layout, aggregated query (None: the triangle), strategy,
#  join_impl, overlap_chunks, measure_skew)
SHARD_RUNS = (
    ("triangle 1,3J", "cube", None, "one_round", "sort_merge", 1, False),
    ("2,3J", "flat", False, "cascade", "sort_merge", 1, False),
    ("2,3J", "flat", False, "cascade", "sort_merge", 2, False),
    ("2,3JA", "flat", True, "cascade_pushdown", "sort_merge", 1, False),
    ("2,3JA", "flat", True, "cascade_pushdown", "sort_merge", 2, False),
    ("2,3JA", "flat", True, "cascade_pushdown", "fused", 1, True),
    ("MS,3J", "flat", False, "mapside", "sort_merge", 1, False),
    ("1,3JA", "pair", True, "one_round_three_way_agg", "sort_merge", 1,
     False),
)
# Bytes a slot of a relation buffer takes (four int32 columns, or three
# and a float32 value, and the mask): the unit of the ranks' send and
# receive buffers, which a SimGrid run never builds.
SHARD_ROW_BYTES = 17
# One CUDA context and its allocator per rank.
SHARD_CONTEXT_BYTES = 1 << 30


def shard_label(run) -> str:
    name, layout, _, _, impl, chunks, measure = run
    return (f"{name} {SHARD_SHAPES[layout]} {impl} C={chunks}"
            f"{' measure_skew' if measure else ''}")


def shard_edges(scale: int, seed: int):
    from repro_torch.data.graphs import DATASETS, rmat_edges
    spec = dataclasses.replace(DATASETS["amazon"], scale=scale)
    return rmat_edges(spec, seed=seed), spec.n_nodes


def shard_caps(stats, tri_stats, run):
    """The run's caps: ``default_chain_caps`` on its grid, the
    triangle's ``default_query_caps``, map-side ``default_mapside_caps``
    (held to the exact loads by ``mapside_caps``)."""
    from repro_torch.core import (JoinQuery, default_chain_caps,
                                  default_query_caps)
    shape = SHARD_SHAPES[run[1]]
    if run[2] is None:
        return default_query_caps(JoinQuery.triangle(), tri_stats, shape)
    return default_chain_caps(stats, shape)


def shard_inputs(run, edges, spec, device):
    """The run's global inputs, on ``device``: grid-scattered relations,
    or the stored partitions loaded from ``spec["store"]``."""
    from repro_torch.checkpoint import load_partitioned
    from repro_torch.core import (ChainQuery, JoinQuery, chain_edge_inputs,
                                  query_table_inputs)
    name, layout, aggregate = run[:3]
    shape = SHARD_SHAPES[layout]
    if aggregate is None:
        return query_table_inputs(JoinQuery.triangle(), [edges] * 3, shape,
                                  device=device)
    if run[3] == "mapside":
        return [load_partitioned(spec["store"], f"s{SHARD_P}_{j}",
                                 device=device) for j in range(3)]
    return chain_edge_inputs(ChainQuery.three_way(aggregate=aggregate),
                             [edges] * 3, shape, device=device)


def shard_execute(grid, run, rels, caps, cert):
    from repro_torch.core import (ChainQuery, JoinQuery, execute_chain,
                                  execute_query, one_round_three_way_agg)
    _, _, aggregate, strategy, impl, chunks, measure = run
    if aggregate is None:
        return execute_query(grid, JoinQuery.triangle(), rels,
                             strategy=strategy, caps=caps, join_impl=impl,
                             overlap_chunks=chunks)
    if strategy == "one_round_three_way_agg":
        return one_round_three_way_agg(
            grid, *rels, recv_capacity=caps.recv, mid_capacity=caps.mid,
            join_capacity=caps.join, out_capacity=caps.out,
            local_capacity=caps.local, join_impl=impl)
    extra = dict(partitioning=cert, hop_modes=("mapside", "mapside"),
                 place_output=True) if strategy == "mapside" else {}
    return execute_chain(grid, ChainQuery.three_way(aggregate=aggregate),
                         rels, strategy=strategy, caps=caps, join_impl=impl,
                         overlap_chunks=chunks, measure_skew=measure,
                         **extra)


def digests(rel, index=()) -> dict:
    """SHA-256 of every column's and the mask's bytes at ``index`` (a
    device's slice of a SimGrid tensor, or a rank's whole shard): equal
    digests are equal full arrays, padding and row order included."""
    import hashlib
    out = {}
    for name, t in sorted(rel.cols.items()) + [("valid", rel.valid)]:
        out[name] = hashlib.sha256(
            t[index].contiguous().cpu().numpy().tobytes()).hexdigest()
    return out


def shard_rank(rank: int, spec: dict) -> list:
    """One rank of phase 3i: every ``SHARD_RUNS`` run on this rank's
    shards in CUDA memory; returns, on rank 0, every rank's digests,
    stats, flags, walls, launches and audits."""
    sys.path.insert(0, str(SRC))
    # The audit's dispatch mode imports torch._dynamo on first use:
    # import it here, outside the timed runs.
    import torch._dynamo  # noqa: F401
    import torch.distributed as dist
    from repro_torch.analysis.op_audit import audit_collectives
    from repro_torch.core import PartitionedRelation, ShardGrid
    from repro_torch.distributed import make_mesh
    from repro_torch.kernels import ops

    # The ranks share the host's cores: one intra-op pool each.
    torch.set_num_threads(max(1, (os.cpu_count() or 1)
                              // dist.get_world_size()))
    mesh = make_mesh(SHARD_MESH, SHARD_AXES)
    on_gpu = mesh.device.type == "cuda"
    grids = {n: ShardGrid(mesh, a) for n, a in SHARD_LAYOUTS.items()}
    edges, _ = shard_edges(spec["scale"], spec["seed"])
    res = {"rank": rank, "device": str(mesh.device),
           "coords": {n: g.coords for n, g in grids.items()}, "runs": []}
    for i, run in enumerate(SHARD_RUNS):
        grid, n = grids[run[1]], len(SHARD_SHAPES[run[1]])
        blocks = []
        for rel in shard_inputs(run, edges, spec, "cpu"):
            stored = isinstance(rel, PartitionedRelation)
            whole = rel.parts if stored else rel
            block = grid.run(lambda g, b: b, whole,
                             in_specs=(grid.axis_names,))
            block = block.map(lambda a: a.reshape(a.shape[n:]))
            blocks.append(PartitionedRelation(block, rel.spec) if stored
                          else block)
        caps = spec["caps"][i]
        ops.reset_launches()
        sync(mesh.device)
        dist.barrier()
        t0 = time.perf_counter()
        if run[3] == "cascade":
            result, report = audit_collectives(
                lambda: shard_execute(grid, run, blocks, caps, spec["cert"]),
                max_gather_rows=caps.local, target=shard_label(run))
            audit = (dict(report.metrics), [f.code for f in report.findings])
        else:
            result = shard_execute(grid, run, blocks, caps, spec["cert"])
            audit = None
        sync(mesh.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        out, stats, ovf = result
        res["runs"].append(dict(
            digests=digests(out), stats={k: v.cpu().numpy()
                                         for k, v in stats.items()},
            overflow=bool(ovf), wall_ms=wall_ms,
            launches=dict(ops.LAUNCHES), audit=audit,
            peak=(torch.cuda.max_memory_allocated() if on_gpu else 0)))
        del result, out, stats, ovf, blocks
        if on_gpu:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, res)
    return everyone


def shard_need(stats, tri_stats, per_slot: dict) -> float:
    """Reckoned device bytes of phase 3i at these statistics: the
    largest SimGrid reference (phase 3's bytes a slot of its strategy)
    plus, for the ranks, the same again and each rank's K x recv send
    and receive buffers and flattened copy (the reference's sequence,
    which the SimGrid's scatter never builds), plus a context a rank."""
    worst_sim, worst_rank = 0.0, 0.0
    for run in SHARD_RUNS:
        shape = SHARD_SHAPES[run[1]]
        caps = shard_caps(stats, tri_stats, run)
        key = {"one_round_three_way_agg": "one_round"}.get(run[3], run[3])
        sim = per_slot[key] * largest_slots(caps, shape)
        k = max(shape)
        slot = max(v for v in dataclasses.astuple(caps) if v)
        ranks = sim + math.prod(shape) * 3 * k * slot * SHARD_ROW_BYTES
        worst_sim, worst_rank = max(worst_sim, sim), max(worst_rank, ranks)
    return worst_sim + worst_rank + \
        math.prod(SHARD_MESH) * SHARD_CONTEXT_BYTES


def run_shardgrid(w: Workload, per_slot: dict, seed: int,
                  device: torch.device) -> dict:
    """Phase 3i: ``SHARD_RUNS`` on a ``ShardGrid`` over 8 ranks
    (``spawn``; ``nccl`` with 8 cards, else ``gloo`` with every rank on
    this card), each rank's relation, stats and flag held to the
    SimGrid run's slice (computed first, here, kept on the host as
    digests), the SimGrid runs to A³ / trace(A³) and the cost model;
    then a one-rank ``nccl`` group captures ``jit_execute_chain`` of
    2,3J on ``ShardGrid`` (1,).  Returns the launches per kernel
    (every rank's runs, and the one-rank eager run)."""
    from repro_torch.checkpoint import save_partitioned
    from repro_torch.core import (ChainQuery, JoinQuery, SimGrid,
                                  chain_partitioning, chain_stats_exact,
                                  clear_compiled_caches, edge_relation,
                                  partition_relation)
    from repro_torch.core import cost_model as cm
    from repro_torch.distributed import spawn
    from repro_torch.kernels import ops

    on_gpu = device.type == "cuda"
    launches = {name: 0 for name in ops.LAUNCHES}
    clear_compiled_caches()
    if on_gpu:
        torch.cuda.empty_cache()

    def reckon(scale):
        (src, dst), n = shard_edges(scale, seed)
        st = (chain_stats_exact([(src, dst)] * 3),
              triangle_stats(src, dst, n)[0])
        return shard_need(*st, per_slot), st

    scale, (stats, tri_stats) = fitting_scale(
        "8 ranks", SHARD_TOP_SCALE, reckon, device, phase="shardgrid")
    ws = w if scale == int(math.log2(w.n_nodes)) else make_workload(scale,
                                                                    seed)
    (src, dst), n_nodes = shard_edges(scale, seed)
    a, d = ws.a3_keys // n_nodes, ws.a3_keys % n_nodes
    trace = float(ws.a3_vals[a == d].sum())
    n_dev = math.prod(SHARD_MESH)
    backend = "nccl" if on_gpu and torch.cuda.device_count() >= n_dev \
        else "gloo"
    caps = [shard_caps(stats, tri_stats, run) for run in SHARD_RUNS]
    ms_caps = mapside_caps(ws, SHARD_P)
    caps[[r[3] for r in SHARD_RUNS].index("mapside")] = ms_caps
    part_cap, how = part_capacity_for(ws.edges, SHARD_P)

    with tempfile.TemporaryDirectory() as store:
        query = ChainQuery.three_way()
        specs = []
        for j in range(3):
            rel = edge_relation(src, dst, names=query.schema(j),
                                device=device)
            pr, ovf = partition_relation(rel, store_key(query, j), SHARD_P,
                                         part_capacity=part_cap)
            check(not bool(ovf), f"shardgrid store {j}: partition overflow")
            save_partitioned(store, f"s{SHARD_P}_{j}", pr)
            specs.append(pr.spec)
        del rel, pr
        cert = chain_partitioning(query, specs)
        spec = dict(scale=scale, seed=seed, caps=caps, store=store,
                    cert=cert)
        log(f"shardgrid: scale {scale} (R-MAT amazon, {len(src)} edges), "
            f"mesh {SHARD_MESH} {SHARD_AXES}, {backend} over {n_dev} ranks "
            f"on {'8 cards' if backend == 'nccl' else device.type + ':0'}; "
            f"store P={SHARD_P}, part_capacity {how}")

        # The SimGrid references, one run at a time, kept as digests.
        refs = []
        for i, run in enumerate(SHARD_RUNS):
            name, layout, aggregate, strategy = run[:4]
            shape = SHARD_SHAPES[layout]
            rels = shard_inputs(run, (src, dst), spec, device)
            t0 = time.perf_counter()
            out, stats_i, ovf = shard_execute(SimGrid(shape), run, rels,
                                              caps[i], cert)
            sync(device)
            sim_ms = (time.perf_counter() - t0) * 1e3
            del rels
            check(not bool(ovf), f"shardgrid {shard_label(run)}: SimGrid "
                                 f"overflow")
            read, shuffled = float(stats_i["read"]), float(stats_i["shuffled"])
            total = float(np.float32(read) + np.float32(shuffled))
            rows = int(out.count().sum())
            sizes, pj = stats.sizes, stats.prefix_joins
            if aggregate is None:
                check(rows == trace, f"triangle: {rows} rows != trace(A^3) "
                                     f"{trace}")
                want = cm.cost_query_one_round(
                    JoinQuery.triangle().rel_dims(), sizes, n_dev,
                    shares=shape)
            elif strategy == "mapside":
                hop = stats_i["hop_shuffled"].cpu().tolist()
                check(hop == [0.0, 0.0], f"MS,3J: hop_shuffled {hop}")
                check(float(stats_i["placed"]) == pj[0],
                      f"MS,3J: placed {float(stats_i['placed'])} != j1")
                want = cm.cost_chain_mapside(sizes, pj, cert,
                                             ("mapside", "mapside"))
                total = float(stats_i["total"])    # placed included
            elif strategy == "one_round_three_way_agg":
                want = cm.cost_chain_one_round_agg(sizes, n_dev, pj[-1],
                                                   shares=shape)
            else:
                want = analytic(name, stats)
            tol = float(np.spacing(np.float32(want))) if want >= 2 ** 24 \
                else 0.0
            check(abs(total - want) <= tol,
                  f"shardgrid {shard_label(run)}: measured {total} != "
                  f"analytic {want}")
            if aggregate is not None:
                check_against_a3(ws, out, aggregate)
            grid_idx = np.ndindex(*shape)
            refs.append(dict(
                digests={c: digests(out, c) for c in grid_idx},
                stats={k: v.cpu().numpy() for k, v in stats_i.items()},
                rows=rows, total=total, want=want, sim_ms=sim_ms,
                packed=(packed_rows(ws, out).cpu()
                        if aggregate is False and strategy == "cascade"
                        else None)))
            del out, stats_i, ovf
            if on_gpu:
                torch.cuda.empty_cache()
        for i, run in enumerate(SHARD_RUNS):
            if run[3] == "cascade" and run[5] > 1:
                base = next(r for r, s in zip(refs, SHARD_RUNS)
                            if s[3] == "cascade" and s[5] == 1)
                check(torch.equal(refs[i]["packed"], base["packed"]),
                      f"{shard_label(run)}: tuple multiset differs from C=1")
        for r in refs:
            r.pop("packed")
        if on_gpu:
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        ranks = spawn(shard_rank, n_dev, backend=backend, device=device.type,
                      args=(spec,), timeout=600)
        spawn_s = time.perf_counter() - t0

    devices = sorted({r["device"] for r in ranks})
    for i, run in enumerate(SHARD_RUNS):
        ref, layout = refs[i], run[1]
        seen = set()
        for r in ranks:
            got, coords = r["runs"][i], r["coords"][layout]
            seen.add(coords)
            check(not got["overflow"], f"{shard_label(run)} rank "
                                       f"{r['rank']}: overflow")
            check(got["digests"] == ref["digests"][coords],
                  f"{shard_label(run)} rank {r['rank']} {coords}: relation "
                  f"differs from the SimGrid slice")
            check(sorted(got["stats"]) == sorted(ref["stats"]) and all(
                np.array_equal(v, ref["stats"][k])
                for k, v in got["stats"].items()),
                f"{shard_label(run)} rank {r['rank']}: stats "
                f"{got['stats']} != SimGrid {ref['stats']}")
        check(len(seen) == n_dev, f"{shard_label(run)}: devices {seen}")
        per_rank = [r["runs"][i]["launches"] for r in ranks]
        for kname in launches:
            launches[kname] += sum(c[kname] for c in per_rank)
        if run[6] and on_gpu:
            for r, c in zip(ranks, per_rank):
                for kname in ("segment_sum", "probe_counts",
                              "hash_histogram"):
                    check(c[kname] > 0, f"{shard_label(run)} rank "
                                        f"{r['rank']}: no {kname} launch")
        audit = ""
        if run[3] == "cascade":
            for r in ranks:
                metrics, codes = r["runs"][i]["audit"]
                check(not codes, f"{shard_label(run)} rank {r['rank']}: "
                                 f"audit findings {codes}")
            audit = (f" audit n_all_to_all="
                     f"{ranks[0]['runs'][i]['audit'][0]['n_all_to_all']} "
                     f"n_collectives="
                     f"{ranks[0]['runs'][i]['audit'][0]['n_collectives']}")
        walls = [r["runs"][i]["wall_ms"] for r in ranks]
        used = [{k: v for k, v in c.items() if v} for c in per_rank]
        log(f"shardgrid {shard_label(run)} ok: {n_dev} ranks equal the "
            f"SimGrid slices (relation, stats, overflow); rows={ref['rows']}"
            f" total={ref['total']:.0f} analytic={ref['want']:.0f}; "
            f"wall_ms max over ranks={max(walls):.1f} (ranks sharing one "
            f"card, not a multi-card time; SimGrid on {device.type} "
            f"{ref['sim_ms']:.1f}); rank peak_bytes max="
            f"{max(r['runs'][i]['peak'] for r in ranks)}{audit}; launches "
            f"per rank={used}")
    overl = {r[5]: ranks[0]["runs"][i]["audit"][0]["n_all_to_all"]
             for i, r in enumerate(SHARD_RUNS) if r[3] == "cascade"}
    check(overl[2] > overl[1], f"shardgrid audit: overlapped cascade "
                               f"all-to-alls {overl[2]} <= staged {overl[1]}")
    card = card_line() if on_gpu else "no card"
    log(f"shardgrid phase ok: backend {backend}, {n_dev} ranks on {devices},"
        f" card {card}; every collective on the ranks' {device.type} "
        f"tensors; spawn + runs "
        f"{spawn_s:.1f} s; overlapped 2,3J all-to-alls {overl[2]} > staged "
        f"{overl[1]}, no FULL_RELATION_ALL_GATHER")

    for kname, c in run_nccl_capture(w, per_slot, seed, device).items():
        launches[kname] += c
    return launches


def run_nccl_capture(w: Workload, per_slot: dict, seed: int,
                     device: torch.device) -> dict:
    """A one-rank ``nccl`` group in this process: ``jit_execute_chain``
    of 2,3J on ``ShardGrid`` (1,) captured as a CUDA graph (its
    collectives in the graph), the replay equal to the eager run and to
    ``SimGrid((1,))``, at the largest scale that fits."""
    import torch.distributed as dist
    from repro_torch.core import (ChainQuery, ShardGrid, SimGrid,
                                  chain_edge_inputs, chain_stats_exact,
                                  clear_compiled_caches, default_chain_caps,
                                  execute_chain, jit_execute_chain)
    from repro_torch.distributed import make_mesh, set_device
    from repro_torch.kernels import ops

    def reckon(scale):
        (src, dst), _ = shard_edges(scale, seed)
        caps = default_chain_caps(chain_stats_exact([(src, dst)] * 3), (1,))
        return 3 * per_slot["cascade"] * largest_slots(caps, (1,)), \
            ((src, dst), caps)

    scale, ((src, dst), caps) = fitting_scale("nccl capture",
                                              SHARD_TOP_SCALE, reckon, device,
                                              phase="shardgrid")
    query = ChainQuery.three_way()
    on_gpu = device.type == "cuda"
    # gloo only where there is no card (a CPU rehearsal: no capture).
    backend = "nccl" if on_gpu else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        device = set_device(device)
        dist.init_process_group(
            backend, init_method=f"file://{tmp}/init", rank=0, world_size=1,
            **(dict(device_id=device) if on_gpu else {}))
        try:
            grid = ShardGrid(make_mesh((1,), ("x",), device=device), ("x",))
            rels = [r.map(lambda a: a[0]) for r in chain_edge_inputs(
                query, [(src, dst)] * 3, (1,), device=device)]
            ops.reset_launches()
            eager = execute_chain(grid, query, rels, strategy="cascade",
                                  caps=caps)
            sync(device)
            counts = dict(ops.LAUNCHES)
            eager = (eager[0].map(lambda t: t.cpu()),
                     {k: v.cpu() for k, v in eager[1].items()},
                     eager[2].cpu())
            if on_gpu:
                torch.cuda.empty_cache()
            plan = jit_execute_chain(grid, query, strategy="cascade",
                                     caps=caps, donate=False)
            t0 = time.perf_counter()
            first = plan(rels)
            sync(device)
            capture_ms = (time.perf_counter() - t0) * 1e3
            del first
            t0 = time.perf_counter()
            replay = plan(rels)
            sync(device)
            replay_ms = (time.perf_counter() - t0) * 1e3
            replay = (replay[0].map(lambda t: t.cpu()),
                      {k: v.cpu() for k, v in replay[1].items()},
                      replay[2].cpu())
            pool = graph_pool_bytes() if on_gpu else 0
            del plan
            clear_compiled_caches()
            if on_gpu:
                torch.cuda.empty_cache()
            sim = execute_chain(SimGrid((1,)), query, chain_edge_inputs(
                query, [(src, dst)] * 3, (1,), device=device),
                strategy="cascade", caps=caps)
            sim = (sim[0].map(lambda t: t[0].cpu()),
                   {k: v.cpu() for k, v in sim[1].items()}, sim[2].cpu())
        finally:
            dist.destroy_process_group()
    check(not bool(eager[2]), "nccl capture: overflow")
    check(same_result(replay, eager), "nccl capture: the replay differs "
                                      "from the eager run")
    check(same_result(eager, sim), "nccl capture: ShardGrid (1,) differs "
                                   "from SimGrid((1,))")
    if on_gpu:
        torch.cuda.empty_cache()
    how = ("captured with its collectives; replay" if on_gpu else
           "run eagerly (no capture on the CPU); second call")
    log(f"shardgrid {backend} capture ok: 2,3J at scale {scale} on "
        f"ShardGrid (1,) over a one-rank {backend} group, jit_execute_chain "
        f"{how} == eager == SimGrid((1,)); rows="
        f"{int(eager[0].count())} capture_ms={capture_ms:.1f} "
        f"replay_ms={replay_ms:.1f} pool_bytes={pool} launches={counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 3j: LM serving (Engine on qwen2-7b at full width)
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2-7b"
# (batch, prompt length, new tokens, max_len) of phase 3j's two greedy
# requests.
LM_REQUESTS = ((4, 1024, 64, 2048), (1, 4096, 32, 4160))
# The kernel against the plain version on the model's own bf16 inputs:
# PERF.md §2's bf16 attention tolerance, as phase 2 applies it (rtol =
# atol).
LM_ATTN_TOL = 2e-2


def lm_prompts(seed: int, batch: int, length: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (batch, length),
                                                dtype=np.int32)


def lm_bytes(tree) -> int:
    from repro_torch.models.params import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def timed_generate(model, params, prompts: np.ndarray, n_new: int,
                   max_len: int, device: torch.device) -> dict:
    """One greedy ``Engine.generate``, the counts set to 0 just before
    and read just after.  Every step is timed with CUDA events around
    the engine's step, and its logits are checked finite on the card
    (one flag, read at the end).  Returns the tokens, the stats, the
    step ms (the prefill first), the wall seconds, the launch counts
    and whether every logit was finite."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, ServeConfig

    eng = Engine(model, params, ServeConfig(max_len=max_len))
    events, finite = [], torch.ones((), dtype=torch.bool, device=device)
    step = eng._step

    def timed(*args):
        nonlocal finite
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        events.append((start, end))
        finite = finite & torch.isfinite(out[0]).all()
        return out

    eng._step = timed
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    tokens, stats = eng.generate(prompts, n_new)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = dict(ops.LAUNCHES)
    del eng._step      # the wrapper refers to the engine: break the cycle
    return dict(tokens=tokens, stats=stats, launched=launched,
                step_ms=[s.elapsed_time(e) for s, e in events],
                wall_s=wall_s, finite=bool(finite))


def lm_request(model, params, i: int, seed: int, batch: int, plen: int,
               n_new: int, max_len: int, device: torch.device) -> dict:
    """One greedy request of phase 3j through ``Engine.generate``
    (``timed_generate``); returns its launch counts."""
    from repro_torch.kernels.flash_attention import _plan
    from repro_torch.models.params import param_count

    cfg = model.cfg
    hq, hkv, d, nl = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.n_layers
    n_params, w_bytes = param_count(params), lm_bytes(params)
    prompts = lm_prompts(seed + i, batch, plen, cfg.vocab_size)
    run = timed_generate(model, params, prompts, n_new, max_len, device)
    tokens, stats, launched, wall_s = (run[k] for k in (
        "tokens", "stats", "launched", "wall_s"))
    step_ms, finite = run["step_ms"], run["finite"]
    prefill_ms, decode_ms = step_ms[0], statistics.median(step_ms[1:])
    check(tokens.shape == (batch, n_new) and tokens.dtype == np.int32
          and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          f"lm request {i + 1}: tokens misshapen or out of range")
    check(bool(finite), f"lm request {i + 1}: logits not finite")
    check(stats == {"prompt_len": float(plen),
                    "generated": float(n_new)},
          f"lm request {i + 1}: stats {stats}")
    check(launched["flash_attention"] == nl * n_new,
          f"lm request {i + 1}: {launched['flash_attention']} "
          f"flash_attention launches, want {nl * n_new}")
    pre = _plan(plen, plen, hq, hkv, d, torch.bfloat16, batch=batch)
    dec = _plan(1, plen + 1, hq, hkv, d, torch.bfloat16, batch=batch)
    # Bounds: a decode step reads every weight and the valid cache
    # once; the prefill's operations are every weight's product with
    # each prompt token (the embedding is a gather) plus causal
    # attention, at the tensor cores' bf16 peak.
    kv_mid = plen + n_new // 2
    kv_bytes = 2 * nl * batch * kv_mid * hkv * d * 2
    dec_bound, dec_by = bound_ms(w_bytes + kv_bytes, 0)
    pairs = plen * (plen + 1) // 2
    pre_ops = (2 * (n_params - cfg.padded_vocab * cfg.d_model)
               * batch * plen + nl * 4 * batch * hq * d * pairs)
    pre_bound, pre_by = bound_ms(w_bytes, pre_ops, HALF_OPS_PER_S)
    log(f"lm request {i + 1} ok: B={batch} P={plen} n_new={n_new} "
        f"max_len={max_len} prefill_ms={prefill_ms:.3f} (bound "
        f"{pre_bound:.3f}, {pre_by}) decode_step_ms_median="
        f"{decode_ms:.3f} (bound {dec_bound:.3f}, {dec_by}; {len(step_ms) - 1}"
        f" steps) wall_s={wall_s:.3f} tokens_per_s="
        f"{batch * n_new / wall_s:.1f} decode_tokens_per_s="
        f"{batch / decode_ms * 1e3:.1f} launches={launched} path "
        f"prefill={pre.path} decode={dec.path} (splits {dec.splits})")
    return launched


def run_lm_serving(seed: int, device: torch.device,
                   iters: int = 10) -> tuple[dict, dict]:
    """Phase 3j: phase 2's ``flash_attention`` cases at the model's shapes
    (``lm_attention_cases``), then ``Engine.generate`` on qwen2-7b at
    full width and depth,
    bf16 weights drawn on the card from ``seed``, greedy.  Two requests
    (``LM_REQUESTS``), the counts set to 0 before each and read after:
    tokens in range, every step's logits finite, the stats the
    reference's, ``flash_attention`` launched once a layer a step.  Then
    every attention call of the first request's prefill and first decode
    step against the plain version on the same inputs, and the whole
    first prefill against a ``backend="ref"`` model sharing the weights.
    Frees everything it made.  Returns the launch counts and the kernel
    cases' results."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import param_count, zeros_of
    from repro_torch.serving import Engine, ServeConfig

    cases = flash_attention_phase(
        torch.Generator(device=device).manual_seed(seed), iters, device,
        lm_attention_cases())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params, w_bytes = param_count(params), lm_bytes(params)
    expect = param_count(model.abstract())
    check(n_params == expect, f"lm: {n_params} parameters, the defs say "
                              f"{expect}")
    hq, hkv, d, nl = cfg.padded_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.n_layers
    log(f"lm {LM_ARCH}: {nl} layers, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} (padded {hq}) / kv {hkv}, head_dim {d}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size} (padded {cfg.padded_vocab}); "
        f"param_count {n_params} (n_params_analytic "
        f"{cfg.n_params_analytic:.0f}), {w_bytes} bytes bf16 on {device}, "
        f"drawn in {init_s:.2f} s")

    counts = {name: 0 for name in ops.LAUNCHES}
    for i, (batch, plen, n_new, max_len) in enumerate(LM_REQUESTS):
        launched = lm_request(model, params, i, seed, batch, plen, n_new,
                              max_len, device)
        for name, c in launched.items():
            counts[name] += c

    # Every attention call of request 1's prefill and first decode step,
    # the kernel against the plain version on the same inputs (these
    # launches are not counted).
    batch, plen, _, max_len = LM_REQUESTS[0]
    prompts = lm_prompts(seed, batch, plen, cfg.vocab_size)
    errs, excess = [], []
    kernel_attention = L.multihead_attention

    def hooked(q, k, v, **kw):
        got = kernel_attention(q, k, v, **kw)
        want = kernel_attention(q, k, v, **dict(kw, backend="ref")).float()
        diff = (got.float() - want).abs()
        errs.append(float(diff.max()))
        # Phase 2's test: assert_close(rtol=atol=tol), so a bf16 output
        # may differ by its rounding (2^-8 relative) at any magnitude.
        excess.append(float((diff - LM_ATTN_TOL * want.abs()).max()))
        return got

    L.multihead_attention = hooked
    try:
        Engine(model, params, ServeConfig(max_len=max_len)).generate(
            prompts, 2)
    finally:
        L.multihead_attention = kernel_attention
    check(len(errs) == 2 * nl, f"lm: {len(errs)} hooked attention calls")
    check(max(excess) <= LM_ATTN_TOL,
          f"lm: attention differs from the plain version beyond rtol = "
          f"atol = {LM_ATTN_TOL}: |diff| - rtol |plain| up to "
          f"{max(excess)}")
    log(f"lm attention vs plain ok: {len(errs)} calls (prefill + first "
        f"decode step, every layer) within rtol = atol = {LM_ATTN_TOL}; "
        f"max_abs_err prefill {max(errs[:nl]):.3g} decode "
        f"{max(errs[nl:]):.3g}; max |diff| - rtol |plain| "
        f"{max(excess):.3g}")

    # The whole first prefill on the kernel and on the plain version.
    ref_model = build_model(cfg, backend="ref")
    toks = torch.as_tensor(prompts, device=device)
    cache = zeros_of(model.cache_defs(batch, max_len), device=device)
    with torch.no_grad():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got, cache = model.decode_step(params, cache, toks, 0)
        end.record()
        end.synchronize()
        warm_ms = start.elapsed_time(end)
        ref_cache = zeros_of(model.cache_defs(batch, max_len), device=device)
        want = ref_model.decode_step(params, ref_cache, toks, 0)[0]
        del ref_cache
        v = cfg.vocab_size
        diff = max(float((got[b].float() - want[b].float()).abs().max())
                   for b in range(batch))
        top1 = float((got[..., :v].argmax(-1) == want[..., :v].argmax(-1)
                      ).float().mean())
        del got, want
    log(f"lm prefill kernel vs plain model: max_abs_logit_diff {diff:.4g}, "
        f"top1_agreement {top1:.5f} over {batch * plen} positions (bf16, "
        f"{nl} layers; no bound); the kernel model's prefill again, warm: "
        f"{warm_ms:.3f} ms")
    peak = torch.cuda.max_memory_allocated()
    del params, cache, model, ref_model, toks
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm phase ok: peak_bytes {peak} (max_memory_allocated); "
        f"allocated {before} bytes before the phase, "
        f"{torch.cuda.memory_allocated()} after")
    lm_decode_profile(seed, device)
    return counts, cases


def lm_decode_profile(seed: int, device: torch.device) -> None:
    """Where a decode step of phase 3j's request 1 spends the card's
    time: the model drawn again, a zero cache at kv 1,025, one step's
    device ms, kernels and largest kernels (``device_kernels``).  Its
    launches are not counted."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import zeros_of

    batch, plen, _, max_len = LM_REQUESTS[0]
    model = build_model(get_config(LM_ARCH))
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    cache = zeros_of(model.cache_defs(batch, max_len), device=device)
    tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
    iters = 5
    with torch.no_grad():
        rows = sorted(device_kernels(
            lambda: model.decode_step(params, cache, tok, plen), iters),
            key=lambda r: -r[1])
    n_kernels = sum(n for name, _, n in rows if not name.lower().startswith(
        ("memcpy", "memset"))) // iters
    top = [(name[:60], round(ms, 4)) for name, ms, _ in rows[:5]]
    log(f"lm decode step device_ms {sum(ms for _, ms, _ in rows):.3f}, "
        f"{n_kernels} kernels (B={batch}, kv {plen + 1}; torch.profiler, "
        f"{iters} steps) largest kernels {top}")
    del model, params, cache, tok
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3k: LM training — granite-3-2b at full width and depth
# ---------------------------------------------------------------------------

TRAIN_ARCH = "granite-3-2b"
# One warm-up step, then the timed steps; the schedule's warm-up and
# total steps (cosine_with_warmup(3e-4, 2, 8)).
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_TOTAL, TRAIN_LR = 8, 2, 8, 3e-4
# DataConfig: one 2,048-token sequence a microbatch (microbatch=8).
TRAIN_SEQ, TRAIN_BATCH = 2048, 8
# The kernel model's gradient against the plain-attention model's, one
# microbatch: the cosine of the whole flattened gradient.
TRAIN_GRAD_COSINE = 0.99
# The smoke Trainer on the card: steps, a simulated failure, checkpoints.
SMOKE_STEPS, SMOKE_FAIL, SMOKE_EVERY = 6, 4, 2
# Resumed losses against an uninterrupted card run: torch's own index
# backward (the embedding's gradient) sums with atomics on the card.
SMOKE_RESUME_RTOL = 1e-5
TRAIN_MARGIN = 4 << 30
# Timed calls of a microbatch and of the update in the train profile.
PROFILE_ITERS = 3


def train_reckoning(cfg, n_params: int) -> tuple[float, str]:
    """Device bytes of phase 3k, reckoned from the config before it
    runs: the larger of the gradient comparison (bf16 weights and two
    bf16 gradient trees) and the train step (bf16 weights, AdamW's
    float32 m and v, the float32 accumulator, one microbatch's bf16
    gradients, the clip's and the accumulation's float32 temporaries of
    the largest leaf), plus activations: under remat each layer's
    input, one layer's recompute, and the loss's (S, vocab) logits in
    bf16 and float32 with their gradients."""
    s, d, f = TRAIN_SEQ, cfg.d_model, cfg.d_ff
    largest = cfg.n_layers * d * f                      # the MLP stacks
    acts = (cfg.n_layers * s * d * 2 + 24 * s * max(d, f) * 4
            + 4 * s * cfg.padded_vocab * 4)
    compare = 2 * n_params + 2 * 2 * n_params
    step = (2 * n_params + 8 * n_params + 4 * n_params + 2 * n_params
            + 2 * 4 * largest)
    need = max(compare, step) + acts
    return need, (f"weights {2 * n_params}, m+v {8 * n_params}, "
                  f"accumulator {4 * n_params}, microbatch grads "
                  f"{2 * n_params}, temporaries {8 * largest}, activations "
                  f"{acts}; gradient comparison {compare + acts}")


def train_bound(cfg, n_params: int) -> tuple[float, str]:
    """Least time of one train step, reckoned from the code: per token
    the blocks' weights run forward, again in the remat recompute, and
    backward (2 + 2 + 4 operations a weight), the lm_head forward and
    backward (6 a weight, on S - 1 positions); attention per layer and
    sequence 4·D·Hq a visible pair forward (S, P·V), 4 again in the
    recompute, 10 backward (S, dP, dV, dK, dQ: the recompute's forward
    gives the lse); all at the bf16 tensor-core peak.  The embedding is a
    gather.  The bytes (weights read 3x, the optimizer's state read and
    written) are a small fraction of it."""
    hq, dh, nl = cfg.padded_heads, cfg.head_dim, cfg.n_layers
    head = cfg.d_model * cfg.padded_vocab
    blocks = n_params - 2 * head - cfg.d_model          # - embedding, head, ln_f
    seqs, s = TRAIN_BATCH, TRAIN_SEQ
    ops_blocks = 8 * blocks * seqs * s
    ops_head = 6 * head * seqs * (s - 1)
    ops_attn = 18 * dh * hq * attention_pairs(s, s) * nl * seqs
    n_ops = ops_blocks + ops_head + ops_attn
    n_bytes = 3 * 2 * n_params + (2 + 2 + 8 + 8 + 4 + 4) * n_params
    ms, by = bound_ms(n_bytes, n_ops, HALF_OPS_PER_S)
    return ms, (f"{by}: blocks 8 x {blocks} weights x {seqs * s} tokens = "
                f"{ops_blocks:.4g}, lm_head 6 x {head} x {seqs * (s - 1)} = "
                f"{ops_head:.4g}, attention 18 x D {dh} x Hq {hq} x "
                f"{attention_pairs(s, s)} pairs x {nl} layers x {seqs} = "
                f"{ops_attn:.4g}; {n_ops:.4g} operations at 989 TFLOP/s; "
                f"{n_bytes:.4g} bytes at 3.35 TB/s")


def grad_cosines(a: list, b: list) -> tuple[float, float]:
    """Cosine of the two flattened gradients, and the lowest cosine of
    any leaf, in float32 (no host copy of a leaf)."""
    dot = na = nb = 0.0
    lowest = 1.0
    for x, y in zip(a, b):
        x, y = x.float(), y.float()
        d, sx, sy = (float((x * y).sum()), float((x * x).sum()),
                     float((y * y).sum()))
        dot, na, nb = dot + d, na + sx, nb + sy
        lowest = min(lowest, d / max(math.sqrt(sx * sy), 1e-30))
    return dot / max(math.sqrt(na * nb), 1e-30), lowest


def run_smoke_trainer(seed: int, device: torch.device) -> dict:
    """``Trainer.run`` on the card at granite-3-2b's smoke config (bf16,
    64-token sequences): an uninterrupted run, a run that fails at step
    ``SMOKE_FAIL``, and its restart from the checkpoint at step
    ``SMOKE_FAIL - 1``; the stitched losses against the uninterrupted
    ones.  Returns the launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig
    from repro_torch.kernels import ops
    from repro_torch.models.lm import build_model
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config(TRAIN_ARCH, smoke=True)
    model = build_model(cfg)
    p0 = model.init(torch.Generator(device=device).manual_seed(seed),
                    device=device)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                      global_batch=4, seed=seed)
    ops.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(name):
            return Trainer(model, data, TrainConfig(
                steps=SMOKE_STEPS, lr=1e-3, warmup=2,
                checkpoint_every=SMOKE_EVERY, log_every=100,
                checkpoint_dir=os.path.join(tmp, name)), device=device)

        full = trainer("a").run(init_params=p0, resume=False)
        dead = trainer("b")
        try:
            dead.run(init_params=p0, resume=False, fail_at_step=SMOKE_FAIL)
            check(False, "smoke trainer: the simulated failure never came")
        except RuntimeError as e:
            check("simulated node failure" in str(e), str(e))
        dead.ckpt.wait()
        resumed = trainer("b").run(init_params=p0, resume=True)
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    want = [m["loss"] for m in full["metrics"]]
    before = [m["loss"] for m in dead.metrics]
    after = [m["loss"] for m in resumed["metrics"]]
    check(len(before) == SMOKE_FAIL and resumed["metrics"][0]["step"]
          == SMOKE_FAIL, f"smoke trainer: resumed at "
          f"{resumed['metrics'][0]['step']}, {len(before)} steps before")
    stitched = before[:SMOKE_FAIL] + after
    rel = max(abs(a - b) / abs(b) for a, b in zip(stitched, want))
    check(rel <= SMOKE_RESUME_RTOL and all(math.isfinite(x) for x in want),
          f"smoke trainer: resumed losses {stitched} against {want}")
    check(counts["flash_attention"] > 0 and counts["flash_attention_bwd"]
          > 0, f"smoke trainer: launches {counts}")
    log(f"lm train smoke trainer ok: {cfg.arch} bf16 on {device}, "
        f"{SMOKE_STEPS} steps, failed at step {SMOKE_FAIL}, resumed from "
        f"the checkpoint at step {SMOKE_FAIL - 1}: losses {stitched} "
        f"against the uninterrupted {want} (max relative difference "
        f"{rel:.3g} <= {SMOKE_RESUME_RTOL}); launches {counts}")
    return counts


def kernel_group(name: str) -> str:
    """The part of a train step a device function belongs to."""
    low = name.lower()
    if "attention_bwd" in low:
        return "flash_attention_bwd"
    if any(k in low for k in ("attention_wgmma", "attention_split",
                              "attention_simt")):
        return "flash_attention"
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "sm90_xmma")):
        return "gemm"
    if low.startswith(("memcpy", "memset")):
        return "copy"
    return "other"


def lm_train_profile(model, planner, params, mb: dict, opt_state,
                     opt_update, grads) -> None:
    """Where a train step's time goes: one microbatch's
    ``compute_grads`` and one optimizer update, each timed with CUDA
    events and traced once with ``torch.profiler``: device ms by group
    (the two attention kernels, cuBLAS GEMMs, copies, the rest), kernel
    count and largest kernels.  Its launches are not counted."""
    from repro_torch.train import compute_grads

    parts = (("microbatch", lambda: compute_grads(model, planner, params,
                                                  mb, 1)),
             ("adamw update", lambda: opt_update(grads, opt_state, params)))
    walls = {}
    for label, fn in parts:
        wall = walls[label] = time_ms(fn, PROFILE_ITERS, warmup=1)
        rows = device_kernels(fn, 1)
        groups: dict = {}
        for name, ms, n in rows:
            g = kernel_group(name)
            t, c = groups.get(g, (0.0, 0))
            groups[g] = (t + ms, c + n)
        busy = sum(ms for _, ms, _ in rows)
        n_kernels = sum(c for g, (_, c) in groups.items() if g != "copy")
        top = [(name[:50], round(ms, 3)) for name, ms, _ in
               sorted(rows, key=lambda r: -r[1])[:6]]
        log(f"lm train profile {label}: wall_ms {wall:.3f} (CUDA events), "
            f"device_ms {busy:.3f} (busy share {busy / wall:.3f}), "
            f"{n_kernels} kernels; device ms by group "
            f"{ {g: (round(t, 3), c) for g, (t, c) in groups.items()} }; "
            f"largest kernels {top}")
    return walls


def attention_host_us(dev, iters: int = 20) -> dict:
    """Host µs of granite-3-2b's attention call as the train step makes
    it: ``flash_attention`` under autograd (the forward, with the lse
    store where its path has one) and ``torch.autograd.grad`` through it
    (the backward), each from a synchronized card to the call's return
    on the host's clock: the launches enqueued, not run.  Medians of
    ``iters`` after two calls untimed."""
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(3)
    leaves = [t.requires_grad_() for t in attention_inputs(
        gen, dev, (1, GRANITE_HEADS, GRANITE_LEN, GRANITE_DIM),
        (1, GRANITE_KV_HEADS, GRANITE_LEN, GRANITE_DIM), torch.bfloat16)]
    dout = torch.randn(leaves[0].shape, generator=gen,
                       device=dev).bfloat16()
    fwd, bwd = [], []
    for _ in range(iters + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = flash_attention(*leaves, causal=True)
        t1 = time.perf_counter()
        torch.autograd.grad(out, leaves, dout)
        t2 = time.perf_counter()
        fwd.append((t1 - t0) * 1e6)
        bwd.append((t2 - t1) * 1e6)
    torch.cuda.synchronize()
    return dict(forward_us=statistics.median(fwd[2:]),
                backward_us=statistics.median(bwd[2:]))


def run_lm_training(seed: int, device: torch.device) -> dict:
    """Phase 3k: ``make_train_step`` on granite-3-2b at full width and
    depth (bf16 weights from ``seed``, remat, microbatch 8, AdamW with
    ``cosine_with_warmup(3e-4, 2, 8)``): its bytes reckoned and held to
    the card first; one microbatch's gradient with the attention kernels
    against a ``backend="ref"`` model's (cosine); one warm-up step, then
    ``TRAIN_STEPS`` timed steps, the counts set to 0 before them and
    read after (``flash_attention`` twice a layer a microbatch under
    remat, ``flash_attention_bwd`` once); the loss must fall.  Then the
    smoke Trainer on the card.  Frees all it made; returns the phase's
    launch counts and ``{step_ms, bound_ms, peak}``."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import DataConfig, shard_batch
    from repro_torch.distributed.sharding import Planner
    from repro_torch.kernels import ops
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import param_count, tree_leaves, tree_map
    from repro_torch.optim import cosine_with_warmup, make_optimizer
    from repro_torch.train import compute_grads, make_train_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    n_params = param_count(model.abstract())
    need, parts = train_reckoning(cfg, n_params)
    total = torch.cuda.get_device_properties(device).total_memory
    log(f"lm train {cfg.arch}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, heads {cfg.n_heads} / kv {cfg.n_kv_heads}, "
        f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"(padded {cfg.padded_vocab}); param_count {n_params}; microbatch "
        f"{cfg.microbatch}, remat {cfg.remat} ({cfg.remat_policy}), "
        f"{cfg.optimizer}; reckoned {need:.0f} bytes ({parts}) of "
        f"{total} on the card")
    check(need + TRAIN_MARGIN <= total,
          f"lm train: reckoned {need} bytes do not fit the card's {total}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    planner = Planner.null()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    torch.cuda.synchronize()
    log(f"lm train weights drawn in {time.perf_counter() - t0:.2f} s")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=seed)

    def batch(step: int) -> dict:
        return {k: torch.as_tensor(v, device=device)
                for k, v in shard_batch(data, step, 0, 1).items()}

    # One microbatch's gradient: the kernels against the plain version.
    mb = {"tokens": batch(0)["tokens"][:1]}
    ops.reset_launches()
    loss_k, grads_k = compute_grads(model, planner, params, mb, 1)
    torch.cuda.synchronize()
    counts_cmp = dict(ops.LAUNCHES)
    check(counts_cmp["flash_attention"] == 2 * cfg.n_layers
          and counts_cmp["flash_attention_bwd"] == cfg.n_layers,
          f"lm train: one microbatch launched {counts_cmp}, want "
          f"{2 * cfg.n_layers} forward and {cfg.n_layers} backward")
    ref_model = build_model(cfg, backend="ref")
    loss_r, grads_r = compute_grads(ref_model, planner, params, mb, 1)
    cos, lowest = grad_cosines(tree_leaves(grads_k), tree_leaves(grads_r))
    check(all(g is not None and g.shape == p.shape for g, p in
              zip(tree_leaves(grads_k), tree_leaves(params))),
          "lm train: a leaf has no gradient")
    check(cos >= TRAIN_GRAD_COSINE, f"lm train: gradient cosine {cos} "
          f"< {TRAIN_GRAD_COSINE}")
    log(f"lm train gradient kernel vs plain ok: one microbatch (1 x "
        f"{TRAIN_SEQ}), loss {float(loss_k):.6f} vs {float(loss_r):.6f}, "
        f"cosine of the flattened gradient {cos:.6f} (>= "
        f"{TRAIN_GRAD_COSINE}), lowest leaf cosine {lowest:.6f} (logged), "
        f"launches {counts_cmp}")
    del grads_k, grads_r, ref_model, loss_k, loss_r
    gc.collect()
    torch.cuda.empty_cache()
    host = attention_host_us(device)
    log(f"lm train attention host_us: {host} (granite's call under "
        f"autograd, enqueue only, median of 20)")

    opt_init, opt_update, _ = make_optimizer(cfg.optimizer, cosine_with_warmup(
        TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL))
    opt_state = opt_init(params)
    step_fn = make_train_step(model, planner, opt_update, clip_norm=1.0)
    losses, norms, step_ms = [], [], []
    counts = dict(counts_cmp)
    ops.reset_launches()
    for step in range(TRAIN_STEPS + 1):
        b = batch(step)
        if step == 1:                    # the timed steps start here
            for name, c in ops.LAUNCHES.items():
                counts[name] += c        # the warm-up step's
            ops.reset_launches()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt_state, _, m = step_fn(params, opt_state, b, None)
        end.record()
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    timed = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_mb = cfg.microbatch * TRAIN_STEPS
    check(timed["flash_attention"] == 2 * cfg.n_layers * n_mb
          and timed["flash_attention_bwd"] == cfg.n_layers * n_mb,
          f"lm train: {TRAIN_STEPS} steps launched {timed}, want "
          f"{2 * cfg.n_layers * n_mb} forward and {cfg.n_layers * n_mb} "
          f"backward")
    check(all(math.isfinite(x) for x in losses + norms),
          f"lm train: losses {losses}, grad norms {norms}")
    check(sum(losses[-2:]) / 2 < losses[0],
          f"lm train: the loss did not fall: {losses}")
    check(peak < total, f"lm train: peak {peak} bytes")
    med = statistics.median(step_ms[1:])
    bound, how = train_bound(cfg, n_params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"lm train bound: {bound:.3f} ms a step ({how})")
    log(f"lm train ok: {TRAIN_STEPS} steps after 1 warm-up, step_ms median "
        f"{med:.3f} (bound {bound:.3f}; warm-up {step_ms[0]:.3f}; all "
        f"{[round(x, 3) for x in step_ms]}), tokens_per_s "
        f"{tokens / med * 1e3:.1f}; losses {losses}; grad norms "
        f"{[round(x, 4) for x in norms]}; peak_bytes {peak} "
        f"(max_memory_allocated; reckoned {need:.0f}); launches {timed} "
        f"(want {2 * cfg.n_layers} forward and {cfg.n_layers} backward a "
        f"microbatch x {n_mb})")
    del step_fn, b, m
    gc.collect()
    # The update's cost does not depend on the values: zero gradients.
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    walls = lm_train_profile(model, planner, params, mb, opt_state,
                             opt_update, grads)
    del params, opt_state, model, grads
    gc.collect()
    torch.cuda.empty_cache()
    log(f"lm train phase: allocated {before} bytes before, "
        f"{torch.cuda.memory_allocated()} after")
    for name, c in timed.items():
        counts[name] += c
    for name, c in run_smoke_trainer(seed, device).items():
        counts[name] += c
    return counts, dict(step_ms=med, step_ms_all=step_ms, bound_ms=bound,
                        peak=peak, microbatch_wall_ms=walls["microbatch"],
                        **host)


# ---------------------------------------------------------------------------
# Phase 3l: the MoE and state-space families, served at full width
# ---------------------------------------------------------------------------

# (arch, layers on the card (None: the full depth), greedy requests as
# (batch, prompt length, new tokens)).  grok-1 and kimi-k2 are cut in
# depth to what 80 GB holds in bf16 beside the init's float32 draw of
# one stacked expert leaf: 4 of 64 layers (42.6 GB of weights) and 1 of
# 61 (38.9 GB; 2 layers would be 73.1 GB).
FAMILY_MODELS = (
    ("grok-1-314b", 4, ((4, 1024, 32),)),
    ("kimi-k2-1t-a32b", 1, ((1, 1024, 16),)),
    ("zamba2-1.2b", None, ((2, 1024, 32),)),
    ("xlstm-125m", None, ((1, 1024, 32),)),
)


def tree_bytes_of(defs, dtype=torch.bfloat16) -> int:
    """Bytes of the tensors a ParamDef tree makes (in ``dtype`` where a
    leaf names none)."""
    from repro_torch.models.params import abstract_params, tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(abstract_params(defs, dtype)))


def family_reckoning(model, batch: int, plen: int, max_len: int
                     ) -> tuple[float, str]:
    """Device bytes of one model of phase 3l: its bf16 weights, and the
    larger of the init's float32 draw of its largest leaf and what a
    request holds beside the weights — two caches (the kernel model's
    and the plain one's), the prefill's logits twice with the
    comparison's four float32 rows, and the MoE buffers (the gathered tokens and the experts' three
    (E, C, f) products, the combine's (N·k, d) float32 rows)."""
    from repro_torch.models.moe import _capacity
    from repro_torch.models.params import abstract_params, tree_leaves
    cfg = model.cfg
    w = tree_bytes_of(model.defs)
    draw = 4 * max(t.numel() for t in tree_leaves(abstract_params(
        model.defs)))
    cache = tree_bytes_of(model.cache_defs(batch, max_len))
    logits = 2 * batch * plen * cfg.padded_vocab * 2 + \
        4 * plen * cfg.padded_vocab * 4
    moe = 0
    if cfg.family == "moe":
        n = batch * plen
        moe = cfg.n_experts * _capacity(cfg, n) * (
            cfg.d_model + 3 * cfg.expert_d_ff) * 2 + \
            2 * n * cfg.top_k * cfg.d_model * 4
    run = 2 * cache + logits + moe
    return w + max(draw, run), (
        f"weights {w} + max(float32 draw {draw}, 2 caches {2 * cache} + "
        f"logits {logits} + moe buffers {moe})")


def family_attention_layers(cfg) -> int:
    """flash_attention calls a step: every layer of a decoder, one a
    super-block for the hybrid's shared block, none in xLSTM."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def family_bounds(model, n_params: int, batch: int, plen: int,
                  kv: int) -> dict:
    """The least times of a prefill and of a decode step at ``kv`` keys.

    Prefill, operations at 989 TFLOP/s: 2 a weight a token for every
    weight a token meets (the embedding is a gather; of the experts only
    the top-k a token is routed to), causal attention's 4·D a visible
    (query, key) pair a head, and the SSD scan's products (each chunk's
    L×L (c·b) and (L×L)·(L×P) contraction, its chunk state and the
    state's readout).  Decode, bytes at 3.35 TB/s: every weight but the
    embedding table read once (every expert: each runs on a buffer of
    at least 8 slots), the valid KV cache read, the float32 recurrent
    states read and written."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models import xlstm as XL
    cfg = model.cfg
    emb = cfg.padded_vocab * cfg.d_model
    tokens = batch * plen
    active = n_params - emb
    if cfg.family == "moe":
        active -= cfg.n_layers * (cfg.n_experts - cfg.top_k) * 3 \
            * cfg.d_model * cfg.expert_d_ff
    n_attn = family_attention_layers(cfg)
    pairs = plen * (plen + 1) // 2
    ops = 2 * active * tokens + n_attn * 4 * batch * cfg.padded_heads \
        * cfg.head_dim * pairs
    L = min(cfg.ssm_chunk, plen)
    state = 0
    if cfg.family == "hybrid":
        _, H, _ = SSM.mamba_dims(cfg)
        N, P = cfg.ssm_state, cfg.ssm_head_dim
        ops += cfg.n_layers * (2 * tokens * L * (N + H * P)
                               + 4 * tokens * H * P * N)
        state = tree_bytes_of(model.cache_defs(batch, 1)["states"],
                              torch.float32)
    elif cfg.family == "ssm":
        _, H, P = XL._dims(cfg)
        n_mlstm = sum(1 for i in range(cfg.n_layers)
                      if (i + 1) % cfg.slstm_every)
        ops += n_mlstm * (2 * tokens * L * H * (2 * P + 1)
                          + 4 * tokens * H * (P + 1) * P)
        state = tree_bytes_of(model.cache_defs(batch, 1), torch.float32)
    kv_bytes = 2 * n_attn * batch * kv * cfg.n_kv_heads * cfg.head_dim * 2
    pre, pre_by = bound_ms(2 * n_params, ops, HALF_OPS_PER_S)
    dec, dec_by = bound_ms(2 * (n_params - emb) + kv_bytes + 2 * state, 0)
    return dict(prefill_bound_ms=pre, prefill_by=pre_by, prefill_ops=ops,
                decode_bound_ms=dec, decode_by=dec_by)


def family_checks(model, params, cfg, batch: int, plen: int, max_len: int,
                  seed: int, device: torch.device) -> dict:
    """Phase 3l's checks on one request's prompts, their launches not
    counted: every attention call of the prefill and of the first decode
    step against the plain version on the same inputs (rtol = atol =
    ``LM_ATTN_TOL``); MoE: layer 0's dispatch plan of the prefill's
    router ids rebuilt on the CPU and equal as full arrays, and the
    share of routed copies dropped; xLSTM: the sLSTM layers' host wall
    over the prefill; then the whole prefill against a
    ``backend="ref"`` model sharing the weights (max abs logit
    difference and top-1 agreement: logged, no bound), the kernel
    model's prefill timed again there, warm."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import xlstm as XL
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import zeros_of
    from repro_torch.serving import Engine, ServeConfig

    prompts = lm_prompts(seed, batch, plen, cfg.vocab_size)
    errs, excess, plans, slstm_s = [], [], [], []
    kernel_attention, plan_fn = L.multihead_attention, MOE._dispatch_plan
    slstm_fn = XL.slstm_forward

    def hooked(q, k, v, **kw):
        got = kernel_attention(q, k, v, **kw)
        want = kernel_attention(q, k, v, **dict(kw, backend="ref")).float()
        diff = (got.float() - want).abs()
        errs.append(float(diff.max()))
        excess.append(float((diff - LM_ATTN_TOL * want.abs()).max()))
        return got

    def planned(ids, n_experts, capacity):
        out = plan_fn(ids, n_experts, capacity)
        plans.append((ids, n_experts, capacity, out))
        return out

    def timed_slstm(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = slstm_fn(*args, **kw)
        torch.cuda.synchronize()
        slstm_s.append(time.perf_counter() - t0)
        return out

    L.multihead_attention, MOE._dispatch_plan = hooked, planned
    XL.slstm_forward = timed_slstm
    try:
        Engine(model, params, ServeConfig(max_len=max_len)).generate(
            prompts, 2)
    finally:
        L.multihead_attention, MOE._dispatch_plan = kernel_attention, plan_fn
        XL.slstm_forward = slstm_fn
    n_attn = family_attention_layers(cfg)
    out = {}
    check(len(errs) == 2 * n_attn,
          f"family {cfg.arch}: {len(errs)} hooked attention calls, want "
          f"{2 * n_attn}")
    if n_attn:
        check(max(excess) <= LM_ATTN_TOL,
              f"family {cfg.arch}: attention differs from the plain version "
              f"beyond rtol = atol = {LM_ATTN_TOL}: |diff| - rtol |plain| up "
              f"to {max(excess)}")
        out.update(attn_calls=len(errs),
                   attn_max_abs_err_prefill=max(errs[:n_attn]),
                   attn_max_abs_err_decode=max(errs[n_attn:]),
                   attn_excess=max(excess))
    if cfg.family == "moe":
        check(len(plans) == 2 * cfg.n_layers,
              f"family {cfg.arch}: {len(plans)} dispatch plans")
        ids, n_experts, capacity, (gather, valid) = plans[0]
        cpu_gather, cpu_valid = plan_fn(ids.cpu(), n_experts, capacity)
        check(ids.device.type == device.type
              and torch.equal(gather.cpu(), cpu_gather)
              and torch.equal(valid.cpu(), cpu_valid),
              f"family {cfg.arch}: layer 0's dispatch plan on the card "
              f"differs from the CPU's")
        kept = int(valid.sum())
        out.update(plan_shape=tuple(gather.shape), plan_capacity=capacity,
                   copies=ids.numel(), kept=kept,
                   dropped_share=1 - kept / ids.numel())
    if cfg.family == "ssm":
        n_slstm = sum(1 for i in range(cfg.n_layers)
                      if (i + 1) % cfg.slstm_every == 0)
        check(len(slstm_s) == n_slstm,
              f"family {cfg.arch}: {len(slstm_s)} sLSTM prefills timed")
        out.update(slstm_prefill_s=slstm_s)

    ref_model = build_model(cfg, backend="ref")
    toks = torch.as_tensor(prompts, device=device)
    with torch.no_grad():
        cache = zeros_of(model.cache_defs(batch, max_len), device=device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got, _ = model.decode_step(params, cache, toks, 0)
        end.record()
        end.synchronize()
        out["warm_prefill_ms"] = start.elapsed_time(end)
        del cache
        cache = zeros_of(model.cache_defs(batch, max_len), device=device)
        want, _ = ref_model.decode_step(params, cache, toks, 0)
        del cache
        v = cfg.vocab_size
        out["logit_diff"] = max(
            float((got[b].float() - want[b].float()).abs().max())
            for b in range(batch))
        out["top1"] = float((got[..., :v].argmax(-1)
                             == want[..., :v].argmax(-1)).float().mean())
        del got, want
    return out


def serve_family(arch: str, depth, requests, seed: int,
                 device: torch.device) -> tuple[dict, dict]:
    """One model of phase 3l: built at full width (cut to ``depth``
    layers where given), its bytes reckoned and held to the card, bf16
    weights drawn on the card from ``seed``, then each greedy request
    through ``Engine.generate`` (``timed_generate``; tokens in range,
    every step's logits finite, the stats the reference's,
    ``flash_attention`` once an attention layer a step) beside its
    bounds, then ``family_checks``.  Frees all it made.  Returns the
    requests' launch counts and the numbers logged."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import build_model
    from repro_torch.models.params import param_count

    cfg = get_config(arch)
    full = cfg.n_layers
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    cut = "full depth" if depth is None else \
        f"depth cut to {depth} of {full} layers"
    model = build_model(cfg)
    max_len = max(p + n for _, p, n in requests)
    need, how = family_reckoning(model, max(b for b, _, _ in requests),
                                 max(p for _, p, _ in requests), max_len)
    ok, free = fits(need, device)
    check(ok, f"family {arch}: reckoned {need:.0f} bytes ({how}) do not "
              f"fit the card's {free:.0f} free with {SERVE_MARGIN} to spare")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    check(n_params == param_count(model.abstract()),
          f"family {arch}: {n_params} parameters, the defs say otherwise")
    n_attn = family_attention_layers(cfg)
    log(f"family {arch}: {cfg.family}, {cut}, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} (padded {cfg.padded_heads}) / kv {cfg.n_kv_heads}, "
        f"head_dim {cfg.head_dim}, experts {cfg.n_experts} x "
        f"{cfg.expert_d_ff} top-{cfg.top_k} (+{cfg.n_shared_experts} "
        f"shared), ssm_state {cfg.ssm_state}, vocab {cfg.vocab_size}; "
        f"param_count {n_params}, {2 * n_params} bytes bf16 drawn in "
        f"{init_s:.2f} s; reckoned {need:.0f} bytes ({how}); "
        f"{n_attn} attention layers a step")

    counts = {}
    res = dict(arch=arch, family=cfg.family, layers=cfg.n_layers,
               full_layers=full, params=n_params, requests=[])
    for i, (batch, plen, n_new) in enumerate(requests):
        prompts = lm_prompts(seed + i, batch, plen, cfg.vocab_size)
        run = timed_generate(model, params, prompts, n_new, max_len, device)
        tokens, launched = run["tokens"], run["launched"]
        label = f"family {arch} request {i + 1}"
        check(tokens.shape == (batch, n_new) and tokens.dtype == np.int32
              and bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
              f"{label}: tokens misshapen or out of range")
        check(run["finite"], f"{label}: logits not finite")
        check(run["stats"] == {"prompt_len": float(plen),
                               "generated": float(n_new)},
              f"{label}: stats {run['stats']}")
        check(launched["flash_attention"] == n_attn * n_new,
              f"{label}: {launched['flash_attention']} flash_attention "
              f"launches, want {n_attn * n_new}")
        prefill_ms = run["step_ms"][0]
        decode_ms = statistics.median(run["step_ms"][1:])
        b = family_bounds(model, n_params, batch, plen, plen + n_new // 2)
        r = dict(batch=batch, prompt=plen, n_new=n_new,
                 prefill_ms=prefill_ms, decode_ms=decode_ms,
                 wall_s=run["wall_s"],
                 tokens_per_s=batch * n_new / run["wall_s"],
                 decode_tokens_per_s=batch / decode_ms * 1e3,
                 launches=launched["flash_attention"], **b)
        res["requests"].append(r)
        log(f"{label} ok: B={batch} P={plen} n_new={n_new} prefill_ms="
            f"{prefill_ms:.3f} (bound {b['prefill_bound_ms']:.3f}, "
            f"{b['prefill_by']}; {b['prefill_ops']:.4g} operations) "
            f"decode_step_ms_median={decode_ms:.3f} (bound "
            f"{b['decode_bound_ms']:.3f}, {b['decode_by']}; {n_new - 1} "
            f"steps) "
            f"wall_s={run['wall_s']:.3f} tokens_per_s="
            f"{r['tokens_per_s']:.1f} decode_tokens_per_s="
            f"{r['decode_tokens_per_s']:.1f} flash_attention launches "
            f"{launched['flash_attention']} (= {n_attn} x {n_new})")
        for name, c in launched.items():
            counts[name] = counts.get(name, 0) + c

    batch, plen, _ = requests[0]
    checks = family_checks(model, params, cfg, batch, plen, max_len, seed,
                           device)
    res.update(checks)
    peak = torch.cuda.max_memory_allocated()
    res["peak_bytes"] = peak
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"family {arch} ok: {checks}; peak_bytes {peak} "
        f"(max_memory_allocated; reckoned {need:.0f}); allocated {before} "
        f"bytes before, {torch.cuda.memory_allocated()} after")
    return counts, res


def run_model_families(seed: int, device: torch.device
                       ) -> tuple[dict, list]:
    """Phase 3l: ``serve_family`` for each of ``FAMILY_MODELS`` in turn.
    Returns the summed launch counts and each model's numbers."""
    counts, results = {}, []
    t0 = time.perf_counter()
    for arch, depth, requests in FAMILY_MODELS:
        launched, res = serve_family(arch, depth, requests, seed, device)
        results.append(res)
        for name, c in launched.items():
            counts[name] = counts.get(name, 0) + c
    log(f"family phase ok: {len(results)} models in "
        f"{time.perf_counter() - t0:.1f} s; launches {counts}")
    return counts, results


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _sorted_ids(gen, batch, n, n_live, n_groups, num_segments, device):
    """Main-path group-by input: a live prefix of non-decreasing group
    ids, the padded tail at ``num_segments`` (dropped)."""
    ids = torch.full((batch, n), num_segments, dtype=torch.int32,
                     device=device)
    live = torch.randint(0, n_groups, (batch, n_live), generator=gen,
                         device=device, dtype=torch.int32)
    ids[:, :n_live] = torch.sort(live, dim=-1).values
    vals = torch.zeros(batch, n, device=device)
    vals[:, :n_live] = 1.0
    return vals, ids


def segment_sum_phase(w: Workload, gen, iters: int, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.segment_sum import segment_sum

    st, caps = w.stats, w.caps
    batch = math.prod(GRID)
    j1, a1, j3 = st.prefix_joins[0], st.prefix_aggs[0], st.prefix_joins[-1]
    cases = {
        # 2,3JA pushdown Γ: (16, mid) rows -> (16, agg) groups.
        "pushdown": (caps.mid, caps.agg, math.ceil(j1 / batch),
                     math.ceil(a1 / batch), False),
        # 1,3JA charged round / final Γ: (16, join) -> (16, out).
        "final": (caps.join, caps.out, math.ceil(j3 / batch),
                  math.ceil(len(w.a3_keys) / batch), False),
        # The same shape with the rows shuffled and non-integer values.
        "shuffled": (caps.join, caps.out, math.ceil(j3 / batch),
                     math.ceil(len(w.a3_keys) / batch), "shuffled"),
        # Sorted, with non-integer values: the same bits on every launch.
        "sorted_float": (caps.join, caps.out, math.ceil(j3 / batch),
                         math.ceil(len(w.a3_keys) / batch), "float"),
        # Past the grid's 65,535 rows (a laned grid's many devices).
        "c3_rows": (256, 64, 200, 64, False),
    }
    results = {}
    for case, (n, s, n_live, n_groups, kind) in cases.items():
        batch = C3_ROWS if case.startswith("c3") else math.prod(GRID)
        vals, ids = _sorted_ids(gen, batch, n, n_live, n_groups, s, dev)
        if kind:
            noise = torch.randn(batch, n, generator=gen, device=dev)
            vals = torch.where(vals > 0, noise, 0.0)
        if kind == "shuffled":
            perm = torch.argsort(torch.rand(batch, n, generator=gen,
                                            device=dev), dim=-1)
            ids = ids.gather(-1, perm).contiguous()
            vals = vals.gather(-1, perm).contiguous()
        got = segment_sum(vals, ids, s)
        want = ref.segment_sum(vals, ids, s)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if kind:          # float sums in another order than the plain
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        else:             # integer-valued sums below 2^24: exact
            check(err == 0.0, f"segment_sum {case}: max abs err {err}")
        if kind == "float":   # one addend a segment: the same bits again
            check(torch.equal(got, segment_sum(vals, ids, s)),
                  f"segment_sum {case}: two launches differ")
        # The library yardstick: one index_add_ into a flat buffer with
        # a sink slot for the dropped ids (index built outside the timing).
        flat = torch.where((ids >= 0) & (ids < s),
                           ids.to(torch.int64)
                           + torch.arange(batch, device=dev)[:, None] * s,
                           batch * s).reshape(-1)
        sink = torch.zeros(batch * s + 1, device=dev)
        flat_vals = vals.reshape(-1)
        ms = time_ms(lambda: segment_sum(vals, ids, s), iters)
        plain_ms = time_ms(lambda: ref.segment_sum(vals, ids, s), iters)
        lib_ms = time_ms(lambda: sink.zero_().index_add_(0, flat, flat_vals),
                         iters)
        b_ms, b_by = bound_ms(batch * n * 8 + batch * s * 4, batch * n)
        results[case] = dict(shape=f"({batch},{n})->({batch},{s})",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
        log(f"kernel segment_sum {case}: {results[case]}")
        del vals, ids, got, want, flat, sink, flat_vals
    torch.cuda.empty_cache()
    return results


def probe_counts_phase(w: Workload, gen, iters: int, dev) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.fused_join import probe_counts

    st, caps = w.stats, w.caps
    batch = math.prod(GRID)
    r, j1, a1 = st.sizes[0], st.prefix_joins[0], st.prefix_aggs[0]
    join2 = (caps.mid, caps.local, math.ceil(j1 / batch),
             math.ceil(r / GRID[1]))
    hop2 = (caps.agg, caps.agg, math.ceil(a1 / batch), math.ceil(r / batch))
    # (shape, key dtype, queries shuffled within each row)
    cases = {
        # 1,3J second join: the (R ⋈ S) shard probes the placed T shard.
        "one_round_join2": (join2, torch.int32, False),
        # 2,3JA hop 2: the aggregated prefix probes T, both at agg.
        "cascade_hop2": (hop2, torch.int32, False),
        # hop 2's queries in random order: every tile's window is most
        # of the row, searched in device memory.
        "unsorted": (hop2, torch.int32, True),
        # The 1,3J shape with 64-bit keys above 2^32.
        "int64": (join2, torch.int64, False),
        # Past the grid's 65,535 rows.
        "c3_rows": ((128, 128, 100, 100), torch.int32, False),
    }
    results = {}
    for case, ((nq, nr, q_live, r_live), dtype, shuffled) in cases.items():
        batch = C3_ROWS if case.startswith("c3") else math.prod(GRID)
        sentinel = torch.iinfo(dtype).max
        offset = 0 if dtype == torch.int32 else 1 << 40

        def side(n, live):
            keys = torch.full((batch, n), sentinel, dtype=dtype, device=dev)
            keys[:, :live] = offset + torch.sort(torch.randint(
                0, w.n_nodes, (batch, live), generator=gen, device=dev,
                dtype=dtype), dim=-1).values
            return keys
        queries, keys = side(nq, q_live), side(nr, r_live)
        if shuffled:
            perm = torch.argsort(torch.rand(batch, nq, generator=gen,
                                            device=dev), dim=-1)
            queries = queries.gather(-1, perm).contiguous()
        lo, hi = probe_counts(queries, keys)
        lo_r, hi_r = ref.probe_counts(queries, keys)
        torch.cuda.synchronize()
        check(torch.equal(lo, lo_r) and torch.equal(hi, hi_r),
              f"probe_counts {case}: kernel != plain")
        err = float(max((lo - lo_r).abs().max(), (hi - hi_r).abs().max()))
        ms = time_ms(lambda: probe_counts(queries, keys), iters)
        dev_ms = device_ms(lambda: probe_counts(queries, keys), iters)
        plain_ms = time_ms(lambda: ref.probe_counts(queries, keys), iters)

        def library():
            torch.searchsorted(keys, queries, side="left", out_int32=True)
            torch.searchsorted(keys, queries, side="right", out_int32=True)
        lib_ms = time_ms(library, iters)
        steps = math.ceil(math.log2(nr + 1))
        size = queries.element_size()
        b_ms, b_by = bound_ms(batch * (nq * size + nr * size + nq * 8),
                              2 * batch * nq * steps)
        results[case] = dict(shape=f"({batch},{nq})x({batch},{nr}) {dtype}",
                             max_abs_err=err, ms=ms, device_ms=dev_ms,
                             plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=b_by)
        log(f"kernel probe_counts {case}: {results[case]}")
        del queries, keys, lo, hi, lo_r, hi_r
        torch.cuda.empty_cache()
    return results


def hash_histogram_phase(w: Workload, gen, iters: int, dev) -> dict:
    from repro_torch.core.hashing import bucket_hash
    from repro_torch.kernels import ref
    from repro_torch.kernels.hash_partition import (bucket_counts,
                                                    hash_histogram)

    st, caps = w.stats, w.caps
    batch = math.prod(GRID)
    r, a1 = st.sizes[0], st.prefix_aggs[0]
    # (rows, keys per row, live prefix, buckets, key dtype, key range)
    shapes = {
        # The largest hop measure_skew reads on the main path: 2,3JA's
        # hop 2, whose left side is the pushdown Γ output (caps.agg
        # slots, a1 live rows), hashed into k = 16 buckets.
        "cascade_hop2": (batch, caps.agg, math.ceil(a1 / batch), K,
                         torch.int32, w.n_nodes),
        # 1,3J: S's second placement hop, 4 buckets.
        "placement_1_3J": (batch, caps.local, math.ceil(r / batch), GRID[1],
                           torch.int32, w.n_nodes),
        # heavy_hitters pass 1: one column of the skew workload.
        "detection": (1, SKEW_EDGES, SKEW_EDGES, 4096, torch.int32,
                      SKEW_NODES),
        # 64-bit keys above 2^32.
        "int64": (batch, caps.local, math.ceil(r / batch), K, torch.int64,
                  1 << 40),
        # Past the grid's 65,535 rows, and past a shared histogram's
        # 12,288 buckets (global atomics).
        "c3_rows": (C3_ROWS, 128, 100, K, torch.int32, w.n_nodes),
        "c3_buckets": (1, SKEW_EDGES, SKEW_EDGES, C3_BUCKETS, torch.int32,
                       SKEW_NODES),
    }
    # Per-block counts at every shape; the totals (bucket_counts, what
    # both callers launch) at the main path's largest hop, at its 4-bucket
    # placement hop (the register counters), at detection and at the
    # C3 shapes.
    cases = [(name, "per_block") for name in shapes]
    cases += [(name, "totals")
              for name in ("cascade_hop2", "placement_1_3J", "detection",
                           "c3_rows", "c3_buckets")]
    results = {}
    for name, form in cases:
        rows, n, live, nb, dtype, hi = shapes[name]
        keys = torch.randint(0, hi, (rows, n), generator=gen, device=dev,
                             dtype=torch.int64).to(dtype)
        valid = torch.arange(n, device=dev).expand(rows, n) < live
        if form == "per_block":
            case = name

            def kernel():
                return hash_histogram(keys, valid, nb)

            def plain():
                return ref.hash_histogram(keys, valid, nb)
        else:
            case = f"bucket_counts_{name}"

            def kernel():
                return bucket_counts(keys, valid, nb)

            def plain():
                return bucket_counts(keys, valid, nb, backend="ref")
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.equal(got, want),
              f"hash_histogram {case}: kernel != plain")
        err = float((got - want).abs().max())
        ms = time_ms(kernel, iters)
        dev_ms = device_ms(kernel, iters)
        plain_ms = time_ms(plain, iters)
        # The library yardstick does less work: torch.bincount over
        # (row, block, bucket) cells, or (row, bucket) cells for the
        # totals, computed outside the timing — it does not hash.
        b = ref.histogram_block(n, 1024) if form == "per_block" else n
        n_blocks = -(-n // b)
        cell = (torch.arange(rows, device=dev)[:, None] * n_blocks
                + torch.arange(n, device=dev) // b) * nb
        cell = torch.where(valid, cell + bucket_hash(keys, nb),
                           rows * n_blocks * nb).reshape(-1)
        size = rows * n_blocks * nb + 1

        def library():
            return torch.bincount(cell, minlength=size)
        lib_ms = time_ms(library, iters)
        lib_dev_ms = device_ms(library, iters)
        # Every valid byte is read, a key only where it is valid (the
        # intermediate's buffers are mostly padding), every count written.
        n_valid = int(valid.sum())
        b_ms, b_by = bound_ms(rows * n + n_valid * keys.element_size()
                              + got.numel() * 4, 10 * n_valid)
        results[case] = dict(
            shape=f"({rows},{n})->{tuple(got.shape)}", max_abs_err=err,
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
            library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by,
            library="torch.bincount of precomputed cells (does not hash)")
        log(f"kernel hash_histogram {case}: {results[case]}")
        del keys, valid, got, want, cell
    torch.cuda.empty_cache()
    return results


def attention_shapes():
    """(case, q shape, kv shape) of the attention entry point's run at
    qwen2-7b's attention widths: prefill and decode."""
    q_pre = (1, ATTN_HEADS, ATTN_LEN, ATTN_DIM)
    kv = (1, ATTN_KV_HEADS, ATTN_LEN, ATTN_DIM)
    return [("prefill", q_pre, kv),
            ("decode", (1, ATTN_HEADS, 1, ATTN_DIM), kv)]


def attention_cases():
    """(label, q shape, kv shape, dtype) of the kernel phase, every path
    of ``_plan`` among them: bf16 prefill, a ragged chunk and D = 64 on
    the tensor cores ("wgmma"), decode in both dtypes split over the kv
    axis ("split"), float32 prefill on the CUDA cores ("simt")."""
    h, hkv, d, n = ATTN_HEADS, ATTN_KV_HEADS, ATTN_DIM, ATTN_LEN
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        ("prefill_bfloat16", (1, h, n, d), (1, hkv, n, d), bf16),
        # The train step's forward (granite-3-2b), timed with and without
        # the lse store its backward reads.
        ("granite_bfloat16", (1, GRANITE_HEADS, GRANITE_LEN, GRANITE_DIM),
         (1, GRANITE_KV_HEADS, GRANITE_LEN, GRANITE_DIM), bf16),
        ("chunk_bfloat16", (1, h, ATTN_CHUNK, d), (1, hkv, ATTN_CHUNK_KV, d),
         bf16),
        ("prefill_d64_bfloat16", (1, h, n, 64), (1, hkv, n, 64), bf16),
        ("decode_bfloat16", (1, h, 1, d), (1, hkv, n, d), bf16),
        ("prefill_float32", (1, h, n, d), (1, hkv, n, d), f32),
        ("decode_float32", (1, h, 1, d), (1, hkv, n, d), f32),
        # The shapes past the first kernels' limits: xlstm-125m's head
        # dim 192 ("simt", and "split" in bfloat16), head dim 80 (the
        # wider instance, masked), float16 (through float32), and
        # (batch, head) rows past 65,535.
        ("c3_prefill_d192_float32", (1, 4, 1024, 192), (1, 4, 1024, 192),
         f32),
        ("c3_decode_d192_bfloat16", (1, 4, 1, 192), (1, 4, n, 192), bf16),
        ("c3_prefill_d80_bfloat16", (1, h, 1024, 80), (1, hkv, 1024, 80),
         bf16),
        ("c3_prefill_float16", (1, h, 1024, d), (1, hkv, 1024, d),
         torch.float16),
        ("c3_rows_float32", (1024, 64, 17, 16), (1024, 64, 17, 16), f32),
    ]


def lm_attention_cases():
    """Phase 2's cases at phase 3j's shapes (run in 3j's process):
    qwen2-7b's 32 padded query heads, request 1's prefill (4 x 1,024)
    and a decode step over 1,088 keys."""
    hkv, d, bf16 = ATTN_KV_HEADS, ATTN_DIM, torch.bfloat16
    return [("lm_prefill_bfloat16", (4, LM_HEADS, 1024, d),
             (4, hkv, 1024, d), bf16),
            ("lm_decode_bfloat16", (4, LM_HEADS, 1, d), (4, hkv, 1088, d),
             bf16)]


def attention_inputs(gen, dev, q_shape, kv_shape, dtype):
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in (q_shape, kv_shape, kv_shape)]


def hgmma_count(path: Path) -> int:
    """``HGMMA`` (wgmma) instructions in a built library's SASS."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, timeout=300, check=True)
    return sum("HGMMA" in line for line in out.stdout.splitlines())


def flash_attention_phase(gen, iters: int, dev, cases=None) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        NATIVE_DTYPES, _flash_attention_cuda, _plan, flash_attention)

    # The plain version's float32 products run in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for label, q_shape, kv_shape, dtype in cases or attention_cases():
        tol, rate = {torch.bfloat16: (2e-2, HALF_OPS_PER_S),
                     torch.float16: (2e-3, HALF_OPS_PER_S)}.get(
                         dtype, (2e-5, FP32_OPS_PER_S))
        b, h, sq, d = q_shape
        hkv, skv = kv_shape[1], kv_shape[2]
        plan = _plan(sq, skv, h, hkv, d, dtype, batch=b)
        q, k, v = attention_inputs(gen, dev, q_shape, kv_shape, dtype)
        got = flash_attention(q, k, v, causal=True)
        want = ref.attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        err = float((got.float() - want.float()).abs().max())
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True), iters)
        plain_ms = time_ms(lambda: ref.attention(q, k, v, causal=True),
                           iters)
        # The library yardstick, SDPA, on the same function: its causal
        # mask is aligned to the top left, so a ragged chunk gets the
        # end-aligned mask as a tensor (built outside the timing); with
        # Sq == Skv it is SDPA's own causal mask, and a single decode
        # query sees every key.
        mask = None
        if 1 < sq != skv:
            mask = (torch.arange(sq, device=dev)[:, None] + (skv - sq)
                    >= torch.arange(skv, device=dev)[None, :])
        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=sq == skv > 1,
                enable_gqa=True)
        lib_ms = time_ms(library, iters)
        dev_ms = device_ms(lambda: flash_attention(q, k, v, causal=True),
                           iters)
        lib_dev_ms = device_ms(library, iters)
        with_lse = {}
        if plan.path != "split":
            # The forward under autograd also stores each row's lse: the
            # same call with the store, timed beside the one without.
            def stored():
                return _flash_attention_cuda(q, k, v, True, d ** -0.5, 128,
                                             128, with_lse=True)

            lse = stored()[1]
            want_lse = ref.attention_lse(q, k, causal=True)
            torch.testing.assert_close(lse, want_lse, rtol=LSE_TOL,
                                       atol=LSE_TOL)
            with_lse = dict(
                ms_lse=time_ms(stored, iters),
                device_ms_lse=device_ms(stored, iters),
                lse_max_abs_err=float((lse - want_lse).abs().max()))
            del lse, want_lse
        n_ops = 4 * b * h * d * attention_pairs(sq, skv)
        n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        b_ms, b_by = bound_ms(n_bytes, n_ops, rate)
        results[label] = dict(
            shape=f"q{q_shape} kv{kv_shape} causal {dtype}",
            path=plan.path, splits=plan.splits, tile=plan.tile,
            native=dtype in NATIVE_DTYPES[plan.path], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by,
            library="torch.nn.functional.scaled_dot_product_attention",
            **with_lse)
        log(f"kernel flash_attention {label}: {results[label]}")
        del q, k, v, got, want, mask
        torch.cuda.empty_cache()
    for prefill, decode in (("prefill_bfloat16", "decode_bfloat16"),
                            ("lm_prefill_bfloat16", "lm_decode_bfloat16")):
        if prefill in results:
            check(results[prefill]["path"] == "wgmma"
                  and results[decode]["path"] == "split",
                  f"flash_attention: {prefill} or {decode} off its path")
    # The C3 16-bit prefills run on the tensor cores in their own dtype
    # (no float32 copy); float32 prefill on the redesigned "simt".
    want = {"c3_prefill_d80_bfloat16": "wgmma",
            "c3_prefill_float16": "wgmma", "prefill_float32": "simt",
            "c3_prefill_d192_float32": "simt", "c3_rows_float32": "simt"}
    off = {k: results[k]["path"] for k, p in want.items()
           if k in results and results[k]["path"] != p}
    check(not off, f"flash_attention: cases off their path: {off}")
    check(all(results[k]["native"] for k in want if k in results),
          "flash_attention: a prefill case ran through a float32 copy")
    return results


# The backward kernel's cases: granite-3-2b's attention as phase 3k's
# train step calls it (32 query heads over 8 kv heads, head dim 64, one
# 2,048-token sequence a microbatch, causal), in both dtypes, then a
# ragged chunk after cached keys at qwen2-7b's widths (head dim 128)
# and the widest instance (head dim 256).
GRANITE_HEADS, GRANITE_KV_HEADS, GRANITE_DIM, GRANITE_LEN = 32, 8, 64, 2048
# The backward against its plain version: phase 2's bf16 tolerance; in
# float32 1e-4 (sums over 2,048 keys in another order).
BWD_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float32: 1e-4}
# The forward's lse (a log2, ~11 at 2,048 keys) against the plain one:
# float32 sums in another order and the fast exp2 / log2.
LSE_TOL = 1e-3


def attention_bwd_cases():
    """(label, q shape, kv shape, dtype) of the backward kernel's phase:
    granite in both dtypes, the ragged chunk, D = 256, and the forward's
    C3 shapes (qwen2-7b's heads at 1,024 positions: bfloat16 at D = 80
    and float16 at D = 128 on "wgmma"; bfloat16 at D = 192 on "simt")."""
    h, hkv, d, n = GRANITE_HEADS, GRANITE_KV_HEADS, GRANITE_DIM, GRANITE_LEN
    ah, akv = ATTN_HEADS, ATTN_KV_HEADS
    return [
        ("granite_bfloat16", (1, h, n, d), (1, hkv, n, d), torch.bfloat16),
        ("granite_float32", (1, h, n, d), (1, hkv, n, d), torch.float32),
        ("chunk_bfloat16", (1, ah, ATTN_CHUNK, ATTN_DIM),
         (1, akv, ATTN_CHUNK_KV, ATTN_DIM), torch.bfloat16),
        ("d256_float32", (1, 4, 512, 256), (1, 2, 512, 256), torch.float32),
        ("d80_bfloat16", (1, ah, 1024, 80), (1, akv, 1024, 80),
         torch.bfloat16),
        ("d128_float16", (1, ah, 1024, 128), (1, akv, 1024, 128),
         torch.float16),
        ("d192_bfloat16", (1, 4, 1024, 192), (1, 4, 1024, 192),
         torch.bfloat16),
    ]


def attention_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal head sees, the diagonal at the end of
    the keys."""
    return sum(max(0, min(skv, i + skv - sq + 1)) for i in range(sq))


#: The backward's device functions, one launch each a call given the
#: forward's lse, by path; both add ``attention_bwd_slice_sum`` where the
#: dK/dV grid sums partials ("wgmma" head slices, "simt" parts), and
#: "simt" once more where its dQ sums parts, and ``attention_bwd_lse``
#: only when it recomputes the lse.
BWD_FUNCTIONS = {"wgmma": ("attention_bwd_delta", "attention_bwd_dq_wgmma",
                           "attention_bwd_dkdv_wgmma"),
                 "simt": ("attention_bwd_delta", "attention_bwd_dq_simt",
                          "attention_bwd_dkdv_simt")}


def bwd_device_split(fn, iters: int, want: dict, what: str):
    """Device ms a call of each backward device function that ``fn``
    runs, from a trace of ``iters`` calls holding exactly ``iters`` times
    ``want[f]`` records of each function f (its launches a call).  The profiler drops records
    (ROADMAP C9): a trace that falls short is taken again, three times
    at most (each short attempt logged and kept in ``TRACE_RETRIES``),
    and None comes back if none was whole."""
    for attempt in range(3):
        split, records = {}, {}
        for name, fn_ms, n in device_kernels(fn, iters):
            m = re.search(r"attention_bwd_\w+", name)
            key = m.group(0) if m else name[:40]
            split[key] = split.get(key, 0.0) + fn_ms
            records[key] = records.get(key, 0) + n
        if all(records.get(f) == iters * n for f, n in want.items()):
            return split
        log(f"trace: {what}: attempt {attempt} held records {records}, "
            f"want {iters} calls of {want}")
        TRACE_RETRIES.append(f"{what} (attempt {attempt}: {records})")
    return None


def flash_attention_bwd_phase(gen, iters: int, dev) -> dict:
    """The backward kernel (``flash_attention_backward``: on "wgmma"
    three device functions a call, four with head slices — delta, dQ,
    dK/dV, the slices' sum; on "simt" three) against
    ``ref.attention_backward`` on the same inputs, the forward's output
    and log-sum-exp from the forward kernel.  Times: the kernel as the
    train step calls it, with the forward's lse (``ms``, ``device_ms``),
    and recomputing the lse (``ms_recompute_lse``, held to the same
    tolerance), the plain version and the library's yardstick, SDPA's
    backward (``torch.autograd.grad`` through
    ``scaled_dot_product_attention`` with ``enable_gqa``, its forward
    run once outside the timing).  ``device_ms`` and ``device_split``
    come from a trace holding ``iters`` records of each of the path's
    device functions (``bwd_device_split``), else they are None.
    Bound: bytes (q, k, v, out, dout read, dq, dk, dv written) or
    operations at the dtype's peak, a visible pair a head: given the
    lse (``bound_ms``, where the forward stored one), 10·D, the products
    S, dP, dV, dK and dQ; recomputing it (``bound_ms_recompute_lse``,
    and ``bound_ms`` where the forward stored none), 12·D, S twice (the
    row's lse, then P) — the same yardstick whichever path runs."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        _bwd_plan, _flash_attention_cuda, flash_attention_backward)

    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for label, q_shape, kv_shape, dtype in attention_bwd_cases():
        tol = BWD_TOL[dtype]
        b, h, sq, d = q_shape
        skv = kv_shape[2]
        hkv = kv_shape[1]
        plan = _bwd_plan(b, h, hkv, sq, skv, d, dtype, True)
        # The peak of the dtype's operations, whichever path runs them.
        rate = (HALF_OPS_PER_S if dtype in (torch.bfloat16, torch.float16)
                else FP32_OPS_PER_S)
        q, k, v = attention_inputs(gen, dev, q_shape, kv_shape, dtype)
        dout = torch.randn(q_shape, generator=gen, device=dev).to(dtype)
        out, lse = _flash_attention_cuda(q, k, v, True, d ** -0.5, 128, 128,
                                         with_lse=True)
        got = flash_attention_backward(q, k, v, out, dout, causal=True,
                                       lse=lse)
        recomputed = flash_attention_backward(q, k, v, out, dout,
                                              causal=True)
        want = ref.attention_backward(q, k, v, dout, causal=True)
        torch.cuda.synchronize()
        err = 0.0
        for grads in (got, recomputed):
            for name, g, w in zip(("dq", "dk", "dv"), grads, want):
                check(g.dtype == dtype and g.shape == w.shape,
                      f"flash_attention_bwd {label}: {name} misshapen")
                torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                           atol=tol)
                err = max(err, float((g.float() - w.float()).abs().max()))
        again = flash_attention_backward(q, k, v, out, dout, causal=True,
                                         lse=lse)
        check(all(torch.equal(a, g) for a, g in zip(again, got)),
              f"flash_attention_bwd {label}: two launches differ")
        del got, want, again, recomputed

        def kernel():
            return flash_attention_backward(q, k, v, out, dout, causal=True,
                                            lse=lse)

        def kernel_recompute():
            return flash_attention_backward(q, k, v, out, dout, causal=True)

        ms = time_ms(kernel, iters)
        ms_recompute = time_ms(kernel_recompute, iters)
        plain_ms = time_ms(lambda: ref.attention_backward(
            q, k, v, dout, causal=True), iters)
        mask = None
        if 1 < sq != skv:
            mask = (torch.arange(sq, device=dev)[:, None] + (skv - sq)
                    >= torch.arange(skv, device=dev)[None, :])
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=sq == skv > 1,
            enable_gqa=True)

        def library():
            return torch.autograd.grad(lib_out, leaves, dout,
                                       retain_graph=True)

        lib_ms = time_ms(library, iters)
        want_fns = dict.fromkeys(BWD_FUNCTIONS[plan.path], 1)
        sums = (plan.slices > 1) + (plan.q_parts > 1)
        if sums:
            want_fns["attention_bwd_slice_sum"] = sums
        split = bwd_device_split(kernel, iters, want_fns,
                                 f"flash_attention_bwd {label}")
        # Given the forward's lse, no lse pass runs.
        check(split is None or "attention_bwd_lse" not in split,
              f"flash_attention_bwd {label}: an lse pass given the lse")
        pairs = attention_pairs(sq, skv)
        n_bytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
        n_ops_recompute = 12 * b * h * d * pairs
        n_ops = n_ops_recompute if lse is None else 10 * b * h * d * pairs
        b_ms, b_by = bound_ms(n_bytes, n_ops, rate)
        results[label] = dict(
            shape=f"q{q_shape} kv{kv_shape} causal {dtype}",
            path=plan.path, slices=plan.slices, ctas=plan.ctas,
            dq_tile=plan.tile, dq_parts=plan.q_parts,
            lse_from_forward=lse is not None,
            max_abs_err=err, ms=ms, ms_recompute_lse=ms_recompute,
            plain_ms=plain_ms, library_ms=lib_ms,
            device_ms=None if split is None else sum(split.values()),
            device_split=split,
            library_device_ms=device_ms(library, iters), bound_ms=b_ms,
            bound_by=b_by, n_ops=n_ops,
            bound_ms_recompute_lse=bound_ms(n_bytes, n_ops_recompute,
                                            rate)[0],
            library="torch.autograd.grad through "
                    "torch.nn.functional.scaled_dot_product_attention")
        log(f"kernel flash_attention_bwd {label}: {results[label]}")
        del q, k, v, dout, out, lse, leaves, lib_out, mask
        torch.cuda.empty_cache()
    want_paths = {"granite_bfloat16": "wgmma", "chunk_bfloat16": "wgmma",
                  "d80_bfloat16": "wgmma", "d128_float16": "wgmma",
                  "granite_float32": "simt", "d256_float32": "simt",
                  "d192_bfloat16": "simt"}
    off = {k: results[k]["path"] for k, p in want_paths.items()
           if results[k]["path"] != p}
    check(not off, f"flash_attention_bwd: cases off their path: {off}")
    check(all(r["lse_from_forward"] for r in results.values()),
          "flash_attention_bwd: a forward returned no lse")
    return results


def run_attention_entry(dev) -> dict:
    """The attention path: the entry point ``flash_attention.flash_attention`` once
    for prefill and once for decode (bfloat16, qwen2-7b widths), with
    the counts set to 0 just before and read just after."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = [attention_inputs(gen, dev, q_shape, kv_shape, torch.bfloat16)
              for _, q_shape, kv_shape in attention_shapes()]
    torch.cuda.synchronize()
    ops.reset_launches()
    outs = [flash_attention(q, k, v, causal=True) for q, k, v in inputs]
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    for (q, _, _), o in zip(inputs, outs):
        check(o.shape == q.shape and o.dtype == q.dtype
              and bool(torch.isfinite(o).all()),
              "attention entry point: output not finite or misshapen")
    check(counts["flash_attention"] > 0,
          "attention entry point: the flash_attention kernel was never "
          "launched")
    log(f"attention entry point ok: prefill + decode, launches={counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 4: the skew path (SharesSkew) at full size
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SkewWorkload:
    n_edges: int
    edges: list
    plan: object
    caps: dict                 # combo.heavy_dims -> ChainCaps
    j3: float
    a3_keys: np.ndarray
    a3_vals: np.ndarray


def combo_edges(plan, combo, edges):
    """The edge lists of one combination's parts: relation j keeps a
    tuple iff each of its join attributes is heavy exactly where the
    combination says so."""
    out = []
    for j, (src, dst) in enumerate(edges):
        keep = np.ones(len(src), bool)
        for d, col in ((j - 1, src), (j, dst)):
            if 0 <= d < len(combo.heavy_dims):
                m = np.isin(col, plan.heavy[d])
                keep &= m if combo.heavy_dims[d] else ~m
        out.append((src[keep], dst[keep]))
    return out


def combo_caps(plan, combo, edges):
    """Caps of one combination from the exact per-reducer loads of its
    parts.  ``default_chain_caps`` (6 × the mean load) does not hold
    them: Zipf keys below the heavy threshold still meet on one reducer
    of the residual grid, whose join is 55 × the mean at 8,192 edges.
    So, on the combination's grid (S on (h(b), g(c)), R1 on h(b), T on
    g(c), as ``place_relation`` routes them), the first local join of
    reducer (i, j) is Σ over its S tuples of indeg_R1(b), the second
    Σ indeg_R1(b)·outdeg_T(c); caps are ``SKEW_CAP_SLACK`` × the
    largest, + 256.
    Placement buffers hold a whole part (no reducer receives more)."""
    from repro_torch.core import ChainCaps
    from repro_torch.core.hashing import bucket_hash
    (_, r1_dst), (s_src, s_dst), (t_src, _) = combo_edges(plan, combo, edges)
    k0, k1 = combo.grid_shape
    reducer = (bucket_hash(torch.as_tensor(s_src), k0, salt=0).numpy() * k1
               + bucket_hash(torch.as_tensor(s_dst), k1, salt=1).numpy())
    indeg = np.bincount(r1_dst, minlength=SKEW_NODES).astype(np.float64)
    outdeg = np.bincount(t_src, minlength=SKEW_NODES).astype(np.float64)
    mid = np.bincount(reducer, weights=indeg[s_src], minlength=k0 * k1)
    join = np.bincount(reducer, weights=indeg[s_src] * outdeg[s_dst],
                       minlength=k0 * k1)

    def per(x):
        return int(SKEW_CAP_SLACK * x) + 256
    place = per(max(combo.sizes))
    return ChainCaps(recv=place, local=place, mid=per(mid.max()),
                     out=per(join.max()), join=per(join.max()),
                     agg=per(join.max()))


def make_skew_workload(n_edges: int, seed: int, device) -> SkewWorkload:
    import scipy.sparse as sp
    from repro_torch.core import ChainQuery, detect_chain_skew
    from repro_torch.data.graphs import zipf_edges

    t0 = time.perf_counter()
    src, dst = zipf_edges(SKEW_NODES, n_edges, SKEW_ALPHA, seed=seed)
    edges = [(src, dst)] * 3
    plan = detect_chain_skew(ChainQuery.three_way(), edges, SKEW_K,
                             device=device)
    check(plan is not None, f"skew workload {n_edges}: no heavy key")
    grids = [c.grid_shape for c in plan.combos]
    check(grids == SKEW_GRIDS,
          f"skew plan {n_edges}: combinations {grids}, want {SKEW_GRIDS}")
    caps = {c.heavy_dims: combo_caps(plan, c, edges) for c in plan.combos}
    n = SKEW_NODES
    adj = sp.csr_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    a3 = (adj @ adj @ adj).tocoo()
    keys = a3.row.astype(np.int64) * n + a3.col
    order = np.argsort(keys)
    j3 = float(a3.data.sum())
    log(f"skew workload: zipf({n}, {n_edges}, {SKEW_ALPHA}) k={SKEW_K}: "
        f"heavy {[h.tolist() for h in plan.heavy]}; combos "
        + "; ".join(f"{c.heavy_dims} {c.grid_shape} sizes {c.sizes} caps "
                    f"{dataclasses.asdict(caps[c.heavy_dims])}"
                    for c in plan.combos)
        + f"; j3={j3:.0f} nnz(A^3)={a3.nnz}; plan cost {plan.cost():.0f}; "
        f"host set-up {time.perf_counter() - t0:.1f} s")
    return SkewWorkload(n_edges, edges, plan, caps, j3, keys[order],
                        a3.data[order])


def plain_shares_load(sw: SkewWorkload, device) -> float:
    """``max_bucket_load`` of plain Shares on the base grid, for
    comparison: its placement only, measured as the executor measures
    it — its join does not fit (the hot reducer holds every path
    through the heavy keys)."""
    from repro_torch.core import (ChainCaps, ChainQuery, SimGrid,
                                  edge_relation, scatter_to_grid)
    from repro_torch.core.executor import place_relation

    query, base = ChainQuery.three_way(), sw.plan.base_shape
    whole = sw.n_edges + 256
    caps = ChainCaps(recv=whole, mid=1, out=1, local=whole)
    load = 0.0
    for j, (s, d) in enumerate(sw.edges):
        rel = scatter_to_grid(edge_relation(s, d, names=query.schema(j),
                                            device=device), base)
        _, ovf, sk = place_relation(SimGrid(base), query, j, rel, caps=caps,
                                    measure_skew=True)
        check(not bool(ovf), f"plain Shares placement {j}: overflow")
        load = max(load, float(sk))
    return load


def run_shares_skew(sw: SkewWorkload, device: torch.device) -> dict:
    """1,3JS and 1,3JSA through ``shares_skew_chain`` with
    ``measure_skew=True``; returns the launches per kernel."""
    from repro_torch.core import ChainQuery, edge_relation, shares_skew_chain
    from repro_torch.kernels import ops

    on_gpu = device.type == "cuda"
    launches = {name: 0 for name in ops.LAUNCHES}
    plan = sw.plan
    w = Workload(SKEW_NODES, sw.edges, None, None, sw.a3_keys, sw.a3_vals)
    for name, aggregate in (("1,3JS", False), ("1,3JSA", True)):
        query = ChainQuery.three_way(aggregate=aggregate)
        rels = [edge_relation(s, d, names=query.schema(j), device=device)
                for j, (s, d) in enumerate(sw.edges)]
        if on_gpu:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        out, stats, overflow = shares_skew_chain(
            query, rels, plan, caps=lambda c: sw.caps[c.heavy_dims],
            measure_skew=True)
        if on_gpu:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        del rels
        check(not bool(overflow), f"{name}: overflow")
        read, shuffled = float(stats["read"]), float(stats["shuffled"])
        total = float(stats["total"])
        load = float(stats["max_bucket_load"])
        if aggregate:
            # Each combination charges its aggregation round: 2·|join|
            # more; past 2^24 the float32 total holds to one ulp.
            want = plan.cost() + 2.0 * sw.j3
            tol = float(np.spacing(np.float32(want)))
            check(abs(total - want) <= tol,
                  f"{name}: measured {total} != plan cost + 2 j3 = {want}")
        else:
            want = plan.cost()
            check(read == plan.read_cost() and shuffled == plan.shuffle_cost(),
                  f"{name}: measured read/shuffled {read}/{shuffled} != plan "
                  f"{plan.read_cost()}/{plan.shuffle_cost()}")
        rows = int(out.count())
        check(aggregate or rows == sw.j3, f"{name}: {rows} rows, j3 = {sw.j3}")
        groups = check_against_a3(w, out, aggregate)
        check(0 < load <= read, f"{name}: max_bucket_load {load}")
        if on_gpu:
            for kname in ("hash_histogram",) + (("segment_sum",)
                                                if aggregate else ()):
                check(counts[kname] > 0,
                      f"{name}: the {kname} kernel was never launched")
        for kname, c in counts.items():
            launches[kname] += c
        del out
        if on_gpu:
            torch.cuda.empty_cache()
        log(f"skew path {name:6s} ok: edges={sw.n_edges} rows={rows} "
            f"groups={groups} read={read:.0f} shuffled={shuffled:.0f} "
            f"total={total:.0f} analytic={want:.0f} max_bucket_load={load:.0f}"
            f" plain_1,3J_max_bucket_load={plain_shares_load(sw, device):.0f}"
            f" (not asserted) wall_ms={wall_ms:.1f} peak_bytes={peak} "
            f"launches={counts}")
    return launches


# ---------------------------------------------------------------------------
# Optional: where the time goes (--profile)
# ---------------------------------------------------------------------------

def profile_runs(w: Workload, sw: SkewWorkload, device: torch.device,
                 out_dir: Path) -> None:
    """Run every main-path strategy, every map-side run (phase 3d's,
    from partitions made on the card) and both SharesSkew queries once
    more under ``torch.profiler``: print the device busy time against
    the wall time and the ops that take most device time, and write
    each run's table to ``out_dir``."""
    from repro_torch.core import (ChainQuery, SimGrid, chain_edge_inputs,
                                  chain_partitioning, edge_relation,
                                  execute_chain, partition_relation,
                                  shares_skew_chain)

    out_dir.mkdir(parents=True, exist_ok=True)
    for name, aggregate, strategy, impl, measure in RUNS:
        query = ChainQuery.three_way(aggregate=aggregate)
        rels = chain_edge_inputs(query, w.edges, GRID, device=device)
        label = f"{impl}{' measure_skew' if measure else ''}"
        _profiled(device, out_dir, name, label, lambda: execute_chain(
            SimGrid(GRID), query, rels, strategy=strategy, caps=w.caps,
            join_impl=impl, measure_skew=measure))
        del rels
    prels, cert = [], None
    part_cap = part_capacity_for(w.edges)[0]
    for j, (src, dst) in enumerate(w.edges):
        query = ChainQuery.three_way()
        prels.append(partition_relation(
            edge_relation(src, dst, names=query.schema(j), device=device),
            store_key(query, j), MS_P, part_capacity=part_cap)[0])
    cert = chain_partitioning(ChainQuery.three_way(),
                              [p.spec for p in prels])
    caps = mapside_caps(w)
    for run in MS_RUNS:
        query, rels, kw = mapside_run(w, prels, cert, caps, run, device)
        _profiled(device, out_dir, run[0], f"mapside {run[2]}",
                  lambda: execute_chain(SimGrid((MS_P,)), query, rels, **kw))
        del rels
    del prels
    for name, aggregate in (("1,3JS", False), ("1,3JSA", True)):
        query = ChainQuery.three_way(aggregate=aggregate)
        rels = [edge_relation(s, d, names=query.schema(j), device=device)
                for j, (s, d) in enumerate(sw.edges)]
        _profiled(device, out_dir, name, "shares_skew",
                  lambda: shares_skew_chain(
                      query, rels, sw.plan,
                      caps=lambda c: sw.caps[c.heavy_dims],
                      measure_skew=True))
        del rels


def _profiled(device: torch.device, out_dir: Path, name: str, label: str,
              run) -> None:
    """One ``run()`` (returning ``(out, stats, overflow)``) under the
    profiler: its wall and device-busy time and its top ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops as kops

    on_gpu = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_gpu
                                     else [])
    if on_gpu:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out, _, overflow = run()
        if on_gpu:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(not bool(overflow), f"profile {name} {label}: overflow")
    del out
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    # aten ops by the device time of the kernels they launch themselves;
    # the port's own kernels launch outside any aten op.
    ops = sorted(((dev_us(e) / 1e3, e.key) for e in events
                  if e.device_type == DeviceType.CPU
                  and e.key.startswith("aten::") and dev_us(e) > 0),
                 reverse=True)
    # The port's kernels by their device functions (bucket_counts runs
    # as "bucket_totals", whose name holds no kernel's).
    symbols = [sym for syms in kops.KERNEL_SYMBOLS.values() for sym in syms]
    own = sorted(((dev_us(e) / 1e3, e.key) for e in events
                  if e.device_type == DeviceType.CUDA
                  and any(sym in e.key for sym in symbols)),
                 reverse=True)
    top = ", ".join(f"{k} {ms:.1f}" for ms, k in ops[:8] + own)
    share = busy_ms / wall_ms if wall_ms else 0.0
    log(f"profile {name:6s} {label:10s}: wall_ms={wall_ms:.1f} "
        f"device_busy_ms={busy_ms:.1f} busy_share={share:.3f}; "
        f"device ms by op: {top}")
    stem = f"{name.replace(',', '_')}_{label.replace(' ', '_')}"
    (out_dir / f"profile_{stem}.txt").write_text(events.table(
        sort_by="self_device_time_total" if on_gpu
        else "self_cpu_time_total", row_limit=60))
    if on_gpu:
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=14,
                    help="R-MAT scale: 2^scale nodes (default 14)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=10,
                    help="timed launches per kernel (median reported)")
    ap.add_argument("--profile", type=Path, default=None, metavar="DIR",
                    help="also trace every main-path and SharesSkew run "
                         "once with torch.profiler and write the tables "
                         "to DIR")
    ap.add_argument("--train-only", action="store_true",
                    help="run phase 3k alone (building the attention "
                         "kernels only) and print its numbers as JSON: "
                         "to compare two trees' train steps, turn about")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    if args.train_only:
        _build.build(("flash_attention", "flash_attention_bwd"))
        log(f"build: {time.perf_counter() - t0:.1f} s")
        counts, train = run_lm_training(args.seed, torch.device("cuda"))
        print(json.dumps({"train": train, "launches": counts}))
        print(card, flush=True)
        return 0
    paths = _build.build()
    log(f"build: {len(paths)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        fn = ""
        for line in path.with_suffix(".log").read_text().splitlines():
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            if "registers" in line or "spill" in line:
                log(f"ptxas {name} {fn}: {line.strip()}")
    for name in ("flash_attention", "flash_attention_bwd"):
        n_hgmma = hgmma_count(paths[name])
        log(f"sass {name}: {n_hgmma} HGMMA instructions")
        check(n_hgmma > 0, f"{name}: no HGMMA in the built library")

    w = make_workload(args.scale, args.seed)
    dev = torch.device("cuda")
    skew = make_skew_workload(SKEW_EDGES, args.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    phases = {"segment_sum": segment_sum_phase(w, gen, args.iters, dev),
              "probe_counts": probe_counts_phase(w, gen, args.iters, dev),
              "hash_histogram": hash_histogram_phase(w, gen, args.iters, dev),
              "flash_attention": flash_attention_phase(gen, args.iters, dev),
              "flash_attention_bwd": flash_attention_bwd_phase(
                  gen, args.iters, dev)}

    launches, per_slot = run_main_path(w, dev)
    compiled, replays = run_compiled_path(w, dev)
    for counts in (compiled, run_serving(w, per_slot, dev),
                   run_mapside_path(w, per_slot, replays, dev),
                   run_entry_points(w, dev),
                   run_store(w, per_slot, args.seed, dev),
                   run_recovery(w, args.seed, dev),
                   run_overlap_path(w, replays, dev),
                   run_shardgrid(w, per_slot, args.seed, dev),
                   run_shares_skew(skew, dev), run_attention_entry(dev)):
        for name, c in counts.items():
            launches[name] += c
    if args.profile is not None:
        profile_runs(w, skew, dev, args.profile)
    lm_counts, lm_cases = run_lm_serving(args.seed, dev, args.iters)
    phases["flash_attention"].update(lm_cases)
    for name, c in lm_counts.items():
        launches[name] += c
    train_counts, _ = run_lm_training(args.seed, dev)
    for name, c in train_counts.items():
        launches[name] += c
    family_counts, _ = run_model_families(args.seed, dev)
    for name, c in family_counts.items():
        launches[name] += c

    # The heaviest case of each kernel's path goes into the line; the
    # path's hash_histogram launches are all bucket_counts.
    headline = {"segment_sum": "final", "probe_counts": "one_round_join2",
                "hash_histogram": "bucket_counts_cascade_hop2",
                "flash_attention": "prefill_bfloat16",
                "flash_attention_bwd": "granite_bfloat16"}
    kernels = []
    for name, meta in KERNELS.items():
        res = phases[name][headline[name]]
        kernels.append(dict(name=name, route="cuda", **meta,
                            launches=launches[name],
                            max_abs_err=max(r["max_abs_err"]
                                            for r in phases[name].values()),
                            ms=res["ms"], plain_ms=res["plain_ms"],
                            bound_ms=res["bound_ms"],
                            bound_by=res["bound_by"],
                            library_ms=res["library_ms"],
                            shape=res["shape"]))
    log(f"trace retries: {len(TRACE_RETRIES)} {TRACE_RETRIES}")
    differ = [t for t in TRACED_GRAPHS if t[1] != t[2]]
    log(f"traced replays whose kernel records equal their graph's kernel "
        f"nodes: {len(TRACED_GRAPHS) - len(differ)} of {len(TRACED_GRAPHS)}"
        f" {differ}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
