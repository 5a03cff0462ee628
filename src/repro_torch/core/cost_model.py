"""Analytic communication-cost model (paper §IV–V) + crossover analysis,
extended to N-way chains (Afrati–Ullman Shares on a rank-(N−1) hypercube
vs. the cascade of two-way rounds, with or without aggregation pushdown).

Port: a verbatim copy of ``src/repro/core/cost_model.py`` (pure Python).

All costs are in TUPLES (the paper's unit; multiply by tuple width for
bytes).  ``r, s, t`` are input sizes; ``j1 = |R ⋈ S|``; ``a1 =
|Γ(R ⋈ S)|``; ``j3 = |R ⋈ S ⋈ T|`` (raw three-way size).

These formulas are validated against the instrumented engine's measured
counts in tests/test_cost_model.py — measured == analytic, exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Paper formulas
# ---------------------------------------------------------------------------

def cost_two_way(r: float, s: float) -> float:
    """One two-way join round: read r+s, shuffle r+s (paper §III)."""
    return 2 * r + 2 * s


def optimal_k1_k2(k: int, r: float, t: float) -> tuple:
    """Afrati–Ullman optimal grid split: k1=√(kr/t), k2=√(kt/r)."""
    k1 = math.sqrt(k * r / t)
    k2 = math.sqrt(k * t / r)
    return k1, k2


def cost_one_round(r: float, s: float, t: float, k: int,
                   k1: Optional[float] = None, k2: Optional[float] = None) -> float:
    """1,3J cost: (r+s+t) + (s + k1·t + k2·r); at the optimal split this is
    r + 2s + t + 2√(k·r·t).  Self-join (r=s=t): 4r + 2r√k."""
    if k1 is None or k2 is None:
        k1, k2 = optimal_k1_k2(k, r, t)
    return (r + s + t) + (s + k1 * t + k2 * r)


def cost_cascade(r: float, s: float, t: float, j1: float) -> float:
    """2,3J cost: 2r + 2s + 2t + 2·|R⋈S| — independent of cluster size."""
    return 2 * r + 2 * s + 2 * t + 2 * j1


def cost_cascade_agg(r: float, s: float, t: float, j1: float, a1: float) -> float:
    """2,3JA cost: 2r+2s+2t + 2j1 + 2a1 (paper: 6r + 2r' + 2r'' for self-join)."""
    return 2 * r + 2 * s + 2 * t + 2 * j1 + 2 * a1


def cost_one_round_agg(r: float, s: float, t: float, j3: float, k: int) -> float:
    """1,3JA cost: 1,3J + 2·j3 (paper: 4r + 2r√k + 2r''' for self-join)."""
    return cost_one_round(r, s, t, k) + 2 * j3


def crossover_reducers(r: float, s: float, t: float, j1: float) -> float:
    """k* where 1,3J's cost overtakes 2,3J's (paper Fig. 3).

    Solve r+2s+t+2√(k r t) = 2(r+s+t)+2 j1  ⇒  √k = (r+t+2j1)/(2√(rt)).
    Self-join: k* = (1 + j1/r)² — e.g. Twitter-like j1/r≈259 ⇒ k*≈67.6k.
    """
    num = r + t + 2 * j1
    den = 2 * math.sqrt(r * t)
    root = num / den
    return root * root


# ---------------------------------------------------------------------------
# N-way chain formulas (Shares hypercube vs. cascade)
# ---------------------------------------------------------------------------
#
# Chain of n relations R_1..R_n with sizes r_j; hypercube dims d=1..n−1,
# share k_d on join attribute A_{d+1}.  R_j pins the dims of its own
# join attributes — m_j := ∏ of its pinned shares (m_1=k_1,
# m_j=k_{j−1}k_j, m_n=k_{n−1}) — and is replicated K/m_j times,
# K = ∏ k_d.  One-round communication: read Σ r_j, shuffle Σ r_j·K/m_j.

def _hashed_dims(j: int, n: int) -> Tuple[int, ...]:
    """0-based dims pinned by 0-based relation j in an n-chain."""
    return tuple(d for d in (j - 1, j) if 0 <= d <= n - 2)


def chain_replications(sizes: Sequence[float],
                       shares: Sequence[float]) -> Tuple[float, ...]:
    """Per-relation replication factor K/m_j for explicit shares."""
    n = len(sizes)
    K = math.prod(shares)
    out = []
    for j in range(n):
        m = math.prod(shares[d] for d in _hashed_dims(j, n))
        out.append(K / m)
    return tuple(out)


def cost_chain_one_round(sizes: Sequence[float], k: int,
                         shares: Optional[Sequence[float]] = None) -> float:
    """1,NJ cost: Σ r_j + Σ r_j · K/m_j.  With ``shares`` omitted, the
    optimal (real-valued) share vector is used.  n=3 at the optimum is
    the paper's r + 2s + t + 2√(k·r·t)."""
    if shares is None:
        shares = optimal_shares_chain(sizes, k)
    repl = chain_replications(sizes, shares)
    return sum(sizes) + sum(r * f for r, f in zip(sizes, repl))


def optimal_shares_chain(sizes: Sequence[float], k: int) -> Tuple[float, ...]:
    """Optimal share vector for a chain join — Lagrangean closed form.

    The KKT conditions of  min Σ r_j K/m_j  s.t. ∏ k_d = K  say that for
    every dim d the total communication of the two relations pinning it
    is the same multiplier λ:  t_d + t_{d+1} = λ with t_j = r_j K/m_j.
    Hence t_{j+2} = t_j: the per-relation terms ALTERNATE, t_odd = α,
    t_even = β.  Substituting m_j = r_j K/t_j and eliminating through
    k_1 = m_1, k_d = m_d/k_{d−1} leaves two log-linear closure
    equations — ∏ k_d = K and k_{n−1} = m_n — in (ln α, ln β): a 2×2
    solve.  n=3 recovers k_1 = √(Kr/t), k_2 = √(Kt/r).

    If the interior solution violates k_d ≥ 1 (a share wants to drop
    below one device), it is refined by projected gradient on the
    (convex) problem with the k_d ≥ 1 constraints active.
    """
    n = len(sizes)
    if n < 2:
        raise ValueError("need at least 2 relations")
    if n == 2:
        return (float(max(k, 1)),)   # a plain two-way join: no replication
    if k <= 1:
        return (1.0,) * (n - 1)      # single reducer: nothing to split
    shares = _chain_shares_interior(sizes, k)
    if min(shares) >= 1.0 - 1e-9:
        return tuple(max(s, 1.0) for s in shares)
    return _shares_clamped(sizes, [_hashed_dims(j, n) for j in range(n)],
                           n - 1, k)


def _chain_shares_interior(sizes: Sequence[float], k: int) -> Tuple[float, ...]:
    """Solve the alternation closed form (all shares assumed ≥ 1)."""
    n = len(sizes)
    lnK = math.log(k)
    lnr = [math.log(s) for s in sizes]
    # ln m_j = lnr_j + lnK − (A if j odd else B), 1-based j.
    # ln k_d = Σ_{i≤d} (−1)^{d−i} ln m_i  =  P_d − u_d·A − w_d·B.
    P, U, W = [], [], []
    for d in range(1, n):              # 1-based dims 1..n−1
        p = u = w = 0.0
        for i in range(1, d + 1):
            sign = (-1.0) ** (d - i)
            p += sign * (lnr[i - 1] + lnK)
            if i % 2 == 1:
                u += sign
            else:
                w += sign
        P.append(p)
        U.append(u)
        W.append(w)
    # Closure 1: Σ_d ln k_d = lnK.
    a1, b1 = sum(U), sum(W)
    c1 = sum(P) - lnK
    # Closure 2: ln k_{n−1} = ln m_n = lnr_n + lnK − (A if n odd else B).
    a2, b2 = U[-1], W[-1]
    c2 = P[-1] - (lnr[n - 1] + lnK)
    if n % 2 == 1:
        a2 -= 1.0
    else:
        b2 -= 1.0
    det = a1 * b2 - a2 * b1
    A = (c1 * b2 - c2 * b1) / det
    B = (a1 * c2 - a2 * c1) / det
    return tuple(math.exp(P[d] - U[d] * A - W[d] * B) for d in range(n - 1))


def _shares_projected(sizes: Sequence[float], Dj, dims: int, k: int,
                      iters: int = 4000) -> Tuple[float, ...]:
    """Projected gradient on x_d = ln k_d over the simplex
    {x ≥ 0, Σ x = ln K} — the clamped (boundary) case the closed forms
    cannot express, for an arbitrary incidence ``Dj`` (per-relation
    pinned-dim tuples).  The objective Σ r_j exp(−Σ_{d∈D_j} x_d) is
    convex in x, so this converges to the constrained optimum."""
    import numpy as np
    L = math.log(k)
    r = np.asarray(sizes, np.float64) / max(sizes)
    x = np.full(dims, L / dims)

    def project(y):
        # Euclidean projection onto {x >= 0, sum x = L}.
        u = np.sort(y)[::-1]
        css = np.cumsum(u)
        rho = np.nonzero(u + (L - css) / (np.arange(dims) + 1) > 0)[0][-1]
        theta = (css[rho] - L) / (rho + 1.0)
        return np.maximum(y - theta, 0.0)

    last = math.inf
    for it in range(iters):
        terms = np.array([rj * math.exp(-sum(x[d] for d in D))
                          for rj, D in zip(r, Dj)])
        grad = np.zeros(dims)
        for t_j, D in zip(terms, Dj):
            for d in D:
                grad[d] -= t_j
        step = 0.5 / (np.abs(grad).max() + 1e-12) / math.sqrt(it + 1.0)
        x = project(x - step * grad)
        if it % 50 == 49:
            cost = float(terms.sum())
            if last - cost <= 1e-12 * max(abs(last), 1.0):
                break
            last = cost
    return tuple(math.exp(v) for v in x)


def _shares_clamped(sizes: Sequence[float], rel_dims, dims: int, k: int,
                    ) -> Tuple[float, ...]:
    """Shares optimum with the k_d ≥ 1 constraints potentially active:
    the pairwise Lagrangean alternation (box clamping built into each
    closed-form move) against the projected-gradient refinement as a
    safety net — the cheaper answer wins.  (Plain gradient descent
    descends slowly when the optimum sits on the boundary; the
    alternation lands there directly.)"""
    balanced = _shares_alternation(sizes, rel_dims, dims, k)
    projected = _shares_projected(sizes, rel_dims, dims, k)
    cost_b = cost_query_one_round(rel_dims, sizes, k, shares=balanced)
    cost_p = cost_query_one_round(rel_dims, sizes, k, shares=projected)
    return balanced if cost_b <= cost_p else projected


def integer_shares(sizes: Sequence[float], k: int) -> Tuple[int, ...]:
    """Executable share vector: greedy factor-2 refinement of (1,..,1)
    towards the real-valued optimum, keeping ∏ shares ≤ k.  (Reducer
    grids in practice are powers of two per dim.)"""
    n = len(sizes)
    if n == 2:
        return (max(1, k),)
    shares = [1] * (n - 1)
    while math.prod(shares) * 2 <= k:
        best_d, best_cost = None, None
        for d in range(n - 1):
            trial = list(shares)
            trial[d] *= 2
            c = cost_chain_one_round(sizes, math.prod(trial), shares=trial)
            if best_cost is None or c < best_cost:
                best_d, best_cost = d, c
        shares[best_d] *= 2
    return tuple(shares)


def replication_lower_bound_chain(sizes: Sequence[float], k: int) -> float:
    """Afrati–Ullman lower bound on one-round chain communication at
    cluster size k: the cost at the *real-valued* optimal share vector
    (PAPERS.md, "Optimizing Multiway Joins in a Map-Reduce Environment"
    — the replication rate of any hypercube assignment is bounded below
    by the Lagrangean optimum).  Any executable integer-share plan must
    cost at least this; the static verifier reports the gap
    ``chosen/floor − 1`` per plan and rejects a chosen cost below the
    floor (a cost-model inconsistency)."""
    return cost_chain_one_round(sizes, k)


def replication_lower_bound_query(rel_dims: Sequence[Sequence[int]],
                                  sizes: Sequence[float], k: int) -> float:
    """The general-hypergraph counterpart of
    :func:`replication_lower_bound_chain`: the one-round Shares cost at
    the real-valued optimum of :func:`optimal_shares_query` — the floor
    for any integer-share grid on the same incidence (for the uniform
    triangle this is the classic ``3r + 3r·k^{1/3}``)."""
    return cost_query_one_round(rel_dims, sizes, k)


def cost_chain_cascade(sizes: Sequence[float],
                       prefix_joins: Sequence[float]) -> float:
    """(N−1),NJ cost: Σ_{rounds} 2·(left input + right input), left-deep.
    ``prefix_joins[i]`` = |R_1 ⋈ .. ⋈ R_{i+2}| (the last entry, the full
    join, is output — never charged).  n=3 is 2r+2s+2t+2j1."""
    n = len(sizes)
    cost, left = 0.0, sizes[0]
    for j in range(1, n):
        cost += 2.0 * (left + sizes[j])
        left = prefix_joins[j - 1]
    return cost


def cost_chain_cascade_pushdown(sizes: Sequence[float],
                                prefix_joins: Sequence[float],
                                prefix_aggs: Sequence[float],
                                pushdown_joins: Optional[Sequence[float]] = None,
                                ) -> float:
    """(N−1),NJA cost: each non-final round is followed by a charged
    aggregation that shrinks the next round's left input to the
    aggregated size ``prefix_aggs[j−1]``.  The final aggregator is
    uncharged (the paper's 6r + 2r' + 2r'' convention).

    Because round j ≥ 2 joins the *aggregated* prefix, its output —
    the input shipped to the next aggregator — is |Γ(J_j) ⋈ R_{j+1}|
    (``pushdown_joins[j−2]``), not the raw prefix join |J_{j+1}|;
    only the first round's aggregation reads the raw |J_2|.  N=3 needs
    no ``pushdown_joins`` and reduces to 2r+2s+2t+2j1+2a1."""
    n = len(sizes)
    if n > 3 and pushdown_joins is None:
        raise ValueError("pushdown cascades beyond N=3 need pushdown_joins "
                         "(|Γ(J_j) ⋈ R_{j+1}| sizes)")
    cost, left = 0.0, sizes[0]
    for j in range(1, n):
        cost += 2.0 * (left + sizes[j])
        if j < n - 1:
            agg_in = prefix_joins[0] if j == 1 else pushdown_joins[j - 2]
            cost += 2.0 * agg_in                   # ship round output to Γ
            left = prefix_aggs[j - 1]
    return cost


def cost_chain_one_round_agg(sizes: Sequence[float], k: int,
                             full_join: float,
                             shares: Optional[Sequence[float]] = None) -> float:
    """1,NJA cost: the one-round join + 2·|full join| — the raw result
    must be materialized and shipped to the aggregators."""
    return cost_chain_one_round(sizes, k, shares) + 2.0 * full_join


# ---------------------------------------------------------------------------
# Map-side cascade over co-partitioned storage (MS,NJ)
# ---------------------------------------------------------------------------
#
# When relation j is stored hash-partitioned AND per-partition sorted on
# the hop's join attribute (the proof is a ChainPartitioning
# certificate, built by repro.core.partition.chain_partitioning), the
# cascade's hop j can run entirely map-side on a 1-D grid of P =
# num_partitions devices: the stored partitions ARE the placement, so
# the hop ships zero input tuples; the running intermediate is
# repartitioned at most once per hop (it lands partitioned on the
# *current* key, the next hop hashes the next key).  Small right sides
# can instead broadcast (P·r_j tuples, no repartition of the left), and
# unproven hops fall back to the plain shuffle (left + right).  Reads
# are charged exactly like the plain cascade: every hop reads both
# inputs.

@dataclasses.dataclass(frozen=True)
class ChainPartitioning:
    """Co-partitioning certificate for one chain cascade.

    num_partitions: P — the 1-D grid size the map-side cascade runs on.
    salt:           partition-hash salt every proof shares; the executor
                    repartitions intermediates with the *same* (P, salt)
                    hash so they land where the stored partitions live.
    right_proven:   per hop j=1..N−1, whether relation j is stored
                    partitioned+sorted on that hop's join attribute.
    left0_proven:   whether relation 0 is pre-partitioned on the first
                    join attribute (hop 1 then ships nothing at all).
    key_dtype:      dtype name the proof's key columns were partitioned
                    under (``"int32"``/``"int64"``).  The partition hash
                    folds 64-bit keys before bucketing, so a certificate
                    minted under one x64 configuration is *unsound* under
                    the other — the executor rejects the mismatch instead
                    of silently merge-joining on folded hashes.  ``None``
                    (legacy certificates) skips the check.
    """

    num_partitions: int
    salt: int
    right_proven: Tuple[bool, ...]
    left0_proven: bool = False
    key_dtype: Optional[str] = None


_MODE_RANK = {"mapside": 0, "broadcast": 1, "shuffle": 2}


def chain_mapside_modes(sizes: Sequence[float],
                        prefix_joins: Sequence[float],
                        part: ChainPartitioning,
                        broadcast_threshold: Optional[float] = None,
                        ) -> Tuple[str, ...]:
    """Cheapest physical mode per cascade hop, given the certificate:

    * ``"mapside"``   — right side proven: 0 shuffled tuples when the
      left is already partitioned on the hop key (hop 1 with
      ``left0_proven``), else one |left| repartition;
    * ``"broadcast"`` — replicate the right side to all P devices
      (P·r_j tuples), the left stays in place; considered only below
      ``broadcast_threshold`` when one is given;
    * ``"shuffle"``   — the plain hash-partition hop (left + right).

    Greedy per-hop choice is optimal for chains: consecutive hops join
    on *different* attributes, so no partition state survives a hop
    except relation 0's (consumed by hop 1) — each hop's cheapest mode
    is independent of the others.  Ties prefer map-side, then
    broadcast (fewer shuffle rounds at equal tuples).
    """
    n = len(sizes)
    if len(part.right_proven) != n - 1:
        raise ValueError(f"certificate proves {len(part.right_proven)} hops "
                         f"for an {n}-relation chain")
    P = part.num_partitions
    modes = []
    left, left_on_key = sizes[0], part.left0_proven
    for j in range(1, n):
        opts = {"shuffle": left + sizes[j]}
        if broadcast_threshold is None or sizes[j] <= broadcast_threshold:
            opts["broadcast"] = float(P) * sizes[j]
        if part.right_proven[j - 1]:
            opts["mapside"] = 0.0 if left_on_key else left
        modes.append(min(opts, key=lambda m: (opts[m], _MODE_RANK[m])))
        left, left_on_key = prefix_joins[j - 1], False
    return tuple(modes)


def chain_mapside_shuffles(sizes: Sequence[float],
                           prefix_joins: Sequence[float],
                           part: ChainPartitioning,
                           modes: Sequence[str],
                           place_output: bool = False) -> Tuple[float, ...]:
    """Per-hop shuffled-tuple counts of the map-side cascade — the
    analytic numbers the executor's measured stats must equal exactly
    (zero on proven hops with an already-partitioned left).

    With ``place_output`` the executor repartitions each hop's output
    onto the *next* hop's key right away whenever the next hop is
    proven (the movement is then charged to :func:`chain_mapside_placed`
    instead), so every proven hop's shuffle is exactly zero; the total
    moved tuples are identical either way — placement only re-times the
    single move each intermediate tuple makes."""
    n = len(sizes)
    P = part.num_partitions
    out = []
    left, left_on_key = sizes[0], part.left0_proven
    for j, mode in zip(range(1, n), modes):
        if mode == "mapside":
            out.append(0.0 if left_on_key else left)
        elif mode == "broadcast":
            out.append(float(P) * sizes[j])
        elif mode == "shuffle":
            out.append(left + sizes[j])
        else:
            raise ValueError(f"unknown hop mode {mode!r}")
        left = prefix_joins[j - 1]
        left_on_key = (place_output and j < n - 1
                       and modes[j] == "mapside")
    return tuple(out)


def chain_mapside_placed(sizes: Sequence[float],
                         prefix_joins: Sequence[float],
                         part: ChainPartitioning,
                         modes: Sequence[str]) -> Tuple[float, ...]:
    """Per-hop *placed*-tuple counts under ``place_output``: hop j's
    output (size ``prefix_joins[j-1]``) moves once, at birth, iff the
    next hop is proven map-side — landing already partitioned on the
    next hop's join key.  Shuffled + placed together never move any
    tuple more than once."""
    n = len(sizes)
    del part
    return tuple(
        prefix_joins[j - 1] if (j < n - 1 and modes[j] == "mapside") else 0.0
        for j in range(1, n))


def cost_chain_mapside(sizes: Sequence[float],
                       prefix_joins: Sequence[float],
                       part: ChainPartitioning,
                       modes: Sequence[str]) -> float:
    """MS,NJ cost: every hop reads both inputs (same charge as the
    plain cascade) plus the per-hop shuffles of
    :func:`chain_mapside_shuffles` — which vanish on proven hops, so a
    fully co-partitioned chain costs Σ reads alone and each tuple is
    shuffled at most once across the whole cascade.  ``place_output``
    does not change this total (it only re-attributes each
    intermediate's single move from the consuming hop to the producing
    one), so one cost prices both executor variants."""
    n = len(sizes)
    read, left = 0.0, sizes[0]
    for j in range(1, n):
        read += left + sizes[j]
        left = prefix_joins[j - 1]
    return read + sum(chain_mapside_shuffles(sizes, prefix_joins, part,
                                             modes))


def skew_excess_mapside(stats: "ChainStats", part: ChainPartitioning,
                        modes: Sequence[str]) -> float:
    """Hop excess of the map-side cascade: proven hops hash nothing
    (stored partitions are read in place) except the one left
    repartition, broadcast hops hash nothing at all, and shuffle hops
    pay the cascade's usual both-input excess at k=P."""
    if stats.key_freqs is None:
        return 0.0
    P = part.num_partitions
    total = 0.0
    left_on_key = part.left0_proven
    for d, mode in enumerate(modes):
        entries = stats.key_freqs[d]
        if mode == "shuffle":
            total += hop_excess(stats.sizes[d], P, _sketch_top(entries, 1))
            total += hop_excess(stats.sizes[d + 1], P,
                                _sketch_top(entries, 2))
        elif mode == "mapside" and not left_on_key:
            total += hop_excess(stats.sizes[d], P, _sketch_top(entries, 1))
        left_on_key = False
    return total


# ---------------------------------------------------------------------------
# General hypergraph formulas (Shares over an arbitrary query hypergraph)
# ---------------------------------------------------------------------------
#
# A query hypergraph assigns each *join attribute* (one shared by >= 2
# relations) a hypercube dim with share k_d; relation j pins the dims of
# its own join attributes, D_j.  With m_j := prod_{d in D_j} k_d and
# K = prod k_d, one-round communication is read Σ r_j + shuffle
# Σ r_j · K/m_j — the chain formulas above are the special case where
# D_j = {j−1, j}.  ``rel_dims`` below is the incidence: one tuple of
# pinned dims per relation (``JoinQuery.rel_dims()``).

def _incidence_dims(rel_dims: Sequence[Sequence[int]]) -> int:
    return 1 + max(d for D in rel_dims for d in D) if any(rel_dims) else 0


def query_replications(rel_dims: Sequence[Sequence[int]],
                       shares: Sequence[float]) -> Tuple[float, ...]:
    """Per-relation replication factor K/m_j for explicit shares on an
    arbitrary hypergraph incidence."""
    K = math.prod(shares)
    out = []
    for D in rel_dims:
        m = math.prod(shares[d] for d in D)
        out.append(K / m)
    return tuple(out)


def cost_query_one_round(rel_dims: Sequence[Sequence[int]],
                         sizes: Sequence[float], k: int,
                         shares: Optional[Sequence[float]] = None) -> float:
    """One-round Shares cost on an arbitrary hypergraph: Σ r_j +
    Σ r_j · K/m_j.  With ``shares`` omitted, the optimal share vector
    from :func:`optimal_shares_query` is used.  On a chain incidence
    this equals :func:`cost_chain_one_round`; on the uniform triangle at
    the optimum it is 3r + 3r·k^{1/3}."""
    if shares is None:
        shares = optimal_shares_query(rel_dims, sizes, k)
    repl = query_replications(rel_dims, shares)
    return sum(sizes) + sum(r * f for r, f in zip(sizes, repl))


def cost_query_cascade(ordered_sizes: Sequence[float],
                       intermediates: Sequence[float]) -> float:
    """Cascade cost along one left-deep join order: Σ rounds 2·(left +
    right), with ``intermediates[i]`` the size of the running
    intermediate *after* round i+1 — post-filter, when the round closes
    a cycle (the closing predicate is applied reduce-side, so only the
    filtered tuples are shipped onward).  The last entry is the output,
    never charged.  Identical in form to :func:`cost_chain_cascade`."""
    return cost_chain_cascade(ordered_sizes, intermediates)


def _is_chain_incidence(rel_dims: Sequence[Sequence[int]]) -> bool:
    """True iff the incidence is exactly the chain pattern D_j =
    {j−1, j} ∩ [0, n−2] — the case the closed form solves."""
    n = len(rel_dims)
    if n < 2 or _incidence_dims(rel_dims) != n - 1:
        return False
    return all(tuple(rel_dims[j]) == _hashed_dims(j, n) for j in range(n))


def _shares_alternation(sizes: Sequence[float],
                        rel_dims: Sequence[Sequence[int]], dims: int, k: int,
                        sweeps: int = 400) -> Tuple[float, ...]:
    """Lagrangean alternation for the Shares optimum on an arbitrary
    hypergraph, with the k_d ≥ 1 constraints native.

    The KKT conditions of min Σ r_j K/m_j s.t. ∏ k_d = K say every dim
    carries the same total communication.  The alternation enforces this
    pairwise: moving share mass δ between dims (d1, d2) in log space
    keeps Σ ln k_d fixed, and only relations pinning *exactly one* of
    the two feel it, so the objective restricted to the move is
    ``A·e^{−δ} + B·e^{δ} + C`` (A/B = the traffic pinned by d1/d2
    alone) — minimized in closed form at δ = ½·ln(A/B), clamped to the
    box ``x ≥ 0``.  Every move is exact and the objective convex, with
    the pairwise directions spanning the constraint surface, so cyclic
    sweeps converge to the constrained optimum — boundary (clamped)
    optima included, which is where plain gradient descent stalls.
    Symmetric hypergraphs are exact at the uniform start: the uniform
    triangle keeps ln k/3 per dim, i.e. the classic k^{1/3} shares."""
    L = math.log(k)
    scale = max(sizes)
    r = [s / scale for s in sizes]
    x = [L / dims] * dims
    for _ in range(sweeps):
        moved = 0.0
        for d1 in range(dims):
            for d2 in range(d1 + 1, dims):
                A = B = 0.0
                for rj, D in zip(r, rel_dims):
                    in1, in2 = d1 in D, d2 in D
                    if in1 == in2:
                        continue     # pins both or neither: e^{−δ}·e^{δ} = 1
                    t = rj * math.exp(-sum(x[d] for d in D))
                    if in1:
                        A += t
                    else:
                        B += t
                if A <= 0.0 and B <= 0.0:
                    continue
                if B <= 0.0:
                    delta = x[d2]          # all pressure on d1: push to the box
                elif A <= 0.0:
                    delta = -x[d1]
                else:
                    delta = 0.5 * math.log(A / B)
                delta = min(max(delta, -x[d1]), x[d2])
                if delta != 0.0:
                    x[d1] += delta
                    x[d2] -= delta
                    moved = max(moved, abs(delta))
        if moved <= 1e-14:
            break
    return tuple(math.exp(v) for v in x)


def optimal_shares_query(rel_dims: Sequence[Sequence[int]],
                         sizes: Sequence[float], k: int) -> Tuple[float, ...]:
    """Optimal (real-valued) share vector for an arbitrary query
    hypergraph — the Afrati–Ullman Shares optimum.

    Chain incidences delegate to :func:`optimal_shares_chain`
    (bit-for-bit: same closed form, same clamping path).  Otherwise the
    pairwise Lagrangean alternation (:func:`_shares_alternation`) does
    the work — exact at the uniform start for symmetric hypergraphs
    (the uniform triangle gets k^{1/3} per attribute), with the
    k_d ≥ 1 box built into every move — and the projected-gradient
    refinement stands by as a safety net (:func:`_shares_clamped`)."""
    rel_dims = tuple(tuple(D) for D in rel_dims)
    if len(rel_dims) != len(sizes):
        raise ValueError(f"{len(sizes)} sizes for {len(rel_dims)} relations")
    dims = _incidence_dims(rel_dims)
    if dims == 0:
        raise ValueError("query has no join attributes (cross product)")
    if dims == 1:
        return (float(max(k, 1)),)   # one shared attribute: hash, no replication
    if k <= 1:
        return (1.0,) * dims         # single reducer: nothing to split
    if _is_chain_incidence(rel_dims):
        return optimal_shares_chain(sizes, k)
    return _shares_clamped(sizes, rel_dims, dims, k)


def integer_shares_query(rel_dims: Sequence[Sequence[int]],
                         sizes: Sequence[float], k: int) -> Tuple[int, ...]:
    """Executable share vector for an arbitrary hypergraph: greedy
    factor-2 refinement of (1,..,1) towards the optimum, keeping
    ∏ shares ≤ k — the general counterpart of :func:`integer_shares`
    (identical choices on chain incidences)."""
    rel_dims = tuple(tuple(D) for D in rel_dims)
    dims = _incidence_dims(rel_dims)
    if dims == 0:
        raise ValueError("query has no join attributes (cross product)")
    if dims == 1:
        return (max(1, k),)
    shares = [1] * dims
    while math.prod(shares) * 2 <= k:
        best_d, best_cost = None, None
        for d in range(dims):
            trial = list(shares)
            trial[d] *= 2
            c = cost_query_one_round(rel_dims, sizes, math.prod(trial),
                                     shares=trial)
            if best_cost is None or c < best_cost:
                best_d, best_cost = d, c
        shares[best_d] *= 2
    return tuple(shares)


@dataclasses.dataclass(frozen=True)
class QueryStats:
    """Cardinality statistics for a general join query.

    sizes:         per-relation tuple counts (query order).
    orders:        candidate connected left-deep join orders (tuples of
                   relation indices).
    intermediates: per order, the running intermediate sizes after each
                   round — *post-filter* at cycle-closing hops; the
                   last entry is the full output (never charged).
    hop_joins:     per order, the raw per-hop local-join sizes *before*
                   cycle-closing filters — what sizes the executor's
                   join buffers (equals ``intermediates`` on acyclic
                   hops).
    agg_groups:    |Γ(result)| for the query's aggregate, if any.
    chain:         the :class:`ChainStats` view when the query is a
                   chain — lets the planner delegate to the chain
                   machinery (pushdown pricing, SharesSkew) unchanged.
    """
    sizes: Tuple[float, ...]
    orders: Tuple[Tuple[int, ...], ...]
    intermediates: Tuple[Tuple[float, ...], ...]
    hop_joins: Tuple[Tuple[float, ...], ...]
    agg_groups: Optional[float] = None
    chain: Optional["ChainStats"] = None

    def __post_init__(self):
        if not (len(self.orders) == len(self.intermediates)
                == len(self.hop_joins)) or not self.orders:
            raise ValueError("need parallel, non-empty orders/intermediates/"
                             "hop_joins")

    @property
    def n_relations(self) -> int:
        return len(self.sizes)

    @property
    def full_output(self) -> float:
        """Size of the query result (same along every order)."""
        return self.intermediates[0][-1]

    def best_order(self) -> Tuple[Tuple[int, ...], float]:
        """The cheapest cascade order and its cost."""
        best, best_cost = None, math.inf
        for order, inter in zip(self.orders, self.intermediates):
            c = cost_query_cascade([self.sizes[i] for i in order], inter)
            if c < best_cost:
                best, best_cost = order, c
        return best, best_cost


# ---------------------------------------------------------------------------
# Skew: balance threshold, hop peak loads, and the SharesSkew cost
# ---------------------------------------------------------------------------
#
# The Shares communication charge Σ r_j·K/m_j is skew-blind: hashing
# sends every tuple with join-attribute value v to the same slice of
# the hypercube, so a heavy v turns one reducer slice into a straggler
# without changing the tuple count.  Following SharesSkew (Afrati,
# Stasinopoulos, Ullman, Vassilakopoulos), each relation is split into
# a heavy part (tuples whose join-attribute value exceeds the balance
# threshold) and a residual part, and one Shares sub-join runs per
# heavy/residual combination: the combination's grid is the plain
# integer-share hypercube with every heavy dim clamped to share 1 —
# a (near-)constant attribute gains nothing from hashing, so the heavy
# tuples are broadcast on their clamped dimension instead.

def balance_threshold(size: float, share: float, slack: float = 1.25) -> float:
    """Frequency above which one key overloads its reducer slice: a key
    hashed into ``share`` buckets is heavy when its frequency exceeds
    ``slack`` times the mean bucket load ``size/share``.  At share 1 the
    dim is not split, so no key can be heavy (threshold ≥ size)."""
    if share <= 1.0:
        return float("inf")
    return slack * size / share


def hop_peak_load(size: float, k: float, f_top: float) -> float:
    """First-order peak bucket load of one map-phase hash hop: the top
    key's f tuples collide in one bucket, the rest spread evenly —
    ``f_top + (size − f_top)/k``.  This is the analytic counterpart of
    the measured ``stats["max_bucket_load"]``."""
    if k <= 1.0:
        return size
    return f_top + (size - f_top) / k


def hop_excess(size: float, k: float, f_top: float) -> float:
    """Excess of the hop's peak bucket over the balanced mean ``size/k``:
    ``f_top·(1 − 1/k)``.  Zero when the dim is unsplit."""
    if k <= 1.0 or f_top <= 0.0:
        return 0.0
    return max(0.0, hop_peak_load(size, k, f_top) - size / k)


def skew_clamped_shape(base_shape: Sequence[int],
                       heavy_dims: Sequence[bool]) -> Tuple[int, ...]:
    """Grid of one SharesSkew combination: the plain integer-share grid
    with heavy dims clamped to share 1 (heavy tuples broadcast there)."""
    return tuple(1 if h else s for s, h in zip(base_shape, heavy_dims))


def cost_shares_skew_combo(sizes: Sequence[float],
                           shape: Sequence[int]) -> float:
    """Read + shuffle of one combination's Shares sub-join on its
    clamped grid: Σ r_j^c + Σ r_j^c · K_c/m_j^c."""
    repl = chain_replications(sizes, shape)
    return sum(sizes) + sum(r * f for r, f in zip(sizes, repl))


def cost_chain_shares_skew(combos: Sequence[Tuple[Sequence[float],
                                                  Sequence[int]]]) -> float:
    """1,NJS cost: Σ over heavy/residual combinations of the sub-join
    cost on the combination's clamped grid.  ``combos`` is a sequence of
    (per-relation sizes, grid shape) pairs — exact when the sizes come
    from :func:`repro.core.skew.detect_chain_skew`, estimated when they
    come from the planner's top-k sketch.  Each combination is a
    separate round, so reads are charged per combination (a relation
    that pins only clamped dims is read by every combination that keeps
    its tuples)."""
    return sum(cost_shares_skew_combo(sizes, shape)
               for sizes, shape in combos)


@dataclasses.dataclass(frozen=True)
class ChainStats:
    """Cardinality statistics for an N-way chain.

    sizes:          (r_1, .., r_N).
    prefix_joins:   (|J_2|, .., |J_N|) — left-deep prefix join sizes;
                    the last entry is the full join (the paper's r''').
    prefix_aggs:    (|Γ(J_2)|, .., |Γ(J_{N−1})|) — aggregated
                    intermediate sizes; needed only for aggregated plans.
    pushdown_joins: (|Γ(J_2) ⋈ R_3|, .., |Γ(J_{N−1}) ⋈ R_N|) — round
                    outputs of the pushdown cascade beyond round 1;
                    needed for aggregated plans with N > 3.
    key_freqs:      optional top-k key-frequency sketch, one tuple per
                    join attribute (hypercube dim) d = 0..N−2.  Each
                    entry is ``(key, f_left, f_right)``: the key's
                    frequency in the left-adjacent relation R_{d+1}
                    (where the attribute is its *right* column) and in
                    the right-adjacent relation R_{d+2} (its *left*
                    column), sorted by combined frequency, descending.
                    Produced by :func:`repro.core.skew.chain_key_sketch`;
                    this is what lets the planner price skew.
    """
    sizes: Tuple[float, ...]
    prefix_joins: Tuple[float, ...]
    prefix_aggs: Optional[Tuple[float, ...]] = None
    pushdown_joins: Optional[Tuple[float, ...]] = None
    key_freqs: Optional[Tuple[Tuple[Tuple[int, float, float], ...], ...]] = None

    def __post_init__(self):
        if self.key_freqs is not None and \
                len(self.key_freqs) != len(self.sizes) - 1:
            raise ValueError(
                f"key_freqs needs one entry per join attribute "
                f"({len(self.sizes) - 1}), got {len(self.key_freqs)}")

    @property
    def n_relations(self) -> int:
        return len(self.sizes)

    def costs(self, k: int, aggregate: bool,
              shares: Optional[Sequence[float]] = None) -> Dict[str, float]:
        """All candidate plan costs, keyed by paper-style names:
        1,NJ[A] (one round on K=k reducers) and N−1,NJ[A] (cascade)."""
        n = self.n_relations
        out = {
            f"1,{n}J": cost_chain_one_round(self.sizes, k, shares),
            f"{n - 1},{n}J": cost_chain_cascade(self.sizes, self.prefix_joins),
        }
        if aggregate:
            if self.prefix_aggs is None or any(
                    math.isnan(v) for v in self.prefix_joins):
                raise ValueError("aggregated planning needs a1 and j3 "
                                 "estimates (prefix_aggs and the full-join "
                                 "size)")
            out[f"{n - 1},{n}JA"] = cost_chain_cascade_pushdown(
                self.sizes, self.prefix_joins, self.prefix_aggs,
                self.pushdown_joins)
            out[f"1,{n}JA"] = cost_chain_one_round_agg(
                self.sizes, k, self.prefix_joins[-1], shares)
        return out


# ---------------------------------------------------------------------------
# Sketch-based skew estimates (planner inputs; exact counterparts live in
# repro.core.skew, which works from the data instead of the sketch)
# ---------------------------------------------------------------------------

def sketch_heavy_entries(stats: "ChainStats", base_shape: Sequence[int],
                         slack: float = 1.25,
                         ) -> Tuple[Tuple[Tuple[int, float, float], ...], ...]:
    """Filter the top-k sketch down to the entries above the balance
    threshold of the plain Shares grid ``base_shape``: key heavy on dim
    d iff its frequency exceeds ``balance_threshold`` in either adjacent
    relation.  Empty tuples everywhere ⇒ the workload looks uniform and
    the skew path should not be considered."""
    if stats.key_freqs is None:
        return tuple(() for _ in base_shape)
    out = []
    for d, entries in enumerate(stats.key_freqs):
        thr_l = balance_threshold(stats.sizes[d], base_shape[d], slack)
        thr_r = balance_threshold(stats.sizes[d + 1], base_shape[d], slack)
        out.append(tuple(e for e in entries
                         if e[1] > thr_l or e[2] > thr_r))
    return tuple(out)


def _sketch_top(entries, side: int) -> float:
    """Top frequency on one side (1=left-adjacent rel, 2=right) of a
    sketch dim; 0.0 when the sketch has no entries."""
    return max((e[side] for e in entries), default=0.0)


def _heavy_fraction(stats: "ChainStats", heavy, j: int, d: int) -> float:
    """Fraction of relation j's tuples whose dim-d attribute is heavy."""
    side = 1 if j == d else 2          # rel d holds the attr on its right
    mass = sum(e[side] for e in heavy[d])
    return min(1.0, mass / max(stats.sizes[j], 1.0))


def estimate_skew_combos(stats: "ChainStats", base_shape: Sequence[int],
                         heavy,
                         ) -> Tuple[Tuple[Tuple[float, ...], Tuple[int, ...]], ...]:
    """Estimated (sizes, grid shape) of every SharesSkew combination,
    from the sketch's heavy masses under an independence assumption:
    r_j^c = r_j · ∏_{d pinned by j} (h_{j,d} if c_d heavy else 1−h_{j,d}).
    Combinations whose heavy set is empty are skipped."""
    n = len(stats.sizes)
    active = [d for d in range(n - 1) if heavy[d]]
    combos = []
    for bits in range(1 << len(active)):
        heavy_dims = [False] * (n - 1)
        for i, d in enumerate(active):
            heavy_dims[d] = bool(bits >> i & 1)
        sizes = []
        for j in range(n):
            r = stats.sizes[j]
            for d in _hashed_dims(j, n):
                h = _heavy_fraction(stats, heavy, j, d)
                r *= h if heavy_dims[d] else 1.0 - h
            sizes.append(r)
        if min(sizes) <= 0.0:
            continue
        combos.append((tuple(sizes),
                       skew_clamped_shape(base_shape, heavy_dims)))
    return tuple(combos)


def skew_excess_one_round(stats: "ChainStats", base_shape: Sequence[int],
                          heavy=None) -> float:
    """Σ over map-phase hops of the peak-over-mean excess of the plain
    Shares join (relation j hashes dim d with f_top = its top sketch
    frequency).  With ``heavy`` given, the excess of the SharesSkew
    *residual* combination instead: heavy keys are split out, so each
    hop's top frequency is the largest NON-heavy sketch entry — the
    first-order model of why the skew path balances."""
    if stats.key_freqs is None:
        return 0.0
    n = len(stats.sizes)
    total = 0.0
    for d in range(n - 1):
        entries = stats.key_freqs[d]
        if heavy is not None:
            dropped = {e[0] for e in heavy[d]}
            entries = tuple(e for e in entries if e[0] not in dropped)
        for j in (d, d + 1):           # the two relations hashing dim d
            side = 1 if j == d else 2
            total += hop_excess(stats.sizes[j], base_shape[d],
                                _sketch_top(entries, side))
    return total


def skew_excess_cascade(stats: "ChainStats", k: int) -> float:
    """Hop excess of the cascade: round j hashes join attribute d=j−1
    into all k reducers, on both inputs.  The left input of rounds ≥ 2
    is an intermediate whose key frequencies are unknown; its base-
    relation frequency is the first-order proxy."""
    if stats.key_freqs is None:
        return 0.0
    n = len(stats.sizes)
    total = 0.0
    for d in range(n - 1):
        entries = stats.key_freqs[d]
        total += hop_excess(stats.sizes[d], k, _sketch_top(entries, 1))
        total += hop_excess(stats.sizes[d + 1], k, _sketch_top(entries, 2))
    return total


# ---------------------------------------------------------------------------
# Overlapped hop time model (the roofline of the chunked shuffle)
# ---------------------------------------------------------------------------
#
# A staged hop serializes its all-to-all and its local join:
# ``t_sh + t_cp``.  The overlapped schedule (``overlap_chunks = C``)
# splits the shuffled side into C row blocks whose collectives carry no
# dependency on the previous block's join, so after the first block's
# shuffle lands, every later block's transfer hides under compute (or
# vice versa when communication dominates): the steady state runs at
# ``max(t_sh, t_cp)/C`` per block.  These formulas are the analytic
# side of benchmarks/roofline.py's measured gate.

def hop_time_staged(t_shuffle: float, t_compute: float) -> float:
    """Wall-clock of one staged hop: shuffle then join, serialized."""
    return t_shuffle + t_compute


def hop_time_overlapped(t_shuffle: float, t_compute: float,
                        chunks: int) -> float:
    """Wall-clock of one overlapped hop with ``chunks`` row blocks:
    one block's pipeline fill (``(t_sh + t_cp)/C``) plus C−1 steady
    blocks at the longer phase's rate.  ``chunks=1`` degenerates to the
    staged time exactly."""
    C = max(1, int(chunks))
    return (t_shuffle + t_compute) / C \
        + max(t_shuffle, t_compute) * (C - 1) / C


def overlap_hidden_fraction(t_staged: float, t_overlapped: float,
                            t_shuffle: float) -> float:
    """Fraction of the shuffle wall-clock the overlap hid:
    ``(t_staged − t_overlapped) / t_shuffle``.  1.0 means the whole
    shuffle disappeared behind compute (the compute-bound ideal
    ``C→∞`` limit when ``t_cp ≥ t_sh``); the roofline gate requires
    ≥ 0.3 on the 16-device emulated mesh."""
    if t_shuffle <= 0:
        return 0.0
    return (t_staged - t_overlapped) / t_shuffle


def relation_row_bytes(rel) -> int:
    """Bytes one materialized row of a relation carries: the sum of
    its column itemsizes plus the validity byte — the unit converting
    the paper's tuple accounting into the roofline's bytes-moved
    accounting."""
    return sum(int(c.dtype.itemsize) for c in rel.cols.values()) + 1


# ---------------------------------------------------------------------------
# Statistics + planner inputs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JoinStats:
    """Cardinality statistics driving algorithm choice."""
    r: float
    s: float
    t: float
    j1: float            # |R ⋈ S|
    a1: Optional[float] = None   # |Γ_{a,c}(R ⋈ S)|      (aggregated runs)
    j3: Optional[float] = None   # |R ⋈ S ⋈ T|           (aggregated runs)

    def costs(self, k: int, aggregate: bool) -> Dict[str, float]:
        out = {
            "1,3J": cost_one_round(self.r, self.s, self.t, k),
            "2,3J": cost_cascade(self.r, self.s, self.t, self.j1),
        }
        if aggregate:
            if self.a1 is None or self.j3 is None:
                raise ValueError("aggregated planning needs a1 and j3 estimates")
            out["2,3JA"] = cost_cascade_agg(self.r, self.s, self.t, self.j1, self.a1)
            out["1,3JA"] = cost_one_round_agg(self.r, self.s, self.t, self.j3, k)
        return out


def estimate_join_size(keys_build, keys_probe) -> float:
    """Exact |R ⋈ S| from key multiplicity histograms:
    Σ_b count_R(b) · count_S(b).  O(n log n), no materialization — this
    is how the framework sizes capacities and plans without running the
    join (cf. the paper's observation that |R⋈S| 'cannot be known
    before we compute it'; it CAN be counted cheaply, which we exploit)."""
    import numpy as np
    bu, bc = np.unique(np.asarray(keys_build), return_counts=True)
    pu, pc = np.unique(np.asarray(keys_probe), return_counts=True)
    common, bi, pi = np.intersect1d(bu, pu, return_indices=True)
    return float(np.sum(bc[bi].astype(np.float64) * pc[pi].astype(np.float64)))
