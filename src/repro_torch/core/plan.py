"""Logical plan IR: join queries as data, not as hand-written algorithms.

Port: a copy of ``src/repro/core/plan.py`` (pure Python); ``Relation`` is
the port's own.

The general object is a :class:`JoinQuery` — a *query hypergraph* in the
Afrati–Ullman Shares sense: a universe of attributes, one hyperedge
(attribute tuple) per relation, optional per-relation value columns, and
an optional sum-of-products aggregate.  Cycles (triangles), stars, and
cliques are all expressible; the executor lowers any connected query to
either the one-round Shares join on a hypercube with one dimension per
*shared attribute*, or a left-deep cascade of two-way joins in which
cycle-closing predicates become post-join filters at the closing hop.

The paper's R(A,B) ⋈ S(B,C) ⋈ T(C,D) is the N=3 instance of the *chain
query* special case

    R_1(A_1, A_2) ⋈ R_2(A_2, A_3) ⋈ ... ⋈ R_N(A_N, A_{N+1})

optionally followed by the endpoint aggregation

    Γ_{A_1, A_{N+1}; SUM prod(values)}          (join-defined matmul chain)

:class:`ChainQuery` is now a thin, validated constructor for that
special case — a `JoinQuery` whose hyperedges form a path.  Repeating an
attribute across hyperedges is what closes a cycle: ``JoinQuery.cycle(3)``
is the triangle query R(a,b) ⋈ S(b,c) ⋈ T(c,a), the workload that the
chain IR could only fake by enumerating the full 3-chain and filtering
``a == d`` afterwards.

``core.executor`` lowers a query to the one-round Shares join
(:func:`~repro.core.executor.one_round_query`) or the cascade
(:func:`~repro.core.executor.cascade_query`); ``core.planner`` picks
between them by analytic cost (:func:`~repro.core.planner.plan_query`,
with :func:`~repro.core.planner.plan_chain` the chain special case).
Adding a new workload — chain, cycle, or star — is writing a query, not
an algorithm.
"""

from __future__ import annotations

import dataclasses
import string
from typing import Optional, Sequence, Tuple

from .relation import Relation


@dataclasses.dataclass(frozen=True)
class QueryAggregate:
    """Γ_{keys; SUM prod(value columns)} over the join result.

    The aggregation semantics: group the joined tuples by ``keys`` and,
    within each group, SUM the product of every relation's value column
    — for the paper's three-way query this is matrix-chain
    multiplication expressed as a join (``out[a, d] = Σ_{b,c}
    v(a,b)·w(b,c)·x(c,d)``); for the triangle query with ``keys=(a,)``
    it is the diagonal of A³ (per-node closed-walk counts).

    Attributes:
      keys: the grouping attributes (at least one, all in the query's
            attribute universe).  For a :class:`ChainQuery` they must be
            the chain's endpoint attributes ``(A_1, A_{N+1})`` — the
            configuration under which SUM-of-products commutes with the
            remaining joins, which is what makes aggregation pushdown
            sound (paper §V); general queries run the aggregation once,
            after the join, so any key subset is legal.
      out:  name of the produced value column (default ``"p"``).  The
            result relation has columns ``(*keys, out)``.
    """

    keys: Tuple[str, ...]
    out: str = "p"


#: The chain IR's historical name for the endpoint aggregate.  Chain
#: queries validate that its keys are the chain endpoints; structurally
#: it is the same object.
ChainAggregate = QueryAggregate


@dataclasses.dataclass(frozen=True)
class JoinQuery:
    """A natural join over an arbitrary query hypergraph.

    The query *is* the workload: hand it with ``n_relations`` physical
    :class:`~repro_torch.core.relation.Relation` inputs to
    ``core.executor.execute_query`` (or let ``core.planner.plan_query``
    pick the strategy first).  ``JoinQuery.triangle()`` is the cyclic
    R(a,b) ⋈ S(b,c) ⋈ T(c,a); ``JoinQuery.star(n)`` the hub-and-leaves
    query; ``JoinQuery.chain(n)`` the canonical chain (also available
    with chain-specific validation as :class:`ChainQuery`).

    Attributes:
      attrs:     the attribute universe, ordered.  *Join attributes* —
                 those shared by ≥ 2 relations — each get one Shares
                 hypercube dimension, in ``attrs`` order.
      relations: one attribute tuple (hyperedge) per relation; each
                 attribute must come from the universe, appear at most
                 once per relation, and the hypergraph must be
                 connected (a disconnected query is a cross product the
                 engine does not model).
      values:    per-relation value column name, or ``None`` for a
                 key-only relation.  Value columns ride along through
                 every join; aggregated queries need a value on every
                 relation (the aggregate multiplies them), and all
                 names — attrs and values together — must be distinct.
      aggregate: optional :class:`QueryAggregate`; ``None`` means plain
                 enumeration (the join result itself).

    Derived shape helpers: ``n_relations``, ``join_attrs`` (the shared
    attributes, one Shares hypercube dim each), ``n_dims``,
    ``schema(j)`` (relation j's column names), ``hashed_dims(j)`` /
    ``dim_attr(d)`` (which hypercube dims a relation pins and which
    attribute a dim hashes), ``rel_dims()`` (the full incidence, the
    cost model's input), ``default_join_order()`` (a connected
    left-deep order), ``chain_attr_order()`` (the chain's attribute
    path when the hypergraph is one, else ``None``), and
    ``check_relations`` to validate physical inputs.
    """

    attrs: Tuple[str, ...]
    relations: Tuple[Tuple[str, ...], ...]
    values: Tuple[Optional[str], ...]
    aggregate: Optional[QueryAggregate] = None

    def __post_init__(self):
        object.__setattr__(self, "attrs", tuple(self.attrs))
        object.__setattr__(self, "relations",
                           tuple(tuple(r) for r in self.relations))
        object.__setattr__(self, "values", tuple(self.values))
        if len(self.relations) < 2:
            raise ValueError("a join query needs >= 2 relations")
        if len(self.values) != len(self.relations):
            raise ValueError(
                f"{len(self.relations)} relations need "
                f"{len(self.relations)} value entries, got {len(self.values)}")
        universe = set(self.attrs)
        covered = set()
        for i, rel in enumerate(self.relations):
            if not rel:
                raise ValueError(f"relation {i} has no attributes")
            if len(set(rel)) != len(rel):
                raise ValueError(f"relation {i} repeats an attribute: {rel}")
            unknown = sorted(set(rel) - universe)
            if unknown:
                raise ValueError(f"relation {i} uses attributes {unknown} "
                                 f"outside the universe {self.attrs}")
            covered |= set(rel)
        if covered != universe:
            raise ValueError(f"attributes {sorted(universe - covered)} "
                             f"appear in no relation")
        named = list(self.attrs) + [v for v in self.values if v]
        if len(set(named)) != len(named):
            raise ValueError(f"attribute/value names must be distinct: {named}")
        reserved = [n for n in named if n.startswith("_cc_")]
        if reserved:
            raise ValueError(f"names {reserved} use the reserved '_cc_' "
                             f"prefix (cycle-closing rename scratch)")
        # Connectivity: the executor's left-deep orders need every
        # relation reachable through shared attributes.
        try:
            self.default_join_order()
        except ValueError as e:
            raise ValueError(f"query hypergraph must be connected: {e}")
        if self.aggregate is not None:
            if any(v is None for v in self.values):
                raise ValueError("aggregated queries need a value column on "
                                 "every relation")
            keys = tuple(self.aggregate.keys)
            if not keys:
                raise ValueError("an aggregate needs at least one group key")
            if len(set(keys)) != len(keys) or set(keys) - universe:
                raise ValueError(f"aggregate keys {keys} must be distinct "
                                 f"attributes of the query")
            if self.aggregate.out in named:
                raise ValueError(
                    f"aggregation output column {self.aggregate.out!r} "
                    f"collides with an attribute/value name")

    # -- shape ------------------------------------------------------------
    @property
    def n_relations(self) -> int:
        return len(self.relations)

    @property
    def join_attrs(self) -> Tuple[str, ...]:
        """Attributes shared by ≥ 2 relations — one hypercube dim each,
        in ``attrs`` order.  (For a chain: the N−1 interior attributes;
        for the triangle: all three; for a star: the hub alone.)"""
        return tuple(a for a in self.attrs
                     if sum(a in rel for rel in self.relations) >= 2)

    @property
    def n_dims(self) -> int:
        """Rank of the Shares hypercube this query joins on."""
        return len(self.join_attrs)

    def schema(self, j: int) -> Tuple[str, ...]:
        """Column names of relation j (0-based)."""
        cols = list(self.relations[j])
        if self.values[j] is not None:
            cols.append(self.values[j])
        return tuple(cols)

    def hashed_dims(self, j: int) -> Tuple[int, ...]:
        """Hypercube dims relation j hashes (Shares): the dims of its
        own join attributes, ascending.  Remaining dims are broadcast
        (replication)."""
        dim_of = {a: d for d, a in enumerate(self.join_attrs)}
        return tuple(sorted(dim_of[a] for a in self.relations[j]
                            if a in dim_of))

    def dim_attr(self, d: int) -> str:
        """The join attribute hashed along hypercube dim d."""
        return self.join_attrs[d]

    def rel_dims(self) -> Tuple[Tuple[int, ...], ...]:
        """Per-relation pinned-dim tuples — the hypergraph incidence the
        cost model's general Shares solver consumes."""
        return tuple(self.hashed_dims(j) for j in range(self.n_relations))

    # -- join orders -------------------------------------------------------
    def default_join_order(self) -> Tuple[int, ...]:
        """A connected left-deep order: start at relation 0, repeatedly
        append the lowest-index unused relation sharing an attribute
        with the accumulated set.  For chains this is ``0, 1, .., N−1``."""
        order = [0]
        seen = set(self.relations[0])
        remaining = set(range(1, len(self.relations)))
        while remaining:
            nxt = next((j for j in sorted(remaining)
                        if seen & set(self.relations[j])), None)
            if nxt is None:
                raise ValueError(f"relations {sorted(remaining)} share no "
                                 f"attribute with {order}")
            order.append(nxt)
            seen |= set(self.relations[nxt])
            remaining.discard(nxt)
        return tuple(order)

    def join_steps(self, order: Optional[Sequence[int]] = None):
        """Left-deep reduce-side plan along ``order`` (default: the
        greedy connected order): one ``(relation index, equi-join
        attribute, cycle-closing extras)`` triple per hop.  The equi-join
        attribute is the first shared one in the relation's attribute
        order; the remaining shared attributes are the cycle-closing
        equalities the executor applies as post-join filters — and the
        static verifier checks are *present* at the closing hop.  This
        is the executor's lowering plan, exposed for introspection."""
        order = tuple(order) if order is not None \
            else self.default_join_order()
        if sorted(order) != list(range(self.n_relations)):
            raise ValueError(f"join order {order} is not a permutation of "
                             f"the {self.n_relations} relations")
        acc = set(self.relations[order[0]])
        steps = []
        for j in order[1:]:
            shared = [a for a in self.relations[j] if a in acc]
            if not shared:
                raise ValueError(f"join order {order} disconnects at "
                                 f"relation {j}")
            steps.append((j, shared[0], tuple(shared[1:])))
            acc |= set(self.relations[j])
        return steps

    def chain_attr_order(self) -> Optional[Tuple[str, ...]]:
        """If the hypergraph is a chain *in relation order* — binary
        relations, consecutive ones sharing exactly one attribute, no
        other sharing — return the attribute path ``A_1..A_{N+1}``;
        else ``None``.  Used by the planner/solver to delegate to the
        chain closed forms (bit-for-bit with `optimal_shares_chain`)."""
        n = self.n_relations
        if any(len(r) != 2 for r in self.relations):
            return None
        if len(self.attrs) != n + 1:
            return None
        shared = []
        for j in range(n - 1):
            s = set(self.relations[j]) & set(self.relations[j + 1])
            if len(s) != 1:
                return None
            shared.append(next(iter(s)))
        path = []
        first = [a for a in self.relations[0] if a != shared[0]]
        if len(first) != 1:
            return None
        path.append(first[0])
        path.extend(shared)
        last = [a for a in self.relations[-1] if a != shared[-1]]
        if len(last) != 1:
            return None
        path.append(last[0])
        if len(set(path)) != len(path):
            return None            # an attribute repeats: a cycle, not a chain
        for j in range(n):
            if tuple(self.relations[j]) != (path[j], path[j + 1]):
                return None
        # The solver's dims are join_attrs in `attrs` order; the chain
        # closed form indexes dims in path order — they must agree.
        if self.join_attrs != tuple(path[1:-1]):
            return None
        return tuple(path)

    # -- validation against physical inputs -------------------------------
    def check_relations(self, rels: Sequence[Relation]) -> None:
        if len(rels) != self.n_relations:
            raise ValueError(f"query has {self.n_relations} relations, "
                             f"got {len(rels)}")
        for j, rel in enumerate(rels):
            missing = sorted(set(self.schema(j)) - set(rel.names))
            if missing:
                raise ValueError(f"relation {j} is missing columns {missing}; "
                                 f"has {rel.names}")

    # -- constructors ------------------------------------------------------
    @staticmethod
    def _chain_parts(n: int):
        if n + 1 > len(string.ascii_lowercase):
            raise ValueError(f"chain too long: {n}")
        attrs = tuple(string.ascii_lowercase[: n + 1])
        rels = tuple((attrs[j], attrs[j + 1]) for j in range(n))
        values = tuple(f"v{j}" for j in range(n))
        return attrs, rels, values

    @classmethod
    def chain(cls, n: int, *, aggregate: bool = False) -> "JoinQuery":
        """Canonical N-way chain as a general JoinQuery (see
        :class:`ChainQuery` for the chain-validated constructor)."""
        attrs, rels, values = cls._chain_parts(n)
        agg = QueryAggregate(keys=(attrs[0], attrs[-1])) if aggregate else None
        return JoinQuery(attrs=attrs, relations=rels, values=values,
                         aggregate=agg)

    @classmethod
    def cycle(cls, n: int, *, aggregate: bool = False) -> "JoinQuery":
        """N-cycle: R_j(a_j, a_{j+1 mod n}) — every attribute is shared,
        so the Shares hypercube has rank n.  ``cycle(3)`` is the
        triangle query; its enumeration result lists every directed
        n-cycle once per rotation (count/n = the cycle count).  With
        ``aggregate=True`` the result is Γ_{a_1; SUM ∏ values} — for
        0/1 edge values, the per-node closed-walk counts (the diagonal
        of Aⁿ)."""
        if n < 3:
            raise ValueError(f"a cycle needs >= 3 relations, got {n}")
        if n > len(string.ascii_lowercase):
            raise ValueError(f"cycle too long: {n}")
        attrs = tuple(string.ascii_lowercase[:n])
        rels = tuple((attrs[j], attrs[(j + 1) % n]) for j in range(n))
        values = tuple(f"v{j}" for j in range(n))
        agg = QueryAggregate(keys=(attrs[0],)) if aggregate else None
        return JoinQuery(attrs=attrs, relations=rels, values=values,
                         aggregate=agg)

    @classmethod
    def triangle(cls, *, aggregate: bool = False) -> "JoinQuery":
        """The triangle query R(a,b) ⋈ S(b,c) ⋈ T(c,a) — ``cycle(3)``.
        Feeding the same edge list to all three relations enumerates
        directed 3-cycles; tuple count / 3 equals
        ``matmul.oracle_triangles``."""
        return cls.cycle(3, aggregate=aggregate)

    @classmethod
    def star(cls, n: int, *, aggregate: bool = False) -> "JoinQuery":
        """Star query: n relations R_j(hub, leaf_j) sharing only the hub
        attribute ``a`` — the Shares hypercube degenerates to a single
        dimension (hash everything on the hub; no replication).  With
        ``aggregate=True``: Γ_{a; SUM ∏ values}, the per-hub product of
        leaf sums."""
        if n < 2:
            raise ValueError(f"a star needs >= 2 relations, got {n}")
        if n + 1 > len(string.ascii_lowercase):
            raise ValueError(f"star too wide: {n}")
        attrs = tuple(string.ascii_lowercase[: n + 1])
        rels = tuple((attrs[0], attrs[j + 1]) for j in range(n))
        values = tuple(f"v{j}" for j in range(n))
        agg = QueryAggregate(keys=(attrs[0],)) if aggregate else None
        return JoinQuery(attrs=attrs, relations=rels, values=values,
                         aggregate=agg)


class ChainQuery(JoinQuery):
    """An N-way chain join over relations R_j(attrs[j], attrs[j+1], values[j]).

    A thin, chain-validated special case of :class:`JoinQuery`: the
    hyperedges are consecutive attribute pairs, so the general machinery
    (hypercube dims, join orders, executor lowerings) applies unchanged
    while construction enforces the chain contract — distinct attribute
    names (repeating a name would close a cycle; cyclic queries are
    spelled ``JoinQuery.cycle``/``triangle`` instead) and, when
    aggregated, endpoint grouping keys (the configuration under which
    aggregation pushdown is sound, paper §V).

    ``ChainQuery.three_way()`` is the paper's R(a,b) ⋈ S(b,c) ⋈ T(c,d);
    ``ChainQuery.chain(n)`` the canonical N-way instance.  Hand it with
    N physical relations to ``core.executor.execute_chain`` (or let
    ``core.planner.plan_chain`` pick the strategy first).

    Attributes (constructor arguments):
      attrs:     N+1 distinct attribute names ``A_1..A_{N+1}``.
                 Relation j (0-based) has key columns ``(attrs[j],
                 attrs[j+1])`` and joins relation j+1 on the shared
                 ``attrs[j+1]``.
      values:    per-relation value column name, or ``None`` for a
                 key-only relation.
      aggregate: optional :class:`ChainAggregate` with keys
                 ``(attrs[0], attrs[-1])``.
    """

    def __init__(self, attrs: Sequence[str],
                 values: Sequence[Optional[str]],
                 aggregate: Optional[QueryAggregate] = None):
        attrs = tuple(attrs)
        values = tuple(values)
        if len(attrs) < 3:
            raise ValueError("a chain query needs >= 2 relations (>= 3 attributes)")
        n = len(attrs) - 1
        if len(values) != n:
            raise ValueError(
                f"{n} relations need {n} value entries, got {len(values)}")
        named = list(attrs) + [v for v in values if v]
        if len(set(named)) != len(named):
            raise ValueError(f"attribute/value names must be distinct: {named}")
        if aggregate is not None:
            if any(v is None for v in values):
                raise ValueError("aggregated queries need a value column on "
                                 "every relation")
            want = (attrs[0], attrs[-1])
            if tuple(aggregate.keys) != want:
                raise ValueError(
                    f"aggregation keys must be the chain endpoints {want}, "
                    f"got {aggregate.keys}")
            if aggregate.out in named:
                raise ValueError(
                    f"aggregation output column {aggregate.out!r} "
                    f"collides with an attribute/value name")
        relations = tuple((attrs[j], attrs[j + 1]) for j in range(n))
        super().__init__(attrs=attrs, relations=relations, values=values,
                         aggregate=aggregate)

    # -- constructors ------------------------------------------------------
    @classmethod
    def chain(cls, n: int, *, aggregate: bool = False) -> "ChainQuery":
        """Canonical N-way chain: attrs a,b,c,...; values v0,v1,...
        ``chain(3)`` is the paper's R(a,b,v0) ⋈ S(b,c,v1) ⋈ T(c,d,v2)."""
        attrs, _, values = cls._chain_parts(n)
        agg = ChainAggregate(keys=(attrs[0], attrs[-1])) if aggregate else None
        return cls(attrs=attrs, values=values, aggregate=agg)

    @classmethod
    def three_way(cls, *, aggregate: bool = False) -> "ChainQuery":
        """The paper's query in its column naming: R(a,b,v) S(b,c,w)
        T(c,d,x), aggregated output value ``p``."""
        agg = ChainAggregate(keys=("a", "d")) if aggregate else None
        return cls(attrs=("a", "b", "c", "d"), values=("v", "w", "x"),
                   aggregate=agg)
