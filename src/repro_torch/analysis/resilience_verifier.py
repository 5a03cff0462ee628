"""Recovery-metadata coverage pass.

A copy of ``src/repro/analysis/resilience_verifier.py`` (host-side, no
tensors).  The resilient executors
(:mod:`repro_torch.resilience.recovery`) recover a cascade hop from the
*previous* hop's materialized snapshot, so a cascade plan is only as
recoverable as its snapshot coverage: every non-final hop must either
appear in ``RecoveryMeta.snapshot_hops`` or be an explicit, reasoned
opt-out.  One-round Shares plans have no hop
snapshots (the recovery unit is the reducer bucket) and are covered by
construction.  This pass checks that claim statically — no execution,
same contract as the plan checker.

Codes:

* ``RECOVERY_GAP`` (error) — a non-final hop has neither a recovery
  point nor an opt-out: a crash there restarts the whole cascade.
* ``RECOVERY_OPT_OUT`` (warning) — a hop is deliberately
  unprotected; legal, but the report keeps the reason visible.
* ``RETRY_BUDGET_ZERO`` (error) — ``max_attempts < 1`` means the
  first injected fault is terminal; recovery is configured off.
* ``RECOVERY_STRATEGY_MISMATCH`` (error) — the metadata describes a
  different strategy than the plan executes; coverage claims about
  the wrong executor certify nothing.
"""

from __future__ import annotations

from typing import Any, Optional

from .report import ERROR, WARNING, VerifierReport

__all__ = ["verify_recovery_meta"]


def verify_recovery_meta(meta: Any, *, plan: Optional[Any] = None,
                         target: str = "recovery") -> VerifierReport:
    """Certify one plan's :class:`~repro_torch.resilience.recovery.RecoveryMeta`.

    ``plan`` (optional) is the execution plan the metadata claims to
    cover; when given, its ``strategy`` must match the metadata's.
    """
    rep = VerifierReport(target=target)
    strategy = str(meta.strategy)
    n_hops = int(meta.n_hops)
    snaps = set(int(h) for h in meta.snapshot_hops)
    opt_out = set(int(h) for h in meta.opt_out)

    if plan is not None and getattr(plan, "strategy", strategy) != strategy:
        rep.add(
            "RECOVERY_STRATEGY_MISMATCH", ERROR, "meta.strategy",
            f"metadata covers strategy {strategy!r} but the plan executes "
            f"{plan.strategy!r}; regenerate the metadata with "
            f"recovery_meta_for({plan.strategy!r}, ...)")

    if int(meta.max_attempts) < 1:
        rep.add(
            "RETRY_BUDGET_ZERO", ERROR, "meta.max_attempts",
            f"max_attempts={int(meta.max_attempts)} disables retry: the "
            f"first injected fault is terminal.  RecoveryPolicy requires "
            f">= 1 (1 = no retry, still a typed failure).")

    # The last hop needs no snapshot — its output IS the result; only
    # hops 0..n_hops-2 feed a later hop that would re-read them.
    protected_range = range(max(n_hops - 1, 0))
    for h in protected_range:
        if h in snaps:
            continue
        if h in opt_out:
            reason = str(meta.opt_out_reason) or "no reason recorded"
            rep.add(
                "RECOVERY_OPT_OUT", WARNING, f"hop {h}",
                f"hop {h} is explicitly unprotected ({reason}): a crash "
                f"at hop {h + 1} re-executes the cascade from the last "
                f"earlier snapshot (or hop 0).")
            continue
        rep.add(
            "RECOVERY_GAP", ERROR, f"hop {h}",
            f"non-final hop {h} has neither a snapshot recovery point "
            f"nor an explicit opt-out; a process death after hop {h} "
            f"silently loses its intermediate.  Add {h} to "
            f"snapshot_hops (the resilient executor materializes it) "
            f"or to opt_out with a reason.")

    rep.metrics["strategy"] = strategy
    rep.metrics["n_hops"] = n_hops
    rep.metrics["snapshot_hops"] = sorted(snaps)
    rep.metrics["opt_out_hops"] = sorted(opt_out)
    rep.metrics["max_attempts"] = int(meta.max_attempts)
    rep.metrics["backoff_cap_ms"] = float(meta.backoff_cap_ms)
    if n_hops > 1:
        covered = sum(1 for h in protected_range if h in snaps)
        rep.metrics["snapshot_coverage"] = covered / len(protected_range)
    else:
        # one-round / single-hop: reducer- or output-granular by
        # construction; nothing to snapshot.
        rep.metrics["snapshot_coverage"] = 1.0
    return rep
