"""``python -m repro_torch.analysis.cli`` — certify plans before
anything runs.

The port of the JAX package's ``repro-verify``
(``src/repro/analysis/cli.py``); the ``repro-verify`` entry point in
``pyproject.toml`` stays the JAX package's.

* ``--all-bench`` rebuilds every plan behind the ``BENCH_*.json``
  sweeps (:mod:`repro_torch.analysis.bench_targets`) and runs the plan
  checker on each — plus the recovery-coverage pass
  (:mod:`repro_torch.analysis.resilience_verifier`) on targets carrying
  recovery metadata;
* ``--bench NAME`` (repeatable) restricts to named sweeps
  (``--bench resilience`` is the recovery-coverage pass alone);
* ``--audit`` adds the op audit of every executor lowering
  (:mod:`repro_torch.analysis.op_audit`: each lowering run at the
  reference fixture's sizes, its aten ops walked) on ``--device``, the
  card unless ``--device cpu`` is passed;
* ``--out FILE`` writes the JSON report artifact.

Exit status is 0 iff no report contains an error-severity finding —
warnings are printed and serialized but do not fail certification.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence

from .bench_targets import TARGET_BUILDERS, all_bench_targets
from .plan_verifier import verify_chain_plan, verify_query_plan
from .report import VerifierReport, reports_to_json
from .resilience_verifier import verify_recovery_meta


def verify_bench_targets(names: Optional[Sequence[str]] = None,
                         ) -> List[VerifierReport]:
    """Build the bench corpus and certify every target.  Targets that
    carry recovery metadata (the resilience sweep's plans) additionally
    pass the recovery-coverage check — every non-final hop needs a
    recovery point or an explicit opt-out."""
    reports: List[VerifierReport] = []
    for t in all_bench_targets(names):
        if t.kind == "chain":
            rep = verify_chain_plan(t.query, t.stats, t.plan, t.caps,
                                    specs=t.specs, target=t.name)
        else:
            rep = verify_query_plan(t.query, t.stats, t.plan, t.caps,
                                    target=t.name)
        if t.recovery is not None:
            rep.extend(verify_recovery_meta(t.recovery, plan=t.plan,
                                            target=t.name))
        reports.append(rep)
    return reports


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.cli",
        description="Statically certify join plans, and audit the "
                    "executor lowerings' ops.")
    parser.add_argument(
        "--all-bench", action="store_true",
        help="verify every plan behind the BENCH_*.json sweeps")
    parser.add_argument(
        "--bench", action="append", metavar="NAME", default=[],
        choices=sorted(TARGET_BUILDERS),
        help="verify one sweep's plans (repeatable); "
             f"choices: {', '.join(sorted(TARGET_BUILDERS))}")
    parser.add_argument(
        "--audit", action="store_true",
        help="also run every executor lowering at a tiny size and "
             "audit its aten ops")
    parser.add_argument(
        "--device", default=None,
        help="the device --audit runs the lowerings on (default: cuda)")
    parser.add_argument(
        "--out", metavar="FILE", default=None,
        help="write the JSON report artifact here")
    args = parser.parse_args(argv)

    if not (args.all_bench or args.bench or args.audit):
        parser.error("nothing to do: pass --all-bench, --bench NAME "
                     "and/or --audit")

    reports: List[VerifierReport] = []
    t0 = time.time()
    if args.all_bench or args.bench:
        names = None if args.all_bench else args.bench
        reports.extend(verify_bench_targets(names))
    if args.audit:
        from .op_audit import audit_lowerings
        reports.extend(audit_lowerings(device=args.device))
    elapsed = time.time() - t0

    for rep in reports:
        print(rep.summary())
        for f in rep.findings:
            print(f"    {f.severity.upper()} {f.code} @ {f.where}")
            print(f"        {f.message}")

    n_err = sum(len(r.errors) for r in reports)
    n_warn = sum(len(r.findings) for r in reports) - n_err
    ok = all(r.ok for r in reports)
    print(f"{len(reports)} target(s) in {elapsed:.1f}s: "
          f"{n_err} error(s), {n_warn} warning(s) — "
          f"{'CERTIFIED' if ok else 'REJECTED'}")

    if args.out:
        with open(args.out, "w") as fh:
            fh.write(reports_to_json(reports))
            fh.write("\n")
        print(f"report written to {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
