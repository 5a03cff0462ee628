"""The port's analysis tools against the JAX package's, on the CPU.

* ``repro_torch.analysis.bench_targets``: every target's name, kind,
  plan, caps and partition specs equal the JAX package's corpus.
* ``python -m repro_torch.analysis.cli --all-bench``: its JSON report
  (targets, finding codes, severities) and exit code equal
  ``repro-verify --all-bench``'s; ``--audit`` adds the op audit.
* ``op_audit.audit_lowerings()``: nine reports, each clean, each having
  walked its lowering's ops; seeded defects are each caught — float
  count accumulation, int64 key narrowing, a donated input returned,
  a cache-key collision — and position narrowing is not one.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as T  # noqa: E402
from repro_torch.analysis import (audit_donation, audit_jit_cache,  # noqa: E402
                                  audit_lowerings, audit_run,
                                  all_bench_targets)
from repro_torch.analysis import cli as t_cli  # noqa: E402
from repro_torch.analysis.op_audit import _chain_fixture  # noqa: E402
from repro_torch.core import executor as ex  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the intra-op pool only oversubscribes the CPU under
    a parallel run (see ``tests/test_torch_skew.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_dict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def test_bench_targets_equal_the_jax_corpus():
    pytest.importorskip("jax")
    from repro.analysis.bench_targets import all_bench_targets as j_targets
    got, want = all_bench_targets(), j_targets()
    assert [t.name for t in got] == [t.name for t in want]
    for g, w in zip(got, want):
        assert g.kind == w.kind, g.name
        assert as_dict(g.plan) == as_dict(w.plan), g.name
        assert as_dict(g.caps) == as_dict(w.caps), g.name
        assert as_dict(g.stats) == as_dict(w.stats), g.name
        assert [as_dict(s) for s in g.specs or ()] == \
            [as_dict(s) for s in w.specs or ()], g.name
        assert (g.recovery is None) == (w.recovery is None), g.name
        if g.recovery is not None:
            assert as_dict(g.recovery) == as_dict(w.recovery), g.name


def findings(path):
    """(target, sorted (code, severity)) of every report in a CLI
    artifact."""
    reports = json.loads(path.read_text())
    reports = reports["reports"] if isinstance(reports, dict) else reports
    return [(r["target"], sorted((f["code"], f["severity"])
                                 for f in r["findings"]))
            for r in reports]


def test_cli_all_bench_equals_repro_verify(tmp_path, capsys):
    pytest.importorskip("jax")
    from repro.analysis import cli as j_cli
    t_out, j_out = tmp_path / "torch.json", tmp_path / "jax.json"
    t_rc = t_cli.main(["--all-bench", "--out", str(t_out)])
    j_rc = j_cli.main(["--all-bench", "--out", str(j_out)])
    assert t_rc == j_rc == 0
    got = findings(t_out)
    assert got == findings(j_out)
    assert len(got) >= 15
    assert "CERTIFIED" in capsys.readouterr().out


def test_cli_audit_and_exit_codes(tmp_path):
    out = tmp_path / "audit.json"
    assert t_cli.main(["--bench", "resilience", "--audit", "--device",
                       "cpu", "--out", str(out)]) == 0
    targets = [t for t, _ in findings(out)]
    assert targets[:2] == ["resilience/one_round (1,3J)",
                           "resilience/cascade (2,3J)"]
    assert sum(t.startswith("ops/") for t in targets) == 9
    with pytest.raises(SystemExit):
        t_cli.main([])                       # nothing to do


def test_cli_exits_nonzero_on_an_error(monkeypatch):
    """Exit status is 0 iff no report holds an error."""
    from repro_torch.analysis import VerifierReport
    bad = VerifierReport(target="seeded")
    bad.add("SEEDED", "error", "here", "a seeded error")
    monkeypatch.setattr(t_cli, "verify_bench_targets", lambda names: [bad])
    assert t_cli.main(["--bench", "nway"]) == 1


# ---------------------------------------------------------------------------
# The op audit
# ---------------------------------------------------------------------------

def test_all_lowerings_audit_clean():
    """Every lowering — one-round chain/query, the cascade (staged and
    fused + overlapped), the map-side cascade over a real partitioned
    store, and ``jit_execute_chain`` with donation (both variants) —
    audits with zero findings."""
    reports = audit_lowerings(device="cpu")
    assert len(reports) == 9
    bad = [r.summary() for r in reports if not r.ok or r.findings]
    assert not bad, "\n".join(bad)
    names = [r.target for r in reports]
    assert names == [
        "ops/one_round_chain", "ops/one_round_query", "ops/cascade_query",
        "ops/one_round_query[fused,overlap]",
        "ops/cascade_query[fused,overlap]", "ops/mapside_cascade_chain",
        "ops/jit_execute_chain", "ops/jit_execute_chain[fused,overlap]",
        "ops/jit_cache_key"]
    # The audit walked the programs.
    assert all(r.metrics["n_ops"] > 100 for r in reports[:-1])


def fixture_rels(key_dtype=None):
    query, edges, _ = _chain_fixture(3)
    if key_dtype is not None:
        edges = [(s.astype(key_dtype), d.astype(key_dtype)) for s, d in edges]
    return query, [T.scatter_to_grid(
        T.edge_relation(s, d, names=query.schema(j), device="cpu",
                        key_dtype=torch.as_tensor(s).dtype), (2, 2))
        for j, (s, d) in enumerate(edges)]


def test_seeded_float_count_accum_caught():
    """Summing integer counts through float32 loses exactness above
    2^24; converting a sum's result does not."""
    query, rels = fixture_rels()
    _, rep = audit_run(
        lambda rs: rs[0].col(query.attrs[0]).to(torch.float32).sum(), rels,
        "seeded/float_accum")
    assert "FLOAT_COUNT_ACCUM" in rep.codes
    assert rep.ok                            # a warning, not an error
    _, rep = audit_run(
        lambda rs: rs[0].col(query.attrs[0]).sum().to(torch.float32), rels,
        "benign/sum_then_convert")
    assert not rep.findings


def test_seeded_key_narrowing_caught():
    """An int64 key column (or a value computed from it) narrowed to
    int32 folds keys above 2^32; the hash's own fold does not count."""
    query, rels = fixture_rels(np.int64)
    _, rep = audit_run(
        lambda rs: (rs[1].col(query.attrs[1]) + 1).to(torch.int32), rels,
        "seeded/key_narrowing")
    assert "KEY_DTYPE_NARROWED" in rep.codes and not rep.ok
    from repro_torch.core import hashing
    _, rep = audit_run(
        lambda rs: hashing.bucket_hash(rs[1].col(query.attrs[1]), 4), rels,
        "benign/hash")
    assert not rep.findings


def test_benign_position_narrowing_not_flagged():
    """Sort permutations and searchsorted positions derive from keys but
    are bounded by the buffer size: narrowing them is not a finding."""
    query, rels = fixture_rels(np.int64)

    def positions(rs):
        col = rs[0].col(query.attrs[0]).reshape(-1)
        order = torch.argsort(col, stable=True)
        srt = col[order]
        pos = torch.searchsorted(srt, srt).to(torch.int32)
        return order.to(torch.int32) + pos

    _, rep = audit_run(positions, rels, "benign/positions")
    assert "KEY_DTYPE_NARROWED" not in rep.codes


def test_seeded_donation_violation_caught():
    query, rels = fixture_rels()
    out, rep = audit_run(lambda rs: (rs[0], rs[1].col("c") + 1), rels,
                         "seeded/donation")
    rep = audit_donation(out, rels, "seeded/donation", report=rep)
    assert "DONATED_INPUT_RETURNED" in rep.codes and not rep.ok
    assert not audit_donation(
        (rels[0].map(torch.clone),), rels, "benign/clone").findings


def test_seeded_cache_key_collision_caught(monkeypatch):
    """A cache key that drops ``overlap_chunks`` hands an overlapped
    plan the staged executable."""
    assert audit_jit_cache().ok
    compiled = ex._compiled

    def leaky(grid, query, strategy, caps, donate, opts, chain):
        opts = {k: v for k, v in opts.items() if k != "overlap_chunks"}
        return compiled(grid, query, strategy, caps, donate, opts, chain)

    monkeypatch.setattr(ex, "_compiled", leaky)
    T.clear_compiled_caches()
    rep = audit_jit_cache()
    assert rep.codes == ("CACHE_KEY_COLLISION",) and not rep.ok
    assert "overlap_chunks" in rep.findings[0].where
    T.clear_compiled_caches()


@pytest.mark.cuda
def test_all_lowerings_audit_clean_on_the_gpu():
    """On the card the fused lowerings probe with the ``probe_counts``
    kernel and ``jit_execute_chain`` captures a CUDA graph under the
    audit; every report stays clean."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    ops.reset_launches()
    reports = audit_lowerings(device="cuda")
    assert len(reports) == 9
    bad = [r.summary() for r in reports if not r.ok or r.findings]
    assert not bad, "\n".join(bad)
    assert ops.LAUNCHES["probe_counts"] > 0
