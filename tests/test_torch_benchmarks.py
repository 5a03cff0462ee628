"""The port's benchmark scripts reproduce the JAX package's pinned
tuple counts.

Each ``benchmarks/*_torch.py`` runs its smallest configuration on the
CPU (``--fast`` where the reference script has it, else its default
size) and every ``read`` / ``shuffled`` / ``max_bucket_load`` /
``total`` field it reaches must equal the pin in
``tests/data/bench_counts_seed.json`` — tuple accounting does not
depend on the framework.  The number of pins compared is asserted, so a
report that lost a field fails.  Times exist only on a GPU: here every
one is null.  The unpinned ports are held to their references too:
``paper_figures_torch``'s rows equal ``benchmarks/paper_figures.py``'s,
and ``engine_micro_torch --fast`` writes its whole report.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
import bench_common_torch as common  # noqa: E402
import engine_micro_torch  # noqa: E402
import nway_chain_torch  # noqa: E402
import paper_figures_torch  # noqa: E402
import resilience_sweep_torch  # noqa: E402
import roofline_torch  # noqa: E402
import run_torch  # noqa: E402
import serving_sweep_torch  # noqa: E402
import skew_sweep_torch  # noqa: E402
import triangle_sweep_torch  # noqa: E402

sys.path.pop(0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: the intra-op pool only oversubscribes the CPU under
    a parallel run (see ``tests/test_torch_skew.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def timings(obj, path=""):
    """Every wall-clock field of a report, by path."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{path}/{k}"
            if (k.endswith("_ms") or k in ("qps", "speedup", "overhead")) \
                    and not isinstance(v, (dict, list)):
                out[p] = v
            else:
                out.update(timings(v, p))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            out.update(timings(v, f"{path}/{i}"))
    return out


def held_to_pins(report, bench, n_pins, complete):
    ok, n, bad = common.check_pins(report, bench, complete=complete)
    assert not bad, bad[:5]
    assert ok and n == n_pins
    assert report["device"] == {"platform": "cpu"}
    times = timings(report)
    assert times and all(v is None for v in times.values()), times


def test_nway_chain_counts_equal_the_pins(tmp_path):
    out = tmp_path / "BENCH_torch_nway.json"
    report = nway_chain_torch.run(device="cpu", out=str(out))
    assert json.loads(out.read_text())["benchmark"] == "nway_chain_torch"
    held_to_pins(report, "BENCH_nway.json", 36, complete=True)
    for row in report["chains"].values():
        assert all(row["measured"][s]["match"]
                   for s in ("one_round", "cascade", "cascade_pushdown"))


def test_skew_sweep_counts_equal_the_pins(tmp_path):
    report = skew_sweep_torch.run(device="cpu",
                                  out=str(tmp_path / "skew.json"))
    held_to_pins(report, "BENCH_skew.json", 20, complete=True)
    assert skew_sweep_torch.acceptance(report)


def test_triangle_sweep_fast_counts_equal_the_pins(tmp_path):
    report = triangle_sweep_torch.run(fast=True, device="cpu",
                                      out=str(tmp_path / "tri.json"))
    held_to_pins(report, "BENCH_triangles.json", 14, complete=False)
    row = report["graphs"]["amazon"]
    assert row["counts_match_oracle"]
    assert all(m["match"] for k, m in row["measured"].items() if k != "k")


def test_serving_sweep_fast_counts_equal_the_pins(tmp_path, monkeypatch):
    # No count depends on the warm repeats; on the CPU each is an eager
    # run, so two stand for the 20 of --fast.
    monkeypatch.setattr(serving_sweep_torch, "WARM_REPEATS_FAST", 2)
    report = serving_sweep_torch.run(fast=True, device="cpu",
                                     out=str(tmp_path / "serving.json"))
    held_to_pins(report, "BENCH_serving.json", 33, complete=True)
    gates = report["gates"]
    assert gates["serve_speedup"] is None and gates["warm_p99_bounded"] is None
    assert all(v for k, v in gates.items() if v is not None), gates


def test_resilience_sweep_fast_counts_equal_the_pins(tmp_path):
    report = resilience_sweep_torch.run(fast=True, device="cpu",
                                        out=str(tmp_path / "res.json"))
    held_to_pins(report, "BENCH_resilience.json", 117, complete=True)
    gates = report["gates"]
    assert gates["overhead_bounded"] is None
    assert all(v for k, v in gates.items() if v is not None), gates


def test_check_pins_reports_a_drifted_count():
    report = {"chains": {"3": {"measured": {"one_round": {
        "read": 360.0, "shuffled": 841.0}}}}}
    ok, n, bad = common.check_pins(report, "BENCH_nway.json", complete=False)
    assert not ok and n == 2
    assert bad == [("chains/3/measured/one_round/shuffled", 841.0, 840.0)]
    ok, n, bad = common.check_pins(report, "BENCH_nway.json", complete=True)
    assert not ok and n == 36 and len(bad) == 35


TIMED = {"staged", "fused", "all_pairs", "sort_merge", "single_pass",
         "multipass", "eager", "replay", "partition", "sort_staged",
         "sort_fused", "probe", "probe_ref", "probe_searchsorted", "emit",
         "shuffle"}


def us_times(obj, path=""):
    """Every timing cell (``{"median_us", "min_us"}``, or null off the
    GPU) of a data-plane report, by path."""
    out = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{path}/{k}"
            if k in TIMED:
                out[p] = v
            elif isinstance(v, dict):
                out.update(us_times(v, p))
    return out


def test_roofline_fast_accounting_equals_the_six_pins(tmp_path):
    report = roofline_torch.run(fast=True, device="cpu",
                                out=str(tmp_path / "roof.json"))
    ok, n, bad = common.check_pins(report, "BENCH_roofline.json",
                                   complete=True)
    assert ok and n == 6 and not bad
    assert roofline_torch.check_report(report) == []
    assert report["device"] == {"platform": "cpu"}
    assert report["overlap"] is None and "A12" in report["overlap_skipped"]
    acc = report["accounting"]
    assert acc["measured"]["staged"] == acc["measured"]["overlapped"]
    times = us_times(report["fused_vs_staged"])
    assert len(times) == 2 * 6 and all(v is None for v in times.values())


def test_engine_micro_fast_report_has_null_times_on_the_cpu(tmp_path):
    out = tmp_path / "jk.json"
    report = engine_micro_torch.run(fast=True, device="cpu", out=str(out))
    assert json.loads(out.read_text())["benchmark"] == "join_kernels_torch"
    assert report["capacities"] == [1024, 4096]
    for cap in ("1024", "4096"):
        row = report["local_join"][cap]
        assert row["sort_merge"] is row["fused"] is row["all_pairs"] is None
        assert set(report["join_phases"][cap]) >= {
            "partition", "sort_staged", "sort_fused", "probe",
            "probe_searchsorted", "emit", "shuffle"}
    assert set(report["executor"]) == {"one_round", "cascade"}
    times = us_times(report)
    assert len(times) == 28 and all(v is None for v in times.values())
    assert engine_micro_torch.check_report(report) == []


def test_paper_figures_rows_equal_the_reference(monkeypatch):
    """Every figure row (name, value, derived) equals
    ``benchmarks/paper_figures.py``'s.  The dense statistics are the
    costly part: on every dataset the port's edges equal the
    reference's and its copy of ``self_join_stats`` equals the
    reference's at scale 8 (at full scale on slashdot); the reference's
    figures then read the port's full-scale statistics, put in its
    cache for this test only."""
    pytest.importorskip("jax")
    import dataclasses
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        ref = importlib.import_module("benchmarks.paper_figures")
        ref_stats = importlib.import_module("benchmarks.sparse_stats")
    finally:
        sys.path.remove(str(ROOT))
    assert list(paper_figures_torch.DATASETS) == list(ref.DATASETS)
    for name, spec in paper_figures_torch.DATASETS.items():
        ref_spec = ref.DATASETS[name]
        src, dst = paper_figures_torch.rmat_edges(spec, seed=42)
        want_src, want_dst = ref.rmat_edges(ref_spec, seed=42)
        np.testing.assert_array_equal(src, want_src, err_msg=name)
        np.testing.assert_array_equal(dst, want_dst, err_msg=name)
        src, dst = paper_figures_torch.rmat_edges(
            dataclasses.replace(spec, scale=8), seed=42)
        assert paper_figures_torch.self_join_stats(src, dst) == \
            ref_stats.self_join_stats(src, dst), name
        monkeypatch.setitem(ref._CACHE, name,
                            paper_figures_torch.dataset_stats(name))
    src, dst = ref.dataset_stats("slashdot")["_edges"]
    assert paper_figures_torch.self_join_stats(src, dst) == \
        ref_stats.self_join_stats(src, dst)
    for fig in ("fig2_comm_cost", "fig3_crossover",
                "fig4_intermediate_aggregation", "fig5_output_reduction",
                "fig6_aggregated_cost"):
        got = getattr(paper_figures_torch, fig)()
        assert got == getattr(ref, fig)(), fig
        assert got
    rows = paper_figures_torch.engine_validation(device="cpu")
    assert [r[0] for r in rows] == ["validate/1,3JA/measured_tuples",
                                    "validate/2,3JA/measured_tuples"]
    assert all(r[2].endswith("MATCH") for r in rows)


def test_run_torch_prints_every_section(capsys):
    """The CSV harness over the figures and the engine rows: the engine
    rows' values are empty off the GPU."""
    assert run_torch.main(["--device", "cpu", "--only", "engine"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 8 and all(line.split(",")[1] == ""
                                   for line in lines[1:])
    assert [s for s, _ in run_torch.sections("cpu")] == [
        "fig2", "fig3", "fig4", "fig5", "fig6", "validate", "engine",
        "roofline"]
