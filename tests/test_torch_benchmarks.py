"""The port's benchmark scripts reproduce the JAX package's pinned
tuple counts.

Each ``benchmarks/*_torch.py`` runs its smallest configuration on the
CPU (``--fast`` where the reference script has it, else its default
size) and every ``read`` / ``shuffled`` / ``max_bucket_load`` /
``total`` field it reaches must equal the pin in
``tests/data/bench_counts_seed.json`` — tuple accounting does not
depend on the framework.  The number of pins compared is asserted, so a
report that lost a field fails.  Times exist only on a GPU: here every
one is null.
"""

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "benchmarks"))
import bench_common_torch as common  # noqa: E402
import nway_chain_torch  # noqa: E402
import resilience_sweep_torch  # noqa: E402
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
