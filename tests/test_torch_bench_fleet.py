"""``bench --fleet-mixed`` against the JAX package's ``dsort bench
--fleet-mixed`` at its ``make fleet-smoke`` size (``--n 20000``): two
agents over loopback TCP behind a controller, on the CPU here.
`test_torch_bench_plain` holds the lines' names, keys and rates; here the
counts and gates: the same jobs, tenants, agents and re-routes, every arm
bit-identical, locality's hit rate above random's and health verdicts
journaled, in both packages; the port's journal holds to the trace
contracts of both packages, the fleet's ``job_routed`` contract
included."""

import pytest

from dsort_tpu.analysis.spec import conformance_report as jax_conformance_report

from dsort_tpu_torch.analysis.spec.contracts import conformance_report
from dsort_tpu_torch.utils.events import EventLog

from test_torch_bench_plain import BenchRuns, hold_lines

#: The fields equal in both packages; the rest are times or depend on
#: thread timing (the hit rates' values, the verdict count).
COUNTS = ("metric", "unit", "jobs", "tenants", "agents", "rerouted", "bit_identical")


@pytest.fixture(scope="module")
def journal(tmp_path_factory):
    return tmp_path_factory.mktemp("fleet") / "fleet.jsonl"


@pytest.fixture(scope="module")
def runs(journal):
    # Both runs write the journal; the port's runs second and stays.
    return BenchRuns({"fleet_mixed": ["--fleet-mixed", "--n", "20000", "--reps", "1",
                                      "--journal", str(journal)]})


@pytest.mark.parametrize("aspect", ["exit_and_rates", "names", "keys"])
def test_bench_lines_match_reference(runs, aspect):
    hold_lines(runs, "fleet_mixed", aspect)


def test_fleet_mixed_counts_and_gates_match_reference(runs):
    jrc, jlines, prc, plines = runs.get("fleet_mixed")
    assert jrc == prc == 0
    assert [{k: ln.get(k) for k in COUNTS} for ln in plines] == [
        {k: ln.get(k) for k in COUNTS} for ln in jlines]
    for main, health in (jlines, plines):
        assert main["metric"] == "fleet_mixed_workload_2agents"
        assert main["jobs"] == 25 and main["agents"] == 2 and main["rerouted"] == 0
        assert main["bit_identical"] is True and health["bit_identical"] is True
        assert main["cache_hit_rate"] > main["cache_hit_rate_random"]
        assert health["health_verdicts"] > 0
        assert isinstance(main["telemetry_overhead_frac"], float)
        assert 0 < main["fairness_p95_ratio"]


def test_fleet_mixed_journal_holds_to_the_contracts(runs, journal):
    runs.get("fleet_mixed")
    records = EventLog.read_jsonl(str(journal))
    types = {r["type"] for r in records}
    assert {"job_routed", "job_dispatched", "agent_register", "health_verdict"} <= types
    report = conformance_report(records)
    assert report["ok"], report["violations"][:3]
    assert report["contracts"]["job_lifecycle"]["checked"] >= 25
    assert jax_conformance_report(records)["ok"]
