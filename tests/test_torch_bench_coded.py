"""``bench --coded-ab``, ``--coded-v2-ab`` and ``--hier-ab`` against the JAX
package's, at its own test sizes (`test_torch_bench_plain` holds the
lines)."""

import pytest

from test_torch_bench_plain import ASPECTS, BenchRuns, hold_lines

MODES = {
    "coded_ab": ["--coded-ab", "--n", "65536", "--reps", "1"],
    "coded_v2_ab": ["--coded-v2-ab", "--n", "65536", "--reps", "1"],
    "hier_ab": ["--hier-ab", "--n", "65536", "--reps", "1"],
}


@pytest.fixture(scope="module")
def runs():
    return BenchRuns(MODES)


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("mode", list(MODES))
def test_bench_lines_match_reference(runs, mode, aspect):
    hold_lines(runs, mode, aspect)


def test_coded_ab_recovers_locally(runs):
    """One coded recovery a faulted sort, the replica bytes charged."""
    healthy, failure = runs.get("coded_ab")[3]
    assert failure["coded_recoveries"] == 1 and failure["recovered_keys"] > 0
    assert healthy["coded_replica_bytes"] > 0


def test_coded_v2_gates(runs):
    """Parity's premium under 0.75x replicate's; the straggler served once,
    its p99 under the owner's."""
    premium, failure, straggler = runs.get("coded_v2_ab")[3]
    assert premium["premium_ratio"] < 0.75 and failure["coded_recoveries"] == 1
    assert straggler["straggler_serves"] == 1
    assert straggler["p99_serve_s"] < straggler["p99_owner_s"]


def test_hier_ab_plans_fewer_dcn_bytes_and_replans(runs):
    """Every grouping plans fewer boundary bytes than the flat ring; the
    worker loss keeps 2 hosts, the host loss re-plans under 4."""
    lines = runs.get("hier_ab")[3]
    groupings = [ln for ln in lines if "hosts" in ln]
    assert [ln["hosts"] for ln in groupings] == [2, 4]
    assert all(ln["dcn_bytes"] < ln["ring_dcn_bytes"] for ln in groupings)
    dev, host = lines[-2:]
    assert (dev["hosts_before"], dev["hosts_after"]) == (2, 2)
    assert host["hosts_before"] == 4 and 2 <= host["hosts_after"] < 4


def test_coded_v2_journal_over_reps_holds_to_the_contracts(tmp_path):
    """Each timed sort is a job of its own in the journal, so three straggler
    reps are three ``straggler_serve`` traces, each served once (one
    `Metrics` across the reps would make them one trace served three
    times)."""
    from dsort_tpu_torch import cli
    from dsort_tpu_torch.analysis.spec.contracts import conformance_report
    from dsort_tpu_torch.utils.events import EventLog
    from test_torch_bench_plain import run_main

    path = tmp_path / "v2.jsonl"
    rc, lines = run_main(cli.main, ["bench", "--coded-v2-ab", "--n", "20000", "--reps", "2",
                                    "--journal", str(path), "--device", "cpu"])
    assert rc == 0 and lines[-1]["straggler_serves"] == 1
    rep = conformance_report(EventLog.read_jsonl(str(path)))
    assert rep["ok"], rep["violations"][:2]
    assert rep["contracts"]["straggler_serve"]["checked"] == 2
