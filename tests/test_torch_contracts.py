"""The port's trace contracts against the JAX package's: the same grammar,
the same engine, the same verdicts, and the port's own drill journals held
by the reference's `TRACE_CONTRACTS`.

The contract cases of the reference's spec tests (``tests/test_spec.py``)
run here against the port's copy (`dsort_tpu_torch.analysis.spec`), each
report compared with the JAX package's on the same records.  Then real
journals of the port on the CPU — a coded loss and a re-form in the SPMD
scheduler, a hier re-form, a served eviction, a coded wave — conform to
the reference's contracts, and a tampered one is refused by both.
"""

import json

import numpy as np
import pytest

from dsort_tpu.analysis.spec import contracts as jc

from dsort_tpu_torch import cli as tcli
from dsort_tpu_torch.analysis.spec import (
    CONTRACT_EXEMPT,
    TRACE_CONTRACTS,
    assert_conformant,
    conformance_report,
    format_conformance,
)
from dsort_tpu_torch.analysis.spec.contracts import (
    ContractError,
    compile_contract,
    contract_names,
)
from dsort_tpu_torch.config import JobConfig, ServeConfig
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler
from dsort_tpu_torch.utils.events import EVENT_TYPES, EventLog
from dsort_tpu_torch.utils.metrics import Metrics



def _same(records, contracts=None) -> dict:
    """The port's report on ``records``, asserted equal to the JAX
    package's."""
    got = conformance_report(records, contracts)
    assert got == jc.conformance_report(records, contracts)
    assert format_conformance(got) == jc.format_conformance(got)
    return got


def _records(log):
    return [e.to_dict() for e in log.events()]


# -- the engine -------------------------------------------------------------------


def test_registry_is_the_references_and_resolves():
    assert TRACE_CONTRACTS == jc.TRACE_CONTRACTS
    assert CONTRACT_EXEMPT == jc.CONTRACT_EXEMPT
    covered = set()
    for contract in TRACE_CONTRACTS.values():
        alphabet = contract_names(contract)
        assert alphabet == jc.contract_names(contract)
        covered |= alphabet
        # Every name of every contract, the fleet's included, is registered.
        assert not (alphabet | set(contract.get("when", ()))) - set(EVENT_TYPES)
    assert not covered & set(CONTRACT_EXEMPT)
    for name, contract in TRACE_CONTRACTS.items():
        assert compile_contract(contract).pattern == jc.compile_contract(contract).pattern


def test_compile_postfix_binds_to_whole_name():
    pat = compile_contract({"steps": ("alpha beta?",)})
    assert pat.fullmatch("alpha,") and pat.fullmatch("alpha,beta,")
    assert not pat.fullmatch("beta,")
    pat = compile_contract({"steps": ("( alpha | beta )+ gamma*",)})
    assert pat.fullmatch("beta,alpha,gamma,gamma,")
    assert not pat.fullmatch("gamma,")


@pytest.mark.parametrize("steps", [("alpha [beta]",), ("( alpha",)])
def test_compile_rejects_garbage(steps):
    with pytest.raises(ContractError):
        compile_contract({"steps": steps})
    with pytest.raises(jc.ContractError):
        jc.compile_contract({"steps": steps})


def _lifecycle(log, job, evict=False, fail=False):
    log.emit("job_admitted", job=job, tenant="t")
    log.emit("job_dequeued", job=job, tenant="t")
    log.emit("attempt_start", job=job, attempt=1)
    if evict:
        log.emit("job_evicted", job=job)
        log.emit("job_readmitted", job=job)
        log.emit("job_dequeued", job=job, tenant="t")
        log.emit("attempt_start", job=job, attempt=2)
    if fail:
        log.emit("job_failed", job=job)
    else:
        log.emit("job_done", job=job)
        log.emit("result_fetch", job=job)


def test_conformance_scopes_interleaved_jobs():
    log = EventLog()
    for etype, job in (("job_admitted", 1), ("job_admitted", 2), ("job_dequeued", 2),
                       ("job_dequeued", 1), ("job_done", 2), ("job_done", 1)):
        log.emit(etype, job=job)
    report = assert_conformant(log)
    assert report == jc.assert_conformant(_records(log))
    assert report["contracts"]["job_lifecycle"]["checked"] == 2


def test_conformance_when_gates_agent_side_journals():
    log = EventLog()
    log.emit("job_done", job=1)
    report = _same(_records(log))
    assert report["ok"] and report["contracts"]["job_lifecycle"]["checked"] == 0


@pytest.mark.parametrize("evict,fail", [(False, False), (True, False), (False, True)])
def test_lifecycles_conform(evict, fail):
    log = EventLog()
    _lifecycle(log, 1, evict=evict, fail=fail)
    assert _same(_records(log))["ok"]


def test_violation_names_contract_and_shows_trace():
    log = EventLog()
    _lifecycle(log, job=1)
    log.emit("job_done", job=1)  # a second terminal
    report = _same(_records(log))
    assert not report["ok"]
    v = report["violations"][0]
    assert v["contract"] == "job_lifecycle" and v["scope"]["job"] == 1
    assert "VIOLATED job_lifecycle" in format_conformance(report)
    with pytest.raises(AssertionError, match="job_lifecycle"):
        assert_conformant(log)


def test_analyzer_conformance_verdict_key():
    from dsort_tpu_torch.obs.analyze import VERDICT_KEYS, analyze_records

    assert "conformance" in VERDICT_KEYS
    log = EventLog()
    _lifecycle(log, job=1)
    assert analyze_records(_records(log))["conformance"]["ok"] is True
    assert analyze_records([])["conformance"] is None


def test_cli_report_conform_exit_codes(tmp_path, capsys):
    log = EventLog()
    _lifecycle(log, job=1, evict=True)
    good = tmp_path / "good.jsonl"
    log.write_jsonl(str(good))
    assert tcli.main(["report", str(good), "--conform"]) == 0
    assert "OK" in capsys.readouterr().out
    bad = tmp_path / "bad.jsonl"
    records = [json.loads(x) for x in good.read_text().splitlines()]
    bad.write_text("".join(json.dumps(r) + "\n" for r in records if r["type"] != "job_dequeued"))
    assert tcli.main(["report", str(bad), "--conform"]) == 1
    assert "job_lifecycle" in capsys.readouterr().out


# -- the port's drill journals under the reference's contracts --------------------


DRILLS = {
    # a coded loss: worker_dead -> mesh_reform -> coded_recover
    "coded": (dict(exchange="ring", redundancy=2), lambda i: i.fail_once(3, "ring"),
              "coded_recovery"),
    "parity": (dict(exchange="ring", redundancy=2, redundancy_mode="parity"),
               lambda i: i.fail_once(3, "ring"), "parity_recovery"),
    # a hier re-form after a lost worker
    "hier": (dict(exchange="hier", hier_hosts=4), lambda i: i.fail_once(2, "spmd"),
             "hier_reform"),
}


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_scheduler_drill_journal_conforms(name):
    job_kw, script, contract = DRILLS[name]
    inj = FaultInjector()
    sched = SpmdScheduler(8, "cpu", JobConfig(settle_delay_s=0.01, **job_kw), inj)
    script(inj)
    data = np.random.default_rng(21).integers(0, 10**6, 1 << 14).astype(np.int32)
    log = EventLog()
    np.testing.assert_array_equal(sched.sort(data, metrics=Metrics(journal=log)), np.sort(data))
    for ss in sched._sorters.values():
        ss.join_stragglers()
    report = _same(_records(log))
    assert report["ok"] and report["contracts"][contract]["checked"] == 1


def test_served_eviction_conforms_and_tampering_is_named(tmp_path):
    """A served eviction's journal conforms to the reference's contracts;
    with its first job_dequeued deleted, both packages name job_lifecycle."""
    from dsort_tpu_torch.serve import SortService

    inj, journal = FaultInjector(), EventLog()
    svc = SortService(8, "cpu", job=JobConfig(settle_delay_s=0.01,
                                              flight_recorder_dir=str(tmp_path)),
                      serve=ServeConfig(small_job_max=1 << 14), injector=inj,
                      journal=journal, start=False)
    inj.fail_once(0, "slice")
    d = np.random.default_rng(17).integers(0, 1 << 30, 5000, dtype=np.int32)
    verdict, ticket = svc.submit(d, tenant="acme")
    assert verdict.admitted
    svc.start()
    np.testing.assert_array_equal(ticket.result(timeout=120), np.sort(d))
    svc.shutdown(drain=True)
    records = _records(journal)
    assert any(r["type"] == "job_evicted" for r in records)
    report = _same(records)
    assert report["ok"] and report["contracts"]["job_lifecycle"]["checked"] == 1
    cut = next(i for i, r in enumerate(records) if r["type"] == "job_dequeued")
    report = _same(records[:cut] + records[cut + 1:])
    assert not report["ok"] and report["violations"][0]["contract"] == "job_lifecycle"


def test_coded_wave_journal_conforms(tmp_path):
    """A coded wave loss reconstructs inline (a free-standing
    coded_recover) and every wave span pairs up."""
    from dsort_tpu_torch.models.wave_sort import ExternalWaveSort
    from dsort_tpu_torch.scheduler.fault import WorkerFailure

    w = ExternalWaveSort(VirtualMesh(4, "cpu"), wave_elems=8192, spill_dir=str(tmp_path),
                         exchange="ring", redundancy=2, resume=False)
    fired = []

    def hook():
        if not fired:
            fired.append(1)
            err = WorkerFailure(2, "ring")
            err.workers = [2]
            raise err

    w.fault_hook = hook
    data = np.random.default_rng(22).integers(0, 10**6, 30_000).astype(np.int32)
    log = EventLog()
    np.testing.assert_array_equal(w.sort(data, metrics=Metrics(journal=log)), np.sort(data))
    report = _same(_records(log))
    assert report["ok"]
    assert report["contracts"]["coded_recovery"]["checked"] == 1
    assert report["contracts"]["wave_span"]["checked"] == 4
