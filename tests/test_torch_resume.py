"""Resumable jobs: the port's checkpointed schedulers against the JAX
package's, drill by drill, on the same seeded inputs.

`SpmdScheduler` (range and shard checkpoints) and the task-pool
`Scheduler` (shard checkpoints) run through both packages with the same
`JobConfig` (``from_dict``, ``checkpoint_dir`` included) and the same
injected faults: JAX on the 8-device CPU mesh, the port on 8 virtual
workers of the CPU.  Compared with no tolerance: the output bits, the
resume counters, and the scheduler's and the store's events in order with
their fields.  The cross-package cases let one package write a store and
the other resume it, repairing only what is missing; ``cli run
--checkpoint-dir`` closes the file.
"""

import dataclasses
import os
import shutil
import time

import numpy as np
import pytest

from dsort_tpu.checkpoint import ShardCheckpoint as JaxShardCheckpoint
from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data.ingest import gen_uniform, gen_zipf
from dsort_tpu.scheduler import DeviceExecutor as JaxDeviceExecutor
from dsort_tpu.scheduler import FaultInjector as JaxFaultInjector
from dsort_tpu.scheduler import Scheduler as JaxScheduler
from dsort_tpu.scheduler import SpmdScheduler as JaxSpmdScheduler
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.checkpoint import ShardCheckpoint
from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.data.ingest import read_ints_file, write_ints_file
from dsort_tpu_torch.parallel import sample_sort as tss
from dsort_tpu_torch.scheduler import (
    DeviceExecutor,
    FaultInjector,
    JobFailedError,
    Scheduler,
    SpmdScheduler,
)
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

EVENTS = {"job_start", "attempt_start", "worker_dead", "mesh_reform", "probe", "job_done",
          "job_failed", "checkpoint_persist", "checkpoint_restore", "checkpoint_clear",
          "coded_budget_exceeded", "coded_recover"}
RESUME = ("mesh_reforms", "spmd_phase_restores", "shuffle_phase_restores",
          "shuffle_ranges_restored", "shuffle_resort_keys", "shards_restored",
          "reassignments", "coded_recoveries")
FAST = dict(settle_delay_s=0.01, heartbeat_timeout_s=5.0)


def _timeline(journal):
    return [(e.type, {k: v for k, v in e.fields.items()
                      if k not in ("job", "tenant", "counters", "wall_s", "fetch_s")})
            for e in journal.events() if e.type in EVENTS]


class Side:
    """One package's scheduler (SPMD or the task pool), injector and
    journal, on its own checkpoint root."""

    def __init__(self, port: bool, root, taskpool: bool = False, **job_kw):
        jjob = JaxJobConfig(checkpoint_dir=str(root), **job_kw)
        self.port, self.root = port, root
        if port:
            self.inj = FaultInjector()
            job = JobConfig.from_dict(dataclasses.asdict(jjob))
            self.sched = (Scheduler(DeviceExecutor(8, "cpu", self.inj), job) if taskpool
                          else SpmdScheduler(8, "cpu", job, self.inj))
        else:
            self.inj = JaxFaultInjector()
            self.sched = (JaxScheduler(JaxDeviceExecutor(injector=self.inj), jjob) if taskpool
                          else JaxSpmdScheduler(job=jjob, injector=self.inj))
        self.taskpool = taskpool
        self.new_journal()

    def new_journal(self):
        self.journal = EventLog() if self.port else JaxEventLog()
        self.metrics = (Metrics if self.port else JaxMetrics)(journal=self.journal)

    def sort(self, data, job_id, **kw):
        if self.taskpool:
            return self.sched.run_job(data, metrics=self.metrics, job_id=job_id)
        return self.sched.sort(data, metrics=self.metrics, job_id=job_id, **kw)

    def result(self):
        return ({k: self.metrics.counters.get(k, 0) for k in RESUME}, _timeline(self.journal))

    def store(self, job_id):
        cls = ShardCheckpoint if self.port else JaxShardCheckpoint
        return cls(str(self.root), job_id)


def _pair(tmp_path, **kw):
    return Side(False, tmp_path / "jax", **kw), Side(True, tmp_path / "port", **kw)


def _same_bits(a, b):
    assert a.dtype == b.dtype
    assert np.array_equal(a.view(f"u{a.dtype.itemsize}"), b.view(f"u{b.dtype.itemsize}"))


def _both(js, ps, data, job_id, **kw):
    """Sort on both sides; require equal bits (and numpy's), counters and
    timelines (as multisets under the task pool); return the port's
    counters."""
    jo, po = js.sort(data, job_id, **kw), ps.sort(data, job_id, **kw)
    _same_bits(po, jo)
    if data.dtype.kind != "f":  # numpy's float sort does not keep -0.0's bits
        _same_bits(po, np.sort(data))
    got, ref = ps.result(), js.result()
    assert got[0] == ref[0]
    if ps.taskpool:  # one handler thread a shard: their events interleave
        assert sorted(map(repr, got[1])) == sorted(map(repr, ref[1]))
    else:
        assert got[1] == ref[1]
    return got[0]


# -- SPMD: the local-sort phase and the shuffle ranges ----------------------


def test_spmd_checkpointed_phase_recovery(tmp_path):
    """A loss before dispatch re-forms the mesh; the retry restores the
    persisted local-sort shards instead of re-sorting them."""
    js, ps = _pair(tmp_path, **FAST)
    for s in (js, ps):
        s.inj.fail_once(1, "spmd")
    c = _both(js, ps, gen_uniform(30_000, seed=51), "spmdjob")
    assert c["mesh_reforms"] == 1 and c["spmd_phase_restores"] == 1


def test_spmd_range_checkpoint_partial_loss(tmp_path):
    """Worker 7 dies while its range is read back: ranges 0..6 restore and
    only the lost interval re-sorts, on the 7 survivors."""
    js, ps = _pair(tmp_path, **FAST)
    for s in (js, ps):
        s.inj.fail_once(7, "assemble")
    data = gen_uniform(40_000, seed=60)
    c = _both(js, ps, data, "rangejob")
    assert c["mesh_reforms"] == 1 and c["shuffle_ranges_restored"] == 7
    assert 0 < c["shuffle_resort_keys"] < len(data) // 2
    types = [t for t, _ in ps.result()[1]]
    assert types.index("checkpoint_persist") < types.index("worker_dead")
    assert types.index("checkpoint_restore") < types.index("job_done")


def test_spmd_resume_subset_phases_are_timed(tmp_path):
    """The resume after a loss at ``assemble`` is split into timed phases,
    in order: the subset build, its sort (which holds the sample sort's own
    phases), the host merge and the range rewrite."""
    ps = Side(True, tmp_path / "port", **FAST)
    ps.inj.fail_once(7, "assemble")
    data = gen_uniform(40_000, seed=61)
    _same_bits(ps.sort(data, "phased"), np.sort(data))
    names = ("resume_subset", "resume_sort", "resume_merge", "resume_rewrite")
    assert all(ps.metrics.phase_s[k] > 0 for k in names)
    starts = [e.fields["phase"] for e in ps.journal.events() if e.type == "phase_start"]
    first = [starts.index(k) for k in names]
    assert first == sorted(first)
    inner = starts[first[1] + 1:first[2]]
    assert "partition" in inner and all(k not in inner for k in names)


@pytest.mark.parametrize("dtype", [np.int32, np.uint64, np.float32])
def test_spmd_full_restore_runs_no_sort(tmp_path, dtype):
    """A re-run of a finished job restores every range: no device program
    runs (float keys persist as the reference's ordered uints)."""
    rng = np.random.default_rng(61)
    if dtype == np.float32:
        data = rng.standard_normal(20_000).astype(dtype)
        data[::97] = np.nan
        data[::89] = -0.0
    else:
        data = rng.integers(0, np.iinfo(dtype).max, 20_000, dtype=dtype, endpoint=True)
    js, ps = _pair(tmp_path, settle_delay_s=0.01)
    _both(js, ps, data, "fulljob")
    for s in (js, ps):
        s.new_journal()
    c = _both(js, ps, data, "fulljob")
    assert c["shuffle_phase_restores"] == 1
    assert "spmd_sort" not in ps.metrics.phase_s
    man = ps.store("fulljob").manifest()
    assert man == js.store("fulljob").manifest()


def test_spmd_stale_job_id_cleared(tmp_path):
    js, ps = _pair(tmp_path, settle_delay_s=0.01)
    _both(js, ps, gen_uniform(10_000, seed=62), "reused")
    for s in (js, ps):
        s.new_journal()
    c = _both(js, ps, gen_uniform(10_000, seed=63), "reused")
    assert c["shuffle_phase_restores"] == 0
    assert "checkpoint_clear" in [t for t, _ in ps.result()[1]]


def test_spmd_resume_with_duplicate_boundary_keys(tmp_path):
    """Boundary values duplicated across lost and kept ranges rebuild by
    count."""
    data = np.random.default_rng(64).integers(0, 50, 40_000).astype(np.int32)
    js, ps = _pair(tmp_path, settle_delay_s=0.01)
    for s in (js, ps):
        s.inj.fail_once(4, "assemble")
    c = _both(js, ps, data, "dupjob")
    assert c["shuffle_ranges_restored"] >= 1


@pytest.mark.parametrize("n", [40_000, 40_001])
def test_spmd_resume_two_gaps_then_full_restore(tmp_path, n):
    """Two non-adjacent ranges deleted: both intervals rebuild by value (a
    subset whose length is not a multiple of 8), the recovery persists as
    one range, and the next run restores it whole."""
    js, ps = _pair(tmp_path, settle_delay_s=0.01)
    data = gen_uniform(n, seed=70)
    _both(js, ps, data, "gapjob")
    for s in (js, ps):
        ck = s.store("gapjob")
        os.remove(ck._range_path(2))
        os.remove(ck._range_path(5))
        s.new_journal()
    c = _both(js, ps, data, "gapjob")
    assert c["shuffle_ranges_restored"] == 6
    assert 0 < c["shuffle_resort_keys"] < len(data) and c["shuffle_resort_keys"] % 8
    for s in (js, ps):
        s.new_journal()
    c = _both(js, ps, data, "gapjob")
    assert c["shuffle_phase_restores"] == 1 and c["shuffle_resort_keys"] == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spmd_store_resumes_across_packages(tmp_path, writer):
    """A job one package finished, with ranges 1 and 6 deleted, resumes in
    the other: the same 6 ranges restore and the same keys re-sort as when
    the writer resumes its own store."""
    data = gen_zipf(30_000, a=1.3, dtype=np.int64, seed=72)
    js, ps = _pair(tmp_path, settle_delay_s=0.01)
    w, r = (js, ps) if writer == "jax" else (ps, js)
    w.sort(data, "xjob")
    ck = w.store("xjob")
    os.remove(ck._range_path(1))
    os.remove(ck._range_path(6))
    shutil.copytree(w.root / "xjob", r.root / "xjob")
    w.new_journal()
    own = w.sort(data, "xjob")
    other = r.sort(data, "xjob")
    _same_bits(other, own)
    _same_bits(other, np.sort(data))
    assert r.result()[0] == w.result()[0]
    assert r.result()[0]["shuffle_ranges_restored"] == 6


def test_spmd_device_resident_skips_checkpoint(tmp_path):
    """keep_on_device with a checkpoint config: the job runs, warns, and
    persists nothing (a handle re-runs on failure)."""
    for port in (False, True):
        s = Side(port, tmp_path / str(port), settle_delay_s=0.01)
        data = gen_uniform(9_000, seed=35)
        h = s.sort(data, "dev", keep_on_device=True)
        np.testing.assert_array_equal(h.to_host(), np.sort(data))
        assert not (s.root.exists() and list(s.root.iterdir()))


def test_spmd_coded_loss_in_resume_subset_keeps_restored_ranges(tmp_path):
    """A coded loss inside a resume's SUBSET re-sort must not complete the
    job from the subset-only snapshot: it takes the re-run path, which
    resumes; the restored ranges stay and nothing is recovered coded."""
    js, ps = _pair(tmp_path, **FAST, exchange="ring", redundancy=2)
    for s in (js, ps):
        s.inj.fail_sequence([(7, "assemble"), (6, "ring")])
    data = gen_uniform(40_000, seed=60)
    c = _both(js, ps, data, "codedresume")
    assert c["shuffle_ranges_restored"] >= 7
    assert 0 < c["shuffle_resort_keys"] < len(data)
    assert c["coded_recoveries"] == 0


def test_spmd_zombie_attempt_cannot_corrupt_checkpoint(monkeypatch, tmp_path):
    """An attempt abandoned by a lapsed wait that wakes after the re-formed
    mesh finished the job is cancelled at its next checkpoint write: the
    store keeps the live 7-range layout and restores cleanly."""
    orig = tss.SampleSort.sort_ranges
    state = {"first": True}

    def hang_then_ranges(self, data, metrics=None, **kw):
        if state["first"]:
            state["first"] = False
            time.sleep(4.0)
        return orig(self, data, metrics, **kw)

    monkeypatch.setattr(tss.SampleSort, "sort_ranges", hang_then_ranges)

    def fake_probe(self, idx):
        if idx == 3:
            return False
        self.table.heartbeat(idx)
        return True

    monkeypatch.setattr(SpmdScheduler, "_probe_device", fake_probe)
    job = JobConfig(settle_delay_s=0.01, heartbeat_timeout_s=0.3, compile_grace_s=2.0,
                    exec_allowance_floor_s=0.3, exec_allowance_keys_per_s=1e9,
                    max_transient_retries=5, checkpoint_dir=str(tmp_path))
    sched = SpmdScheduler(8, "cpu", job)
    data = gen_uniform(30_000, seed=94)
    np.testing.assert_array_equal(sched.sort(data, job_id="zombie"), np.sort(data))
    deadline = time.monotonic() + 10.0
    while sched.lane_stuck_for("spmd") > 0 or state["first"]:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    time.sleep(0.5)
    ckpt = ShardCheckpoint(str(tmp_path), "zombie")
    assert ckpt.manifest()["n_ranges"] == 7 and len(ckpt.completed_ranges()) == 7
    m = Metrics()
    np.testing.assert_array_equal(sched.sort(data, metrics=m, job_id="zombie"), np.sort(data))
    assert m.counters["shuffle_phase_restores"] == 1


def test_check_cancelled_raises_attempt_cancelled():
    import threading

    from dsort_tpu_torch.scheduler.fault import AttemptCancelled

    ev = threading.Event()
    SpmdScheduler._check_cancelled(ev)
    SpmdScheduler._check_cancelled(None)
    ev.set()
    with pytest.raises(AttemptCancelled):
        SpmdScheduler._check_cancelled(ev)


# -- the task pool's shard checkpoints --------------------------------------


def test_taskpool_rerun_restores_every_shard(tmp_path):
    """Run 1 completes by reassignment (workers 2..7 dead); run 2 restores
    all 8 shards with every worker dead; without the store it fails."""
    js, ps = _pair(tmp_path, taskpool=True, **FAST)
    data = gen_uniform(8_000, seed=33)
    for s in (js, ps):
        for i in range(2, 8):
            s.inj.kill(i)
    _both(js, ps, data, "jobA")
    for s in (js, ps):
        for i in range(8):
            s.inj.kill(i)
        s.new_journal()
    c = _both(js, ps, data, "jobA")
    assert c["shards_restored"] == 8
    with pytest.raises(JobFailedError):
        ps.sort(data, "jobB")


def test_taskpool_stale_checkpoint_cleared(tmp_path):
    js, ps = _pair(tmp_path, taskpool=True, settle_delay_s=0.01)
    _both(js, ps, gen_uniform(20_000, seed=81), "reused")
    for s in (js, ps):
        s.new_journal()
    c = _both(js, ps, gen_uniform(20_000, seed=82), "reused")
    assert c["shards_restored"] == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_taskpool_store_resumes_across_packages(tmp_path, writer):
    """Shards 0, 3 and 5 of a job one package finished survive; the other
    package restores them and sorts only the rest."""
    data = np.random.default_rng(83).standard_normal(20_000).astype(np.float64)
    js, ps = _pair(tmp_path, taskpool=True, settle_delay_s=0.01)
    w, r = (js, ps) if writer == "jax" else (ps, js)
    w.sort(data, "samejob")
    ck = w.store("samejob")
    for i in (1, 2, 4, 6, 7):
        os.remove(ck._shard_path(i))
    shutil.copytree(w.root / "samejob", r.root / "samejob")
    out = r.sort(data, "samejob")
    _same_bits(out, np.sort(data))
    assert r.metrics.counters["shards_restored"] == 3


# -- cli run --checkpoint-dir / --job-id -------------------------------------


def test_cli_run_checkpoint_resume(tmp_path):
    """``run --checkpoint-dir``: ranges persist under the input-derived job
    id (the scheduler, not the fused route, at 5,000 keys); a re-run
    restores; changed data under the same name clears the store."""
    rng = np.random.default_rng(31)
    data = rng.integers(0, 10**6, 5_000).astype(np.int32)
    src, out, jpath = tmp_path / "ck_input.txt", tmp_path / "out.txt", tmp_path / "j.jsonl"
    write_ints_file(src, data)
    argv = ["run", str(src), "-o", str(out), "--checkpoint-dir", str(tmp_path / "ck"),
            "--device", "cpu", "--journal", str(jpath)]
    assert cli.main(argv) == 0
    assert any(n.startswith("range_") for n in os.listdir(tmp_path / "ck" / "ck_input.txt"))
    np.testing.assert_array_equal(read_ints_file(out), np.sort(data))
    recs = EventLog.read_jsonl(str(jpath))
    assert recs[0]["type"] == "job_start" and recs[0]["mode"] == "spmd"
    assert recs[0]["job_id"] == "ck_input.txt"
    out.unlink()
    assert cli.main(argv) == 0
    np.testing.assert_array_equal(read_ints_file(out), np.sort(data))
    done = [r for r in EventLog.read_jsonl(str(jpath)) if r["type"] == "job_done"]
    assert done[-1]["counters"].get("shuffle_phase_restores") == 1
    data2 = rng.integers(0, 10**6, 5_000).astype(np.int32)
    write_ints_file(src, data2)
    assert cli.main(argv) == 0
    np.testing.assert_array_equal(read_ints_file(out), np.sort(data2))


def test_cli_taskpool_checkpoint_flag(tmp_path):
    data = np.random.default_rng(33).integers(0, 1000, 9_000).astype(np.int32)
    src, out = tmp_path / "tp_in.txt", tmp_path / "tp_out.txt"
    write_ints_file(src, data)
    argv = ["run", str(src), "-o", str(out), "--mode", "taskpool", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "ck2"), "--job-id", "tpjob"]
    assert cli.main(argv) == 0
    assert any(n.startswith("shard_") for n in os.listdir(tmp_path / "ck2" / "tpjob"))
    np.testing.assert_array_equal(read_ints_file(out), np.sort(data))


@pytest.mark.parametrize("bad", ["..", ".", "a/b", "a\\b", "..."])
def test_cli_job_id_path_escape_rejected(tmp_path, bad):
    src = tmp_path / "x.txt"
    write_ints_file(src, np.arange(10, dtype=np.int32))
    with pytest.raises(SystemExit):
        cli.main(["run", str(src), "-o", str(tmp_path / "o.txt"), "--device", "cpu",
                  "--checkpoint-dir", str(tmp_path / "ck"), "--job-id", bad])


def test_cli_job_id_for_matches_reference():
    from dsort_tpu.cli import _job_id_for as jax_job_id_for

    for path, explicit in (("/a/b/in put.txt", None), ("/x/..", None), ("f", "ok-id.1"),
                           ("/d/±.txt", None)):
        assert cli._job_id_for(path, explicit) == jax_job_id_for(path, explicit)


@pytest.mark.parametrize("flags", [["--mode", "local"], ["--device-resident"]])
def test_cli_checkpoint_ignored_with_warning(tmp_path, caplog, flags):
    """``--mode local`` and ``--device-resident`` do not checkpoint: they
    warn, sort, and leave the checkpoint root empty."""
    import logging

    data = gen_uniform(3_000, seed=5)
    src, out = tmp_path / "in.txt", tmp_path / "out.txt"
    write_ints_file(src, data)
    logger = logging.getLogger("dsort_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="dsort_tpu_torch"):
            assert cli.main(["run", str(src), "-o", str(out), "--device", "cpu",
                             "--checkpoint-dir", str(tmp_path / "ck"), *flags]) == 0
    finally:
        logger.removeHandler(caplog.handler)
    assert "--checkpoint-dir" in caplog.text
    np.testing.assert_array_equal(read_ints_file(out), np.sort(data))
    assert not (tmp_path / "ck").exists() or not any((tmp_path / "ck").rglob("*.npy"))
