"""The port's wave pipeline against the JAX package's, on the same inputs.

`ExternalWaveSort` and `ExternalWaveTeraSort` run through both packages:
JAX on its 8-device CPU mesh, the port on ``VirtualMesh(P, "cpu")`` (its
kernels' plain versions).  Compared with no tolerance: sorted bits, the
wave and exchange counters, the manifest (the sampled splitters included)
and, with ``overlap=False`` (one thread, so a total order), the journal
event for event; with the overlap on, the same events as a multiset.  The
programs covered: ``ring``, ``fused``, ``hier``, ``coded`` (replicate and
parity) and P = 1; the resume contract at (wave, run) granularity, across
packages too; the mid-ring repair; the crash drill through the port's CLI
in a child process; record waves with their retention repair.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data.ingest import gen_terasort_file, gen_uniform, gen_zipf
from dsort_tpu.models.wave_sort import ExternalWaveSort as JaxExternalWaveSort
from dsort_tpu.models.wave_sort import ExternalWaveTeraSort as JaxExternalWaveTeraSort
from dsort_tpu.models.wave_sort import sample_global_splitters as jax_sample_splitters
from dsort_tpu.parallel.mesh import local_device_mesh
from dsort_tpu.scheduler import FaultInjector as JaxFaultInjector
from dsort_tpu.scheduler.fault import WorkerFailure as JaxWorkerFailure
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.checkpoint import ShardCheckpoint
from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.models.external_sort import record_keys
from dsort_tpu_torch.models.wave_sort import (
    DIE_AFTER_WAVE_ENV,
    ExternalWaveSort,
    ExternalWaveTeraSort,
    _shard_cap,
    sample_global_splitters,
)
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.scheduler import FaultInjector
from dsort_tpu_torch.scheduler.fault import WorkerFailure
from dsort_tpu_torch.utils import events
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAVE_COUNTERS = ("waves_sorted", "runs_sorted", "runs_resumed", "wave_runs_resorted",
                 "wave_resort_keys", "exchange_ring_steps", "exchange_bytes_on_wire",
                 "exchange_bytes_saved", "fused_exchange_launches", "fused_exchange_steps",
                 "coded_recoveries", "coded_recovered_keys", "coded_replica_bytes",
                 "hier_exchanges", "dcn_bytes_on_wire", "intra_host_bytes_on_wire",
                 "dcn_bytes_saved")
TIMING = ("job", "tenant", "counters", "seconds", "wall_s", "fetch_s")


def _events(journal):
    """Every event but the timers' (and the reference's compile records),
    its clock fields left out."""
    return [(e.type, {k: v for k, v in e.fields.items() if k not in TIMING})
            for e in journal.events()
            if e.type in events.EVENT_TYPES
            and e.type not in ("phase_start", "phase_end", "variant_compiled")]


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(f"u{a.dtype.itemsize}"), b.view(f"u{b.dtype.itemsize}"))


class Side:
    """One package's wave sort with its journal, on its own spill root."""

    def __init__(self, port: bool, root, p: int = 8, job_kw=None, records=False, **kw):
        self.port, self.root = port, root
        jjob = JaxJobConfig(**(job_kw or {}))
        if port:
            mesh, job = VirtualMesh(p, "cpu"), JobConfig.from_dict(vars(jjob))
            cls = ExternalWaveTeraSort if records else ExternalWaveSort
        else:
            mesh, job = local_device_mesh(p), jjob
            cls = JaxExternalWaveTeraSort if records else JaxExternalWaveSort
        self.sorter = cls(mesh, spill_dir=str(root), job=job, **kw)
        self.journal = EventLog() if port else JaxEventLog()
        self.metrics = (Metrics if port else JaxMetrics)(journal=self.journal)
        self.inj = FaultInjector() if port else JaxFaultInjector()
        self.failure = WorkerFailure if port else JaxWorkerFailure

    def counters(self):
        return {k: self.metrics.counters.get(k, 0) for k in WAVE_COUNTERS}

    def manifest(self, job_id):
        return ShardCheckpoint(str(self.root), job_id).manifest()

    def sweep_hook(self, on_call=None):
        """The scheduler's aggregating ring-hook shape: sweep every
        position, raise ONE failure carrying all; ``on_call`` limits it to
        that call of the hook (1-based)."""
        calls = {"n": 0}

        def hook():
            calls["n"] += 1
            if on_call is not None and calls["n"] != on_call:
                return
            failed = []
            for i in range(self.sorter.num_workers):
                try:
                    self.inj.check(i, "ring")
                except self.failure as f:
                    failed.append(f.worker)
            if failed:
                e = self.failure(failed[0], "ring")
                e.workers = failed
                raise e

        return hook


def _pair(tmp_path, p=8, **kw):
    return Side(False, tmp_path / "jax", p, **kw), Side(True, tmp_path / "port", p, **kw)


def _compare(js, ps, ordered):
    assert ps.counters() == js.counters()
    got, want = _events(ps.journal), _events(js.journal)
    if ordered:
        assert got == want
    else:
        assert sorted(map(repr, got)) == sorted(map(repr, want))


def _both(js, ps, data, ordered=None):
    jo = js.sorter.sort(data, metrics=js.metrics)
    po = ps.sorter.sort(data, metrics=ps.metrics)
    _same_bits(po, jo)
    _compare(js, ps, not ps.sorter.overlap if ordered is None else ordered)
    return po


# -- correctness against the reference ---------------------------------------


@pytest.mark.parametrize("n,wave,p", [(0, 64, 8), (1, 64, 8), (1000, 300, 8), (20000, 4096, 8),
                                      (5000, 777, 4), (4096, 4096, 8), (3000, 700, 1)])
def test_wave_matches_jax(tmp_path, n, wave, p):
    data = np.random.default_rng(n + wave).integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    js, ps = _pair(tmp_path, p, wave_elems=wave, job_id="w", overlap=False)
    out = _both(js, ps, data)
    _same_bits(out, np.sort(data))
    if n:
        assert ps.manifest("w") == js.manifest("w")


@pytest.mark.parametrize("exchange", ["ring", "fused", "hier"])
def test_wave_zipf_int64_matches_jax(tmp_path, exchange):
    """Every wave plans against the measured histogram; ``fused`` launches
    one exchange a wave, ``hier`` journals its two-level plan."""
    data = gen_zipf(12000, a=1.3, dtype=np.int64, seed=3)
    js, ps = _pair(tmp_path, wave_elems=2000, job_id="wz", exchange=exchange, overlap=False)
    assert ps.sorter.exchange == js.sorter.exchange == exchange
    _same_bits(_both(js, ps, data), np.sort(data))
    c = ps.counters()
    assert c["waves_sorted"] == 6
    assert c["fused_exchange_launches"] == (6 if exchange == "fused" else 0)
    assert c["hier_exchanges"] == (6 if exchange == "hier" else 0)
    assert "skew_report" in ps.journal.types()


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.uint32, np.uint64, np.int16,
                                   np.uint8])
def test_wave_dtypes_match_jax(tmp_path, dtype):
    """Float keys with NaN / ±0.0 ride as ordered uints, narrow keys widen
    to int32 on the card; the manifests' ``storage_dtype`` is the
    reference's."""
    rng = np.random.default_rng(9)
    if np.dtype(dtype).kind == "f":
        data = rng.standard_normal(6000).astype(dtype)
        data[::211] = np.nan
        data[::301] = -0.0
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, 6000, dtype=dtype, endpoint=True)
    js, ps = _pair(tmp_path, wave_elems=1500, job_id="wf")
    _both(js, ps, data)
    assert ps.manifest("wf") == js.manifest("wf")


def test_wave_sentinel_valued_keys(tmp_path):
    data = np.random.default_rng(4).integers(-100, 100, 3000).astype(np.int32)
    data[::17] = np.iinfo(np.int32).max
    js, ps = _pair(tmp_path, wave_elems=512, job_id="ws")
    _same_bits(_both(js, ps, data), np.sort(data))


def test_wave_overlap_on_and_off_agree(tmp_path):
    data = np.random.default_rng(5).integers(0, 10**6, 16000).astype(np.int32)
    outs = []
    for overlap in (True, False):
        s = ExternalWaveSort(VirtualMesh(8, "cpu"), wave_elems=3000, job_id=f"o{overlap}",
                             spill_dir=str(tmp_path), overlap=overlap)
        outs.append(s.sort(data))
    _same_bits(outs[0], outs[1])
    _same_bits(outs[0], np.sort(data))


def test_wave_binary_file_roundtrip_memmap(tmp_path):
    data = np.random.default_rng(6).integers(-(2**31), 2**31 - 1, 20000).astype(np.int32)
    in_path, out_path = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    data.tofile(in_path)
    ExternalWaveSort(VirtualMesh(8, "cpu"), wave_elems=4096, spill_dir=str(tmp_path / "sp"),
                     job_id="wfile").sort_binary_file(in_path, out_path, dtype=np.int32)
    _same_bits(np.fromfile(out_path, dtype=np.int32), np.sort(data))


def test_splitters_and_shard_cap_are_the_references():
    data = np.random.default_rng(7).integers(-(10**6), 10**6, 50000).astype(np.int32)
    for p in (1, 2, 8, 16):
        np.testing.assert_array_equal(sample_global_splitters(data, len(data), p),
                                      jax_sample_splitters(data, len(data), p))
    from dsort_tpu.models.wave_sort import _shard_cap as jax_shard_cap

    for budget, p in ((1, 8), (4000, 8), (4097, 3), (1 << 23, 8)):
        assert _shard_cap(budget, p) == jax_shard_cap(budget, p)


# -- the resume contract ------------------------------------------------------


def test_wave_full_resume_and_no_resume(tmp_path):
    data = np.random.default_rng(8).integers(-(10**6), 10**6, 9000).astype(np.int32)
    for resume, restored in ((True, 0), (True, 24), (False, 0)):
        js, ps = _pair(tmp_path, wave_elems=3000, job_id="wr", resume=resume, overlap=False)
        _both(js, ps, data)
        assert ps.counters()["runs_resumed"] == restored
    assert ps.counters()["runs_sorted"] == 24


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_wave_store_resumes_across_packages(tmp_path, writer):
    """Two runs of wave 2 deleted from a store one package wrote: the other
    package re-sorts exactly those two runs (one ``wave_resume``) and
    restores the other 46, with the same counters and events as the
    writer's own resume."""
    data = np.random.default_rng(10).integers(-(10**6), 10**6, 24000).astype(np.int32)
    js, ps = _pair(tmp_path, wave_elems=4000, job_id="wp", overlap=False)
    w, r = (js, ps) if writer == "jax" else (ps, js)
    w.sorter.sort(data)
    for name in ("aux_w00002_00003.npy", "aux_w00002_00005.npy"):
        os.remove(w.root / "wp" / name)
    shutil.rmtree(r.root, ignore_errors=True)
    shutil.copytree(w.root, r.root)
    _same_bits(_both(js, ps, data), np.sort(data))
    c = r.counters()
    assert c["wave_runs_resorted"] == 2 and c["runs_resumed"] == 46
    assert c["wave_resort_keys"] < len(data)
    ev = [f for t, f in _events(r.journal) if t == "wave_resume"]
    assert ev == [{"wave": 2, "missing": 2, "present": 6, "reason": "restart_resume"}]


def test_wave_stale_manifest_detection(tmp_path):
    data = np.random.default_rng(11).integers(-(10**6), 10**6, 6000).astype(np.int32)
    flipped = data.copy()
    flipped[0] ^= 1
    for d, wave in ((data, 1500), (flipped, 1500), (flipped, 2000)):
        js, ps = _pair(tmp_path, wave_elems=wave, job_id="wstale", overlap=False)
        _both(js, ps, d)
        assert ps.counters()["runs_resumed"] == 0


# -- the fault matrix ---------------------------------------------------------


def test_wave_mid_ring_loss_repairs_in_flight(tmp_path):
    """A loss inside wave 2's ring re-sorts that wave's runs on the host;
    the other waves stay on the mesh."""
    data = np.random.default_rng(12).integers(-(10**6), 10**6, 24000).astype(np.int32)
    js, ps = _pair(tmp_path, wave_elems=4000, job_id="wfault", overlap=False)
    for s in (js, ps):
        calls = {"n": 0}

        def hook(s=s, calls=calls):
            calls["n"] += 1
            if calls["n"] == 3:
                raise s.failure(5, "ring")

        s.sorter.fault_hook = hook
    _same_bits(_both(js, ps, data), np.sort(data))
    c = ps.counters()
    assert c["wave_runs_resorted"] == 8 and c["waves_sorted"] == 5


@pytest.mark.parametrize("records", [False, True], ids=["keys", "records"])
def test_wave_host_repair_phases_are_timed(tmp_path, records):
    """The host repair of a wave is split into timed phases inside
    ``wave_repair``: the range selection, the sort and the spill."""
    if records:
        src = str(tmp_path / "in.bin")
        gen_terasort_file(src, 8000, seed=24)
        ps = Side(True, tmp_path / "port", records=True, wave_recs=2000, job_id="rp",
                  overlap=False)
    else:
        data = np.random.default_rng(25).integers(-(10**6), 10**6, 16000).astype(np.int32)
        ps = Side(True, tmp_path / "port", wave_elems=4000, job_id="rp", overlap=False)
    calls = {"n": 0}

    def hook():
        calls["n"] += 1
        if calls["n"] == 2:
            raise WorkerFailure(5, "ring")

    ps.sorter.fault_hook = hook
    if records:
        ps.sorter.sort_file(src, str(tmp_path / "out.bin"), metrics=ps.metrics)
    else:
        _same_bits(ps.sorter.sort(data, metrics=ps.metrics), np.sort(data))
    assert ps.counters()["wave_runs_resorted"] == 8
    names = ("wave_repair_select", "wave_repair_sort", "wave_repair_spill")
    assert all(k in ps.metrics.phase_s for k in names)
    seq = [(e.type, e.fields["phase"]) for e in ps.journal.events()
           if e.type in ("phase_start", "phase_end") and e.fields["phase"].startswith("wave_rep")]
    assert seq == [("phase_start", "wave_repair")] + [
        (t, k) for k in names for t in ("phase_start", "phase_end")
    ] + [("phase_end", "wave_repair")]


CUDA_LOST = "CUDA error: unspecified launch failure"


@pytest.mark.parametrize("records", [False, True], ids=["keys", "records"])
@pytest.mark.parametrize("overlap", [False, True], ids=["inline", "overlap"])
@pytest.mark.parametrize("where", ["dispatch", "retire"])
def test_wave_cuda_error_propagates_and_the_rerun_resumes(tmp_path, records, overlap, where):
    """A CUDA runtime error in wave 2 (a classified device error: sticky on
    the card) propagates: no wave is re-sorted on the host.  Waves 0 and 1
    are durable, and the re-run resumes them and sorts the rest on the
    mesh."""
    from dsort_tpu_torch.scheduler.fault import classify_runtime_error

    assert classify_runtime_error(RuntimeError(CUDA_LOST)) == "device"
    n, wave = (12000, 2000) if records else (24000, 4000)
    if records:
        src = str(tmp_path / "in.bin")
        gen_terasort_file(src, n, seed=21)
        raw = np.fromfile(src, np.uint8).reshape(-1, 100)
        kw = dict(records=True, wave_recs=wave)
    else:
        data = np.random.default_rng(22).integers(-(10**6), 10**6, n).astype(np.int32)
        kw = dict(wave_elems=wave)

    def run(side):
        if records:
            out = str(tmp_path / "out.bin")
            side.sorter.sort_file(src, out, metrics=side.metrics)
            return np.fromfile(out, np.uint8).reshape(-1, 100)
        return side.sorter.sort(data, metrics=side.metrics)

    ps = Side(True, tmp_path / "port", job_id="cuda_err", overlap=overlap, **kw)
    if where == "dispatch":
        calls = {"n": 0}

        def hook():
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError(CUDA_LOST)

        ps.sorter.fault_hook = hook
    else:
        retire = ps.sorter._retire_wave

        def failing_retire(w, *a):
            if w == 2:
                raise RuntimeError(CUDA_LOST)
            return retire(w, *a)

        ps.sorter._retire_wave = failing_retire
    with pytest.raises(RuntimeError, match="unspecified launch failure"):
        run(ps)
    assert ps.counters()["wave_runs_resorted"] == 0
    assert "wave_resume" not in ps.journal.types()
    done = ShardCheckpoint(str(tmp_path / "port"), "cuda_err").completed_wave_runs()
    assert sorted({w for w, _ in done}) == [0, 1] and len(done) == 16

    again = Side(True, tmp_path / "port", job_id="cuda_err", overlap=overlap, **kw)
    got = run(again)
    if records:
        np.testing.assert_array_equal(got, _tera_oracle(raw))
    else:
        _same_bits(got, np.sort(data))
    c = again.counters()
    assert c["runs_resumed"] == 16 and c["waves_sorted"] == 4 and c["wave_runs_resorted"] == 0


@pytest.mark.parametrize("mode", ["replicate", "parity"])
def test_wave_coded_repair_no_host_resort(tmp_path, mode):
    """A coded wave repairs a mid-ring loss from its plane: one
    ``coded_recover`` / ``parity_recover`` for wave 1, zero runs
    re-sorted; a re-run restores every coded run."""
    data = gen_uniform(1 << 15, seed=7)
    kw = dict(wave_elems=1 << 13, job_id="cw", redundancy=2, redundancy_mode=mode,
              overlap=False)
    js, ps = _pair(tmp_path, **kw)
    for s in (js, ps):
        s.inj.fail_once(3, "ring")
        s.sorter.fault_hook = s.sweep_hook(on_call=2)
    _same_bits(_both(js, ps, data), np.sort(data))
    c = ps.counters()
    assert c["coded_recoveries"] == 1 and c["wave_runs_resorted"] == 0
    assert c["waves_sorted"] == 4
    rec = [f for t, f in _events(ps.journal) if t in ("coded_recover", "parity_recover")]
    assert len(rec) == 1 and rec[0]["wave"] == 1 and rec[0]["dead"] == [3]
    js, ps = _pair(tmp_path, **kw)
    _both(js, ps, data)
    assert ps.counters()["runs_resumed"] == 32 and ps.counters()["waves_sorted"] == 0


def test_wave_coded_over_budget_degrades_to_host_resort(tmp_path):
    data = gen_uniform(1 << 14, seed=9)
    js, ps = _pair(tmp_path, wave_elems=1 << 13, job_id="cw2", redundancy=2, resume=False,
                   overlap=False)
    for s in (js, ps):
        s.inj.fail_sequence([(3, "ring"), (4, "ring")])
        s.sorter.fault_hook = s.sweep_hook()
    _same_bits(_both(js, ps, data), np.sort(data))
    types = ps.journal.types()
    assert "coded_budget_exceeded" in types and "wave_resume" in types
    assert ps.counters()["wave_runs_resorted"] == 8


def test_wave_knob_resolution_matches_jax(tmp_path, caplog):
    """A coded wave overrides ``fused`` to ``ring``; ``hier`` under 4
    workers downgrades; ``alltoall`` maps to ``ring``."""
    cases = [(8, dict(exchange="fused", redundancy=2)), (2, dict(exchange="hier")),
             (8, dict(exchange="alltoall")), (8, dict(job_kw=dict(exchange="hier",
                                                               hier_hosts=4)))]
    for p, kw in cases:
        js, ps = _pair(tmp_path, p, wave_elems=1 << 12, job_id="k", **kw)
        for attr in ("exchange", "redundancy", "redundancy_mode", "hier_hosts"):
            assert getattr(ps.sorter, attr) == getattr(js.sorter, attr), (p, kw, attr)
    data = gen_uniform(1 << 13, seed=13)
    js, ps = _pair(tmp_path, wave_elems=1 << 12, job_id="kf", exchange="fused", redundancy=2)
    _both(js, ps, data)


def test_wave_crash_drill_through_the_cli(tmp_path):
    """``DSORT_WAVE_DIE_AFTER_WAVE=1`` in a child process running the port's
    ``cli external --mesh 8 --device cpu``: exit 17 with waves 0-1 durable
    (16 runs, fsynced before the rename); the re-run restores them and
    sorts only waves 2-5.  The JAX package resumes the same store alike."""
    data = np.random.default_rng(13).integers(-(10**6), 10**6, 24000).astype(np.int32)
    in_path = str(tmp_path / "in.bin")
    data.tofile(in_path)
    args = ["external", in_path, "-o", str(tmp_path / "out.bin"), "--mesh", "8",
            "--wave-elems", "4000", "--spill-dir", str(tmp_path / "sp"), "--job-id", "wkill",
            "--device", "cpu"]
    env = {**os.environ, "PYTHONPATH": REPO, DIE_AFTER_WAVE_ENV: "1"}
    r = subprocess.run([sys.executable, "-m", "dsort_tpu_torch.cli", *args], env=env,
                       capture_output=True, text=True, timeout=240, cwd=str(tmp_path))
    assert r.returncode == 17, r.stderr[-2000:]
    done = [n for n in os.listdir(tmp_path / "sp" / "wkill") if n.startswith("aux_w")]
    assert len(done) == 16 and not any(".tmp" in n for n in done)
    shutil.copytree(tmp_path / "sp", tmp_path / "jax")
    js, ps = Side(False, tmp_path / "jax", wave_elems=4000, job_id="wkill", overlap=False), \
        Side(True, tmp_path / "sp", wave_elems=4000, job_id="wkill", overlap=False)
    _same_bits(_both(js, ps, data), np.sort(data))
    c = ps.counters()
    assert c["runs_resumed"] == 16 and c["runs_sorted"] == 32
    assert c["wave_runs_resorted"] == 0
    assert cli.main(args) == 0
    _same_bits(np.fromfile(str(tmp_path / "out.bin"), np.int32), np.sort(data))


def test_cli_external_mesh_journal(tmp_path):
    data = np.random.default_rng(16).integers(-(2**31), 2**31 - 1, 16000).astype(np.int32)
    in_path, out_path = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    jpath = str(tmp_path / "journal.jsonl")
    data.tofile(in_path)
    assert cli.main(["external", in_path, "-o", out_path, "--mesh", "8", "--wave-elems", "4000",
                     "--spill-dir", str(tmp_path / "spill"), "--journal", jpath,
                     "--device", "cpu", "--exchange", "hier", "--no-overlap"]) == 0
    _same_bits(np.fromfile(out_path, dtype=np.int32), np.sort(data))
    types = [r["type"] for r in EventLog.read_jsonl(jpath)]
    assert types.count("wave_start") == 4 and types.count("wave_done") == 4
    assert "hier_exchange_plan" in types and "skew_report" in types


# -- TeraSort record waves ----------------------------------------------------


def _tera_oracle(raw):
    k1, k2 = record_keys(raw)
    return raw[np.lexsort((k2, k1))]


def _tera_both(tmp_path, n, wave, job_id, prep=None, **kw):
    in_path = str(tmp_path / f"{job_id}.bin")
    if not os.path.exists(in_path):
        gen_terasort_file(in_path, n, seed=14)
    js, ps = _pair(tmp_path, records=True, wave_recs=wave, job_id=job_id, overlap=False, **kw)
    if prep is not None:
        prep(js, ps)
    outs = []
    for s in (js, ps):
        out = str(s.root / f"{job_id}.out")
        os.makedirs(s.root, exist_ok=True)
        s.sorter.sort_file(in_path, out, metrics=s.metrics)
        outs.append(np.fromfile(out, np.uint8).reshape(-1, 100))
    raw = np.fromfile(in_path, np.uint8).reshape(-1, 100)
    np.testing.assert_array_equal(outs[1], _tera_oracle(raw))
    np.testing.assert_array_equal(outs[1], outs[0])
    _compare(js, ps, ordered=True)
    assert ps.manifest(job_id) == js.manifest(job_id)
    return ps


def test_wave_terasort_matches_jax(tmp_path):
    ps = _tera_both(tmp_path, 12000, 3000, "tw")
    assert ps.counters()["waves_sorted"] == 4


def test_wave_terasort_partial_resume_across_packages(tmp_path):
    ps = _tera_both(tmp_path, 12000, 3000, "twp")

    def drop(js, ps):
        os.remove(ps.root / "twp" / "aux_w00001_00004.npy")
        shutil.rmtree(js.root)
        shutil.copytree(ps.root, js.root)

    ps = _tera_both(tmp_path, 12000, 3000, "twp", prep=drop)
    c = ps.counters()
    assert c["wave_runs_resorted"] == 1 and c["runs_resumed"] == 31


def test_wave_terasort_coded_retention_repair(tmp_path):
    """A coded record wave repairs from the retained host rows:
    ``coded_recover`` with ``mode="retain"`` and ``replica_bytes=0``, zero
    runs re-sorted."""
    def arm(js, ps):
        for s in (js, ps):
            s.inj.fail_once(3, "ring")
            s.sorter.fault_hook = s.sweep_hook()

    ps = _tera_both(tmp_path, 8000, 2048, "twc", prep=arm, redundancy=2)
    rec = [f for t, f in _events(ps.journal) if t == "coded_recover"]
    assert len(rec) == 1 and rec[0]["mode"] == "retain" and rec[0]["replica_bytes"] == 0
    assert ps.counters()["wave_runs_resorted"] == 0


def test_cli_terasort_external_mesh(tmp_path):
    in_path, out_path = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    gen_terasort_file(in_path, 8000, seed=18)
    assert cli.main(["terasort", in_path, "-o", out_path, "--external", "--mesh", "8",
                     "--run-recs", "2000", "--spill-dir", str(tmp_path / "spill"),
                     "--job-id", "twcli", "--device", "cpu"]) == 0
    raw = np.fromfile(in_path, np.uint8).reshape(-1, 100)
    np.testing.assert_array_equal(np.fromfile(out_path, np.uint8).reshape(-1, 100),
                                  _tera_oracle(raw))
    assert len(ShardCheckpoint(str(tmp_path / "spill"), "twcli").completed_wave_runs()) == 32
