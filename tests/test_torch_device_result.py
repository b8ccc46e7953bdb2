"""The port's device-resident results against the JAX package's.

`DeviceSortResult` keeps the sorted rows on the device: ``to_host()`` is the
only copy of keys to the host, ``consume(fn)`` hands the padded rows to a
next stage, ``validate_on_device()`` runs ``dsort validate``'s order check
and FNV-1a multiset checksum where the keys are.  Every case of
``tests/test_device_resident.py`` but the batch, checkpoint and bench ones
runs through both packages on the same seeded numpy input — JAX on the
8-device CPU mesh (its fused ring under the Pallas interpreter), the port
with ``device="cpu"`` — and compares exactly: per-shard lengths, offsets,
host bytes, the whole padded rows a stage sees (pads included), checksums,
counters and the journal's order.
"""

import threading

import numpy as np
import pytest
import torch

from dsort_tpu.cli import main as jax_cli_main
from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data.ingest import gen_uniform, gen_zipf
from dsort_tpu.models import validate as jv
from dsort_tpu.models.pipelines import fused_sort_small as jax_fused_sort_small
from dsort_tpu.parallel.device_result import DeviceSortResult as JaxDeviceSortResult
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort
from dsort_tpu.scheduler import FaultInjector as JaxFaultInjector
from dsort_tpu.scheduler import SpmdScheduler as JaxSpmdScheduler
from dsort_tpu.utils.events import EventLog as JaxEventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.models import validate as tv
from dsort_tpu_torch.models.pipelines import fused_sort_small
from dsort_tpu_torch.parallel import DeviceSortResult
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.scheduler import FaultInjector, SpmdScheduler
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

INT_DTYPES = [np.int32, np.int64, np.uint32, np.uint64, np.int8, np.uint8, np.int16, np.uint16]
EXCHANGES = ["alltoall", "ring", "fused"]
DEVICE_COUNTERS = ("device_handles", "device_validates", "device_consumes",
                   "device_handle_reruns", "mesh_reforms")
DEVICE_EVENTS = {"job_start", "attempt_start", "worker_dead", "mesh_reform", "job_done",
                 "device_handle", "device_handle_invalidated", "device_validate",
                 "device_consume", "result_fetch"}


def _host_sum(a: np.ndarray) -> int:
    return jv._multiset(a, len(a), a.dtype.itemsize)


def _keys(dtype, n, seed):
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(info.min, info.max, n, dtype=dtype, endpoint=True)


def _view(handle, port: bool) -> np.ndarray:
    """The flat padded rows a next stage receives (not donated)."""
    if port:
        return handle.consume(lambda x: x.clone(), donate=False).numpy()
    return np.asarray(handle.consume(lambda x: x, donate=False))


def _same_handles(jh, th):
    """Both handles equal: lengths, offsets, host bytes, the whole padded
    rows (pads at the dtype's maximum), the device checksum."""
    assert th.dtype == jh.dtype and len(th) == len(jh) and th.num_shards == jh.num_shards
    np.testing.assert_array_equal(th.shard_lengths, jh.shard_lengths)
    np.testing.assert_array_equal(th.offsets, jh.offsets)
    tview, jview = _view(th, True), _view(jh, False)
    assert tview.dtype == jview.dtype and np.array_equal(tview, jview)
    rows = tview.reshape(th.num_shards, -1)
    for i, c in enumerate(th.shard_lengths):
        assert (rows[i, c:] == np.iinfo(th.dtype).max).all()
    trep, jrep = th.validate_on_device(), jh.validate_on_device()
    assert (trep.records, trep.sorted_ok, trep.checksum) == (
        jrep.records, jrep.sorted_ok, jrep.checksum)
    host = th.to_host()
    assert host.dtype == jh.dtype and np.array_equal(host, jh.to_host())
    return trep, host


def test_device_result_round_trip(mesh8):
    """The round trip: validate ok on the device, checksum equal to the host
    `_multiset`, to_host equal to np.sort, the counters and events of the
    reference, offsets recovering the layout."""
    data = gen_uniform(120_000, seed=3)
    jm = JaxMetrics(journal=JaxEventLog())
    m = Metrics(journal=EventLog())
    jh = JaxSampleSort(mesh8).sort(data, metrics=jm, keep_on_device=True)
    h = SampleSort(VirtualMesh(8, "cpu")).sort(data, metrics=m, keep_on_device=True)
    assert h.valid and len(h) == len(data) and h.num_shards == 8
    rep, host = _same_handles(jh, h)
    assert rep.sorted_ok and rep.records == len(data) and rep.first_violation is None
    assert rep.checksum == _host_sum(data) == tv._multiset(data, len(data), 4)
    np.testing.assert_array_equal(host, np.sort(data))
    assert h.offsets[-1] == len(data) and (np.diff(h.offsets) == h.shard_lengths).all()
    for k in ("device_handles", "device_validates", "device_consumes"):
        assert m.counters[k] == jm.counters[k], k
    ours = [t for t in m.journal.types() if t in DEVICE_EVENTS]
    theirs = [t for t in jm.journal.types() if t in DEVICE_EVENTS]
    assert ours == theirs and "phase_start" in m.journal.types()
    assert "assemble" not in m.phase_s


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_device_result_dtypes_and_exchanges(mesh8, dtype, exchange):
    """Every integer dtype under every exchange: the handle's rows (pads
    at the dtype's maximum), lengths, offsets, host bytes and checksum;
    against the JAX package's handle for every dtype under alltoall and for
    uint64 and int8 under ring and fused."""
    data = _keys(dtype, 30_000, 11)
    h = SampleSort(VirtualMesh(8, "cpu")).sort(
        data, keep_on_device=True, exchange=exchange)
    if exchange == "alltoall" or dtype in (np.uint64, np.int8):
        jh = JaxSampleSort(mesh8, JaxJobConfig(key_dtype=dtype)).sort(
            data, keep_on_device=True, exchange=exchange)
        rep, host = _same_handles(jh, h)
    else:
        rep, host = h.validate_on_device(), h.to_host()
        rows = h._rows().numpy()
        for i, c in enumerate(h.shard_lengths):
            assert (rows[i, c:] == np.iinfo(dtype).max).all()
    assert rep.sorted_ok and rep.checksum == _host_sum(data)
    assert host.dtype == dtype and np.array_equal(host, np.sort(data))


def test_device_result_sentinel_keys_and_duplicates(mesh8):
    """Real sentinel-valued keys and heavy duplicates pass: pads are
    excluded by count, not by value."""
    rng = np.random.default_rng(13)
    data = rng.integers(-50, 50, 40_000).astype(np.int32)
    data[::91] = np.iinfo(np.int32).max
    jh = JaxSampleSort(mesh8).sort(data, keep_on_device=True)
    h = SampleSort(VirtualMesh(8, "cpu")).sort(data, keep_on_device=True)
    rep, _ = _same_handles(jh, h)
    assert rep.sorted_ok and rep.records == len(data) and rep.checksum == _host_sum(data)


def test_device_result_skew_capacity_retry(mesh8):
    """A capacity retry mid-dispatch still yields a valid handle."""
    data = np.concatenate([np.full(30_000, 9, np.int32), gen_uniform(8_000, seed=5)])
    jm, m = JaxMetrics(), Metrics()
    jh = JaxSampleSort(mesh8, JaxJobConfig(capacity_factor=1.0)).sort(
        data, metrics=jm, keep_on_device=True)
    h = SampleSort(VirtualMesh(8, "cpu"), JobConfig(capacity_factor=1.0)).sort(
        data, metrics=m, keep_on_device=True)
    assert m.counters["capacity_retries"] == jm.counters["capacity_retries"] >= 1
    rep, host = _same_handles(jh, h)
    assert rep.sorted_ok and np.array_equal(host, np.sort(data))


def test_device_validate_detects_unsorted_rows():
    """An in-row order break is caught (the reference's plain-jit case)."""
    import jax.numpy as jnp

    rows = np.array([[3, 1, 2, 7], [8, 9, 10, 11]], np.int32)
    jrep = JaxDeviceSortResult(jnp.asarray(rows.reshape(-1)), shard_lengths=np.array([4, 4]),
                               n=8).validate_on_device()
    rep = DeviceSortResult(torch.from_numpy(rows), [4, 4], 8).validate_on_device()
    assert not rep.sorted_ok and rep.records == 8
    assert (rep.sorted_ok, rep.checksum) == (jrep.sorted_ok, jrep.checksum)


def test_device_validate_detects_boundary_violation(mesh8):
    """A cross-shard boundary break is caught (the reference's shard_map
    case): every row sorted, rows in descending key ranges.  The checksum
    is order-independent and still exact."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    rows = np.stack([np.arange(100, 116, dtype=np.int32) + 16 * ((7 - i) % 8) for i in range(8)])
    arr = jax.device_put(rows.reshape(-1), NamedSharding(mesh8, P("w")))
    jrep = JaxDeviceSortResult(arr, shard_lengths=np.full(8, 16), n=128, mesh=mesh8,
                               axis="w").validate_on_device()
    rep = DeviceSortResult(torch.from_numpy(rows), np.full(8, 16), 128).validate_on_device()
    assert not rep.sorted_ok and not jrep.sorted_ok
    assert rep.checksum == jrep.checksum == _host_sum(rows.reshape(-1))


@pytest.mark.parametrize("case", ["empty rows between", "leading empty rows", "break across empty",
                                  "equal at boundary", "one row"])
def test_device_validate_boundary_cases_match_jax(case):
    """The cross-row check skips empty rows and compares each nonempty row
    with the nearest nonempty row before it, as the reference's scan does;
    pads never take part."""
    import jax.numpy as jnp

    big = np.iinfo(np.int32).max
    rows, counts = {
        "empty rows between": ([[1, 2, big], [big] * 3, [big] * 3, [2, 5, big]], [2, 0, 0, 2]),
        "leading empty rows": ([[big] * 3, [big] * 3, [4, 4, 4], [5, 6, big]], [0, 0, 3, 2]),
        "break across empty": ([[1, 9, big], [big] * 3, [8, 10, big], [11, big, big]], [2, 0, 2, 1]),
        "equal at boundary": ([[1, 3, 3], [3, 3, big], [big] * 3, [3, 4, big]], [3, 2, 0, 2]),
        "one row": ([[5, 4, big]], [2]),
    }[case]
    rows, counts = np.array(rows, np.int32), np.array(counts)
    n = int(counts.sum())
    jrep = JaxDeviceSortResult(jnp.asarray(rows.reshape(-1)), shard_lengths=counts,
                               n=n).validate_on_device()
    rep = DeviceSortResult(torch.from_numpy(rows), counts, n).validate_on_device()
    assert (rep.records, rep.sorted_ok, rep.checksum) == (jrep.records, jrep.sorted_ok,
                                                          jrep.checksum)
    assert rep.sorted_ok == (case in ("empty rows between", "leading empty rows",
                                      "equal at boundary"))


@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_device_fnv_matches_jax_and_host(dtype):
    """The per-key FNV-1a (int64 bits) equals the JAX package's uint64 hash
    key for key, and its masked sum equals the host `_multiset`."""
    import jax.numpy as jnp

    keys = _keys(dtype, (3, 1000), 21)
    want = np.asarray(jv._fnv1a_u64(jnp.asarray(keys)))
    got = tv._fnv1a_u64(torch.from_numpy(keys)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    ok, checksum, total = tv._rows_order_and_checksum(
        torch.from_numpy(np.sort(keys, axis=1)), torch.tensor([1000, 0, 700]))
    assert int(total) == 1700
    assert int(checksum) & tv._MASK64 == _host_sum(
        np.concatenate([np.sort(keys[0]), np.sort(keys[2])[:700]]))


def test_device_validate_corruption_changes_checksum(mesh8):
    """Flipping one key's value flips the checksum: the permutation proof
    has teeth."""
    data = gen_uniform(20_000, seed=7)
    rep = SampleSort(VirtualMesh(8, "cpu")).sort(data, keep_on_device=True).validate_on_device()
    jrep = JaxSampleSort(mesh8).sort(data, keep_on_device=True).validate_on_device()
    corrupted = data.copy()
    corrupted[123] ^= 1
    assert rep.checksum == jrep.checksum == _host_sum(data) != _host_sum(corrupted)


def test_device_result_consume_chains_stage(mesh8):
    """consume() runs a next stage over the padded rows (donated) and
    consumes the handle: later reads refuse.  The stage's output equals
    the JAX package's, pads included."""
    data = gen_uniform(50_000, seed=17)
    jm, m = JaxMetrics(journal=JaxEventLog()), Metrics(journal=EventLog())
    jh = JaxSampleSort(mesh8).sort(data, metrics=jm, keep_on_device=True)
    h = SampleSort(VirtualMesh(8, "cpu")).sort(data, metrics=m, keep_on_device=True)
    lengths = h.shard_lengths.copy()
    got = h.consume(lambda x: x.bitwise_xor_(1)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.consume(lambda x: x ^ 1)))
    cap = got.size // 8
    expect = np.sort(data) ^ 1
    for i, (lo, ci) in enumerate(zip(h.offsets, lengths)):
        np.testing.assert_array_equal(got[i * cap : i * cap + ci], expect[lo : lo + ci])
    assert m.counters["device_consumes"] == jm.counters["device_consumes"] == 1
    assert m.journal.types()[-1] == "device_consume" == jm.journal.types()[-1]
    assert not h.valid and "consumed" in repr(h)
    with pytest.raises(RuntimeError, match="consumed"):
        h.to_host()
    with pytest.raises(RuntimeError, match="consumed"):
        h.validate_on_device()


def test_device_result_consume_without_donation_keeps_handle(mesh8):
    """An out-of-place stage without donation leaves the handle live."""
    data = gen_uniform(9_000, seed=19)
    h = SampleSort(VirtualMesh(8, "cpu")).sort(data, keep_on_device=True)
    out = h.consume(lambda x: x + 0, donate=False)
    assert h.valid and out.shape == h._rows().reshape(-1).shape
    np.testing.assert_array_equal(h.to_host(), np.sort(data))
    assert h.to_host() is h.to_host()  # the one copy is cached


def test_device_result_empty_and_float_refusal(mesh8):
    jh = JaxSampleSort(mesh8).sort(np.empty(0, np.int32), keep_on_device=True)
    h = SampleSort(VirtualMesh(8, "cpu")).sort(np.empty(0, np.int32), keep_on_device=True)
    assert len(h) == 0 and h.num_shards == jh.num_shards == 1
    rep = h.validate_on_device()
    assert rep.sorted_ok and rep.records == 0 and rep.checksum == 0
    assert h.to_host().size == 0 and h.to_host().dtype == np.int32
    for sort in (SampleSort(VirtualMesh(8, "cpu")).sort, JaxSampleSort(mesh8).sort):
        with pytest.raises(TypeError, match="integer keys"):
            sort(np.zeros(10, np.float32), keep_on_device=True)


def test_device_result_torn_buffer_and_missing_hook_raise():
    """to_host refuses lengths that do not sum to n; an invalidated handle
    without a re-run hook refuses every read; repr shows the state."""
    rows = torch.arange(8, dtype=torch.int32).view(2, 4)
    torn = DeviceSortResult(rows, [4, 3], 8)
    with pytest.raises(RuntimeError, match="sum to 7, expected 8"):
        torn.to_host()
    h = DeviceSortResult(rows, [4, 4], 8)
    assert repr(h) == "DeviceSortResult(n=8, shards=2, dtype=int32, live)"
    h.invalidate("mesh_reform")
    assert not h.valid and "invalidated(mesh_reform)" in repr(h) and h.dtype == np.int32
    for read in (h.to_host, h.validate_on_device, lambda: h.consume(lambda x: x)):
        with pytest.raises(RuntimeError, match="no re-run hook"):
            read()


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int16, np.uint8])
def test_fused_sort_small_keep_on_device(dtype):
    """The fused route: one upload and the padded row's sort, no download;
    the handle (one shard, label ``fused``) equals the JAX package's and
    reads correctly from another thread."""
    data = _keys(dtype, 10_000, 23)
    jm, m = JaxMetrics(), Metrics()
    jh = jax_fused_sort_small(data, metrics=jm, keep_on_device=True)
    h = fused_sort_small(data, metrics=m, keep_on_device=True, device="cpu")
    assert h.num_shards == 1 and len(h) == len(data) and h.label == jh.label == "fused"
    box = {}
    reader = threading.Thread(target=lambda: box.update(rep=_same_handles(jh, h)))
    reader.start()
    reader.join(timeout=60)
    assert not reader.is_alive()
    rep, host = box["rep"]
    assert rep.sorted_ok and rep.checksum == _host_sum(data)
    np.testing.assert_array_equal(host, np.sort(data))
    assert m.counters["device_handles"] == jm.counters["device_handles"] == 1
    empty = fused_sort_small(np.empty(0, dtype), keep_on_device=True, device="cpu")
    assert len(empty) == 0 and empty.to_host().dtype == dtype
    with pytest.raises(TypeError, match="integer keys"):
        fused_sort_small(np.zeros(4, np.float64), keep_on_device=True, device="cpu")


def _drill_side(port: bool):
    if port:
        inj = FaultInjector()
        sched = SpmdScheduler(8, "cpu", JobConfig(settle_delay_s=0.01), inj)
        return inj, sched, Metrics(journal=EventLog())
    inj = JaxFaultInjector()
    sched = JaxSpmdScheduler(job=JaxJobConfig(settle_delay_s=0.01), injector=inj)
    return inj, sched, JaxMetrics(journal=JaxEventLog())


def _device_timeline(m):
    return [t for t in m.journal.types() if t in DEVICE_EVENTS]


def test_spmd_scheduler_device_resident_fault_drill(mesh8):
    """A mesh re-form invalidates a handle made before it (device_handle_invalidated
    after mesh_reform), and the handle re-runs once on the surviving mesh:
    the counters and the journal's order equal the reference's."""
    data = gen_uniform(60_000, seed=31)
    sides = []
    for port in (False, True):
        inj, sched, m = _drill_side(port)
        h = sched.sort(data, metrics=m, keep_on_device=True)
        assert h.valid
        inj.fail_once(2, "spmd")
        sched.sort(gen_uniform(8_000, seed=32), metrics=m)
        assert m.counters["mesh_reforms"] == 1 and not h.valid
        np.testing.assert_array_equal(h.to_host(), np.sort(data))
        assert h.valid and m.counters["device_handle_reruns"] == 1
        rep = h.validate_on_device()
        assert rep.sorted_ok and rep.checksum == _host_sum(data)
        types = m.journal.types()
        assert types.index("mesh_reform") < types.index("device_handle_invalidated")
        sides.append((h, m))
    (jh, jm), (h, m) = sides
    # The re-run is a new job: per-job revival brings worker 2 back.
    assert h.num_shards == jh.num_shards == 8
    np.testing.assert_array_equal(h.shard_lengths, jh.shard_lengths)
    assert {k: m.counters.get(k, 0) for k in DEVICE_COUNTERS} == {
        k: jm.counters.get(k, 0) for k in DEVICE_COUNTERS}
    assert _device_timeline(m) == _device_timeline(jm)
    inval = [e.fields for e in m.journal.events() if e.type == "device_handle_invalidated"]
    assert [(f["reason"], f["n"]) for f in inval] == [("mesh_reform", 1)]


def test_spmd_scheduler_device_resident_survives_injected_failure(mesh8):
    """A worker lost during the device-resident sort itself: the scheduler
    re-forms and the handle it returns is already the re-run's."""
    data = gen_zipf(50_000, a=1.2, seed=33)
    handles = []
    for port in (False, True):
        inj, sched, m = _drill_side(port)
        inj.fail_once(3, "spmd")
        h = sched.sort(data, metrics=m, keep_on_device=True)
        assert m.counters["mesh_reforms"] == 1 and "device_handle_invalidated" not in m.journal.types()
        handles.append(h)
    rep, host = _same_handles(*handles)
    assert rep.sorted_ok and np.array_equal(host, np.sort(data))


def test_spmd_scheduler_device_resident_float_refusal():
    for sched in (JaxSpmdScheduler(job=JaxJobConfig()), SpmdScheduler(8, "cpu")):
        with pytest.raises(TypeError, match="integer keys"):
            sched.sort(np.zeros(8, np.float32), keep_on_device=True)


def test_cli_run_device_resident(tmp_path):
    """`run --device-resident` through both CLIs: the same output bytes,
    exit 0, the device events in the journal and ``result_fetch`` once."""
    rng = np.random.default_rng(37)
    inp = tmp_path / "in.txt"
    inp.write_text("\n".join(str(x) for x in rng.integers(0, 10**6, 4000)))
    outs = {}
    for name, main in (("jax", jax_cli_main), ("port", cli.main)):
        out, journal = tmp_path / f"{name}.txt", tmp_path / f"{name}.jsonl"
        extra = ["--device", "cpu"] if name == "port" else []
        rc = main(["run", str(inp), "-o", str(out), "--device-resident",
                   "--journal", str(journal)] + extra)
        assert rc == 0
        types = [r["type"] for r in EventLog.read_jsonl(str(journal))]
        assert "device_handle" in types and "device_validate" in types
        assert types.count("result_fetch") == 1
        outs[name] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    got = np.array(outs["port"].split(), dtype=np.int64)
    assert len(got) == 4000 and (np.diff(got) >= 0).all()


def test_cli_run_device_resident_needs_spmd(tmp_path):
    inp = tmp_path / "in.txt"
    inp.write_text("3\n1\n")
    errors = []
    for main, extra in ((jax_cli_main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(["run", str(inp), "--device-resident", "--mode", "taskpool"] + extra)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "--device-resident requires --mode spmd"


def test_cli_run_device_resident_fails_on_a_bad_checksum(tmp_path, monkeypatch):
    """A permutation the checksum rejects exits 1, the output still written."""
    inp, out = tmp_path / "in.txt", tmp_path / "out.txt"
    inp.write_text("5\n2\n9\n")
    monkeypatch.setattr(tv, "_multiset", lambda *a: 0)
    assert cli.main(["run", str(inp), "-o", str(out), "--device-resident",
                     "--device", "cpu"]) == 1
    assert out.read_text() == "2\n5\n9\n"
