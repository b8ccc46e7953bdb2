"""The port's ring and fused exchanges against the JAX package's.

The plan helpers (`ladder_rungs`, `ring_step_quantum`, `step_maxes`,
`ring_caps`, `ring_wire_bytes`, `skew_stats`) must equal JAX's on seeded
histograms.  Whole sorts: the same seeded numpy keys go through JAX
``SampleSort(mesh)`` on the CPU mesh — its fused ring under the Pallas
interpreter, as ``tests/test_ring_kernel.py`` runs it — and the port's
``SampleSort(VirtualMesh(P, "cpu"))``; the sorted bits, the per-shard counts
(``sort_ranges``), the journaled per-step caps and the wire-byte counter
must be identical, with no capacity retry.  The port also runs with its
block kernels forced on (their plain versions: the eager merge tower and
the rank-plane merge network), where the same results must hold.
"""

import dataclasses
import functools
import types
import zlib

import numpy as np
import pytest
import torch

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.ops import float_order as jfo
from dsort_tpu.parallel import exchange as jex
from dsort_tpu.parallel.mesh import local_device_mesh
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort
from dsort_tpu.utils.events import EventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.ops import float_order as fo
from dsort_tpu_torch.ops import ring_kernel as rk
from dsort_tpu_torch.parallel import exchange as ex
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.utils.metrics import Metrics


class _Journal:
    """The port's `Metrics` journal seam, recording ``(type, fields)``."""

    def __init__(self):
        self.events = []

    def emit(self, etype, **fields):
        self.events.append((etype, fields))
        return types.SimpleNamespace(mono=0.0)


def _histograms():
    rng = np.random.default_rng(5)
    uni = rng.integers(900, 1100, (8, 8))
    zipf = np.minimum(rng.zipf(1.3, (8, 8)) * 100, 50_000)
    return {"uniform": (uni, 1_000 * 8), "zipf": (zipf, 60_000), "seven": (uni[:7, :7], 7_000)}


@pytest.mark.parametrize("name", ["uniform", "zipf", "seven"])
def test_plan_helpers_match_jax(name):
    hist, n_local = _histograms()[name]
    p = hist.shape[0]
    assert ex.ladder_rungs(n_local) == jex.ladder_rungs(n_local)
    assert ex.ladder_rungs(n_local, 100) == jex.ladder_rungs(n_local, 100)
    assert ex.ring_step_quantum(n_local, p) == jex.ring_step_quantum(n_local, p)
    assert ex.step_maxes(hist, p) == jex.step_maxes(hist, p)
    caps = ex.ring_caps(hist, n_local, p)
    assert caps == jex.ring_caps(hist, n_local, p)
    assert ex.ring_wire_bytes(caps, 12, p) == jex.ring_wire_bytes(caps, 12, p)
    assert ex.alltoall_wire_bytes(1024, 100, p) == jex.alltoall_wire_bytes(1024, 100, p)
    assert ex.skew_stats(hist, p) == jex.skew_stats(hist, p)
    for e in ("alltoall", "ring", "fused"):
        assert ex.dispatches_per_exchange(e, p) == jex.dispatches_per_exchange(e, p)
        assert ex.resolve_exchange(e, "ring", p) == jex.resolve_exchange(e, "ring", p)
    assert ex.resolve_exchange(None, "fused", 1) == "alltoall"
    assert rk._step_offsets(caps) == [0] + list(np.cumsum(caps))


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name.startswith("uniform_"):
        return rng.integers(-(2**31), 2**31, int(name.split("_")[1])).astype(np.int32)
    if name == "zipf_int64":
        return np.minimum(rng.zipf(1.3, 20_000), 2**62).astype(np.int64)
    if name == "all_equal":
        return np.full(6_000, 7, np.int32)
    if name == "sentinel":
        x = rng.integers(-100, 100, 9_000).astype(np.int32)
        x[:200] = np.iinfo(np.int32).max
        return x
    if name == "float32_nan":
        x = rng.normal(size=5_000).astype(np.float32)
        x[::97] = np.nan
        return x
    if name == "seven_shards":
        return rng.integers(-(10**6), 10**6, 7_001).astype(np.int32)
    if name == "empty":
        return np.zeros(0, np.int32)
    if name == "one":
        return np.array([-7], np.int32)
    raise KeyError(name)


CASES = ["uniform_64", "uniform_5000", "uniform_40000", "zipf_int64", "all_equal",
         "sentinel", "float32_nan", "seven_shards", "empty", "one"]


def _p(name):
    return 7 if name == "seven_shards" else 8


def _plan_record(events):
    """Per-step caps (in step order) from the ``exchange_step`` events."""
    return [f["cap"] for t, f in events if t == "exchange_step"]


@functools.lru_cache(maxsize=None)
def _jax_result(name, exchange):
    x = _case(name)
    ss = JaxSampleSort(local_device_mesh(_p(name)), JaxJobConfig())
    m = JaxMetrics(journal=EventLog())
    out = ss.sort(x, m, exchange=exchange)
    rx = jfo.float_to_ordered_uint(x) if x.dtype.kind == "f" else x
    counts = [len(r) for r in ss.sort_ranges(rx, exchange=exchange)]
    events = [(e.type, e.fields) for e in m.journal.events()]
    return out, counts, _plan_record(events), dict(m.counters)


@pytest.mark.parametrize("kernels", ["from_jax", "block"])
@pytest.mark.parametrize("exchange", ["ring", "fused"])
@pytest.mark.parametrize("name", CASES)
def test_ring_sort_matches_jax(name, exchange, kernels):
    x = _case(name)
    want, want_counts, want_caps, want_counters = _jax_result(name, exchange)
    job = JobConfig.from_dict(dataclasses.asdict(JaxJobConfig()))
    if kernels == "block":
        job = dataclasses.replace(job, local_kernel="block", merge_kernel="block_merge")
    ss = SampleSort(VirtualMesh(_p(name), "cpu"), job)
    m = Metrics(journal=_Journal())
    out = ss.sort(x, m, exchange=exchange)
    assert out.dtype == want.dtype and out.shape == want.shape
    np.testing.assert_array_equal(out.view(f"u{out.dtype.itemsize}"),
                                  want.view(f"u{want.dtype.itemsize}"))
    rx = fo.float_to_ordered_int(torch.from_numpy(x)).numpy() if x.dtype.kind == "f" else x
    assert [len(r) for r in ss.sort_ranges(rx, exchange=exchange)] == want_counts
    assert _plan_record(m.journal.events) == want_caps
    for counter in ("exchange_bytes_on_wire", "exchange_bytes_saved", "exchange_ring_steps",
                    "fused_exchange_launches", "fused_exchange_steps"):
        assert m.counters.get(counter, 0) == want_counters.get(counter, 0), counter
    assert m.counters.get("capacity_retries", 0) == 0
    if exchange == "fused" and len(x) > 0:
        assert m.counters["fused_exchange_launches"] == 1
        assert m.counters["fused_exchange_steps"] == _p(name) - 1


def test_ring_plan_journals_skew_and_resize_like_jax():
    """The zipf plan's skew report and resized steps, event for event."""
    x = _case("zipf_int64")
    jm = JaxMetrics(journal=EventLog())
    JaxSampleSort(local_device_mesh(8), JaxJobConfig()).sort(x, jm, exchange="ring")
    m = Metrics(journal=_Journal())
    SampleSort(VirtualMesh(8, "cpu")).sort(x, m, exchange="ring")
    keep = ("skew_report", "exchange_step", "exchange_resize")
    want = [(e.type, {k: v for k, v in e.fields.items() if k != "job"})
            for e in jm.journal.events() if e.type in keep]
    got = [(t, {k: v for k, v in f.items() if k != "job"})
           for t, f in m.journal.events if t in keep]
    assert got == want
    assert any(t == "exchange_resize" for t, _ in got)


def test_alltoall_wire_bytes_match_jax():
    x = _case("zipf_int64")  # overflows once: both attempts are charged
    jm = JaxMetrics()
    JaxSampleSort(local_device_mesh(8), JaxJobConfig()).sort(x, jm)
    m = Metrics()
    SampleSort(VirtualMesh(8, "cpu")).sort(x, m)
    assert m.counters["exchange_bytes_on_wire"] == jm.counters["exchange_bytes_on_wire"]
    assert m.counters["capacity_retries"] == jm.counters["capacity_retries"] == 1


def test_ring_exchange_plain_layout():
    """The exchange's plain version against a direct construction: slot k
    of row d holds source (d-k)'s bucket for d, sentinel-padded to the
    power-of-two slot, odd slots reversed; kv tags and payload rows follow
    the reference's flat step layout."""
    rng = np.random.default_rng(40)
    p, n_local, rb = 5, 50, 3
    xs = np.sort(rng.integers(-99, 99, (p, n_local)), axis=1).astype(np.int64)
    cuts = np.sort(rng.integers(0, n_local + 1, (p, p - 1)), axis=1)
    starts = np.concatenate([np.zeros((p, 1), np.int64), cuts], axis=1)
    lens = np.diff(np.concatenate([starts, np.full((p, 1), n_local)], axis=1), axis=1)
    caps = tuple(max(8, -(-max(lens[s, (s + k) % p] for s in range(p)) // 8) * 8) for k in range(p))
    payload = rng.integers(0, 256, (p, n_local, rb), dtype=np.uint8)
    wk, wt, wv = rk.ring_exchange(*(torch.from_numpy(a) for a in (xs, starts, lens)), caps,
                                  torch.from_numpy(payload))
    slot, p2 = rk._slot_len(caps), 8
    offs, total = rk._step_offsets(caps), sum(caps)
    sent = np.iinfo(np.int64).max
    wk, wt, wv = wk.numpy().reshape(p, p2, slot), wt.numpy().reshape(p, p2, slot), wv.numpy()
    for d in range(p):
        for k in range(p2):
            want_k = np.full(slot, sent)
            want_t = 2 * total + np.arange(slot)
            if k < p:
                s = (d - k) % p
                ln = lens[s, d]
                want_k[:ln] = xs[s, starts[s, d]: starts[s, d] + ln]
                pos = np.arange(caps[k])
                want_t[: caps[k]] = offs[k] + pos + (pos >= ln) * total
                np.testing.assert_array_equal(
                    wv[d, offs[k]: offs[k] + ln], payload[s, starts[s, d]: starts[s, d] + ln])
                assert not wv[d, offs[k] + ln: offs[k] + caps[k]].any()
            if k % 2:
                want_k, want_t = want_k[::-1], want_t[::-1]
            np.testing.assert_array_equal(wk[d, k], want_k)
            np.testing.assert_array_equal(wt[d, k], want_t)
    tags = torch.from_numpy(rng.integers(-2, 2 * total, (p, total)).astype(np.int32))
    got = rk.gather_rows(torch.from_numpy(wv), tags).numpy()
    t = tags.numpy()
    src = np.where((t >= 0) & (t < total), t, 0)
    np.testing.assert_array_equal(got, np.take_along_axis(wv, src[:, :, None], axis=1))
    assert not any(rk.launch_counts().values())  # CPU tensors: plain versions only


@pytest.mark.parametrize("row_bytes", [1, 13, 92])
def test_gather_rows_plain_reads_strided_tags(row_bytes):
    """The gather's plain version on tags that are a leading slice of wider
    rows (tag stride above ``total``, as the merged workspace gives them),
    ``total`` not a multiple of 32, tags below 0 and at or above ``total``
    (row 0), against numpy."""
    rng = np.random.default_rng(row_bytes)
    p, total = 3, 45
    ws = rng.integers(0, 256, (p, total, row_bytes), dtype=np.uint8)
    wide = rng.integers(-4, 2 * total, (p, total + 19)).astype(np.int32)
    wide[:, :3] = [-1, total, 0]
    tags = torch.from_numpy(wide)[:, :total]
    assert tags.stride(0) > total
    got = rk.gather_rows(torch.from_numpy(ws), tags).numpy()
    t = wide[:, :total]
    src = np.where((t >= 0) & (t < total), t, 0)
    np.testing.assert_array_equal(got, np.take_along_axis(ws, src[:, :, None], axis=1))
    assert not any(rk.launch_counts().values())


def test_fused_needs_cuda_or_cpu_tensors():
    x = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    z = torch.zeros((2, 2), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        rk.ring_exchange(x, z, z, (8, 8))
    with pytest.raises(ValueError, match="int32 room"):
        rk.ring_exchange(torch.zeros((2, 8), dtype=torch.int32),
                         torch.zeros((2, 2), dtype=torch.int64),
                         torch.zeros((2, 2), dtype=torch.int64), (2**29, 8),
                         torch.zeros((2, 8, 4), dtype=torch.uint8))


@pytest.mark.parametrize("exchange", ["ring", "fused"])
def test_cli_run_exchange_flag(tmp_path, exchange):
    from dsort_tpu_torch import cli

    x = _case("uniform_5000")
    src, dst = tmp_path / "input.txt", tmp_path / "output.txt"
    src.write_text("".join(f"{v}\n" for v in x.tolist()))
    argv = ["run", str(src), "-o", str(dst), "--device", "cpu", "--exchange", exchange]
    assert cli.main(argv) == 0
    assert dst.read_bytes() == "".join(f"{v}\n" for v in np.sort(x).tolist()).encode()
