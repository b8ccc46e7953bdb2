"""The roofline's byte count, interval unions and gaps, the trace's
reduction and the device readers, on made-up intervals."""

import json

import pytest

from sortbench import manifest, trace, yardstick
from sortbench.record import Job, Run

H100 = "NVIDIA H100 80GB HBM3"


def test_sort_bytes_read_once_written_once():
    assert yardstick.sort_bytes(1 << 26, 4) == 536_870_912
    assert yardstick.sort_bytes(1 << 23, 100) == 1_677_721_600
    assert yardstick.hbm_peak(H100) == 3.35e12
    assert yardstick.hbm_peak("some other card") is None


def test_union_counts_overlap_once():
    ivs = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert yardstick.union_length(ivs) == pytest.approx(5.0)
    assert sum(e - s for s, e in ivs) == pytest.approx(6.2)  # a sum counts twice
    assert yardstick.union_length(ivs, 1.5, 8.5) == pytest.approx(1.5 + 1 + 0.5)
    assert yardstick.merged([(3, 4), (0, 1), (1, 2)]) == [(0, 2), (3, 4)]
    assert yardstick.gaps(ivs, -1, 10) == [(-1, 0), (3, 5), (6, 8), (9, 10)]
    assert yardstick.gaps([], 0, 1) == [(0, 1)]
    assert yardstick.overlap([(0, 4), (6, 8)], [(3, 7)]) == pytest.approx(2.0)


def _chrome(tmp_path):
    ev = []

    def x(cat, name, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur})

    for j, t in enumerate((1000.0, 3000.0)):  # two jobs of 1,000 us
        x("user_annotation", "sortbench:job", t, 1000)
        x("user_annotation", "dsort:partition", t, 400)
        x("user_annotation", "dsort:assemble", t + 700, 300)
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", t + 100, 200)
        x("kernel", f"void k<int>(int*, long){'' if j else ' '}", t + 400, 100)
        x("kernel", "void k2(int*)", t + 450, 100)  # overlaps the first kernel
        x("gpu_memset", "Memset (Device)", t + 600, 10)
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", t + 750, 200)
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", t + 560, 20)
    x("kernel", "void outside()", 0.0, 500)  # before the window
    ev.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 1500})
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return trace.read(p)


def test_trace_reduction(tmp_path):
    tr = _chrome(tmp_path)
    assert tr.window == pytest.approx((1e-3, 4e-3)) and tr.window_s == pytest.approx(3e-3)
    per_job_busy = 200 + 150 + 10 + 200 + 20  # us, the two kernels' union 150
    assert tr.busy_s() == pytest.approx(2 * per_job_busy * 1e-6)
    assert tr.busy_s(("kernel",)) == pytest.approx(2 * 150e-6)
    assert tr.busy_s(("gpu_memcpy",), trace.COPY_DIRECTIONS) == pytest.approx(2 * 400e-6)
    assert tr.jobs_without_kernel() == []
    ops = dict(map(tuple, tr.device_ops()))
    assert ops["void k<int>"] == pytest.approx(200e-6) and "void outside" not in ops
    idle = dict(map(tuple, tr.idle_by_phase()))
    # each job: idle 0-100 and 300-400 in partition; 550-560, 580-600 and
    # 610-700 outside; 700-750 and 950-1000 in assemble; and 1,000 us between.
    assert idle["dsort:partition"] == pytest.approx(2 * 200e-6)
    assert idle["dsort:assemble"] == pytest.approx(2 * 100e-6)
    assert idle["outside dsort phases"] == pytest.approx(2 * 120e-6 + 1000e-6)
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s())


def test_a_job_without_kernels_is_named(tmp_path):
    tr = _chrome(tmp_path)
    tr.jobs.append((5e-3, 6e-3))
    assert tr.jobs_without_kernel() == [2]


def test_device_readers(tmp_path):
    tr = _chrome(tmp_path)
    conf = {"item_bytes": 4}
    jobs = [Job(0.0, 1.0, 1 << 20, {"partition": 0.5}, {"exchange_bytes_on_wire": 1 << 22}, True),
            Job(1.0, 2.0, 1 << 20, {"partition": 0.25}, {"exchange_bytes_on_wire": 1 << 22}, False)]
    rec = Run(conf, H100, 5.0, 0.0, jobs, tr)
    pkg = manifest.PKG

    def read(name):
        return manifest.load_module(manifest.reader_path(pkg, name)).read(rec)

    least = 2 * (1 << 20) * 4 / 3.35e12
    assert read("sort_roofline_pct.keys") == pytest.approx(100 * least / 150e-6)
    assert read("device_idle_pct.keys") == pytest.approx(100 * (1 - tr.busy_s() / 3e-3))
    assert read("copy_ms.records") == pytest.approx(0.4)
    assert read("partition_ms.keys") == pytest.approx(250.0)  # the captured job left out
    assert read("exchange_bytes_per_key.keys") == pytest.approx(4.0)
    assert read("keys_per_s") == pytest.approx(2 * (1 << 20) / 2.0)
    assert read("setup_s") == 5.0
    untraced = Run(conf, H100, 5.0, 0.0, jobs, None)
    assert manifest.load_module(manifest.reader_path(pkg, "copy_ms")).read(untraced) is None
    other = Run(conf, "another card", 5.0, 0.0, jobs, tr)
    assert manifest.load_module(manifest.reader_path(pkg, "sort_roofline_pct")).read(other) is None
