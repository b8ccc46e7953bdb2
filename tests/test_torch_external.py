"""The port's single-device out-of-core sorts against the JAX package's.

`ExternalSort` and `ExternalTeraSort` run on the same seeded inputs
through both packages (the port on the CPU, its kernels' plain versions):
sorted bits, run counters and the run store's manifest must be equal.  The
cross-package cases let one package spill a job's runs and the other
resume it after run files are deleted, re-sorting only those; ``cli
external`` and ``cli terasort --external`` close the file.  The reference
merges with its native heap merge where it is built (``native_merges``);
the port always takes the numpy fallback, so that counter is left out.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from dsort_tpu.cli import main as jax_cli_main
from dsort_tpu.data.ingest import gen_terasort_file
from dsort_tpu.models.external_sort import ExternalSort as JaxExternalSort
from dsort_tpu.models.external_sort import ExternalTeraSort as JaxExternalTeraSort
from dsort_tpu.models.external_sort import _fingerprint as jax_fingerprint
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.checkpoint import ShardCheckpoint
from dsort_tpu_torch.config import ConfigError, ExternalConfig
from dsort_tpu_torch.models.external_sort import (
    ExternalSort,
    ExternalTeraSort,
    _fingerprint,
    record_keys,
)
from dsort_tpu_torch.utils.events import EventLog
from dsort_tpu_torch.utils.metrics import Metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_COUNTERS = ("runs_sorted", "runs_resumed")


def _counters(m):
    return {k: m.counters.get(k, 0) for k in RUN_COUNTERS}


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(f"u{a.dtype.itemsize}"), b.view(f"u{b.dtype.itemsize}"))


def _keys(n, dtype, seed):
    rng = np.random.default_rng(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype)
        x[::53] = np.nan
        x[::59] = -0.0
        x[::61] = np.inf
        x[::67] = -np.inf
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)


def _both(tmp_path, data, run, job_id, **kw):
    """Sort with both packages; equal bits and run counters.  Returns the
    port's output and metrics."""
    jm, pm = JaxMetrics(), Metrics()
    jo = JaxExternalSort(run_elems=run, spill_dir=str(tmp_path / "jax"), job_id=job_id,
                         **kw).sort(data, metrics=jm)
    po = ExternalSort(run_elems=run, spill_dir=str(tmp_path / "port"), job_id=job_id,
                      device="cpu", **kw).sort(data, metrics=pm)
    _same_bits(po, jo)
    assert _counters(pm) == _counters(jm)
    return po, pm


@pytest.mark.parametrize("n,run", [(0, 64), (1, 64), (100, 64), (1000, 128), (4096, 512),
                                   (5000, 777)])
def test_external_matches_jax(tmp_path, n, run):
    data = _keys(n, np.int32, n)
    out, _ = _both(tmp_path, data, run, f"t{n}")
    _same_bits(out, np.sort(data))


@pytest.mark.parametrize("dtype", [np.int64, np.uint32, np.uint64, np.int16, np.uint8,
                                   np.float32, np.float64])
def test_external_dtypes_match_jax(tmp_path, dtype):
    """Every key dtype, floats with NaN / ±0.0 / ±inf riding as ordered
    uints; the stores' manifests (``storage_dtype`` included) are equal."""
    data = _keys(3000, dtype, 5)
    _both(tmp_path, data, 512, "d")
    man = {p: ShardCheckpoint(str(tmp_path / p), "d").manifest() for p in ("jax", "port")}
    assert man["port"] == man["jax"]
    assert man["port"]["storage_dtype"] == (
        f"uint{8 * np.dtype(dtype).itemsize}" if np.dtype(dtype).kind == "f"
        else np.dtype(dtype).name)


def test_external_partial_run_with_sentinel_keys(tmp_path):
    """The final partial run's trim keeps real max-valued keys."""
    sent = np.iinfo(np.int32).max
    data = np.array([5, sent, 1, sent, 3, 2, 7, sent, 0], dtype=np.int32)
    out, _ = _both(tmp_path, data, 4, "sent")
    _same_bits(out, np.sort(data))


def test_external_resume_skips_finished_runs(tmp_path):
    data = _keys(1000, np.int32, 7) % 1000
    _, m1 = _both(tmp_path, data, 100, "resume")
    assert m1.counters["runs_sorted"] == 10
    _, m2 = _both(tmp_path, data, 100, "resume")
    assert _counters(m2) == {"runs_sorted": 0, "runs_resumed": 10}
    _, m3 = _both(tmp_path, data, 100, "resume", resume=False)
    assert m3.counters["runs_sorted"] == 10


def test_external_partial_resume_after_simulated_crash(tmp_path):
    """A crash at the 4th submit loses the run in flight too: runs 0..1 are
    on disk, runs 2..6 re-sort on resume."""
    data = _keys(700, np.int32, 8) % 1000
    s = ExternalSort(run_elems=100, spill_dir=str(tmp_path), job_id="crash", device="cpu")
    calls = {"n": 0}
    orig = s._submit_run

    def dying(chunk):
        if calls["n"] == 3:
            raise RuntimeError("injected crash")
        calls["n"] += 1
        return orig(chunk)

    s._submit_run = dying
    with pytest.raises(RuntimeError, match="injected crash"):
        s.sort(data)
    s._submit_run = orig
    m = Metrics()
    _same_bits(s.sort(data, metrics=m), np.sort(data))
    assert _counters(m) == {"runs_resumed": 2, "runs_sorted": 5}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_external_store_resumes_across_packages(tmp_path, writer):
    """A job one package finished, with run files 2 and 5 deleted, resumes in
    the other: 6 runs restore, 2 re-sort, the output is numpy's."""
    data = _keys(4000, np.float32, 9)
    cls = {"jax": lambda: JaxExternalSort(run_elems=500, spill_dir=str(tmp_path), job_id="x"),
           "port": lambda: ExternalSort(run_elems=500, spill_dir=str(tmp_path), job_id="x",
                                        device="cpu")}
    first = cls[writer]().sort(data)
    ck = ShardCheckpoint(str(tmp_path), "x")
    os.remove(ck._shard_path(2))
    os.remove(ck._shard_path(5))
    m = (Metrics if writer == "jax" else JaxMetrics)()
    out = cls["port" if writer == "jax" else "jax"]().sort(data, metrics=m)
    _same_bits(out, first)
    assert _counters(m) == {"runs_resumed": 6, "runs_sorted": 2}


def test_external_reused_job_id_detects_different_data(tmp_path):
    a = _keys(500, np.int32, 12) % 1000
    b = _keys(500, np.int32, 13) % 1000
    for data, run in ((a, 100), (b, 100), (b, 250)):
        out, m = _both(tmp_path, data, run, "same")
        _same_bits(out, np.sort(data))
        assert m.counters["runs_resumed"] == 0


def test_external_binary_file_roundtrip_and_memmap_out(tmp_path):
    data = _keys(5000, np.int32, 9)
    in_path, out_path = str(tmp_path / "in.bin"), str(tmp_path / "out.bin")
    data.tofile(in_path)
    s = ExternalSort(run_elems=1024, spill_dir=str(tmp_path / "spill"), job_id="file",
                     device="cpu")
    s.sort_binary_file(in_path, out_path, dtype=np.int32)
    _same_bits(np.fromfile(out_path, dtype=np.int32), np.sort(data))
    s.sort_binary_file(in_path, str(tmp_path / "out.npy"), dtype=np.int32)
    _same_bits(np.load(str(tmp_path / "out.npy")), np.sort(data))
    u = _keys(2000, np.uint32, 10)
    mm = np.memmap(str(tmp_path / "o.raw"), dtype=np.uint32, mode="w+", shape=(2000,))
    s2 = ExternalSort(run_elems=256, spill_dir=str(tmp_path / "spill"), job_id="mm",
                      device="cpu")
    assert s2.sort(u, out=mm) is mm
    mm.flush()
    _same_bits(np.fromfile(str(tmp_path / "o.raw"), dtype=np.uint32), np.sort(u))


def test_external_single_run_result_is_owned_and_empty_file(tmp_path):
    s = ExternalSort(run_elems=100, spill_dir=str(tmp_path), job_id="own", device="cpu")
    out = s.sort(np.array([3, 1, 2], dtype=np.int32))
    assert out.flags.writeable
    out[0] = 7
    in_path, out_path = str(tmp_path / "e.bin"), str(tmp_path / "e.out")
    open(in_path, "wb").close()
    s.sort_binary_file(in_path, out_path, dtype=np.int32)
    assert os.path.getsize(out_path) == 0


def test_fingerprint_is_the_references():
    for data in (_keys(1000, np.int64, 1), _keys(3, np.float32, 2), _keys(1, np.uint8, 3)):
        assert _fingerprint(data) == jax_fingerprint(data)


def test_external_config_defaults_and_checks():
    from dsort_tpu.config import ExternalConfig as JaxExternalConfig

    assert ExternalConfig() == ExternalConfig(**vars(JaxExternalConfig()))
    for bad in (dict(run_elems=1), dict(wave_elems=1), dict(mesh=0)):
        with pytest.raises(ConfigError):
            ExternalConfig(**bad)
    with pytest.raises(ValueError):
        ExternalSort(run_elems=1, device="cpu")


# -- TeraSort records -----------------------------------------------------------


def _tera_oracle(path):
    raw = np.fromfile(path, dtype=np.uint8).reshape(-1, 100)
    k1, k2 = record_keys(raw)
    return raw[np.lexsort((k2, k1))]


@pytest.mark.parametrize("n,run", [(3000, 512), (33, 64), (1500, 400)])
def test_external_terasort_matches_jax(tmp_path, n, run):
    in_path = str(tmp_path / "t.bin")
    gen_terasort_file(in_path, n, seed=n)
    outs, ms = {}, {}
    for name, cls, mcls in (("jax", JaxExternalTeraSort, JaxMetrics),
                            ("port", ExternalTeraSort, Metrics)):
        kw = {"device": "cpu"} if name == "port" else {}
        ms[name] = mcls()
        cls(run_recs=run, spill_dir=str(tmp_path / name), job_id="t", **kw).sort_file(
            in_path, str(tmp_path / f"{name}.bin"), metrics=ms[name])
        outs[name] = np.fromfile(str(tmp_path / f"{name}.bin"), np.uint8).reshape(-1, 100)
    np.testing.assert_array_equal(outs["port"], _tera_oracle(in_path))
    np.testing.assert_array_equal(outs["port"], outs["jax"])
    assert _counters(ms["port"]) == _counters(ms["jax"])
    assert ms["port"].counters["runs_sorted"] == -(-n // run)


def test_external_terasort_prefix_collisions(tmp_path):
    """Records with equal 8-byte prefixes order by key bytes 8-9."""
    raw = np.random.default_rng(4).integers(0, 256, (1000, 100)).astype(np.uint8)
    raw[:, :8] = 7
    in_path, out_path = str(tmp_path / "c.bin"), str(tmp_path / "c_sorted.bin")
    raw.tofile(in_path)
    ExternalTeraSort(run_recs=256, spill_dir=str(tmp_path / "spill"), job_id="t2",
                     device="cpu").sort_file(in_path, out_path)
    got = np.fromfile(out_path, dtype=np.uint8).reshape(-1, 100)
    np.testing.assert_array_equal(got, _tera_oracle(in_path))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_external_terasort_store_resumes_across_packages(tmp_path, writer):
    in_path = str(tmp_path / "r.bin")
    gen_terasort_file(in_path, 2000, seed=5)
    mk = {"jax": lambda: JaxExternalTeraSort(run_recs=512, spill_dir=str(tmp_path / "s"),
                                             job_id="t3"),
          "port": lambda: ExternalTeraSort(run_recs=512, spill_dir=str(tmp_path / "s"),
                                           job_id="t3", device="cpu")}
    mk[writer]().sort_file(in_path, str(tmp_path / "o1.bin"))
    os.remove(ShardCheckpoint(str(tmp_path / "s"), "t3")._shard_path(1))
    m = (Metrics if writer == "jax" else JaxMetrics)()
    mk["port" if writer == "jax" else "jax"]().sort_file(in_path, str(tmp_path / "o2.bin"),
                                                           metrics=m)
    assert _counters(m) == {"runs_resumed": 3, "runs_sorted": 1}
    got = np.fromfile(str(tmp_path / "o2.bin"), np.uint8).reshape(-1, 100)
    np.testing.assert_array_equal(got, _tera_oracle(in_path))


def test_external_terasort_empty(tmp_path):
    empty, out_e = str(tmp_path / "e.bin"), str(tmp_path / "e_sorted.bin")
    open(empty, "wb").close()
    ExternalTeraSort(run_recs=64, spill_dir=str(tmp_path / "spill"), job_id="t5",
                     device="cpu").sort_file(empty, out_e)
    assert os.path.getsize(out_e) == 0


# -- the CLI ------------------------------------------------------------------


def test_cli_external_matches_jax(tmp_path, caplog):
    """``external`` without ``--mesh``: the same bytes as ``dsort
    external``; ``--exchange`` and ``--redundancy`` warn there."""
    import logging

    data = _keys(3000, np.int32, 11)
    in_path = str(tmp_path / "in.bin")
    data.tofile(in_path)
    assert jax_cli_main(["external", in_path, "-o", str(tmp_path / "j.bin"),
                         "--run-elems", "512", "--spill-dir", str(tmp_path / "js")]) == 0
    logger = logging.getLogger("dsort_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger="dsort_tpu_torch"):
            assert cli.main(["external", in_path, "-o", str(tmp_path / "p.bin"),
                             "--run-elems", "512", "--spill-dir", str(tmp_path / "ps"),
                             "--device", "cpu", "--exchange", "ring", "--redundancy", "2",
                             "--journal", str(tmp_path / "j.jsonl")]) == 0
    finally:
        logger.removeHandler(caplog.handler)
    assert "--exchange has no effect" in caplog.text
    assert "--redundancy has no effect" in caplog.text
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    _same_bits(np.fromfile(str(tmp_path / "p.bin"), np.int32), np.sort(data))
    phases = {r["phase"] for r in EventLog.read_jsonl(str(tmp_path / "j.jsonl"))
              if r["type"] == "phase_end"}
    assert phases == {"run_generation", "merge"}


def test_cli_terasort_external_validates(tmp_path):
    """``terasort --external`` in a child process on the CPU, then ``cli
    validate`` of the output against the input."""
    in_path, out_path = str(tmp_path / "cli.bin"), str(tmp_path / "cli_sorted.bin")
    env = {**os.environ, "PYTHONPATH": REPO}

    def run(*a):
        return subprocess.run([sys.executable, "-m", "dsort_tpu_torch.cli", *a], env=env,
                              capture_output=True, text=True, timeout=240, cwd=str(tmp_path))

    assert run("gen", "600", "-o", in_path, "--dist", "terasort").returncode == 0
    r = run("terasort", in_path, "-o", out_path, "--external", "--run-recs", "256",
            "--spill-dir", str(tmp_path / "spill"), "--device", "cpu")
    assert r.returncode == 0, r.stderr
    v = run("validate", out_path, "--against", in_path, "--terasort")
    assert v.returncode == 0, v.stdout + v.stderr
    np.testing.assert_array_equal(np.fromfile(out_path, np.uint8).reshape(-1, 100),
                                  _tera_oracle(in_path))
    shutil.rmtree(tmp_path / "spill")


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_ordered_uint_carrier_is_the_references(tmp_path, dtype):
    """The ordered uints the stores hold (`float_to_ordered_uint`, derived
    from the signed carrier) are the reference's bits, from a read-only
    memmap too; the inverse gives the reference's floats (NaNs canonical);
    `sort_float_keys_via_uint` sorts as numpy does and carries a tuple's
    tail through."""
    from dsort_tpu.ops import float_order as jfo

    from dsort_tpu_torch.ops import float_order as fo

    rng = np.random.default_rng(23)
    info = np.finfo(dtype)
    x = np.concatenate([
        (rng.standard_normal(400) * 100).astype(dtype),
        np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, info.tiny, -info.tiny,
                  info.smallest_subnormal, -info.smallest_subnormal, info.max, info.min],
                 dtype),
    ])
    path = tmp_path / "x.bin"
    x.tofile(path)
    ro = np.memmap(path, dtype=dtype, mode="r")
    want = np.asarray(jfo.float_to_ordered_uint(x))
    for src in (x, ro):
        got = fo.float_to_ordered_uint(src)
        assert got.dtype == want.dtype == fo.ordered_uint_dtype(dtype)
        np.testing.assert_array_equal(got, want)
    _same_bits(fo.ordered_uint_to_float(want, dtype),
               np.asarray(jfo.ordered_uint_to_float(want, dtype)))
    with pytest.raises(TypeError):
        fo.ordered_uint_to_float(want.view(f"i{want.dtype.itemsize}"), dtype)
    out, tail = fo.sort_float_keys_via_uint(lambda u: (np.sort(u), "tail"), x)
    assert tail == "tail"
    _same_bits(out, np.asarray(jfo.ordered_uint_to_float(np.sort(want), dtype)))
