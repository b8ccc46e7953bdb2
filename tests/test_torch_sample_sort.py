"""The port's SampleSort against the JAX package's on the 8-device CPU mesh.

The same seeded numpy inputs go through JAX ``SampleSort(mesh8)`` and the
port's ``SampleSort(VirtualMesh(8, "cpu"), JobConfig.from_dict(asdict(job)))``.
The sorted output must be bit-identical, the per-shard counts
(``sort_ranges`` lengths) identical, and so must the ``capacity_retries``
counts.  The port also runs with its block kernels forced on (their plain
versions on the CPU), where the same three results must hold.  Also here:
the float_order, partition and ingest counterparts and ``cli run``.
"""

import dataclasses
import functools
import zlib

import numpy as np
import pytest
import torch

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.data import ingest as jingest
from dsort_tpu.data import partition as jpart
from dsort_tpu.ops import float_order as jfo
from dsort_tpu.parallel.mesh import local_device_mesh
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import ConfigError, JobConfig
from dsort_tpu_torch.data import ingest, partition
from dsort_tpu_torch.ops import float_order as fo
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.utils.metrics import Metrics

P = 8


def _float_specials(rng, n):
    x = (rng.standard_normal(n) * 1e3).astype(np.float32)
    specials = np.array(
        [np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-45, -1e-45], np.float32
    )
    x[rng.choice(n, 64, replace=False)] = np.resize(specials, 64)
    return x


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "uniform_int32":
        return rng.integers(-(2**31), 2**31, 40_000).astype(np.int32)
    if name == "zipf_int64":
        return np.minimum(rng.zipf(1.3, 20_000), 2**62).astype(np.int64)
    if name == "float32_nan":
        return _float_specials(rng, 20_000)
    if name == "empty":
        return np.zeros(0, np.int32)
    if name == "one":
        return np.array([-7], np.int32)
    if name == "odd_n_uint32":
        return rng.integers(0, 2**32, 1_003, dtype=np.uint64).astype(np.uint32)
    raise KeyError(name)


CASES = ["uniform_int32", "zipf_int64", "float32_nan", "empty", "one", "odd_n_uint32"]


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    """(sorted keys, per-shard counts, capacity_retries) from the JAX side."""
    x = _case(name)
    ss = JaxSampleSort(local_device_mesh(P), JaxJobConfig())
    m = JaxMetrics()
    out = ss.sort(x, m)
    rx = jfo.float_to_ordered_uint(x) if x.dtype.kind == "f" else x
    counts = [len(r) for r in ss.sort_ranges(rx)]
    return out, counts, m.counters.get("capacity_retries", 0)


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("kernels", ["from_jax", "block"])
@pytest.mark.parametrize("name", CASES)
def test_sample_sort_matches_jax(name, kernels):
    x = _case(name)
    want, want_counts, want_retries = _jax_result(name)
    job = JobConfig.from_dict(dataclasses.asdict(JaxJobConfig()))
    if kernels == "block":
        job = dataclasses.replace(job, local_kernel="block", merge_kernel="block_merge")
    ss = SampleSort(VirtualMesh(P, "cpu"), job)
    m = Metrics()
    out = ss.sort(x, m)
    assert out.dtype == want.dtype and out.shape == want.shape
    np.testing.assert_array_equal(_bits(out), _bits(want))
    rx = fo.float_to_ordered_int(torch.from_numpy(x)).numpy() if x.dtype.kind == "f" else x
    assert [len(r) for r in ss.sort_ranges(rx)] == want_counts
    assert m.counters.get("capacity_retries", 0) == want_retries


def test_single_worker_matches_jax():
    """P=1 short-circuits after the local sort in both packages."""
    x = _case("uniform_int32")[:5_000]
    want = JaxSampleSort(local_device_mesh(1), JaxJobConfig()).sort(x)
    ss = SampleSort(VirtualMesh(1, "cpu"))
    np.testing.assert_array_equal(ss.sort(x), want)
    assert [len(r) for r in ss.sort_ranges(x)] == [len(x)]


def test_zipf_case_takes_the_capacity_retry():
    assert _jax_result("zipf_int64")[2] >= 1


def test_float_sort_is_numpy_order_with_nans_last():
    x = _case("float32_nan")
    out = SampleSort(VirtualMesh(P, "cpu")).sort(x)
    np.testing.assert_array_equal(out, np.sort(x))  # NaN == NaN here
    assert np.isnan(out[-int(np.isnan(x).sum()):]).all()


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_float_order_matches_jax_bijection(dtype):
    """Port's signed carrier == the reference's ordered uint with its sign
    bit flipped; the round trip is bit-exact except canonicalized NaNs."""
    rng = np.random.default_rng(11)
    info = np.finfo(dtype)
    x = np.concatenate([
        (rng.standard_normal(500) * 100).astype(dtype),
        np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf, info.tiny,
                  -info.tiny, info.smallest_subnormal, -info.smallest_subnormal,
                  info.max, info.min], dtype),
    ])
    u = jfo.float_to_ordered_uint(x)
    top = np.array(1, u.dtype) << np.array(8 * u.dtype.itemsize - 1, u.dtype)
    s = fo.float_to_ordered_int(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(s.view(u.dtype), u ^ top)
    back = fo.ordered_int_to_float(torch.from_numpy(s), torch.from_numpy(x).dtype).numpy()
    np.testing.assert_array_equal(_bits(back), _bits(jfo.ordered_uint_to_float(u, dtype)))
    order = np.argsort(s, kind="stable")
    np.testing.assert_array_equal(x[order], np.sort(x))


@pytest.mark.parametrize("n,w", [(0, 8), (1, 8), (17, 4), (1_003, 8), (64, 1)])
@pytest.mark.parametrize("dtype", [np.int32, np.uint64])
def test_partition_matches_jax(n, w, dtype):
    data = np.arange(n, dtype=dtype)[::-1].copy()
    assert partition.equal_partition(n, w) == jpart.equal_partition(n, w)
    for a, b in zip(partition.partition(data, w), jpart.partition(data, w)):
        np.testing.assert_array_equal(a, b)
    shards, counts = partition.pad_to_shards(data, w)
    js, jc = jpart.pad_to_shards(data, w)
    np.testing.assert_array_equal(shards, js)
    np.testing.assert_array_equal(counts, jc)


def test_ingest_roundtrip_is_byte_compatible(tmp_path):
    rng = np.random.default_rng(12)
    x = rng.integers(-(2**31), 2**31, 2_000).astype(np.int32)
    ingest.write_ints_file(tmp_path / "a.txt", x)
    jingest.write_ints_file(tmp_path / "b.txt", x)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
    np.testing.assert_array_equal(ingest.read_ints_file(tmp_path / "a.txt"), x)


@pytest.mark.parametrize("text,dtype", [
    ("1\n3000000000\n", np.int32), ("-1\n", np.uint32),
    ("99999999999999999999\n", np.int64),
])
def test_ingest_out_of_range_raises(tmp_path, text, dtype):
    p = tmp_path / "in.txt"
    p.write_text(text)
    with pytest.raises(OverflowError):
        ingest.read_ints_file(p, dtype)


def test_cli_run_on_cpu_matches_numpy_formatting(tmp_path):
    rng = np.random.default_rng(13)
    x = rng.integers(-(2**31), 2**31, 5_000).astype(np.int32)
    src, dst = tmp_path / "input.txt", tmp_path / "output.txt"
    src.write_text("".join(f"{v}\n" for v in x.tolist()))
    assert cli.main(["run", str(src), "-o", str(dst), "--device", "cpu"]) == 0
    assert dst.read_bytes() == "".join(f"{v}\n" for v in np.sort(x).tolist()).encode()


def test_job_config_from_dict_and_validation():
    job = JobConfig.from_dict(dataclasses.asdict(
        JaxJobConfig(oversample=16, capacity_factor=2.0, max_capacity_retries=1)
    ))
    assert (job.oversample, job.capacity_factor, job.max_capacity_retries) == (16, 2.0, 1)
    for bad in (dict(hier_hosts=-1), dict(redundancy=0), dict(redundancy_mode="raid"),
                dict(merge_kernel="nope"), dict(exchange="nope"),
                dict(oversample=0), dict(capacity_factor=0.5)):
        with pytest.raises(ConfigError):
            JobConfig(**bad)
        with pytest.raises(Exception):  # the reference refuses the same values
            JaxJobConfig(**bad)
    # hier, radix and the coded plane are ported: from_dict carries them.
    knobs = dict(exchange="hier", hier_hosts=4, local_kernel="radix", redundancy=2,
                 redundancy_mode="parity")
    job = JobConfig.from_dict(dataclasses.asdict(JaxJobConfig(**knobs)))
    assert {k: getattr(job, k) for k in knobs} == knobs
    # So is the planner: from_dict carries autotune.
    assert JobConfig.from_dict(dataclasses.asdict(JaxJobConfig(autotune=True))).autotune is True
