"""The port's merges and pipelines against the JAX package's.

The same seeded numpy inputs go through ``dsort_tpu.ops.merge`` /
``dsort_tpu.models.pipelines`` (JAX on the 8-device CPU mesh) and their
counterparts in ``dsort_tpu_torch`` on the CPU: the host merges, the
on-device merge of shards, `pad_rung` over the reference's contract domain,
`fused_sort_small` (sentinel-valued keys, NaN floats, narrow key dtypes,
each local kernel's plain version) and `GatherMergeSort` (uniform, zipf,
the reference's golden 10,000 ints in 1..100).  Tolerance: bit-identical
outputs, equal phase names.
"""

import numpy as np
import pytest
import torch

from dsort_tpu.data.ingest import gen_uniform, gen_zipf
from dsort_tpu.data.ingest import read_ints_file as jax_read
from dsort_tpu.data.ingest import write_ints_file as jax_write
from dsort_tpu.data.partition import pad_to_shards
from dsort_tpu.models import pipelines as jpl
from dsort_tpu.ops import merge as jmerge
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch.data import ingest
from dsort_tpu_torch.models import pipelines as tpl
from dsort_tpu_torch.ops import merge as tmerge
from dsort_tpu_torch.ops.local_sort import sentinel_for, sort_padded
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.utils.metrics import Metrics

NARROW = ["int8", "uint8", "int16", "uint16", "float16"]


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(f"u{a.dtype.itemsize}")


def _same(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(_bits(got), _bits(want))


# -- host merges (tests/test_merge.py's cases) --------------------------------


def test_merge_sorted_host_matches_jax():
    rng = np.random.default_rng(3)
    chunks = [np.sort(rng.integers(-1000, 1000, n).astype(np.int32)) for n in (10, 0, 57, 3, 1000)]
    _same(tmerge.merge_sorted_host(chunks), jmerge.merge_sorted_host(chunks))
    _same(tmerge.merge_sorted_host(chunks), np.sort(np.concatenate(chunks)))


@pytest.mark.parametrize("chunks", [
    [], [np.array([1, 2, 3], np.int32)],
    [np.empty(0, np.int64), np.empty(0, np.int64)],
], ids=["none", "one", "all_empty_int64"])
def test_merge_sorted_host_single_and_empty(chunks):
    _same(tmerge.merge_sorted_host(chunks), jmerge.merge_sorted_host(chunks))


def test_merge_streaming_matches_jax():
    chunks = [np.array([1, 4, 7]), np.array([2, 5]), np.array([0, 9])]
    got = list(tmerge.merge_sorted_host_streaming(chunks))
    assert got == list(jmerge.merge_sorted_host_streaming(chunks)) == [0, 1, 2, 4, 5, 7, 9]


def test_merge_sorted_host_kv_is_stable_in_run_order():
    """Equal keys across runs keep run order: the payload rows (run id,
    position) come out exactly as the JAX package's."""
    rng = np.random.default_rng(9)
    keys, vals = [], []
    for r, n in enumerate((40, 0, 17, 33, 1)):
        k = np.sort(rng.integers(0, 12, n).astype(np.int64))
        keys.append(k)
        vals.append(np.stack([np.full(n, r), np.arange(n)], axis=1).astype(np.int32))
    gk, gv = tmerge.merge_sorted_host_kv(keys, vals)
    wk, wv = jmerge.merge_sorted_host_kv(keys, vals)
    _same(gk, wk)
    _same(gv, wv)
    order = np.lexsort((gv[:, 1], gv[:, 0], gk))
    assert np.array_equal(order, np.arange(len(gk)))
    ek, ev = tmerge.merge_sorted_host_kv([np.empty(0, np.int64)], [np.empty((0, 2), np.int32)])
    assert ek.shape == (0,) and ev.shape == (0, 2) and ev.dtype == np.int32


def test_merge_shards_device_matches_jax():
    import jax
    import jax.numpy as jnp

    from dsort_tpu.ops.local_sort import sort_padded as jax_sort_padded

    rng = np.random.default_rng(4)
    buf = rng.integers(-50, 50, (4, 8)).astype(np.int32)
    counts = np.array([8, 3, 0, 5], dtype=np.int32)
    js, jc = jax.vmap(jax_sort_padded)(jnp.asarray(buf), jnp.asarray(counts))
    jflat, jtotal = jmerge.merge_shards_device(js, jc)
    ts, tc = sort_padded(torch.from_numpy(buf), torch.from_numpy(counts))
    tflat, ttotal = tmerge.merge_shards_device(ts, tc)
    _same(tflat.numpy(), np.asarray(jflat))
    assert int(ttotal) == int(jtotal) == 16 and ttotal.dtype == torch.int32
    assert (tflat.numpy()[16:] == sentinel_for(np.int32)).all()


# -- pipelines (tests/test_pipelines.py's cases) -------------------------------


def test_pad_rung_matches_jax_over_the_contract_domain():
    domain = list(range(1, 1025)) + [4096, 4097, (1 << 20) - 3, 1 << 20]
    got = [tpl.pad_rung(n) for n in domain]
    assert got == [jpl.pad_rung(n) for n in domain]
    for n, out in zip(domain, got):
        assert out >= n and out >= 8 and out % 8 == 0
        assert out - n < max(8, 1 << max((n - 1).bit_length() - 3, 0))
    assert tpl.FUSED_SMALL_JOB_MAX == jpl.FUSED_SMALL_JOB_MAX == 1 << 20


def test_pad_for_fused_keeps_the_data():
    data = np.arange(1000, dtype=np.int64)[::-1].copy()
    buf = tpl.pad_for_fused(data)
    assert len(buf) == jpl.pad_rung(1000) == len(jpl.pad_for_fused(data))
    assert np.array_equal(buf[:1000], data) and buf.dtype == data.dtype


def test_local_pipeline_matches_jax():
    import jax.numpy as jnp

    data = gen_uniform(10_000, seed=7)
    shards, counts = pad_to_shards(data, 8)
    jflat, jtotal = jpl.local_pipeline_step(jnp.asarray(shards), jnp.asarray(counts))
    tflat, ttotal = tpl.local_pipeline(torch.from_numpy(shards), torch.from_numpy(counts))
    assert int(ttotal) == int(jtotal) == len(data)
    _same(tflat.numpy(), np.asarray(jflat))


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 16_384, 50_001])
def test_fused_sort_small_matches_jax(n):
    rng = np.random.default_rng(5)
    data = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    jm, tm = JaxMetrics(), Metrics()
    _same(tpl.fused_sort_small(data, metrics=tm, device="cpu"), jpl.fused_sort_small(data, metrics=jm))
    assert set(tm.phase_s) == set(jm.phase_s) == ({"partition", "local_sort", "assemble"} if n else set())


def test_fused_sort_small_sentinel_and_floats_match_jax():
    data = np.array([5, np.iinfo(np.int32).max, -1, np.iinfo(np.int32).max], np.int32)
    _same(tpl.fused_sort_small(data, device="cpu"), jpl.fused_sort_small(data))
    f = np.array([3.5, np.nan, -np.inf, 0.0, -0.0, np.inf, np.nan], np.float32)
    got = tpl.fused_sort_small(f, device="cpu")
    _same(got, jpl.fused_sort_small(f))
    assert np.isnan(got[-2:]).all()
    assert _bits(got[1:3]).tolist() == [0x80000000, 0]  # -0.0 before +0.0


@pytest.mark.parametrize("dtype", ["uint32", "int64", "uint64", "float64"])
def test_fused_sort_small_key_dtypes_match_jax(dtype):
    rng = np.random.default_rng(21)
    if dtype == "float64":
        data = rng.standard_normal(3_001)
        data[::97] = np.nan
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, 3_001, dtype=dtype, endpoint=True)
        data[:2] = [info.min, info.max]
    _same(tpl.fused_sort_small(data, device="cpu"), jpl.fused_sort_small(data))


@pytest.mark.parametrize("kernel", ["lax", "block", "bitonic", "pallas"])
def test_fused_sort_small_kernels_match_jax(kernel):
    """Each local kernel's plain version on the fused route gives the JAX
    route's bits (JAX's ``auto`` on the CPU is ``lax``)."""
    rng = np.random.default_rng(23)
    data = rng.integers(-(2**31), 2**31 - 1, 9_000, dtype=np.int64).astype(np.int32)
    data[::50] = np.iinfo(np.int32).max
    _same(tpl.fused_sort_small(data, kernel, device="cpu"), jpl.fused_sort_small(data))


@pytest.mark.parametrize("dtype", NARROW)
def test_fused_sort_small_narrow_dtypes_match_jax(dtype):
    rng = np.random.default_rng(29)
    if dtype == "float16":
        data = rng.standard_normal(2_000).astype(np.float16)
        data[::41] = np.nan
        data[1::41] = -0.0
    else:
        info = np.iinfo(dtype)
        data = rng.integers(info.min, info.max, 2_000, endpoint=True).astype(dtype)
    want = jpl.fused_sort_small(data)
    for kernel in ("auto", "block", "pallas"):
        _same(tpl.fused_sort_small(data, kernel, device="cpu"), want)


def test_fused_sort_small_refuses_device_results_and_needs_a_device(monkeypatch):
    """Device-resident results take integer keys only (float keys raise, as
    in the reference); the route needs a device unless the CPU is asked."""
    with pytest.raises(TypeError, match="integer keys"):
        tpl.fused_sort_small(np.arange(4, dtype=np.float32), keep_on_device=True, device="cpu")
    h = tpl.fused_sort_small(np.arange(4, dtype=np.int32)[::-1].copy(), keep_on_device=True,
                             device="cpu")
    assert h.to_host().tolist() == [0, 1, 2, 3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.fused_sort_small(np.arange(4, dtype=np.int32))


@pytest.mark.parametrize("n", [0, 1, 7, 1000, 100_000])
def test_gather_merge_sort_uniform_matches_jax(mesh8, n):
    data = gen_uniform(n, seed=n)
    jm, tm = JaxMetrics(), Metrics()
    want = jpl.GatherMergeSort(mesh8).sort(data, metrics=jm)
    _same(tpl.GatherMergeSort(VirtualMesh(8, "cpu")).sort(data, metrics=tm), want)
    assert set(tm.phase_s) == set(jm.phase_s) == {"partition", "local_sort", "gather", "merge"}


def test_gather_merge_sort_zipf_and_floats_match_jax(mesh8):
    data = gen_zipf(50_000, seed=5)
    _same(tpl.GatherMergeSort(VirtualMesh(8, "cpu")).sort(data),
          jpl.GatherMergeSort(mesh8).sort(data))
    f = np.random.default_rng(6).standard_normal(5_000).astype(np.float32)
    f[::13] = np.nan
    _same(tpl.GatherMergeSort(VirtualMesh(8, "cpu")).sort(f), jpl.GatherMergeSort(mesh8).sort(f))


def test_gather_merge_reference_golden_workload(mesh8, tmp_path):
    """The reference's shipped job: 10,000 ints in 1..100, written and read
    as ``input.txt``; the output file is ``sort -n``'s, byte for byte, and
    the JAX package's."""
    rng = np.random.default_rng(42)
    data = rng.integers(1, 101, 10_000).astype(np.int32)
    inp = tmp_path / "input.txt"
    ingest.write_ints_file(inp, data)
    loaded = ingest.read_ints_file(inp)
    _same(loaded, jax_read(inp))
    out = tpl.GatherMergeSort(VirtualMesh(8, "cpu")).sort(loaded)
    outp, refp = tmp_path / "output.txt", tmp_path / "ref.txt"
    ingest.write_ints_file(outp, out)
    jax_write(refp, jpl.GatherMergeSort(mesh8).sort(jax_read(inp)))
    assert outp.read_bytes() == refp.read_bytes()
    assert outp.read_bytes() == "".join(f"{v}\n" for v in np.sort(data).tolist()).encode()
