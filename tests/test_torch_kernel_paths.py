"""The port's sample sort through the ``pallas`` and ``bitonic`` kernels
against the JAX package's.

The port's ``SampleSort`` with ``local_kernel="pallas"``,
``local_kernel="bitonic"`` and ``merge_kernel="bitonic"``, under
``alltoall`` and ``ring``, against JAX ``SampleSort`` with
``local_kernel="bitonic"`` on the 8-device CPU mesh (the JAX ``pallas``
sort costs about 70 s under the interpreter; every kernel gives the same
bits): bit-identical output, identical per-shard counts and, on the ring,
identical per-step caps.  Records under ``merge_kernel="bitonic"``: keys,
counts and the record multiset per key.  Also the ring's eager/deferred
merge rule read for the new kernels, as the reference reads it.
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
from dsort_tpu.parallel.mesh import local_device_mesh
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort
from dsort_tpu.utils.events import EventLog
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.ops import float_order as fo
from dsort_tpu_torch.parallel import exchange as ex
from dsort_tpu_torch.parallel import sample_sort as pss
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.utils.metrics import Metrics


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _case(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "uniform_int32":
        return rng.integers(-(2**31), 2**31, 20_000).astype(np.int32)
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


CASES = ["uniform_int32", "zipf_int64", "all_equal", "sentinel", "float32_nan",
         "seven_shards", "empty", "one"]
CONFIGS = {
    "pallas": dict(local_kernel="pallas"),
    "bitonic": dict(local_kernel="bitonic"),
    "merge_bitonic": dict(merge_kernel="bitonic"),
}


def _p(name):
    return 7 if name == "seven_shards" else 8


class _Journal:
    """The port's `Metrics` journal seam, recording ``(type, fields)``."""

    def __init__(self):
        self.events = []

    def emit(self, etype, **fields):
        self.events.append((etype, fields))
        return types.SimpleNamespace(mono=0.0)


def _caps(events):
    return [f["cap"] for t, f in events if t == "exchange_step"]


@functools.lru_cache(maxsize=None)
def _jax_result(name, exchange):
    x = _case(name)
    ss = JaxSampleSort(local_device_mesh(_p(name)), JaxJobConfig(local_kernel="bitonic"))
    m = JaxMetrics(journal=EventLog())
    out = ss.sort(x, m, exchange=exchange)
    rx = jfo.float_to_ordered_uint(x) if x.dtype.kind == "f" else x
    counts = [len(r) for r in ss.sort_ranges(rx, exchange=exchange)]
    return out, counts, _caps((e.type, e.fields) for e in m.journal.events())


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
@pytest.mark.parametrize("name", CASES)
def test_sample_sort_kernels_match_jax(name, exchange, config):
    x = _case(name)
    want, want_counts, want_caps = _jax_result(name, exchange)
    job = JobConfig.from_dict(dataclasses.asdict(JaxJobConfig(**CONFIGS[config])))
    ss = SampleSort(VirtualMesh(_p(name), "cpu"), job)
    m = Metrics(journal=_Journal())
    out = ss.sort(x, m, exchange=exchange)
    assert out.dtype == want.dtype and out.shape == want.shape
    np.testing.assert_array_equal(_bits(out), _bits(want))
    rx = fo.float_to_ordered_int(_t(x)).numpy() if x.dtype.kind == "f" else x
    assert [len(r) for r in ss.sort_ranges(rx, exchange=exchange)] == want_counts
    assert _caps(m.journal.events) == want_caps


def _record_multiset(keys, vals):
    rows = np.ascontiguousarray(vals).reshape(len(vals), -1).view(np.uint8)
    order = np.lexsort(tuple(rows.T[::-1]) + (_bits(keys),))
    return keys[order], rows[order]


@functools.lru_cache(maxsize=None)
def _jax_kv(exchange):
    rng = np.random.default_rng(21)
    keys = np.minimum(rng.zipf(1.3, 9_000), 2**62).astype(np.int64)
    keys[::40] = np.iinfo(np.int64).max  # real keys equal to the pad sentinel
    vals = np.stack([np.arange(9_000, dtype=np.int64), rng.integers(0, 9, 9_000)], 1)
    job = JaxJobConfig(key_dtype=keys.dtype, payload_bytes=16, merge_kernel="bitonic")
    ss = JaxSampleSort(local_device_mesh(8), job)
    return keys, vals, job, ss.sort_kv(keys, vals, exchange=exchange), [
        len(r) for r in ss.sort_ranges(keys)
    ]


@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
def test_sort_kv_bitonic_merge_matches_jax(exchange, monkeypatch):
    keys, vals, jjob, (want_k, want_v), want_counts = _jax_kv(exchange)
    seen = []
    trim = pss._trim_rows

    def spy(rows, c, n, what):
        seen.append([int(v) for v in c])
        return trim(rows, c, n, what)

    monkeypatch.setattr(pss, "_trim_rows", spy)
    ss = SampleSort(VirtualMesh(8, "cpu"), JobConfig.from_dict(dataclasses.asdict(jjob)))
    out_k, out_v = ss.sort_kv(keys, vals, exchange=exchange)
    np.testing.assert_array_equal(out_k, want_k)
    assert seen[0] == want_counts
    for a, b in zip(_record_multiset(out_k, out_v), _record_multiset(want_k, want_v)):
        np.testing.assert_array_equal(a, b)


# -- the ring's eager/deferred rule under the new kernels ---------------------


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_ring_folds_keys_through_the_bitonic_tower(monkeypatch):
    """merge_kernel="bitonic" is a run merge: the keys ring folds every
    landed run through the tower (P-1 pair merges), as the reference does."""
    folds = _spy(monkeypatch, ex, "_merge2")
    x = _case("uniform_int32")
    out = SampleSort(VirtualMesh(8, "cpu"), JobConfig(merge_kernel="bitonic")).sort(
        x, exchange="ring")
    np.testing.assert_array_equal(out, np.sort(x))
    assert len(folds) == 7


def test_ring_under_pallas_sorts_once(monkeypatch):
    """Under local_kernel="pallas" the combine resolves to the flat sort:
    the ring collects its runs and sorts once through pallas_sort, so the
    tile sort runs twice per sort (the plan's local sort and the combine)."""
    folds = _spy(monkeypatch, ex, "_merge2")
    from dsort_tpu_torch.ops import pallas_sort as mod

    sorts = _spy(monkeypatch, mod, "pallas_sort")
    x = _case("uniform_int32")
    out = SampleSort(VirtualMesh(8, "cpu"), JobConfig(local_kernel="pallas")).sort(
        x, exchange="ring")
    np.testing.assert_array_equal(out, np.sort(x))
    assert not folds and len(sorts) == 2
    assert pss._resolve_merge_kernel("auto", "pallas", torch.int32, 1 << 20, "cuda") == "sort"


def test_kv_tower_stays_eager_only_for_block_merge(monkeypatch):
    folds = _spy(monkeypatch, ex, "_merge2_kv")
    keys = np.arange(5_000, dtype=np.int64)[::-1].copy()
    vals = np.arange(5_000, dtype=np.int32)
    for job in (JobConfig(merge_kernel="bitonic"), JobConfig(local_kernel="pallas")):
        ok, ov = SampleSort(VirtualMesh(8, "cpu"), job).sort_kv(keys, vals, exchange="ring")
        np.testing.assert_array_equal(ok, np.arange(5_000))
        np.testing.assert_array_equal(ov, vals[::-1])
    assert not folds


def test_fused_merge_is_eager_on_cuda_for_every_kernel():
    from dsort_tpu_torch.ops import ring_kernel as rk

    for kernel, merge in (("pallas", "auto"), ("bitonic", "auto"), ("lax", "bitonic")):
        assert rk._fused_eager(merge, kernel, torch.int32, 1 << 20, "cuda")
    assert not rk._fused_eager("auto", "pallas", torch.int32, 1 << 20, "cpu")
    assert rk._fused_eager("bitonic", "lax", torch.int32, 1 << 20, "cpu")
