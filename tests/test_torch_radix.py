"""The port's LSD radix sort (`dsort_tpu_torch.ops.radix`) against the JAX
package's (`dsort_tpu.ops.radix`), on the same seeded numpy inputs.

Keys come back bit-identical for every int, uint and float width the
reference's tests cover, NaN bit patterns included; payloads follow the
stable order exactly.  The port also batches over leading axes and bounds
each pass's one-hot, which the reference's 1-D form has no counterpart for:
those are held against numpy's stable argsort.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.ops.local_sort import sort_padded as jax_sort_padded
from dsort_tpu.ops.radix import radix_sort as jax_radix_sort
from dsort_tpu.ops.radix import radix_sort_kv as jax_radix_sort_kv
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.ops import local_sort as ls
from dsort_tpu_torch.ops import radix
from dsort_tpu_torch.ops.radix import radix_sort, radix_sort_kv
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort

SIZES = [0, 1, 2, 3, 7, 128, 1000, 8192, 8193, 20000]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(f"u{a.dtype.itemsize}")


def _same(port: torch.Tensor, ref) -> None:
    got, want = port.numpy(), np.asarray(ref)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", SIZES)
def test_radix_int32_matches_jax(n):
    x = np.random.default_rng(n).integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    out = radix_sort(torch.from_numpy(x))
    _same(out, jax_radix_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(out.numpy(), np.sort(x))


@pytest.mark.parametrize(
    "dtype", [np.int32, np.uint32, np.int64, np.uint64, np.int16, np.uint16, np.int8, np.uint8]
)
def test_radix_integer_dtypes_match_jax(dtype):
    info = np.iinfo(dtype)
    x = np.random.default_rng(0).integers(info.min, info.max, 4097, dtype=dtype, endpoint=True)
    out = radix_sort(torch.from_numpy(x))
    _same(out, jax_radix_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(out.numpy(), np.sort(x))


@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.float64])
def test_radix_float_bit_order_matches_jax(dtype):
    """Floats sort by the reference's sign fold: -0.0 before +0.0, positive
    NaNs above +inf and negative NaNs below -inf, each by bit pattern."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(5000) * 1e3).astype(dtype)
    x[:6] = [0.0, -0.0, np.inf, -np.inf, 1.5, -1.5]
    u = x.view(f"u{x.itemsize}")
    nbits = 8 * x.itemsize
    exp_all = ((1 << (nbits - 1)) - 1) & ~((1 << {16: 10, 32: 23, 64: 52}[nbits]) - 1)
    sign = 1 << (nbits - 1)
    u[6:10] = [exp_all | 1, exp_all | 3 | sign, exp_all | 2, (1 << (nbits - 1)) - 1]
    out = radix_sort(torch.from_numpy(x))
    _same(out, jax_radix_sort(jnp.asarray(x)))
    got = out.numpy()
    assert np.isnan(got[0]) and np.isnan(got[-1])  # a negative NaN first, positive NaNs last
    np.testing.assert_array_equal(got[~np.isnan(got)], np.sort(x[~np.isnan(x)]))


def test_radix_extremes_and_duplicates():
    x = np.array([0, -1, 1, 2**31 - 1, -(2**31), 5, 5, 5, -1, 0], dtype=np.int32)
    _same(radix_sort(torch.from_numpy(x)), jax_radix_sort(jnp.asarray(x)))
    same = np.full(1000, 42, dtype=np.int32)
    np.testing.assert_array_equal(radix_sort(torch.from_numpy(same)).numpy(), same)


@pytest.mark.parametrize("bits", [1, 4, 8, 11])
def test_radix_bits_per_pass_matches_jax(bits):
    x = np.random.default_rng(2).integers(-(2**31), 2**31 - 1, 3000, dtype=np.int64).astype(np.int32)
    _same(radix_sort(torch.from_numpy(x), bits_per_pass=bits),
          jax_radix_sort(jnp.asarray(x), bits_per_pass=bits))


def test_radix_kv_matches_jax():
    rng = np.random.default_rng(3)
    n = 4099
    keys = rng.integers(-1000, 1000, n).astype(np.int32)
    payload = rng.integers(0, 256, (n, 10)).astype(np.uint8)
    out_k, out_v = radix_sort_kv(torch.from_numpy(keys), torch.from_numpy(payload))
    jk, jv = jax_radix_sort_kv(jnp.asarray(keys), jnp.asarray(payload))
    _same(out_k, jk)
    _same(out_v, jv)
    perm = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(out_v.numpy(), payload[perm])


def test_radix_kv_is_stable():
    keys = np.array([7, 7, 7, 3, 3, 7], dtype=np.int32)
    payload = np.arange(6, dtype=np.int32)[:, None]
    out_k, out_v = radix_sort_kv(torch.from_numpy(keys), torch.from_numpy(payload))
    np.testing.assert_array_equal(out_k.numpy(), [3, 3, 7, 7, 7, 7])
    np.testing.assert_array_equal(out_v.numpy()[:, 0], [3, 4, 0, 1, 2, 5])


def test_radix_kv_refuses_mismatched_payload():
    with pytest.raises(ValueError, match="leading dims"):
        radix_sort_kv(torch.zeros(5, dtype=torch.int32), torch.zeros((4, 2), dtype=torch.uint8))
    with pytest.raises(ValueError):
        radix_sort(torch.tensor(3))


def test_radix_batches_over_leading_axes():
    """Rows along the last axis, any leading shape, each row its own sort;
    records stable per row (payloads ride whole rows of 3 bytes)."""
    rng = np.random.default_rng(4)
    x = rng.integers(-(2**31), 2**31 - 1, (3, 2, 9001)).astype(np.int32)
    np.testing.assert_array_equal(radix_sort(torch.from_numpy(x)).numpy(), np.sort(x, -1))
    k = rng.integers(0, 50, (4, 10000)).astype(np.int64)
    v = rng.integers(0, 256, (4, 10000, 3)).astype(np.uint8)
    ok, ov = radix_sort_kv(torch.from_numpy(k), torch.from_numpy(v))
    for r in range(4):
        perm = np.argsort(k[r], kind="stable")
        np.testing.assert_array_equal(ok[r].numpy(), k[r][perm])
        np.testing.assert_array_equal(ov[r].numpy(), v[r][perm])


def test_radix_bounded_one_hot_batches(monkeypatch):
    """With the one-hot bound below one block's worth, each pass walks the
    blocks one batch at a time: the same bits as the unbounded pass."""
    x = np.random.default_rng(5).integers(-(2**31), 2**31 - 1, (2, 20000)).astype(np.int32)
    want = radix_sort(torch.from_numpy(x)).numpy()
    monkeypatch.setattr(radix, "_MAX_ONEHOT", 8192 * 256 * 2)  # 2 blocks a batch
    got = radix_sort(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x, -1))


def test_radix_as_local_kernel_matches_jax():
    x = np.random.default_rng(4).integers(-(2**31), 2**31 - 1, 2048, dtype=np.int64).astype(np.int32)
    _same(ls.sort_with_kernel(torch.from_numpy(x), "radix"), np.sort(x))
    buf = np.full(4096, 123, dtype=np.int32)
    buf[:2048] = x
    got, _ = ls.sort_padded(torch.from_numpy(buf), 2048, "radix")
    want, _ = jax_sort_padded(jnp.asarray(buf), 2048, "radix")
    _same(got, want)
    assert ls.resolve_kernel("auto", torch.int32, 1 << 20, "cpu") != "radix"


@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
def test_radix_in_sample_sort_matches_jax(mesh8, exchange):
    data = np.random.default_rng(5).integers(-(2**31), 2**31 - 1, 1 << 14, dtype=np.int64)
    data = data.astype(np.int32)
    jjob = JaxJobConfig(local_kernel="radix", exchange=exchange)
    want = JaxSampleSort(mesh8, jjob).sort(data)
    port = SampleSort(VirtualMesh(8, "cpu"), JobConfig.from_dict(dataclasses.asdict(jjob)))
    got = port.sort(data)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(data))
    ranges = port.sort_ranges(data)
    want_ranges = JaxSampleSort(mesh8, jjob).sort_ranges(data)
    assert [len(r) for r in ranges] == [len(r) for r in want_ranges]
