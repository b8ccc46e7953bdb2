"""8- and 16-bit keys through the port's sample sort, against the JAX package.

int8, uint8, int16, uint16 and float16 keys sort under every exchange
(``alltoall``, ``ring``, ``fused``) and every ported local kernel, keys
alone and with a payload: the block, tile and fused-ring kernels take 32-
and 64-bit keys, so the sort entry points widen these to int32 and narrow
the result (`ops.float_order.sort_narrow_keys_via_int32`,
`ops.local_sort.widened_keys`).  The JAX package runs each (dtype, exchange) once on the
8-device CPU mesh with its default kernel — its Pallas kernels would run
interpreted — and the port must give its bits under every kernel: the
sorted keys with the same capacity retries, and for records the same
sorted keys with a payload that stays with its key (equal keys' payload
order is not specified, in either package).
"""

import numpy as np
import pytest

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.parallel.sample_sort import SampleSort as JaxSampleSort
from dsort_tpu.utils.metrics import Metrics as JaxMetrics

from dsort_tpu_torch.config import JobConfig
from dsort_tpu_torch.ops.local_sort import sort_with_kernel
from dsort_tpu_torch.parallel.mesh import VirtualMesh
from dsort_tpu_torch.parallel.sample_sort import SampleSort
from dsort_tpu_torch.utils.metrics import Metrics

NARROW = ["int8", "uint8", "int16", "uint16", "float16"]
KERNELS = ["auto", "lax", "block", "bitonic", "pallas"]


def _keys(dtype: str, n: int = 3_000) -> np.ndarray:
    rng = np.random.default_rng(NARROW.index(dtype))
    if dtype == "float16":
        x = (rng.standard_normal(n) * 300).astype(np.float16)
        x[::53] = np.nan
        x[1::53] = -0.0
        x[2::53] = np.inf
        return x
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, n, endpoint=True).astype(dtype)
    x[:3] = [info.min, info.max, info.max]  # the dtype's sentinel as a real key
    return x


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(f"u{a.dtype.itemsize}")


@pytest.mark.parametrize("exchange", ["alltoall", "ring", "fused"])
@pytest.mark.parametrize("dtype", NARROW)
def test_narrow_keys_every_kernel_match_jax(mesh8, dtype, exchange):
    x = _keys(dtype)
    payload = np.arange(len(x), dtype=np.int32)
    jss = JaxSampleSort(mesh8, JaxJobConfig(exchange=exchange))
    jm = JaxMetrics()
    want = jss.sort(x, jm)
    for kernel in KERNELS:
        ss = SampleSort(VirtualMesh(8, "cpu"), JobConfig(exchange=exchange, local_kernel=kernel))
        tm = Metrics()
        got = ss.sort(x, tm)
        assert got.dtype == want.dtype and np.array_equal(_bits(got), _bits(want)), kernel
        assert tm.counters.get("capacity_retries", 0) == jm.counters.get("capacity_retries", 0)
        got_k, got_v = ss.sort_kv(x, payload)
        assert got_k.dtype == want.dtype and np.array_equal(_bits(got_k), _bits(want)), kernel
        assert np.array_equal(np.sort(got_v), payload)
        assert np.array_equal(_bits(x[got_v]), _bits(got_k)), kernel


@pytest.mark.parametrize("dtype", NARROW)
def test_widened_kernels_on_rows(dtype):
    """`sort_with_kernel` under ``block`` and ``pallas`` takes a 2-D batch of
    narrow keys (the plain versions on the CPU) and returns its dtype; NaNs
    come back last and canonical."""
    import torch

    x = torch.from_numpy(_keys(dtype, 3 * 700).reshape(3, 700))
    want = np.sort(x.numpy(), axis=-1)
    if dtype == "float16":
        want[np.isnan(want)] = np.float16(np.nan)
    for kernel in ("block", "pallas"):
        got = sort_with_kernel(x, kernel)
        assert got.dtype == x.dtype and np.array_equal(_bits(got.numpy()), _bits(want))
