"""dsort_tpu_torch's CUDA kernels on the card (skipped without a GPU).

JAX-free, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX's CPU mesh.)
"""

import numpy as np
import pytest
import torch

from dsort_tpu_torch.ops import block_sort as tb


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _keys(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_kernels_match_plain_versions(cuda, dtype):
    """Each kernel bit-identical to its plain version, and the launch
    counters move only where a kernel launched."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(_keys(rng, (4, 16384), dtype)).to(cuda)
    cases = [
        ("bitonic_tile_kernel", lambda t: tb.bitonic_tile(t, 4096),
         lambda t: tb.tile_sort_plain(t, 4096)),
        ("bitonic_tile_kernel", lambda t: tb.bitonic_tile(t, 4096, 256),
         lambda t: tb.tile_sort_plain(t, 4096, 256)),
        ("bitonic_global_stage_kernel", lambda t: tb.bitonic_global_stage(t, 16384, 8192),
         lambda t: tb.global_stage_plain(t, 16384, 8192)),
        ("bitonic_tile_merge_kernel", lambda t: tb.bitonic_tile_merge(t, 4096, 16384),
         lambda t: tb.tile_merge_plain(t, 4096, 16384)),
    ]
    for name, kernel, plain in cases:
        tb.reset_launch_counts()
        got = kernel(x.clone())
        want = plain(x.clone())
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        assert tb.launch_counts()[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64, np.uint64])
def test_block_sort_and_merge_on_cuda(cuda, dtype):
    rng = np.random.default_rng(9)
    x = _keys(rng, (3, 70_001), dtype)
    out = tb.block_sort(torch.from_numpy(x).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(out, np.sort(x, axis=1))
    runs = np.sort(_keys(rng, (2, 8, 9_000), dtype), axis=2)
    out = tb.block_merge_runs(torch.from_numpy(runs).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(out, np.sort(runs.reshape(2, -1), axis=1))


@pytest.mark.cuda
def test_sample_sort_on_cuda_goes_through_the_kernels(cuda):
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    rng = np.random.default_rng(10)
    x = _keys(rng, 1 << 20, np.int32)
    tb.reset_launch_counts()
    out = SampleSort(VirtualMesh(8)).sort(x)
    np.testing.assert_array_equal(out, np.sort(x))
    assert all(tb.launch_counts().values()), tb.launch_counts()
