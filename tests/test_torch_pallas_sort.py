"""The port's tile sorts, radix histogram and bitonic tree against the JAX
package's, and the dispatch, config and CLI of the ``pallas`` / ``bitonic``
kernels.

The same seeded numpy inputs go through the JAX function (its Pallas
kernels under the interpreter on the CPU, as ``tests/test_bitonic_pallas.py``
and ``tests/test_pallas_kv_hist.py`` run them) and the port's, whose kernel
wrappers run their plain PyTorch versions on CPU tensors.  Sorting and
counting are exact, so every comparison is exact equality.  The JAX Pallas
functions are called only at the sizes its tier-1 tests use (the
interpreter costs tens of seconds above them); at larger sizes the port is
held against numpy, against which those tests hold JAX.  The sample sorts
through these kernels are in ``tests/test_torch_kernel_paths.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dsort_tpu.config import JobConfig as JaxJobConfig
from dsort_tpu.ops import bitonic as jbt
from dsort_tpu.ops import pallas_sort as jps

from dsort_tpu_torch import cli
from dsort_tpu_torch.config import ConfigError, JobConfig
from dsort_tpu_torch.ops import bitonic as bt
from dsort_tpu_torch.ops import local_sort as ls
from dsort_tpu_torch.ops import pallas_sort as ps


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


# -- pallas_sort, pallas_sort_kv, radix_histogram against JAX -----------------


@pytest.mark.parametrize("n,rows", [(1024, 8), (3 * 1024 + 17, 8)])
def test_pallas_sort_matches_jax(n, rows):
    rng = np.random.default_rng(n)
    x = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    want = np.asarray(jps.pallas_sort(jnp.asarray(x), tile_rows=rows))
    got = ps.pallas_sort(_t(x), tile_rows=rows).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))
    assert not any(ps.launch_counts().values())  # CPU tensors: plain versions only


@pytest.mark.parametrize("n", [1, 255, 256])
def test_pallas_sort_kv_matches_jax(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-50, 50, n).astype(np.int32)  # many duplicates
    payload = np.arange(n, dtype=np.int32)
    want_k, want_v = jps.pallas_sort_kv(jnp.asarray(keys), jnp.asarray(payload), tile_rows=2)
    got_k, got_v = ps.pallas_sort_kv(_t(keys), _t(payload), tile_rows=2)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_v.numpy(), np.argsort(keys, kind="stable"))


def test_pallas_sort_kv_wide_payload_matches_jax():
    rng = np.random.default_rng(0)
    n = 700
    keys = rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32)
    payload = rng.integers(0, 256, (n, 9)).astype(np.uint8)  # TeraSort-like rows
    want_k, want_v = jps.pallas_sort_kv(jnp.asarray(keys), jnp.asarray(payload), tile_rows=2)
    got_k, got_v = ps.pallas_sort_kv(_t(keys), _t(payload), tile_rows=2)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_pallas_sort_kv_sentinel_keys_match_jax():
    sent = np.iinfo(np.int32).max
    keys = np.array([5, sent, 1, sent, 3], dtype=np.int32)
    payload = np.array([50, 51, 52, 53, 54], dtype=np.int32)
    want_k, want_v = jps.pallas_sort_kv(jnp.asarray(keys), jnp.asarray(payload), tile_rows=2)
    got_k, got_v = ps.pallas_sort_kv(_t(keys), _t(payload), tile_rows=2)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_v.numpy(), [52, 54, 50, 51, 53])
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("shift,bits", [(0, 8), (8, 8), (24, 8), (0, 4)])
def test_radix_histogram_matches_jax(shift, bits):
    rng = np.random.default_rng(shift + bits)
    x = rng.integers(0, 2**31 - 1, 3000, dtype=np.int64).astype(np.int32)
    want = np.asarray(jps.radix_histogram(jnp.asarray(x), shift, bits, tile_rows=2))
    got = ps.radix_histogram(_t(x), shift, bits, tile_rows=2).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.sum() == len(x)


def test_radix_histogram_pad_case_matches_jax():
    x = np.zeros(77, dtype=np.int32)
    want = np.asarray(jps.radix_histogram(jnp.asarray(x), 0, 8, tile_rows=2))
    got = ps.radix_histogram(_t(x), 0, 8, tile_rows=2).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 77 and got[1:].sum() == 0


def _tile_keys(rng, kind, shape, dtype):
    """Random keys over the whole range, or heavy ties (7 distinct values)."""
    x = _keys(rng, shape, dtype)
    return x if kind == "random" else x % 7


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("tile_rows", [1, 2])
def test_tile_sort_matches_jax_tile_kernel(tile_rows, kind):
    """S1's wrapper on CPU tensors (its plain version) against the JAX
    package's `_tile_sort` (the Pallas tile kernel, interpreted), int32,
    three tiles."""
    rng = np.random.default_rng(10 * tile_rows + len(kind))
    x = _tile_keys(rng, kind, 3 * tile_rows * ps.LANES, np.int32)
    want = np.asarray(
        jps._tile_sort(jnp.asarray(x.reshape(-1, ps.LANES)), rows=tile_rows, interpret=True)
    ).reshape(-1)
    got = ps.tile_sort(_t(x.copy()), tile_rows).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x.reshape(3, -1), axis=1).reshape(-1))
    assert not any(ps.launch_counts().values())


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("tile_rows", [1, 2])
def test_tile_sort_kv_matches_jax_tile_kernel(tile_rows, kind):
    """S2's wrapper on CPU tensors (its plain version) against the JAX
    package's `_tile_sort_kv` (the Pallas key+index tile kernel,
    interpreted), int32 keys and a permuted int32 index, three tiles; with
    ties the index orders equal keys."""
    rng = np.random.default_rng(30 * tile_rows + len(kind))
    n = 3 * tile_rows * ps.LANES
    x = _tile_keys(rng, kind, n, np.int32)
    v = rng.permutation(n).astype(np.int32)
    want_k, want_v = jps._tile_sort_kv(jnp.asarray(x.reshape(-1, ps.LANES)),
                                       jnp.asarray(v.reshape(-1, ps.LANES)),
                                       rows=tile_rows, interpret=True)
    got_k, got_v = ps.tile_sort_kv(_t(x.copy()), _t(v.copy()), tile_rows)
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k).reshape(-1))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v).reshape(-1))
    order = np.lexsort((v.reshape(3, -1), x.reshape(3, -1)), axis=1)
    np.testing.assert_array_equal(got_v.numpy(), np.take_along_axis(v.reshape(3, -1), order, 1)
                                  .reshape(-1))
    assert not any(ps.launch_counts().values())


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("tile_rows", [1, 2, 8])
def test_tile_sort_int64_sorts_each_tile(tile_rows, kind):
    rng = np.random.default_rng(20 * tile_rows + len(kind))
    x = _tile_keys(rng, kind, (2, 3 * tile_rows * ps.LANES), np.int64)
    x[0, :3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1]
    got = ps.tile_sort(_t(x.copy()), tile_rows).numpy()
    tile = tile_rows * ps.LANES
    np.testing.assert_array_equal(got, np.sort(x.reshape(-1, tile), axis=1).reshape(x.shape))


# -- larger sizes, held against numpy -----------------------------------------


def _keys(rng, shape, dtype):
    if np.dtype(dtype).kind == "f":
        return rng.standard_normal(shape).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint64, np.float32])
@pytest.mark.parametrize("shape,tile_rows", [((3, 5_000), 2), ((20_001,), 8), ((2, 2), 2)])
def test_pallas_sort_batched_matches_numpy(dtype, shape, tile_rows):
    rng = np.random.default_rng(sum(shape) + tile_rows)
    x = _keys(rng, shape, dtype)
    got = ps.pallas_sort(_t(x), tile_rows=tile_rows).numpy()
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got), _bits(np.sort(x, axis=-1)))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint64])
def test_pallas_sort_kv_batched_is_stable(dtype):
    rng = np.random.default_rng(3)
    keys = _keys(rng, (3, 4_001), dtype) % 97
    keys[:, :40] = np.iinfo(dtype).max  # real keys equal to the pad sentinel
    payload = rng.integers(0, 256, (3, 4_001, 5)).astype(np.uint8)
    got_k, got_v = ps.pallas_sort_kv(_t(keys), _t(payload), tile_rows=4)
    order = np.argsort(keys, axis=1, kind="stable")
    np.testing.assert_array_equal(got_k.numpy(), np.take_along_axis(keys, order, 1))
    np.testing.assert_array_equal(got_v.numpy(), np.take_along_axis(payload, order[:, :, None], 1))


def _digits(x, shift, bits):
    width = 8 * x.itemsize
    if shift >= width:
        d = x >> x.dtype.type(width - 1) if x.dtype.kind == "i" else np.zeros_like(x)
    else:
        d = x >> x.dtype.type(shift)
    return (d & x.dtype.type((1 << bits) - 1)).astype(np.int64)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.uint64])
@pytest.mark.parametrize("shift,bits", [(0, 8), (28, 8), (40, 4), (56, 8), (3, 14), (70, 3)])
def test_radix_histogram_matches_numpy(dtype, shift, bits):
    rng = np.random.default_rng(bits)
    x = _keys(rng, 9_001, dtype)
    got = ps.radix_histogram(_t(x), shift, bits).numpy()
    np.testing.assert_array_equal(got, np.bincount(_digits(x, shift, bits), minlength=1 << bits))
    assert got.sum() == x.size


# -- the tile kernels' plain versions and the wrappers' checks ---------------


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_tile_sorts_sort_each_tile(dtype):
    rng = np.random.default_rng(4)
    x = _keys(rng, (4, 1024), dtype)
    got = ps.tile_sort(_t(x.copy()), tile_rows=2).numpy()
    np.testing.assert_array_equal(got, np.sort(x.reshape(-1, 256), axis=1).reshape(x.shape))
    k = x % 5
    v = rng.permutation(k.size).astype(np.int32).reshape(k.shape)
    gk, gv = ps.tile_sort_kv(_t(k.copy()), _t(v.copy()), tile_rows=2)
    kt, vt = k.reshape(-1, 256), v.reshape(-1, 256)
    order = np.lexsort((vt, kt), axis=1)
    np.testing.assert_array_equal(gk.numpy().reshape(-1, 256), np.take_along_axis(kt, order, 1))
    np.testing.assert_array_equal(gv.numpy().reshape(-1, 256), np.take_along_axis(vt, order, 1))


def test_tile_wrappers_check_their_inputs():
    x = torch.zeros(512, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        ps.tile_sort(x, tile_rows=3)
    with pytest.raises(ValueError, match="whole tiles"):
        ps.tile_sort(x, tile_rows=8)
    with pytest.raises(TypeError, match="int32 or int64"):
        ps.tile_sort(torch.zeros(512, dtype=torch.float32), tile_rows=2)
    with pytest.raises(ValueError, match="index plane"):
        ps.tile_sort_kv(x, torch.zeros(512, dtype=torch.int64), tile_rows=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ps.tile_sort(torch.zeros(512, dtype=torch.int32, device="meta"), tile_rows=2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ps.radix_histogram(torch.zeros(8, dtype=torch.int32, device="meta"))
    with pytest.raises(TypeError):
        ps.radix_histogram(torch.zeros(8, dtype=torch.float32))
    assert not any(ps.launch_counts().values())


def test_cluster_route_sizes():
    """The default 32,768-key tile fits one CTA as int32 keys; int64 keys
    and every key+index tile need two CTAs' shared memory."""
    assert ps.cluster_size(256, torch.int32) == 1
    assert ps.cluster_size(256, torch.int64) == 2
    assert ps.cluster_size(256, torch.int32, kv=True) == 2
    assert ps.cluster_size(256, torch.int64, kv=True) == 2
    assert ps.cluster_size(2, torch.int64, kv=True) == 1
    assert ps.cluster_size(512, torch.int64) == 4


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_tile_sort_cluster_sizes(dtype):
    """S1's own rule: CTA shares of at most 4,096 keys (8 CTAs at the
    default 32,768-key tile, both key types), never fewer CTAs than shared
    memory needs (`cluster_size`), at most 8, and a share the kernel
    takes (16 keys a thread up to 16,384 a share, 32 at 32,768, int32
    only)."""
    assert ps.tile_sort_cluster_size(32, dtype) == 1
    assert ps.tile_sort_cluster_size(64, dtype) == 2
    assert ps.tile_sort_cluster_size(128, dtype) == 4
    assert ps.tile_sort_cluster_size(256, dtype) == 8
    top = 2048 if dtype == torch.int32 else 1024
    assert ps.tile_sort_cluster_size(top, dtype) == 8
    tile_rows = 1
    while tile_rows <= top:
        c = ps.tile_sort_cluster_size(tile_rows, dtype)
        share = tile_rows * ps.LANES // c
        assert c & (c - 1) == 0 and ps.cluster_size(tile_rows, dtype) <= c <= 8
        assert share * dtype.itemsize <= ps._SMEM_BYTES
        assert share <= 4096 or c == 8
        assert share <= 16384 or (share == 32768 and dtype == torch.int32)
        tile_rows *= 2


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_tile_sort_kv_cluster_sizes(dtype):
    """S2's rule (`tile_sort_cluster_size` with ``kv``): CTA shares of at
    most 4,096 pairs (8 CTAs at the default 32,768-pair tile, both key
    types), never fewer CTAs than shared memory needs (`cluster_size` with
    ``kv``), at most 8, and a share the kernel takes (16 pairs a thread, up
    to 16,384 a share)."""
    assert ps.tile_sort_cluster_size(32, dtype, kv=True) == 1
    assert ps.tile_sort_cluster_size(64, dtype, kv=True) == 2
    assert ps.tile_sort_cluster_size(128, dtype, kv=True) == 4
    assert ps.tile_sort_cluster_size(256, dtype, kv=True) == 8
    assert ps.tile_sort_cluster_size(1024, dtype, kv=True) == 8
    with pytest.raises(ValueError, match="shared memory"):
        ps.tile_sort_cluster_size(2048, dtype, kv=True)
    tile_rows = 1
    while tile_rows <= 1024:
        c = ps.tile_sort_cluster_size(tile_rows, dtype, kv=True)
        share = tile_rows * ps.LANES // c
        assert c & (c - 1) == 0 and ps.cluster_size(tile_rows, dtype, kv=True) <= c <= 8
        assert share * (dtype.itemsize + 4) <= ps._SMEM_BYTES
        assert share <= 4096 or c == 8
        assert 16 <= share <= 16384
        tile_rows *= 2


# -- the bitonic module against JAX's -----------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint64, np.float32])
def test_bitonic_functions_match_jax(dtype):
    """Unbatched against the JAX function, batched against its vmap."""
    rng = np.random.default_rng(np.dtype(dtype).num)
    x = _keys(rng, (3, 1000), dtype)
    want = np.asarray(jax.jit(jbt.bitonic_sort)(jnp.asarray(x[0])))
    np.testing.assert_array_equal(bt.bitonic_sort(_t(x[0])).numpy(), want)
    want = np.asarray(jax.jit(jax.vmap(jbt.bitonic_sort))(jnp.asarray(x)))
    np.testing.assert_array_equal(bt.bitonic_sort(_t(x)).numpy(), want)
    a, b = np.sort(_keys(rng, (2, 512), dtype), axis=1)
    want = np.asarray(jax.jit(jbt.bitonic_merge_pair)(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(bt.bitonic_merge_pair(_t(a), _t(b)).numpy(), want)
    runs = np.sort(_keys(rng, (2, 4, 256), dtype), axis=2)
    want = np.asarray(jax.jit(jbt.merge_sorted_runs)(jnp.asarray(runs[0])))
    np.testing.assert_array_equal(bt.merge_sorted_runs(_t(runs[0])).numpy(), want)
    want = np.asarray(jax.jit(jax.vmap(jbt.merge_sorted_runs))(jnp.asarray(runs)))
    np.testing.assert_array_equal(bt.merge_sorted_runs(_t(runs)).numpy(), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint64])
def test_bitonic_kv_merges_match_jax(dtype):
    rng = np.random.default_rng(7)
    keys = _keys(rng, (2, 8, 128), dtype) % 11  # ties: the value decides
    vals = rng.permutation(keys.size).astype(np.int32).reshape(keys.shape)
    order = np.lexsort((vals, keys), axis=2)
    keys, vals = np.take_along_axis(keys, order, 2), np.take_along_axis(vals, order, 2)
    merge = jax.jit(jbt.merge_sorted_runs_kv)
    for want, got in (
        (merge(jnp.asarray(keys[0]), jnp.asarray(vals[0])),
         bt.merge_sorted_runs_kv(_t(keys[0]), _t(vals[0]))),
        (jax.jit(jax.vmap(jbt.merge_sorted_runs_kv))(jnp.asarray(keys), jnp.asarray(vals)),
         bt.merge_sorted_runs_kv(_t(keys), _t(vals))),
        (jax.jit(jbt.bitonic_merge_pair_kv)(
            *map(jnp.asarray, (keys[0, 0], vals[0, 0], keys[0, 1], vals[0, 1]))),
         bt.bitonic_merge_pair_kv(*map(_t, (keys[0, 0], vals[0, 0], keys[0, 1], vals[0, 1])))),
    ):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_bitonic_merges_refuse_ragged_runs():
    with pytest.raises(ValueError, match="power-of-two"):
        bt.bitonic_merge_pair(torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="power-of-two"):
        bt.merge_sorted_runs(torch.zeros((3, 4), dtype=torch.int32))


# -- dispatch, config and CLI -------------------------------------------------


def test_sort_with_kernel_dispatch():
    x = torch.tensor([5, -3, 7, 0], dtype=torch.int32)
    for kernel in ("lax", "block", "bitonic", "pallas"):
        np.testing.assert_array_equal(ls.sort_with_kernel(x, kernel).numpy(), [-3, 0, 5, 7])
    assert ls.LOCAL_KERNELS == ("auto", "lax", "block", "bitonic", "pallas", "radix")
    np.testing.assert_array_equal(ls.sort_with_kernel(x, "radix").numpy(), [-3, 0, 5, 7])
    with pytest.raises(ValueError, match="unknown local kernel"):
        ls.sort_with_kernel(x, "quicksort")
    for kernel in ("bitonic", "pallas", "radix"):  # auto never picks them
        assert ls.resolve_kernel("auto", torch.int32, 1 << 20, "cpu") != kernel


def test_job_config_accepts_the_new_kernels():
    for kw in (dict(local_kernel="pallas"), dict(local_kernel="bitonic"),
               dict(merge_kernel="bitonic"), dict(local_kernel="pallas", merge_kernel="bitonic"),
               dict(local_kernel="radix")):
        job = JobConfig.from_dict(dataclasses.asdict(JaxJobConfig(**kw)))
        assert all(getattr(job, k) == v for k, v in kw.items())
    with pytest.raises(ConfigError, match="local_kernel"):
        JobConfig(local_kernel="quicksort")


@pytest.mark.parametrize("argv", [["--kernel", "pallas"], ["--kernel", "bitonic"],
                                  ["--merge-kernel", "bitonic", "--exchange", "ring"]])
def test_cli_run_kernel_flags(tmp_path, argv):
    x = np.random.default_rng(5).integers(-(2**31), 2**31, 5_000).astype(np.int32)
    src, dst = tmp_path / "input.txt", tmp_path / "output.txt"
    src.write_text("".join(f"{v}\n" for v in x.tolist()))
    assert cli.main(["run", str(src), "-o", str(dst), "--device", "cpu", *argv]) == 0
    assert dst.read_bytes() == "".join(f"{v}\n" for v in np.sort(x).tolist()).encode()


def test_cli_refuses_radix(tmp_path):
    # The radix kernel is ported: --kernel radix sorts; an unknown kernel is
    # what the parser refuses.
    with pytest.raises(SystemExit):
        cli.main(["run", str(tmp_path / "x"), "--device", "cpu", "--kernel", "quicksort"])
    x = np.random.default_rng(6).integers(-(2**31), 2**31, 3_000).astype(np.int32)
    src, dst = tmp_path / "input.txt", tmp_path / "output.txt"
    src.write_text("".join(f"{v}\n" for v in x.tolist()))
    assert cli.main(["run", str(src), "-o", str(dst), "--device", "cpu", "--kernel", "radix"]) == 0
    assert dst.read_bytes() == "".join(f"{v}\n" for v in np.sort(x).tolist()).encode()
