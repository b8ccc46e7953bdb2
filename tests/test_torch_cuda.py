"""dsort_tpu_torch's CUDA kernels on the card (skipped without a GPU).

JAX-free, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(``--noconftest`` skips ``tests/conftest.py``, which sets up JAX's CPU mesh.)
"""

import numpy as np
import pytest
import torch

from dsort_tpu_torch.ops import block_sort as tb
from dsort_tpu_torch.ops import ring_kernel as rk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _keys(rng, shape, dtype):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, shape, dtype=dtype, endpoint=True)


def _tile_limit(dtype, ranked):
    """The largest tile `bitonic_tile` admits: 48 KB of keys (and ranks)."""
    return 8192 if dtype == np.int32 and not ranked else 4096


def _tile_inputs(rng, shape, dtype, ranked):
    """Random keys; keys % 7 with a permutation rank plane and with ranks in
    {0, 1, 2} (full (key, rank) ties); INT_MIN / INT_MAX / sentinel keys."""
    perm = rng.permutation(int(np.prod(shape))).astype(np.int32).reshape(shape)
    out = [(_keys(rng, shape, dtype), perm)]
    if ranked:
        mod7 = _keys(rng, shape, dtype) % 7
        out += [(mod7, perm), (mod7, rng.integers(0, 3, shape).astype(np.int32))]
    info, i32 = np.iinfo(dtype), np.iinfo(np.int32)
    extremes = np.array([info.min, info.max, info.max - 1, info.min + 1, 0, -1], dtype)
    out.append((rng.choice(extremes, shape), rng.choice(np.array([i32.max, i32.min, 0], np.int32), shape)))
    return out


TILE_SWEEP = [
    (dtype, ranked, 1 << e)
    for dtype in (np.int32, np.int64)
    for ranked in (False, True)
    for e in range(1, 14)
    if 1 << e <= _tile_limit(dtype, ranked)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ranked,tile", TILE_SWEEP)
def test_kernels_match_plain_versions(cuda, dtype, ranked, tile):
    """The tile kernel bit-identical to its plain version at every tile the
    wrapper admits, k_start in {2, 4, T/2, T}, on random keys, ties that
    the rank plane decides, full (key, rank) ties and extreme keys; at the
    default tile also the other two kernels (heavy key ties with the rank
    plane).  The launch counters move only where a kernel launched."""
    rng = np.random.default_rng(8)
    plane = tb.RANK if ranked else ""
    for k_start in sorted({k for k in (2, 4, tile // 2, tile) if 2 <= k <= tile}):
        for keys, ranks in _tile_inputs(rng, (3, 2 * tile), dtype, ranked):
            x = torch.from_numpy(keys).to(cuda)
            r = torch.from_numpy(ranks).to(cuda) if ranked else None
            px, pr = x.clone(), r.clone() if ranked else None
            tb.reset_launch_counts()
            tb.bitonic_tile(x, tile, k_start, r)
            tb.tile_sort_plain(px, tile, k_start, pr)
            torch.cuda.synchronize()
            assert torch.equal(x, px), (tile, k_start)
            if ranked:
                assert torch.equal(r, pr), (tile, k_start)
            assert tb.launch_counts()["bitonic_tile_kernel" + plane] == 1
    if tile != tb.TILE:
        return
    keys = _keys(rng, (4, 16384), dtype)
    if ranked:
        keys = keys % 7
    x = torch.from_numpy(keys).to(cuda)
    r = torch.from_numpy(rng.permutation(4 * 16384).astype(np.int32).reshape(4, -1)).to(cuda)
    cases = [
        ("bitonic_tile_kernel", lambda t, q: tb.bitonic_tile(t, 4096, 2, q),
         lambda t, q: tb.tile_sort_plain(t, 4096, 2, q)),
        ("bitonic_tile_kernel", lambda t, q: tb.bitonic_tile(t, 4096, 256, q),
         lambda t, q: tb.tile_sort_plain(t, 4096, 256, q)),
        ("bitonic_global_stage_kernel", lambda t, q: tb.bitonic_global_stage(t, 16384, 8192, q),
         lambda t, q: tb.global_stage_plain(t, 16384, 8192, q)),
        ("bitonic_tile_merge_kernel", lambda t, q: tb.bitonic_tile_merge(t, 4096, 16384, q),
         lambda t, q: tb.tile_merge_plain(t, 4096, 16384, q)),
    ]
    for name, kernel, plain in cases:
        tb.reset_launch_counts()
        kx, kr = x.clone(), r.clone() if ranked else None
        px, pr = x.clone(), r.clone() if ranked else None
        kernel(kx, kr)
        plain(px, pr)
        torch.cuda.synchronize()
        assert torch.equal(kx, px), name
        if ranked:
            assert torch.equal(kr, pr), name
        assert tb.launch_counts()[name + plane] == 1
        assert sum(tb.launch_counts().values()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ranked,tile", TILE_SWEEP)
def test_tile_merge_matches_plain_version(cuda, dtype, ranked, tile):
    """The tile merge bit-identical to its plain version at every tile the
    wrapper admits, on rows of 8 tiles at k in {2T, 4T, 8T}: k < row_len
    puts tiles of both directions in a row.  Random keys, ties that the
    rank plane decides, full (key, rank) ties and extreme keys; one launch
    counted per call."""
    rng = np.random.default_rng(12)
    plane = tb.RANK if ranked else ""
    for k in (2 * tile, 4 * tile, 8 * tile):
        for keys, ranks in _tile_inputs(rng, (3, 8 * tile), dtype, ranked):
            x = torch.from_numpy(keys).to(cuda)
            r = torch.from_numpy(ranks).to(cuda) if ranked else None
            px, pr = x.clone(), r.clone() if ranked else None
            tb.reset_launch_counts()
            tb.bitonic_tile_merge(x, tile, k, r)
            assert tb.launch_counts()["bitonic_tile_merge_kernel" + plane] == 1
            assert sum(tb.launch_counts().values()) == 1
            tb.tile_merge_plain(px, tile, k, pr)
            torch.cuda.synchronize()
            assert torch.equal(x, px), (tile, k)
            if ranked:
                assert torch.equal(r, pr), (tile, k)


@pytest.mark.cuda
@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_global_stage_groups_match_plain_version(cuda, dtype, ranked):
    """The global-stage kernel bit-identical to ``global_stage_plain(...,
    stages=s)`` for every s up to S_max, for the top group of the top level
    (j = row_len/2) and the bottom group of a lower level (j_low = T, both
    directions in a row), on random keys, keys % 7 with permuted ranks and
    with ranks in {0, 1, 2}; one launch counted per call.  The library's
    S_max equals `STAGES_MAX`."""
    from dsort_tpu_torch.ops._build import library

    t = torch.from_numpy(np.zeros(0, dtype)).dtype
    s_max = tb.STAGES_MAX[(t, ranked)]
    assert library().dsort_bitonic_global_stages_max(t.itemsize, int(ranked)) == s_max
    rng = np.random.default_rng(16)
    rows, row_len = 4, 1 << 19
    inputs = [(_keys(rng, (rows, row_len), dtype), None)]
    if ranked:
        perm = rng.permutation(rows * row_len).astype(np.int32).reshape(rows, row_len)
        mod7 = _keys(rng, (rows, row_len), dtype) % 7
        inputs = [(inputs[0][0], perm), (mod7, perm),
                  (mod7, rng.integers(0, 3, (rows, row_len)).astype(np.int32))]
    plane = tb.RANK if ranked else ""
    for keys, ranks in inputs:
        x = torch.from_numpy(keys).to(cuda)
        r = torch.from_numpy(ranks).to(cuda) if ranked else None
        for s in range(1, s_max + 1):
            for k, j in ((row_len, row_len // 2), (row_len // 2, tb.TILE << (s - 1))):
                kx, kr = x.clone(), r.clone() if ranked else None
                px, pr = x.clone(), r.clone() if ranked else None
                tb.reset_launch_counts()
                tb.bitonic_global_stage(kx, k, j, kr, stages=s)
                assert tb.launch_counts()["bitonic_global_stage_kernel" + plane] == 1
                assert sum(tb.launch_counts().values()) == 1
                tb.global_stage_plain(px, k, j, pr, stages=s)
                torch.cuda.synchronize()
                assert torch.equal(kx, px), (s, k, j)
                if ranked:
                    assert torch.equal(kr, pr), (s, k, j)


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
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_pair_sort_and_kv_merge_on_cuda(cuda, dtype):
    """block_sort_pairs / block_merge_runs_kv on the card equal their plain
    versions on the CPU (sentinel-valued keys and ties included)."""
    rng = np.random.default_rng(11)
    keys = _keys(rng, (3, 50_000), dtype) % 1000
    keys[:, :100] = np.iinfo(dtype).max
    rank = rng.permutation(keys.size).astype(np.int32).reshape(keys.shape)
    got = tb.block_sort_pairs(torch.from_numpy(keys).to(cuda), torch.from_numpy(rank).to(cuda))
    want = tb.block_sort_pairs(torch.from_numpy(keys), torch.from_numpy(rank))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    k2, r2 = want[0].numpy().reshape(3, 10, 5_000), want[1].numpy().reshape(3, 10, 5_000)
    got = tb.block_merge_runs_kv(torch.from_numpy(k2).to(cuda), torch.from_numpy(r2).to(cuda))
    want = tb.block_merge_runs_kv(torch.from_numpy(k2), torch.from_numpy(r2))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _exchange_inputs(rng, p, n_local, dtype, row_bytes):
    """Sorted shards, a random bucket split of each, caps covering it."""
    xs = np.sort(_keys(rng, (p, n_local), dtype), axis=1)
    cuts = np.sort(rng.integers(0, n_local + 1, (p, p - 1)), axis=1)
    starts = np.concatenate([np.zeros((p, 1), np.int64), cuts], axis=1)
    lens = np.diff(np.concatenate([starts, np.full((p, 1), n_local)], axis=1), axis=1)
    caps = tuple(
        int(-(-max(lens[s, (s + k) % p] for s in range(p)) // 8) * 8) or 8 for k in range(p)
    )
    payload = rng.integers(0, 256, (p, n_local, row_bytes), dtype=np.uint8)
    return xs, starts.astype(np.int64), lens.astype(np.int64), caps, payload


@pytest.mark.cuda
@pytest.mark.parametrize("p,dtype,row_bytes", [
    (8, np.int32, 92), (7, np.int64, 13), (2, np.int64, 16),
    (3, np.int32, 1), (5, np.int64, 100), (4, np.int32, 256), (6, np.int64, 92),
])
def test_ring_exchange_and_gather_match_plain(cuda, p, dtype, row_bytes):
    """The exchange (keys, kv) and the gather bit-identical to their plain
    versions; the gather on the exchange's workspace, with its tags a slice
    of wider rows (stride above total), and on a ``total`` that is not a
    multiple of 32, tags below 0 and at or above ``total`` included."""
    rng = np.random.default_rng(p)
    xs, starts, lens, caps, payload = _exchange_inputs(rng, p, 20_000, dtype, row_bytes)
    host = [torch.from_numpy(a) for a in (xs, starts, lens, payload)]
    dev = [t.to(cuda) for t in host]
    rk.reset_launch_counts()
    for kv in (False, True):
        got = rk.ring_exchange(*dev[:3], caps, dev[3] if kv else None)
        want = rk.ring_exchange_plain(*host[:3], caps, host[3] if kv else None)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g.cpu(), w)
    total = sum(caps)
    ws = want[2]
    for rows, extra in ((ws, 0), (ws, 37), (ws[:, : total - 3].contiguous(), 5)):
        n = rows.shape[1]
        tags = torch.from_numpy(rng.integers(-3, 2 * n, (p, n + extra)).astype(np.int32))[:, :n]
        got = rk.gather_rows(rows.to(cuda), tags.to(cuda))
        assert torch.equal(got.cpu(), rk.gather_rows_plain(rows, tags))
    assert rk.launch_counts() == {
        "ring_exchange_kernel": 1, "ring_exchange_kernel+kv": 1, "gather_rows_kernel": 3,
    }


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["alltoall", "ring", "fused"])
def test_sample_sort_on_cuda_goes_through_the_kernels(cuda, exchange):
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    rng = np.random.default_rng(10)
    x = _keys(rng, 1 << 20, np.int32)
    tb.reset_launch_counts()
    rk.reset_launch_counts()
    out = SampleSort(VirtualMesh(8)).sort(x, exchange=exchange)
    np.testing.assert_array_equal(out, np.sort(x))
    counts = tb.launch_counts()
    assert all(counts[name] for name in tb.WRAPPERS), counts
    assert rk.launch_counts()["ring_exchange_kernel"] == (exchange == "fused")


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["alltoall", "ring", "fused"])
def test_sort_kv_on_cuda(cuda, exchange):
    from dsort_tpu_torch.data.ingest import gen_terasort
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    keys, payload = gen_terasort(1 << 20, seed=5)
    keys[:50] = np.iinfo(np.uint64).max  # sentinel-valued keys keep their payloads
    tb.reset_launch_counts()
    rk.reset_launch_counts()
    ko, vo = SampleSort(VirtualMesh(8)).sort_kv(keys, payload, exchange=exchange)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ko, keys[order])
    tail = len(keys) - 50
    np.testing.assert_array_equal(vo[:tail], payload[order][:tail])
    assert sorted(map(bytes, vo[tail:])) == sorted(map(bytes, payload[order][tail:]))
    assert tb.launch_counts()["bitonic_global_stage_kernel+rank"] > 0
    assert rk.launch_counts()["gather_rows_kernel"] == (exchange == "fused")


@pytest.mark.cuda
def test_seven_shards_on_cuda(cuda):
    """A non-power-of-two mesh on the card: whole sentinel slots in the
    fused merge layout, for keys and records."""
    from dsort_tpu_torch.data.ingest import gen_terasort
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    rng = np.random.default_rng(12)
    ss = SampleSort(VirtualMesh(7))
    x = _keys(rng, 700_001, np.int64)
    for exchange in ("ring", "fused"):
        np.testing.assert_array_equal(ss.sort(x, exchange=exchange), np.sort(x))
    keys, payload = gen_terasort(300_001, seed=6)
    ko, vo = ss.sort_kv(keys, payload, exchange="fused")
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ko, keys[order])
    np.testing.assert_array_equal(vo, payload[order])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tile_rows", [(np.int32, 2), (np.int32, 256), (np.int64, 256),
                                             (np.int64, 512)])
def test_tile_sorts_match_plain_versions(cuda, dtype, tile_rows):
    """S1 / S2 bit-identical to their plain versions, through one CTA per
    tile and through the cluster routes (8 CTAs at 32,768 and 65,536
    keys)."""
    from dsort_tpu_torch.ops import pallas_sort as ps

    rng = np.random.default_rng(13)
    tile = tile_rows * ps.LANES
    x = torch.from_numpy(_keys(rng, (4, 2 * tile), dtype)).to(cuda)
    ps.reset_launch_counts()
    got = ps.tile_sort(x.clone(), tile_rows)
    assert torch.equal(got, ps.tile_sort_plain(x.clone(), tile_rows))
    assert torch.equal(got.view(-1, tile), torch.sort(x.view(-1, tile)).values)
    k = x % 5  # ties: the index decides
    v = torch.randperm(k.numel(), device=cuda, dtype=torch.int32).view(k.shape)
    gk, gv = ps.tile_sort_kv(k.clone(), v.clone(), tile_rows)
    pk, pv = ps.tile_sort_kv_plain(k.clone(), v.clone(), tile_rows)
    assert torch.equal(gk, pk) and torch.equal(gv, pv)
    assert ps.launch_counts() == {
        "tile_sort_kernel": 1, "tile_sort_kv_kernel": 1, "radix_histogram_kernel": 0,
    }


S1_SWEEP = [(dtype, 1 << e) for dtype, top in ((np.int32, 11), (np.int64, 10))
            for e in range(top + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tile_rows", S1_SWEEP)
def test_tile_sort_sweep_matches_plain_version(cuda, dtype, tile_rows):
    """S1 bit-identical to its plain version at every tile_rows the wrapper
    admits (T = 128 keys up to 1, 2, 4 and 8 CTAs a tile), on random keys,
    % 7 ties and extreme keys; one launch counted per call."""
    from dsort_tpu_torch.ops import pallas_sort as ps

    rng = np.random.default_rng(16)
    tile = tile_rows * ps.LANES
    inputs = _tile_inputs(rng, (3 if tile_rows <= 256 else 2, tile), dtype, True)
    for keys, _ in inputs[:2] + inputs[3:]:  # [2] repeats [1]'s keys
        x = torch.from_numpy(keys).to(cuda)
        ps.reset_launch_counts()
        got = ps.tile_sort(x.clone(), tile_rows)
        assert torch.equal(got, ps.tile_sort_plain(x.clone(), tile_rows))
        assert ps.launch_counts()["tile_sort_kernel"] == 1


S2_SWEEP = [(dtype, 1 << e) for dtype in (np.int32, np.int64) for e in range(11)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tile_rows", S2_SWEEP)
def test_tile_sort_kv_sweep_matches_plain_version(cuda, dtype, tile_rows):
    """S2 bit-identical to its plain version at every tile_rows the wrapper
    admits (T = 128 up to 131,072 pairs: 1, 2, 4 and 8 CTAs a tile), on
    random, % 7 and extreme keys, each with the index as an arange, a
    permutation and in {0, 1, 2} (repeated (key, index) pairs); one launch
    counted per call."""
    from dsort_tpu_torch.ops import pallas_sort as ps

    rng = np.random.default_rng(17)
    tile = tile_rows * ps.LANES
    shape = (3 if tile_rows <= 256 else 2, tile)
    n = shape[0] * tile
    inputs = _tile_inputs(rng, shape, dtype, True)
    indices = (np.arange(n, dtype=np.int32).reshape(shape),
               rng.permutation(n).astype(np.int32).reshape(shape),
               rng.integers(0, 3, shape).astype(np.int32))
    for keys, _ in inputs[:2] + inputs[3:]:  # [2] repeats [1]'s keys
        for index in indices:
            k, v = torch.from_numpy(keys).to(cuda), torch.from_numpy(index).to(cuda)
            ps.reset_launch_counts()
            gk, gv = ps.tile_sort_kv(k.clone(), v.clone(), tile_rows)
            pk, pv = ps.tile_sort_kv_plain(k.clone(), v.clone(), tile_rows)
            assert torch.equal(gk, pk) and torch.equal(gv, pv)
            assert ps.launch_counts()["tile_sort_kv_kernel"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.uint64])
def test_radix_histogram_matches_plain_version(cuda, dtype):
    from dsort_tpu_torch.ops import pallas_sort as ps

    rng = np.random.default_rng(14)
    x = torch.from_numpy(_keys(rng, 300_001, dtype)).to(cuda)
    for shift, bits in ((0, 8), (24, 8), (56, 8), (3, 14), (70, 3)):
        got = ps.radix_histogram(x, shift, bits)
        assert torch.equal(got, ps.radix_histogram_plain(x, shift, bits)), (shift, bits)
        assert int(got.sum()) == x.numel()


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["alltoall", "ring"])
def test_pallas_sample_sort_on_cuda(cuda, exchange):
    """local_kernel="pallas" on the card: the tile kernel in phase 1 and
    phase 5, the output equal to numpy's; and pallas_sort_kv stable."""
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.ops import pallas_sort as ps
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    rng = np.random.default_rng(15)
    x = _keys(rng, 1 << 20, np.int64)
    ps.reset_launch_counts()
    out = SampleSort(VirtualMesh(8), JobConfig(local_kernel="pallas")).sort(x, exchange=exchange)
    np.testing.assert_array_equal(out, np.sort(x))
    assert ps.launch_counts()["tile_sort_kernel"] == 2
    keys = _keys(rng, 100_003, np.uint64) % 1000
    rows = rng.integers(0, 256, (100_003, 13), dtype=np.uint8)
    ok, ov = ps.pallas_sort_kv(torch.from_numpy(keys).to(cuda), torch.from_numpy(rows).to(cuda))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(ok.cpu().numpy(), keys[order])
    np.testing.assert_array_equal(ov.cpu().numpy(), rows[order])


# -- the fault plane on the card ----------------------------------------------

_DRILL = dict(settle_delay_s=0.01, heartbeat_timeout_s=5.0)


def _drill(cuda, injector=None, **job):
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.scheduler import SpmdScheduler

    return SpmdScheduler(8, cuda, JobConfig(**{**_DRILL, **job}), injector)


@pytest.mark.cuda
def test_scheduler_loss_before_dispatch_on_cuda(cuda):
    """A worker lost before dispatch: the 7 survivors re-run on the card's
    kernels and return numpy's bits."""
    from dsort_tpu_torch.scheduler import FaultInjector
    from dsort_tpu_torch.utils.metrics import Metrics

    inj = FaultInjector()
    inj.fail_once(2, "spmd")
    sched = _drill(cuda, inj)
    x = _keys(np.random.default_rng(40), 1 << 20, np.int32)
    m = Metrics()
    tb.reset_launch_counts()
    np.testing.assert_array_equal(sched.sort(x, m), np.sort(x))
    assert m.counters["mesh_reforms"] == 1
    assert sched.table.live_workers() == [0, 1, 3, 4, 5, 6, 7]
    counts = tb.launch_counts()
    assert all(counts[name] for name in tb.WRAPPERS), counts


@pytest.mark.cuda
def test_scheduler_mid_ring_loss_fused_on_cuda(cuda):
    """A worker lost between the fused plan and its exchange: one exchange
    launch (the re-run's), two plans, 7 + 6 steps."""
    from dsort_tpu_torch.scheduler import FaultInjector
    from dsort_tpu_torch.utils.metrics import Metrics

    inj = FaultInjector()
    sched = _drill(cuda, inj, exchange="fused")
    z = np.minimum(np.random.default_rng(41).zipf(1.3, 1 << 20), 2**62).astype(np.int64)
    inj.fail_once(3, "ring")
    m = Metrics()
    rk.reset_launch_counts()
    np.testing.assert_array_equal(sched.sort(z, m), np.sort(z))
    assert m.counters["mesh_reforms"] == 1
    assert m.counters["fused_exchange_launches"] == 2
    assert m.counters["exchange_ring_steps"] == 13
    assert rk.launch_counts()["ring_exchange_kernel"] == 1


@pytest.mark.cuda
def test_scheduler_hang_and_failed_probe_on_cuda(cuda):
    """A hung attempt (warm bucket) is detected long before the hang ends;
    worker 3 fails its probe and the job completes on the other 7."""
    import time

    from dsort_tpu_torch.scheduler import FaultInjector
    from dsort_tpu_torch.utils.metrics import Metrics

    inj = FaultInjector()
    sched = _drill(cuda, inj, heartbeat_timeout_s=0.5, compile_grace_s=60.0,
                   exec_allowance_floor_s=0.5, exec_allowance_keys_per_s=1e9,
                   max_transient_retries=5)
    x = _keys(np.random.default_rng(42), 1 << 20, np.int32)
    np.testing.assert_array_equal(sched.sort(x), np.sort(x))  # warm
    inj.hang_once(0, "spmd", seconds=4.0)
    inj.fail_once(3, "probe")
    m = Metrics()
    t0 = time.monotonic()
    out = sched.sort(x, m)
    took = time.monotonic() - t0
    np.testing.assert_array_equal(out, np.sort(x))
    assert took < 4.0, took
    assert m.counters["spmd_wait_timeouts"] == 1 and m.counters["mesh_reforms"] == 1
    assert not sched.table.is_alive(3)
    deadline = time.monotonic() + 30
    while sched.lane_stuck_for("spmd") > 0:  # drain the abandoned attempt
        assert time.monotonic() < deadline
        time.sleep(0.05)


@pytest.mark.cuda
def test_probe_round_trip_and_refused_launch_on_cuda(cuda):
    """The probe is a real round trip to the card; a shape the C entry
    refuses raises `KernelLaunchError` (cudaErrorInvalidValue), which the
    classifier calls a program error."""
    from dsort_tpu_torch.ops.errors import KernelLaunchError
    from dsort_tpu_torch.scheduler.fault import classify_runtime_error

    sched = _drill(cuda)
    assert all(sched._probe_device(i) for i in range(8))
    x = torch.zeros((2, 2048), dtype=torch.int32, device=cuda)
    tb.reset_launch_counts()
    with pytest.raises(KernelLaunchError) as e:
        tb._launch("bitonic_global_stage", x, None, 1024, 1024, 1)  # 2 j > k
    assert (e.value.code, e.value.name) == (1, "cudaErrorInvalidValue")
    assert classify_runtime_error(e.value) is None
    assert tb.launch_counts()["bitonic_global_stage_kernel"] == 0


# -- one-row grids: the fused route and the task pool ------------------------

ONE_ROW = [1 << e for e in range(16, 21)] + [(1 << 17) + 3, (1 << 20) - 1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", ONE_ROW)
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_one_row_block_and_tile_sorts(cuda, dtype, n):
    """`block_sort` and `pallas_sort` of one row of 2^16..2^20 keys (16 to
    256 block tiles, 2 to 32 S1 tiles a row) equal `torch.sort`, each
    kernel of the path launched."""
    from dsort_tpu_torch.ops import pallas_sort as ps

    x = torch.from_numpy(_keys(np.random.default_rng(n), (1, n), dtype)).to(cuda)
    want = torch.sort(x).values
    tb.reset_launch_counts()
    ps.reset_launch_counts()
    assert torch.equal(tb.block_sort(x), want)
    assert torch.equal(ps.pallas_sort(x), want)
    counts = {**tb.launch_counts(), **ps.launch_counts()}
    assert all(counts[name] for name in tb.WRAPPERS), counts
    assert counts["tile_sort_kernel"] == 1, counts


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["auto", "pallas"])
def test_fused_sort_small_on_cuda(cuda, kernel):
    """A fused job of 2^20 - 1 keys sorts one row through the card's
    kernels; below a 2^16-key rung ``auto`` launches no block kernel."""
    from dsort_tpu_torch.models.pipelines import fused_sort_small
    from dsort_tpu_torch.ops import pallas_sort as ps

    rng = np.random.default_rng(43)
    for dtype in (np.int32, np.uint32, np.int64, np.int16):
        x = _keys(rng, (1 << 20) - 1, dtype)
        tb.reset_launch_counts()
        ps.reset_launch_counts()
        np.testing.assert_array_equal(fused_sort_small(x, kernel), np.sort(x))
        counts = {**tb.launch_counts(), **ps.launch_counts()}
        if kernel == "auto" and np.dtype(dtype).itemsize >= 4:
            assert all(counts[name] for name in tb.WRAPPERS), counts
        if kernel == "pallas":
            assert counts["tile_sort_kernel"] == 1, counts
    small = _keys(rng, 1 << 14, np.int32)
    tb.reset_launch_counts()
    np.testing.assert_array_equal(fused_sort_small(small), np.sort(small))
    assert not any(tb.launch_counts().values())


@pytest.mark.cuda
def test_taskpool_kill_on_cuda(cuda):
    """The task pool with worker 3 killed: its shard reassigned to worker 0,
    every shard sorted by the block kernels on one row."""
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.scheduler import DeviceExecutor, FaultInjector, Scheduler
    from dsort_tpu_torch.utils.metrics import Metrics

    inj = FaultInjector()
    inj.kill(3)
    pool = Scheduler(DeviceExecutor(8, cuda, inj), JobConfig(settle_delay_s=0.01))
    x = _keys(np.random.default_rng(44), 1 << 21, np.int32)
    m = Metrics()
    tb.reset_launch_counts()
    np.testing.assert_array_equal(pool.run_job(x, m), np.sort(x))
    assert m.counters["reassignments"] == 1 and not pool.table.is_alive(3)
    assert tb.launch_counts()["bitonic_tile_kernel"] == 8


def _fnv_multiset(a):
    """The host FNV-1a multiset checksum (`models.validate._multiset`)."""
    from dsort_tpu_torch.models.validate import _multiset

    return _multiset(a, len(a), a.dtype.itemsize)


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["alltoall", "ring", "fused"])
def test_keep_on_device_round_trip_on_cuda(cuda, exchange):
    """keep_on_device on the card: the handle's rows stay on the GPU, its
    checksum equals the input's, to_host equals np.sort, the lengths equal
    sort_ranges', and the block kernels (and the ring kernel under fused)
    launched."""
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    x = _keys(np.random.default_rng(45), 1 << 20, np.int32)
    ss = SampleSort(VirtualMesh(8))
    tb.reset_launch_counts()
    rk.reset_launch_counts()
    h = ss.sort(x, keep_on_device=True, exchange=exchange)
    assert h._rows().device.type == "cuda"
    counts = tb.launch_counts()
    assert all(counts[name] for name in tb.WRAPPERS), counts
    assert rk.launch_counts()["ring_exchange_kernel"] == (exchange == "fused")
    rep = h.validate_on_device()
    assert rep.sorted_ok and rep.records == len(x) and rep.checksum == _fnv_multiset(x)
    np.testing.assert_array_equal(h.to_host(), np.sort(x))
    lengths = [len(r) for r in ss.sort_ranges(x, exchange=exchange)]
    np.testing.assert_array_equal(h.shard_lengths, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.uint64,
                                   np.int8, np.uint8, np.int16, np.uint16])
def test_keep_on_device_dtypes_on_cuda(cuda, dtype):
    """Every integer dtype on the card: pads at the dtype's maximum, the
    device checksum equal to the host one, an in-row and a boundary break
    caught."""
    from dsort_tpu_torch.parallel import DeviceSortResult
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort

    x = _keys(np.random.default_rng(46), 1 << 18, dtype)
    h = SampleSort(VirtualMesh(8)).sort(x, keep_on_device=True)
    rows = h._rows()
    assert rows.device.type == "cuda" and h.dtype == dtype
    host_rows = rows.cpu().numpy()
    for i, c in enumerate(h.shard_lengths):
        assert (host_rows[i, c:] == np.iinfo(dtype).max).all()
    rep = h.validate_on_device()
    assert rep.sorted_ok and rep.checksum == _fnv_multiset(x)
    np.testing.assert_array_equal(h.to_host(), np.sort(x))
    keys = (np.arange(256) + np.iinfo(dtype).min).astype(dtype)  # 256 distinct, ascending
    swapped = keys.copy()
    swapped[[74, 75]] = keys[[75, 74]]
    for label, k in (("in-row break", swapped), ("boundary break",
                                                 keys.reshape(4, 64)[::-1].reshape(-1))):
        rows = torch.from_numpy(np.ascontiguousarray(k)).to(cuda).view(4, 64)
        rep = DeviceSortResult(rows, [64] * 4, 256).validate_on_device()
        assert not rep.sorted_ok and rep.checksum == _fnv_multiset(keys), label


@pytest.mark.cuda
def test_fused_handle_read_from_another_thread_on_cuda(cuda):
    """fused_sort_small returns its handle without a synchronize; another
    thread reads it correctly."""
    import threading

    from dsort_tpu_torch.models.pipelines import fused_sort_small

    x = _keys(np.random.default_rng(48), (1 << 20) - 1, np.int32)
    h = fused_sort_small(x, keep_on_device=True)
    box = {}
    reader = threading.Thread(target=lambda: box.update(
        rep=h.validate_on_device(), host=h.to_host()))
    reader.start()
    reader.join(timeout=120)
    assert not reader.is_alive()
    assert box["rep"].sorted_ok and box["rep"].checksum == _fnv_multiset(x)
    np.testing.assert_array_equal(box["host"], np.sort(x))


@pytest.mark.cuda
def test_keep_on_device_rerun_drill_on_cuda(cuda):
    """A later job's worker loss invalidates a handle made before it; its next use
    re-runs once on the card and is right."""
    from dsort_tpu_torch.scheduler import FaultInjector
    from dsort_tpu_torch.utils.metrics import Metrics

    inj = FaultInjector()
    sched = _drill(cuda, inj)
    x = _keys(np.random.default_rng(49), 1 << 20, np.int32)
    m = Metrics()
    h = sched.sort(x, m, keep_on_device=True)
    inj.fail_once(2, "spmd")
    sched.sort(x[: 1 << 16], m)
    assert not h.valid and m.counters["mesh_reforms"] == 1
    np.testing.assert_array_equal(h.to_host(), np.sort(x))
    assert h.valid and m.counters["device_handle_reruns"] == 1
    assert h.validate_on_device().checksum == _fnv_multiset(x)


# -- radix, hier and the coded plane on the card -------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64, np.uint64, np.int16,
                                   np.uint8, np.float32, np.float64])
def test_radix_sort_on_cuda_matches_cpu(cuda, dtype):
    """The plain PyTorch radix sort on the card gives its CPU bits, rows
    batched, records stable."""
    from dsort_tpu_torch.ops.radix import radix_sort, radix_sort_kv

    rng = np.random.default_rng(50)
    if np.dtype(dtype).kind == "f":
        x = (rng.standard_normal((3, 20001)) * 1e3).astype(dtype)
        x[0, :4] = [np.nan, -np.nan, -0.0, np.inf]
    else:
        x = _keys(rng, (3, 20001), dtype)
    t = torch.from_numpy(x)
    got = radix_sort(t.to(cuda)).cpu()
    want = radix_sort(t)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    k = torch.from_numpy(rng.integers(0, 64, 30000).astype(np.int64))
    v = torch.from_numpy(rng.integers(0, 256, (30000, 90), dtype=np.uint8))
    gk, gv = radix_sort_kv(k.to(cuda), v.to(cuda))
    perm = np.argsort(k.numpy(), kind="stable")
    np.testing.assert_array_equal(gk.cpu().numpy(), k.numpy()[perm])
    np.testing.assert_array_equal(gv.cpu().numpy(), v.numpy()[perm])


@pytest.mark.cuda
@pytest.mark.parametrize("hosts", [2, 4])
def test_hier_sort_on_cuda(cuda, hosts):
    """hier at 2^20 int32 on the card: numpy's bits and ring's per-shard
    counts, the block kernels launched for the local sort and the merges."""
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.parallel.sample_sort import SampleSort
    from dsort_tpu_torch.utils.metrics import Metrics

    x = _keys(np.random.default_rng(51), 1 << 20, np.int32)
    ss = SampleSort(VirtualMesh(8, cuda), JobConfig(exchange="hier", hier_hosts=hosts))
    tb.reset_launch_counts()
    m = Metrics()
    np.testing.assert_array_equal(ss.sort(x, m), np.sort(x))
    got = tb.launch_counts()
    assert got["bitonic_tile_kernel"] and got["bitonic_tile_merge_kernel"], got
    assert m.counters["hier_exchanges"] == 1
    ring = SampleSort(VirtualMesh(8, cuda), JobConfig(exchange="ring"))
    assert [len(r) for r in ss.sort_ranges(x)] == [len(r) for r in ring.sort_ranges(x)]


@pytest.mark.cuda
@pytest.mark.parametrize("red,mode", [(2, "replicate"), (2, "parity"), (3, "parity")])
def test_coded_recovery_on_cuda(cuda, red, mode):
    """A mid-ring loss at 2^20 int32 on the card: one attempt, the dead
    range rebuilt from the plane copied to the host, numpy's bits."""
    from dsort_tpu_torch.scheduler import FaultInjector
    from dsort_tpu_torch.utils.events import EventLog
    from dsort_tpu_torch.utils.metrics import Metrics

    x = _keys(np.random.default_rng(52), 1 << 20, np.int32)
    inj = FaultInjector()
    sched = _drill(cuda, inj, exchange="ring", redundancy=red, redundancy_mode=mode)
    np.testing.assert_array_equal(sched.sort(x), np.sort(x))
    inj.fail_once(3, "ring")
    m = Metrics(journal=EventLog())
    np.testing.assert_array_equal(sched.sort(x, m), np.sort(x))
    types = m.journal.types()
    assert types.count("attempt_start") == 1 and m.counters["coded_recoveries"] == 1


@pytest.mark.cuda
def test_gf2mul_and_parity_fold_on_cuda(cuda):
    from dsort_tpu_torch.parallel import exchange as ex

    x = torch.arange(256, dtype=torch.uint8)
    got = ex._gf2mul_u8(x.to(cuda))
    assert got.dtype == torch.uint8 and torch.equal(got.cpu(), ex._gf2mul_u8(x))
    rows = [torch.randint(0, 256, (8, 4096), dtype=torch.uint8) for _ in range(8)]
    for a, b in zip(ex._parity_fold([r.to(cuda) for r in rows], 2), ex._parity_fold(rows, 2)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32, np.float32])
def test_external_sort_on_cuda(cuda, tmp_path, dtype):
    """`ExternalSort` of 2^20 keys in 4 runs on the card: numpy's bits (the
    float oracle through the ordered-uint order), the block kernels
    launched for every run, and a resume that sorts nothing."""
    from dsort_tpu_torch.models.external_sort import ExternalSort
    from dsort_tpu_torch.ops.float_order import float_to_ordered_uint, ordered_uint_to_float
    from dsort_tpu_torch.utils.metrics import Metrics

    rng = np.random.default_rng(40)
    if dtype == np.float32:
        data = rng.standard_normal(1 << 20).astype(dtype)
        data[::97] = np.nan
        data[::89] = -0.0
        want = ordered_uint_to_float(np.sort(float_to_ordered_uint(data)), dtype)
    else:
        data = _keys(rng, 1 << 20, dtype)
        want = np.sort(data)
    s = ExternalSort(run_elems=1 << 18, spill_dir=str(tmp_path), job_id="x")
    tb.reset_launch_counts()
    m = Metrics()
    out = s.sort(data, metrics=m)
    assert np.array_equal(out.view(f"u{out.dtype.itemsize}"), want.view(f"u{want.dtype.itemsize}"))
    assert m.counters["runs_sorted"] == 4
    assert tb.launch_counts()["bitonic_tile_kernel"] >= 4
    m2 = Metrics()
    s.sort(data, metrics=m2)
    assert m2.counters["runs_resumed"] == 4 and "runs_sorted" not in m2.counters


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["ring", "fused", "hier"])
def test_external_wave_sort_on_cuda(cuda, tmp_path, exchange):
    """`ExternalWaveSort(VirtualMesh(8))` of 2^20 int32 in 4 waves on the
    card: numpy's bits, the block kernels launched in every wave's plan
    (``block``: rows of 2^15 keys are under ``auto``'s threshold), one R1
    launch a wave under ``fused``; and with the overlap off the same
    bits."""
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.models.wave_sort import ExternalWaveSort
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.utils.metrics import Metrics

    data = _keys(np.random.default_rng(41), 1 << 20, np.int32)
    for overlap in (True, False):
        s = ExternalWaveSort(VirtualMesh(8), wave_elems=1 << 18, spill_dir=str(tmp_path),
                             job_id=f"w{overlap}", exchange=exchange, overlap=overlap,
                             job=JobConfig(local_kernel="block"))
        tb.reset_launch_counts()
        rk.reset_launch_counts()
        m = Metrics()
        out = s.sort(data, metrics=m)
        torch.cuda.synchronize()
        assert np.array_equal(out, np.sort(data))
        assert m.counters["waves_sorted"] == 4
        assert tb.launch_counts()["bitonic_tile_kernel"] >= 4
        assert rk.launch_counts()["ring_exchange_kernel"] == (4 if exchange == "fused" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", [False, True])
def test_external_wave_sort_cuda_error_propagates_on_cuda(cuda, tmp_path, overlap):
    """A `cudaErrorLaunchFailure` in wave 2's dispatch on the card is not
    repaired on the host: the job raises it, no run is re-sorted, waves 0
    and 1 are durable, and the re-run resumes them and sorts the other
    two waves on the card."""
    from dsort_tpu_torch.checkpoint import ShardCheckpoint
    from dsort_tpu_torch.config import JobConfig
    from dsort_tpu_torch.models.wave_sort import ExternalWaveSort
    from dsort_tpu_torch.ops.errors import KernelLaunchError
    from dsort_tpu_torch.parallel.mesh import VirtualMesh
    from dsort_tpu_torch.utils.metrics import Metrics

    data = _keys(np.random.default_rng(42), 1 << 20, np.int32)

    def sorter():
        return ExternalWaveSort(VirtualMesh(8), wave_elems=1 << 18, spill_dir=str(tmp_path),
                                job_id="lost", overlap=overlap,
                                job=JobConfig(local_kernel="block"))

    s = sorter()
    calls = {"n": 0}

    def hook():
        calls["n"] += 1
        if calls["n"] == 3:
            raise KernelLaunchError("ring_exchange", 719)

    s.fault_hook = hook
    m = Metrics()
    with pytest.raises(KernelLaunchError) as e:
        s.sort(data, metrics=m)
    assert e.value.name == "cudaErrorLaunchFailure"
    assert "wave_runs_resorted" not in m.counters
    done = ShardCheckpoint(str(tmp_path), "lost").completed_wave_runs()
    assert sorted({w for w, _ in done}) == [0, 1] and len(done) == 16
    tb.reset_launch_counts()
    m = Metrics()
    out = sorter().sort(data, metrics=m)
    torch.cuda.synchronize()
    assert np.array_equal(out, np.sort(data))
    assert m.counters["runs_resumed"] == 16 and m.counters["waves_sorted"] == 2
    assert tb.launch_counts()["bitonic_tile_kernel"] >= 2
