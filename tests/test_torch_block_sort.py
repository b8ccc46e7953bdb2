"""The port's block-bitonic sort against the JAX package's Pallas kernels.

Same seeded numpy inputs through both: the JAX kernels run in the Pallas
interpreter (as ``tests/test_block_sort.py`` runs them, small
``tile_rows=8`` / ``block_rows=64`` tiles), the port's on ``device="cpu"``,
where every wrapper takes its kernel's plain PyTorch version.  Sorting is
exact, so every comparison is bit-for-bit equality.  The CUDA kernels
themselves are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsort_tpu.ops import block_sort as jb
from dsort_tpu_torch.ops import block_sort as tb
from test_block_sort import _deep_interpret_ok

# The JAX kernels' tile (rows=8 x 128 lanes) in keys.
JAX_TILE = 8 * 128
# Port tiles of the deep cases: the JAX tile, and a small one that leaves
# 2^7 or more tiles a row, so a level's cross stages split into a full
# group of S_max stages and a remainder (S_max <= 6).
DEEP_TILES = (JAX_TILE, 128)


@pytest.fixture(scope="module")
def deep():
    """Skip exactly where the JAX suite skips its deep interpreter cases."""
    if not _deep_interpret_ok():
        pytest.skip("pallas interpreter on this jax cannot lower the deep "
                    "cross/orbit kernels (MLIR i64 operand mismatch)")


def _keys(rng, n, dtype):
    """Random keys over the dtype's full range, with its extremes, -1 (or
    1 for unsigned) and heavy duplicates mixed in."""
    dtype = np.dtype(dtype)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    special = np.array(
        [info.min, info.max, 0, 1, -1 if info.min < 0 else 2], dtype=dtype
    )
    x[: n // 4] = rng.choice(special, n // 4)
    rng.shuffle(x)
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}")


def _alternating_runs(rng, n, run):
    """n int32 keys as runs of ``run`` keys, even runs ascending, odd
    descending — the input a merge level ``2*run`` expects."""
    x = np.sort(rng.integers(-(2**31), 2**31, (n // run, run)).astype(np.int32), 1)
    x[1::2] = x[1::2, ::-1]
    return x.reshape(-1)


@pytest.mark.parametrize("case", ["random", "extremes"])
def test_tile_sort_plain_matches_k1(case):
    """tile_sort_plain(T=1024) == K1 `_tile_sort_cm(rows=8)`: 4 tiles,
    alternately ascending and descending."""
    rng = np.random.default_rng(1)
    x = (rng.integers(-(2**31), 2**31, 4 * JAX_TILE).astype(np.int32)
         if case == "random" else _keys(rng, 4 * JAX_TILE, np.int32))
    (ref,) = jb._tile_sort_cm((jnp.asarray(x.reshape(-1, 128)),), 8, True)
    out = tb.tile_sort_plain(torch.from_numpy(x.copy()).view(1, -1), JAX_TILE)
    np.testing.assert_array_equal(out.numpy().reshape(-1), np.asarray(ref).reshape(-1))


@pytest.mark.parametrize("k_start", [4, 64, 1024])
def test_tile_sort_plain_k_start_matches_k1b(k_start):
    """tile_sort_plain(k_start) == K1b `_sort_levels(rows=8, k_start)` on
    alternately directed runs of k_start/2 keys."""
    rng = np.random.default_rng(k_start)
    x = _alternating_runs(rng, 4 * JAX_TILE, k_start // 2)
    (ref,) = jb._sort_levels((jnp.asarray(x.reshape(-1, 128)),), 8, k_start, True, True)
    out = tb.tile_sort_plain(torch.from_numpy(x.copy()).view(1, -1), JAX_TILE, k_start)
    np.testing.assert_array_equal(out.numpy().reshape(-1), np.asarray(ref).reshape(-1))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
def test_block_sort_single_block_matches_jax(dtype):
    """n=1000 (not a power of two) fits one JAX merge block."""
    rng = np.random.default_rng(2)
    x = _keys(rng, 1000, dtype)
    ref = np.asarray(jb.block_sort(jnp.asarray(x), block_rows=64, tile_rows=8, interpret=True))
    out = tb.block_sort(torch.from_numpy(x), tile=JAX_TILE).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(out, np.sort(x))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64, np.uint64])
def test_block_sort_deep_matches_jax(dtype, deep):
    """n=9000 spans several JAX blocks: K1, K2a, K2/K2c and K2b/K3 all run
    there; tile, global-stage and tile-merge all run here."""
    rng = np.random.default_rng(3)
    x = _keys(rng, 9000, dtype)
    ref = np.asarray(jb.block_sort(jnp.asarray(x), block_rows=64, tile_rows=8, interpret=True))
    for tile in DEEP_TILES:
        out = tb.block_sort(torch.from_numpy(x), tile=tile).numpy()
        np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(out, np.sort(x))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 129, 1024, 1025, 5000])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64, np.uint64])
def test_block_sort_matches_numpy(n, dtype):
    rng = np.random.default_rng(n)
    x = _keys(rng, n, dtype)
    out = tb.block_sort(torch.from_numpy(x), tile=256).numpy()
    np.testing.assert_array_equal(out, np.sort(x))


@pytest.mark.parametrize("value", [np.iinfo(np.int32).min, -1, 0, np.iinfo(np.int32).max])
def test_block_sort_all_equal_keys(value):
    x = np.full(3000, value, np.int32)
    np.testing.assert_array_equal(tb.block_sort(torch.from_numpy(x), tile=256).numpy(), x)


def test_block_sort_batched_rows_sort_independently():
    rng = np.random.default_rng(4)
    x = rng.integers(-50, 50, (5, 3000)).astype(np.int64)
    out = tb.block_sort(torch.from_numpy(x), tile=512).numpy()
    np.testing.assert_array_equal(out, np.sort(x, axis=1))


def _sorted_runs(rng, r, l, dtype):
    return np.sort(_keys(rng, r * l, dtype).reshape(r, l), axis=1)


@pytest.mark.parametrize("dtype,r,l", [
    (np.int32, 4, 1000), (np.uint32, 3, 700), (np.int64, 8, 512), (np.uint64, 8, 512),
])
def test_block_merge_runs_matches_jax(dtype, r, l):
    rng = np.random.default_rng(r * 1000 + l)
    runs = _sorted_runs(rng, r, l, dtype)
    ref = np.asarray(jb.block_merge_runs(jnp.asarray(runs), block_rows=64, interpret=True))
    out = tb.block_merge_runs(torch.from_numpy(runs), tile=JAX_TILE).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(out, np.sort(runs.reshape(-1)))


def test_block_merge_runs_deep_matches_jax(deep):
    """8 runs of 4096: runs longer than a tile enter at the global stages."""
    rng = np.random.default_rng(5)
    runs = _sorted_runs(rng, 8, 4096, np.int32)
    ref = np.asarray(jb.block_merge_runs(jnp.asarray(runs), block_rows=64, interpret=True))
    for tile in DEEP_TILES:
        out = tb.block_merge_runs(torch.from_numpy(runs), tile=tile).numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("r,l", [(1, 777), (2, 1), (7, 130), (8, 4096)])
def test_block_merge_runs_matches_numpy(r, l):
    rng = np.random.default_rng(r + l)
    runs = _sorted_runs(rng, r, l, np.int64)
    out = tb.block_merge_runs(torch.from_numpy(runs), tile=256).numpy()
    np.testing.assert_array_equal(out, np.sort(runs.reshape(-1)))


def test_block_merge_runs_batched():
    """(B, R, L): each batch entry merges on its own (the post-exchange
    shape, one entry per destination shard)."""
    rng = np.random.default_rng(6)
    runs = np.sort(rng.integers(-9, 9, (3, 8, 300)).astype(np.int32), axis=2)
    out = tb.block_merge_runs(torch.from_numpy(runs), tile=256).numpy()
    np.testing.assert_array_equal(out, np.sort(runs.reshape(3, -1), axis=1))


def _bitonic_tiles(rng, rows, row_len, tile, dtype):
    """Rows of ``tile``-key bitonic tiles: each an ascending run then a
    descending one, cut at random, rotated at random (still bitonic)."""
    x = np.sort(_keys(rng, rows * row_len, dtype).reshape(-1, tile), axis=1)
    for t, (cut, turn) in enumerate(rng.integers(0, tile, (x.shape[0], 2))):
        x[t, cut:] = x[t, cut:][::-1].copy()
        x[t] = np.roll(x[t], turn)
    return x.reshape(rows, row_len)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("tile", [2, 16, 64, 1024])
def test_tile_merge_plain_sorts_bitonic_tiles(tile, dtype):
    """On bitonic tiles the merge of level k sorts each tile in the
    direction of bit k of its in-row index: at k = row_len every tile
    ascends and the merge equals ``torch.sort`` of the ``(n/T, T)`` view
    (the one torch call timed beside the kernel); at k < row_len the
    tiles of a row alternate in runs of k / T."""
    rng = np.random.default_rng(tile)
    rows, row_len = 3, 8 * tile
    x = _bitonic_tiles(rng, rows, row_len, tile, dtype)
    starts = np.arange(rows * row_len // tile) * tile % row_len
    for k in (2 * tile, 4 * tile, row_len):
        got = tb.tile_merge_plain(torch.from_numpy(x.copy()), tile, k).view(-1, tile)
        want = np.sort(x.reshape(-1, tile), axis=1)
        desc = (starts & k) != 0
        want[desc] = want[desc, ::-1]
        np.testing.assert_array_equal(got.numpy(), want)
        if k == row_len:
            assert not desc.any()
            assert torch.equal(got, torch.sort(torch.from_numpy(x).view(-1, tile)).values)


@pytest.mark.parametrize("tile", [2, 8, 16])
def test_small_tile_merge_matches_jax_block_merge_runs(tile):
    """Tiles below a warp (the merge kernel's one-thread and partial-warp
    launches): level by level over 8 alternating runs, the wrapper on a CPU
    tensor equals the plain version, and the merged row equals the JAX
    package's ``block_merge_runs`` (Pallas interpreter) and the port's."""
    rng = np.random.default_rng(70 + tile)
    runs = _sorted_runs(rng, 8, 96, np.int32)
    ref = np.asarray(jb.block_merge_runs(jnp.asarray(runs), block_rows=64, interpret=True))
    buf = np.full((8, 128), np.iinfo(np.int32).max, np.int32)
    buf[:, :96] = runs
    buf[1::2] = buf[1::2, ::-1]
    x = torch.from_numpy(buf.reshape(1, -1).copy())
    s_max = tb.STAGES_MAX[(x.dtype, False)]
    k = 2 * 128  # the merge levels above the run length
    while k <= x.shape[1]:
        for j, stages in tb._cross_groups(k, tile, s_max):
            tb.global_stage_plain(x, k, j, None, stages)
        want = tb.tile_merge_plain(x.clone(), tile, k)
        assert torch.equal(tb.bitonic_tile_merge(x, tile, k), want), k
        k *= 2
    np.testing.assert_array_equal(_bits(x.numpy()[0, :768]), _bits(ref))
    out = tb.block_merge_runs(torch.from_numpy(runs), tile=tile).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-(2**31), 2**31, (2, 4096)).astype(np.int32))
    tb.reset_launch_counts()
    got = tb.bitonic_tile(x.clone(), 1024)
    np.testing.assert_array_equal(got.numpy(), tb.tile_sort_plain(x.clone(), 1024).numpy())
    got = tb.bitonic_global_stage(x.clone(), 4096, 1024)
    np.testing.assert_array_equal(got.numpy(), tb.global_stage_plain(x.clone(), 4096, 1024).numpy())
    got = tb.bitonic_global_stage(x.clone(), 4096, 2048, stages=3)
    np.testing.assert_array_equal(
        got.numpy(), tb.global_stage_plain(x.clone(), 4096, 2048, stages=3).numpy())
    got = tb.bitonic_tile_merge(x.clone(), 1024, 4096)
    np.testing.assert_array_equal(got.numpy(), tb.tile_merge_plain(x.clone(), 1024, 4096).numpy())
    assert not any(tb.launch_counts().values())


@pytest.mark.parametrize("bad", ["dtype", "row_len", "tile", "contiguous", "device", "k",
                                 "no_stages", "stages_over_max", "stages_past_j"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    x = torch.zeros((2, 4096), dtype=torch.int32)
    call = lambda: tb.bitonic_tile(x, 1024)  # noqa: E731
    if bad == "dtype":
        x = x.to(torch.int16)
    elif bad == "row_len":
        x = torch.zeros((2, 3000), dtype=torch.int32)
    elif bad == "tile":
        call = lambda: tb.bitonic_tile(x, 16384)  # noqa: E731
    elif bad == "contiguous":
        x = torch.zeros((4096, 2), dtype=torch.int32).t()
    elif bad == "device":
        x = torch.zeros((2, 4096), dtype=torch.int32, device="meta")
    elif bad == "k":
        call = lambda: tb.bitonic_global_stage(x, 2048, 2048)  # noqa: E731
    elif bad == "no_stages":
        call = lambda: tb.bitonic_global_stage(x, 4096, 2048, stages=0)  # noqa: E731
    elif bad == "stages_over_max":
        s_max = tb.STAGES_MAX[(torch.int32, False)]
        call = lambda: tb.bitonic_global_stage(x, 4096, 2048, stages=s_max + 1)  # noqa: E731
    else:  # the group's last stage would sit below j = 1
        call = lambda: tb.bitonic_global_stage(x, 4096, 4, stages=4)  # noqa: E731
    with pytest.raises((ValueError, TypeError)):
        call()


# -- the grouped cross stages -------------------------------------------------


@pytest.mark.parametrize("s_max", [1, 4, 5])
@pytest.mark.parametrize("g", [1, 4, 5, 6, 11, 14])
def test_cross_groups_cover_each_stage_once(g, s_max):
    """A level with g cross stages: every j from k/2 down to the tile once,
    in order, in ceil(g / s_max) groups of at most s_max stages."""
    tile = 64
    k = tile << g
    groups = tb._cross_groups(k, tile, s_max)
    stages = [j >> s for j, n in groups for s in range(n)]
    assert stages == [k >> e for e in range(1, g + 1)]
    assert len(groups) == -(-g // s_max)
    assert all(1 <= n <= s_max for _, n in groups)


def test_stages_max_table_covers_every_kernel_type():
    assert set(tb.STAGES_MAX) == {(d, r) for d in (torch.int32, torch.int64) for r in (False, True)}
    assert all(1 <= v <= 6 for v in tb.STAGES_MAX.values())


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_global_stage_plain_stages_equal_successive_stages(dtype, ranked):
    """``stages=s`` (and the wrapper on a CPU tensor) equals s one-stage
    calls from j down, for every s up to S_max, at the top and the bottom
    of a level; keys % 7 with ranks in {0, 1, 2} (full ties) for the rank
    plane."""
    rng = np.random.default_rng(41)
    rows, row_len = 3, 1 << 10
    keys = _keys(rng, rows * row_len, dtype).reshape(rows, row_len)
    ranks = None
    if ranked:
        keys = keys % 7
        ranks = torch.from_numpy(rng.integers(0, 3, (rows, row_len)).astype(np.int32))
    x = torch.from_numpy(keys)
    for s in range(1, tb.STAGES_MAX[(x.dtype, ranked)] + 1):
        for k, j in ((row_len, row_len // 2), (row_len // 2, 1 << (s - 1))):
            want, wr = x.clone(), None if ranks is None else ranks.clone()
            for e in range(s):
                tb.global_stage_plain(want, k, j >> e, wr)
            for fn in (tb.global_stage_plain, tb.bitonic_global_stage):
                got, gr = x.clone(), None if ranks is None else ranks.clone()
                fn(got, k, j, gr, stages=s)
                assert torch.equal(got, want), (s, k, j)
                if ranked:
                    assert torch.equal(gr, wr), (s, k, j)


@pytest.mark.parametrize("ranked", [False, True])
def test_network_runs_one_global_stage_call_per_group(monkeypatch, ranked):
    """The host loop on the CPU issues the same grouped calls as on the
    card: per level k > T, `_cross_groups` in order, then one tile merge."""
    calls = []
    real = tb.bitonic_global_stage

    def spy(x, k, j, r=None, stages=1):
        calls.append((k, j, stages))
        return real(x, k, j, r, stages)

    monkeypatch.setattr(tb, "bitonic_global_stage", spy)
    rng = np.random.default_rng(42)
    n, tile = 1 << 13, 32
    x = _keys(rng, n, np.int32)
    if ranked:
        r = rng.permutation(n).astype(np.int32)
        out_k, out_r = tb.block_sort_pairs(torch.from_numpy(x), torch.from_numpy(r), tile=tile)
        order = np.lexsort((r, x))
        np.testing.assert_array_equal(out_r.numpy(), r[order])
    else:
        out_k = tb.block_sort(torch.from_numpy(x), tile=tile)
    np.testing.assert_array_equal(out_k.numpy(), np.sort(x))
    s_max = tb.STAGES_MAX[(torch.int32, ranked)]
    want = [(k, j, s) for k in (tile << e for e in range(1, 9))
            for j, s in tb._cross_groups(k, tile, s_max)]
    assert calls == want
    assert len(calls) == sum(-(-g // s_max) for g in range(1, 9))


# -- the rank plane ----------------------------------------------------------


def _tied_keys(rng, n, dtype):
    """Few distinct keys (so ranks decide), the dtype's extremes and the
    sentinel among them."""
    info = np.iinfo(dtype)
    pool = np.array([info.min, info.max, 0, 1, 7, info.max - 1], dtype=dtype)
    return rng.choice(pool, n)


@pytest.mark.parametrize("case", ["random", "ties"])
def test_tile_sort_plain_rank_matches_k1(case):
    """tile_sort_plain with the rank plane == K1 `_tile_sort_cm` on
    (key, rank) planes: 4 tiles of 1024, alternately directed."""
    rng = np.random.default_rng(21)
    n = 4 * JAX_TILE
    x = (rng.integers(-(2**31), 2**31, n).astype(np.int32)
         if case == "random" else _tied_keys(rng, n, np.int32))
    r = rng.permutation(n).astype(np.int32)
    ref_k, ref_r = jb._tile_sort_cm(
        (jnp.asarray(x.reshape(-1, 128)), jnp.asarray(r.reshape(-1, 128))), 8, True
    )
    k, rk_ = torch.from_numpy(x.copy()).view(1, -1), torch.from_numpy(r.copy()).view(1, -1)
    tb.tile_sort_plain(k, JAX_TILE, 2, rk_)
    np.testing.assert_array_equal(k.numpy().reshape(-1), np.asarray(ref_k).reshape(-1))
    np.testing.assert_array_equal(rk_.numpy().reshape(-1), np.asarray(ref_r).reshape(-1))


@pytest.mark.parametrize("k_start", [4, 256])
def test_tile_sort_plain_rank_k_start_matches_k1b(k_start):
    """The K1b merge entry with a rank plane: alternately directed runs of
    k_start/2 (key, rank) pairs, equal keys included."""
    rng = np.random.default_rng(k_start + 1)
    run = k_start // 2
    n = 4 * JAX_TILE
    x = _tied_keys(rng, n, np.int32).reshape(-1, run)
    r = rng.permutation(n).astype(np.int32).reshape(-1, run)
    order = np.lexsort((r, x), axis=1)
    x, r = np.take_along_axis(x, order, 1), np.take_along_axis(r, order, 1)
    x[1::2], r[1::2] = x[1::2, ::-1], r[1::2, ::-1]
    x, r = x.reshape(-1).copy(), r.reshape(-1).copy()
    ref_k, ref_r = jb._sort_levels(
        (jnp.asarray(x.reshape(-1, 128)), jnp.asarray(r.reshape(-1, 128))), 8, k_start, True, True
    )
    k, rk_ = torch.from_numpy(x.copy()).view(1, -1), torch.from_numpy(r.copy()).view(1, -1)
    tb.tile_sort_plain(k, JAX_TILE, k_start, rk_)
    np.testing.assert_array_equal(k.numpy().reshape(-1), np.asarray(ref_k).reshape(-1))
    np.testing.assert_array_equal(rk_.numpy().reshape(-1), np.asarray(ref_r).reshape(-1))


def _pairs_case(rng, n, dtype, case):
    if case == "random":
        k = _keys(rng, n, dtype)
    elif case == "ties":
        k = _tied_keys(rng, n, dtype)
    elif case == "equal":
        k = np.full(n, 5, dtype)
    else:  # every key the padding sentinel
        k = np.full(n, np.iinfo(dtype).max, dtype)
    return k, rng.permutation(n).astype(np.int32)


PAIR_DTYPES = [np.int32, np.uint32, np.int64, np.uint64]


@pytest.mark.parametrize("case", ["random", "ties", "equal", "sentinel"])
@pytest.mark.parametrize("dtype", PAIR_DTYPES)
def test_block_sort_pairs_single_block_matches_jax(dtype, case):
    """n=1000 (one JAX block; pads engage): keys and permuted ranks equal
    JAX's and the (key, rank) lexsort."""
    rng = np.random.default_rng(31)
    k, r = _pairs_case(rng, 1000, dtype, case)
    ref_k, ref_r = jb.block_sort_pairs(
        jnp.asarray(k), jnp.asarray(r), block_rows=64, tile_rows=8, interpret=True
    )
    out_k, out_r = tb.block_sort_pairs(torch.from_numpy(k), torch.from_numpy(r), tile=JAX_TILE)
    np.testing.assert_array_equal(_bits(out_k.numpy()), _bits(np.asarray(ref_k)))
    np.testing.assert_array_equal(out_r.numpy(), np.asarray(ref_r))
    order = np.lexsort((r, k))
    np.testing.assert_array_equal(out_r.numpy(), r[order])


@pytest.mark.parametrize("dtype", [np.int32, np.uint64])
def test_block_sort_pairs_deep_matches_jax(dtype, deep):
    """n=9000: every JAX pass and every port kernel runs with the rank plane
    (one 32-bit and one 64-bit key type; the single-block test covers all
    four)."""
    rng = np.random.default_rng(32)
    k, r = _pairs_case(rng, 9000, dtype, "ties")
    ref_k, ref_r = jb.block_sort_pairs(
        jnp.asarray(k), jnp.asarray(r), block_rows=64, tile_rows=8, interpret=True
    )
    for tile in DEEP_TILES:
        out_k, out_r = tb.block_sort_pairs(torch.from_numpy(k), torch.from_numpy(r), tile=tile)
        np.testing.assert_array_equal(_bits(out_k.numpy()), _bits(np.asarray(ref_k)))
        np.testing.assert_array_equal(out_r.numpy(), np.asarray(ref_r))


def _kv_runs(rng, r, l, dtype, case):
    """r rows of l (key, rank) pairs, each row sorted by (key, rank), ranks
    the shuffle's ``is_pad * total + position`` with sentinel pads."""
    total = r * l
    k, _ = _pairs_case(rng, total, dtype, case)
    k = k.reshape(r, l)
    rank = np.arange(total, dtype=np.int32).reshape(r, l)
    order = np.lexsort((rank, k), axis=1)
    k, rank = np.take_along_axis(k, order, 1), np.take_along_axis(rank, order, 1)
    k[:, -7:] = np.iinfo(dtype).max  # padded tails: pad ranks above every real one
    rank[:, -7:] = total + np.arange(total).reshape(r, l)[:, -7:]
    return k, rank


@pytest.mark.parametrize("case", ["random", "ties", "sentinel"])
@pytest.mark.parametrize("dtype,r,l", [
    (np.int32, 8, 100), (np.uint32, 3, 700), (np.int64, 8, 128), (np.uint64, 5, 96),
])
def test_block_merge_runs_kv_matches_jax(dtype, r, l, case):
    """Runs shorter than a tile, non-power-of-two rows and lengths: the col
    (2n + j) and row (3n + j) pad ranks engage on both sides."""
    rng = np.random.default_rng(r * l)
    k, rank = _kv_runs(rng, r, l, dtype, case)
    ref_k, ref_r = jb.block_merge_runs_kv(
        jnp.asarray(k), jnp.asarray(rank), block_rows=64, interpret=True
    )
    out_k, out_r = tb.block_merge_runs_kv(torch.from_numpy(k), torch.from_numpy(rank),
                                          tile=JAX_TILE)
    np.testing.assert_array_equal(_bits(out_k.numpy()), _bits(np.asarray(ref_k)))
    np.testing.assert_array_equal(out_r.numpy(), np.asarray(ref_r))
    flat = np.lexsort((rank.reshape(-1), k.reshape(-1)))
    np.testing.assert_array_equal(out_r.numpy(), rank.reshape(-1)[flat])


def test_block_merge_runs_kv_deep_matches_jax(deep):
    """8 runs of 4096 (key, rank) pairs enter at the global stages."""
    rng = np.random.default_rng(33)
    k, rank = _kv_runs(rng, 8, 4096, np.int32, "ties")
    ref_k, ref_r = jb.block_merge_runs_kv(
        jnp.asarray(k), jnp.asarray(rank), block_rows=64, interpret=True
    )
    for tile in DEEP_TILES:
        out_k, out_r = tb.block_merge_runs_kv(torch.from_numpy(k), torch.from_numpy(rank),
                                              tile=tile)
        np.testing.assert_array_equal(out_k.numpy(), np.asarray(ref_k))
        np.testing.assert_array_equal(out_r.numpy(), np.asarray(ref_r))


def test_block_merge_runs_kv_batched_and_small_tile():
    """(B, R, L) batches merge entry by entry; a small tile drives the
    global stages with the rank plane on the CPU."""
    rng = np.random.default_rng(34)
    ks, rs = zip(*(_kv_runs(rng, 6, 300, np.int64, "ties") for _ in range(3)))
    k, rank = np.stack(ks), np.stack(rs)
    out_k, out_r = tb.block_merge_runs_kv(torch.from_numpy(k), torch.from_numpy(rank), tile=64)
    for b in range(3):
        flat = np.lexsort((rank[b].reshape(-1), k[b].reshape(-1)))
        np.testing.assert_array_equal(out_k[b].numpy(), k[b].reshape(-1)[flat])
        np.testing.assert_array_equal(out_r[b].numpy(), rank[b].reshape(-1)[flat])


def test_rank_plane_wrappers_check_the_plane():
    x = torch.zeros((2, 4096), dtype=torch.int32)
    for bad in (torch.zeros((2, 4096), dtype=torch.int64), torch.zeros((2, 2048), dtype=torch.int32),
                torch.zeros((4096, 2), dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            tb.bitonic_global_stage(x, 4096, 2048, bad)
    with pytest.raises(ValueError):  # 4096 x (8 + 4) B is 48 KB; 8192 keys are not
        tb.bitonic_tile(torch.zeros((1, 8192), dtype=torch.int64), 8192, 2,
                        torch.zeros((1, 8192), dtype=torch.int32))
