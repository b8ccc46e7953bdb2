"""Block-bitonic sort and run merge over hand-written CUDA kernels.

Counterpart of ``dsort_tpu/ops/block_sort.py``.  The reference runs the
bitonic network as six Pallas kernels shaped by the TPU's VMEM (K1 tile
sort, K1b level combiner, K2 cross stage, K2c orbit pass, K2a fused low
levels, K2b/K3 span tail).  On Hopper the network is carried by three CUDA
kernels in ``csrc/block_sort.cu``, each beside its plain PyTorch version
here:

  ===========================  =====================  ===================  ====================
  CUDA kernel (wrapper)        replaces               where a stage runs   plain version
  ===========================  =====================  ===================  ====================
  bitonic_tile_kernel          K1 (k_start=2), K1b    registers: 16 keys   `tile_sort_plain`
  (`bitonic_tile`)             (k_start>2)            a thread; j < 512
                                                      in the thread or
                                                      on warp shuffles,
                                                      j >= 512 through
                                                      shared memory
  bitonic_global_stage_kernel  K2, K2c (up to       registers: the 2^S   `global_stage_plain`
  (`bitonic_global_stage`)     S_max stages j>=T of   keys S stages of a
                               one level per launch)  level touch, a
                                                      thread; one HBM pass
  bitonic_tile_merge_kernel    in-block tails of      registers: 8 keys    `tile_merge_plain`
  (`bitonic_tile_merge`)       K2a, K2b/K3            a thread, one level
                                                      k > T, one direction
                                                      a tile; j < 256 in
                                                      the thread or on
                                                      shuffles, j >= 256
                                                      through shared memory
  ===========================  =====================  ===================  ====================

Every function works on a 2-D batch ``(rows, row_len)`` with ``row_len`` a
power of two and sorts each row independently; the top level of every row
is ascending.  Each kernel and plain version takes an optional int32 rank
plane ``r`` of the keys' shape: pairs then compare as ``(key, rank)`` and
the ranks move with their keys — the reference's extra 32-bit plane, which
`block_sort_pairs` and `block_merge_runs_kv` use to carry the payload
permutation.  The 64-bit ``(hi, lo)`` plane split of the reference is a
Mosaic constraint and is not copied: int64 keys are compared natively.
Unsigned and float keys ride as order-preserving signed ints
(`ops.float_order`).

The host loop (`_network`) runs a level's cross stages ``j = k/2..T`` in
groups of at most ``S_max`` consecutive stages (`_cross_groups`), one
global-stage launch a group; ``S_max`` per key type and plane is
`STAGES_MAX`, the mirror of ``kStagesMax`` in the ``.cu``.  The CPU runs
the same groups through the plain version.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
only for a CPU tensor; anything else raises.  `launch_counts` counts the
launches per kernel, apart for those that carried the rank plane
(``<kernel>+rank``); `reset_launch_counts` zeroes them.
"""

from __future__ import annotations

import threading

import torch

from dsort_tpu_torch.ops.errors import KernelLaunchError
from dsort_tpu_torch.ops.float_order import from_signed_keys, to_signed_keys
from dsort_tpu_torch.ops.local_sort import sentinel_for

#: Tile size (keys) of the shared-memory kernels: 16 KB of int32 or 32 KB of
#: int64 per block (32 / 48 KB with the rank plane), inside the 48 KB a
#: launch gets without opting in to more.
TILE = 4096
_SMEM_BYTES = 48 * 1024
_KERNEL_DTYPES = (torch.int32, torch.int64)
#: S_max: the most consecutive stages of one level a global-stage launch
#: runs, per (key dtype, rank plane present); mirrors ``kStagesMax`` in
#: ``csrc/block_sort.cu``, which instantiates S = 1..S_max.
STAGES_MAX = {
    (torch.int32, False): 6,
    (torch.int32, True): 5,
    (torch.int64, False): 6,
    (torch.int64, True): 5,
}


def _is_pow2(v: int) -> bool:
    return v >= 1 and (v & (v - 1)) == 0


def _ceil_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# -- plain PyTorch versions (the same network, written with tensor ops) ------


def _stage_plain(
    x: torch.Tensor, k: int, j: int, r: torch.Tensor | None = None
) -> torch.Tensor:
    """Stage ``(k, j)`` of the network on ``(rows, row_len)``, in place;
    with a rank plane ``r`` pairs compare as ``(key, rank)``."""
    rows, row_len = x.shape
    v = x.view(rows, row_len // (2 * j), 2, j)
    a, b = v[:, :, 0, :], v[:, :, 1, :]
    # Bit k of the in-row index is constant across each 2j-block (k >= 2j).
    start = torch.arange(0, row_len, 2 * j, device=x.device)
    asc = ((start & k) == 0).view(1, -1, 1)
    if r is None:
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        a.copy_(torch.where(asc, lo, hi))
        b.copy_(torch.where(asc, hi, lo))
        return x
    w = r.view(rows, row_len // (2 * j), 2, j)
    ra, rb = w[:, :, 0, :], w[:, :, 1, :]
    a_gt = (a > b) | ((a == b) & (ra > rb))
    b_gt = (b > a) | ((a == b) & (rb > ra))
    swap = torch.where(asc, a_gt, b_gt)
    na, nb = torch.where(swap, b, a), torch.where(swap, a, b)
    nra, nrb = torch.where(swap, rb, ra), torch.where(swap, ra, rb)
    a.copy_(na)
    b.copy_(nb)
    ra.copy_(nra)
    rb.copy_(nrb)
    return x


def tile_sort_plain(
    x: torch.Tensor, tile: int, k_start: int = 2, r: torch.Tensor | None = None
) -> torch.Tensor:
    """Levels ``k_start..tile`` of every ``tile``-key tile, in place."""
    k = k_start
    while k <= tile:
        j = k // 2
        while j >= 1:
            _stage_plain(x, k, j, r)
            j //= 2
        k *= 2
    return x


def global_stage_plain(
    x: torch.Tensor, k: int, j: int, r: torch.Tensor | None = None, stages: int = 1
) -> torch.Tensor:
    """Stages ``j, j/2, .., j >> (stages-1)`` of level ``k`` over whole
    rows, in place."""
    for s in range(stages):
        _stage_plain(x, k, j >> s, r)
    return x


def tile_merge_plain(
    x: torch.Tensor, tile: int, k: int, r: torch.Tensor | None = None
) -> torch.Tensor:
    """Stages ``j = tile/2..1`` of level ``k``, in place."""
    j = tile // 2
    while j >= 1:
        _stage_plain(x, k, j, r)
        j //= 2
    return x


# -- kernel wrappers ---------------------------------------------------------


def _check(x: torch.Tensor, tile: int | None = None, r: torch.Tensor | None = None) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, row_len) tensor, got {tuple(x.shape)}")
    if not _is_pow2(x.shape[1]):
        raise ValueError(f"row_len must be a power of two, got {x.shape[1]}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel keys must be int32 or int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("kernel keys must be contiguous")
    if r is not None:
        if r.dtype != torch.int32 or r.shape != x.shape or r.device != x.device:
            raise ValueError(
                f"the rank plane must be int32 of the keys' shape and device, got "
                f"{r.dtype} {tuple(r.shape)} on {r.device}"
            )
        if not r.is_contiguous():
            raise ValueError("the rank plane must be contiguous")
    if tile is not None:
        if not (_is_pow2(tile) and 2 <= tile <= x.shape[1]):
            raise ValueError(
                f"tile must be a power of two in [2, row_len={x.shape[1]}], got {tile}"
            )
        row_bytes = x.element_size() + (4 if r is not None else 0)
        if tile * row_bytes > _SMEM_BYTES:
            raise ValueError(
                f"tile of {tile} x {row_bytes} B exceeds {_SMEM_BYTES} B "
                "of shared memory"
            )


def _launch(name: str, x: torch.Tensor, r: torch.Tensor | None, *args) -> None:
    from dsort_tpu_torch.ops._build import library

    suffix = "i32" if x.dtype == torch.int32 else "i64"
    fn = getattr(library(), f"dsort_{name}_{suffix}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rp = None if r is None else r.data_ptr()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), rp, x.shape[0], x.shape[1], *args, stream)
    if err != 0:
        raise KernelLaunchError(name, err)
    with _LAUNCH_LOCK:  # slices launch from several threads
        _LAUNCHES[f"{name}_kernel" + ("" if r is None else RANK)] += 1


def _route(x: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"block-bitonic kernels run on cuda or cpu, not {x.device}")


def bitonic_tile(
    x: torch.Tensor, tile: int, k_start: int = 2, r: torch.Tensor | None = None
) -> torch.Tensor:
    """Levels ``k_start..tile`` inside every tile (K1 / K1b), in place."""
    _check(x, tile, r)
    if not (_is_pow2(k_start) and 2 <= k_start <= tile):
        raise ValueError(f"k_start must be a power of two in [2, {tile}], got {k_start}")
    if not _route(x):
        return tile_sort_plain(x, tile, k_start, r)
    _launch("bitonic_tile", x, r, tile, k_start)
    return x


def bitonic_global_stage(
    x: torch.Tensor, k: int, j: int, r: torch.Tensor | None = None, stages: int = 1
) -> torch.Tensor:
    """Compare-exchange stages ``j, j/2, .., j >> (stages-1)`` of level
    ``k`` across whole rows in one pass (K2 / K2c), in place."""
    _check(x, None, r)
    if not (_is_pow2(k) and _is_pow2(j) and j < k <= x.shape[1]):
        raise ValueError(f"need powers of two j < k <= row_len, got k={k} j={j}")
    s_max = STAGES_MAX[(x.dtype, r is not None)]
    if not (1 <= stages <= s_max and j >> (stages - 1) >= 1):
        raise ValueError(
            f"stages must be in [1, {s_max}] with j >> (stages-1) >= 1, got "
            f"stages={stages} j={j}"
        )
    if not _route(x):
        return global_stage_plain(x, k, j, r, stages)
    _launch("bitonic_global_stage", x, r, k, j, stages)
    return x


def bitonic_tile_merge(
    x: torch.Tensor, tile: int, k: int, r: torch.Tensor | None = None
) -> torch.Tensor:
    """Stages ``j < tile`` of level ``k > tile`` inside every tile (the
    in-block tails of K2a / K2b/K3), in place."""
    _check(x, tile, r)
    if not (_is_pow2(k) and tile < k <= x.shape[1]):
        raise ValueError(f"k must be a power of two in ({tile}, row_len], got {k}")
    if not _route(x):
        return tile_merge_plain(x, tile, k, r)
    _launch("bitonic_tile_merge", x, r, tile, k)
    return x


WRAPPERS = {
    "bitonic_tile_kernel": bitonic_tile,
    "bitonic_global_stage_kernel": bitonic_global_stage,
    "bitonic_tile_merge_kernel": bitonic_tile_merge,
}

#: Suffix of a launch count taken with the rank plane.
RANK = "+rank"
_LAUNCHES = {name + plane: 0 for name in WRAPPERS for plane in ("", RANK)}
_LAUNCH_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, per CUDA kernel name; the
    ``+rank`` entries count the launches that carried the rank plane."""
    return dict(_LAUNCHES)


# -- the host loop -----------------------------------------------------------


def _cross_groups(k: int, tile: int, s_max: int) -> list[tuple[int, int]]:
    """Level ``k``'s cross stages ``j = k/2..tile`` as ``(j_top, stages)``
    groups of at most ``s_max`` consecutive stages, top-down."""
    groups = []
    j, left = k // 2, (k // tile).bit_length() - 1
    while left > 0:
        s = min(s_max, left)
        groups.append((j, s))
        j >>= s
        left -= s
    return groups


def _network(
    x: torch.Tensor, tile: int, k_start: int = 2, r: torch.Tensor | None = None
) -> torch.Tensor:
    """Run levels ``k_start..row_len`` on every row of ``x`` (and of the
    rank plane ``r``), in place."""
    row_len = x.shape[1]
    t = min(tile, row_len)
    s_max = STAGES_MAX[(x.dtype, r is not None)]
    k = k_start
    if k <= t:
        bitonic_tile(x, t, k, r)
        k = 2 * t
    while k <= row_len:
        for j, stages in _cross_groups(k, t, s_max):
            bitonic_global_stage(x, k, j, r, stages)
        bitonic_tile_merge(x, t, k, r)
        k *= 2
    return x


def merge_alternating_runs(
    x: torch.Tensor, run_len: int, r: torch.Tensor | None = None, tile: int = TILE
) -> torch.Tensor:
    """Sort rows ``(rows, row_len)`` made of ``run_len``-key runs that are
    sorted alternately ascending and descending (the bitonic merge entry:
    only the levels above ``run_len`` run), in place; ``r`` rides along as
    the rank plane.  ``run_len`` and ``row_len`` are powers of two."""
    if not (_is_pow2(run_len) and x.dim() == 2 and x.shape[1] % run_len == 0):
        raise ValueError(f"runs of {run_len} keys do not tile rows of shape {tuple(x.shape)}")
    if x.shape[1] == run_len:
        return x
    return _network(x, tile, 2 * run_len, r)


def _as_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() == 1:
        return x.unsqueeze(0)
    if x.dim() == 2:
        return x
    raise ValueError(f"{name} takes a 1-D array or a 2-D batch of rows, got {tuple(x.shape)}")


def _signed_keys(x: torch.Tensor, name: str) -> torch.Tensor:
    s = to_signed_keys(x)
    if s.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name} takes 32- or 64-bit keys, got {x.dtype}")
    return s


def block_sort(x: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Ascending sort of a 1-D tensor, or of every row of a 2-D batch.

    Pads each row to a power of two with the sentinel and trims, so the
    result equals ``torch.sort(x).values`` for every length.  int32/int64
    keys run natively; unsigned and float keys ride the order-preserving
    signed mappings (NaNs last, canonical).
    """
    rows = _as_rows(x, "block_sort")
    n = rows.shape[1]
    if n <= 1:
        return x.clone()
    if not _is_pow2(tile):
        raise ValueError(f"tile must be a power of two, got {tile}")
    s = _signed_keys(rows, "block_sort")
    p = _ceil_pow2(n)
    buf = torch.full(
        (s.shape[0], p), sentinel_for(s.dtype), dtype=s.dtype, device=s.device
    )
    buf[:, :n] = s
    out = from_signed_keys(_network(buf, tile)[:, :n].contiguous(), x.dtype)
    return out.reshape(x.shape)


def block_sort_pairs(
    keys: torch.Tensor, rank: torch.Tensor, tile: int = TILE
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic ``(key, rank)`` ascending sort of a 1-D tensor or of
    every row of a 2-D batch; returns both, permuted.

    ``rank`` (int32, typically ``is_pad * n + position``) breaks key ties
    and comes back as the payload gather permutation.  Rows are padded to a
    power of two with (sentinel, ``INT32_MAX``), so pads sort after any
    real entry whose key equals the sentinel.
    """
    if keys.shape != rank.shape:
        raise ValueError(
            f"block_sort_pairs takes equal shapes, got {tuple(keys.shape)} and "
            f"{tuple(rank.shape)}"
        )
    rows, rrows = _as_rows(keys, "block_sort_pairs"), _as_rows(rank, "block_sort_pairs")
    n = rows.shape[1]
    if n <= 1:
        return keys.clone(), rank.to(torch.int32)
    s = _signed_keys(rows, "block_sort_pairs")
    p = _ceil_pow2(n)
    kb = torch.full((s.shape[0], p), sentinel_for(s.dtype), dtype=s.dtype, device=s.device)
    rb = torch.full((s.shape[0], p), torch.iinfo(torch.int32).max, dtype=torch.int32,
                    device=s.device)
    kb[:, :n] = s
    rb[:, :n] = rrows
    _network(kb, tile, 2, rb)
    out = from_signed_keys(kb[:, :n].contiguous(), keys.dtype)
    return out.reshape(keys.shape), rb[:, :n].reshape(rank.shape)


def _runs_batch(runs: torch.Tensor, name: str) -> torch.Tensor:
    if runs.dim() not in (2, 3):
        raise ValueError(
            f"{name} takes (R, L) runs or a (B, R, L) batch, got {tuple(runs.shape)}"
        )
    return runs if runs.dim() == 3 else runs.unsqueeze(0)


def block_merge_runs(runs: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """Merge R ascending rows ``(R, L)`` into one sorted ``(R*L,)`` tensor;
    a 3-D batch ``(B, R, L)`` merges each batch entry into ``(B, R*L)``.

    Only the merge levels above the run length run: odd runs are flipped so
    runs alternate ascending/descending, then the network enters at level
    ``2 * L`` (the tile kernel's ``k_start`` when runs are shorter than a
    tile, as K1b does for the reference).  Sentinel pads in the rows' tails
    ride along and sort to the back.  Integer keys (and floats through the
    signed mapping).
    """
    batch = _runs_batch(runs, "block_merge_runs")
    b, r, l = batch.shape
    n = r * l
    if r == 1 or n <= 1:
        return runs.reshape(runs.shape[:-2] + (n,)).clone()
    s = _signed_keys(batch, "block_merge_runs")
    l2, r2 = _ceil_pow2(l), _ceil_pow2(r)
    buf = torch.full(
        (b, r2, l2), sentinel_for(s.dtype), dtype=s.dtype, device=s.device
    )
    buf[:, :r, :l] = s
    buf[:, 1::2] = buf[:, 1::2].flip(-1)
    merged = merge_alternating_runs(buf.view(b, r2 * l2), l2, tile=tile)[:, :n]
    out = from_signed_keys(merged.contiguous(), runs.dtype)
    return out.reshape(runs.shape[:-2] + (n,))


def block_merge_runs_kv(
    keys: torch.Tensor, rank: torch.Tensor, tile: int = TILE
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lexicographic ``(key, rank)`` merge of pre-sorted rows; both returned.

    The kv counterpart of `block_merge_runs`: ``keys`` / ``rank`` are
    ``(R, L)`` (or a ``(B, R, L)`` batch) with every row sorted ascending
    by ``(key, rank)``, real ranks below ``2 R L``.  Columns pad to a power
    of two with (sentinel, ``2n + j``) and rows with (sentinel, ``3n + j``),
    so every padded row stays ``(key, rank)``-sorted and the pads trim off
    the tail.  The rank plane comes back as the payload permutation.
    """
    if keys.shape != rank.shape:
        raise ValueError(
            f"block_merge_runs_kv takes equal shapes, got {tuple(keys.shape)} and "
            f"{tuple(rank.shape)}"
        )
    batch = _runs_batch(keys, "block_merge_runs_kv")
    rbatch = _runs_batch(rank, "block_merge_runs_kv").to(torch.int32)
    b, r, l = batch.shape
    n = r * l
    if r == 1 or n <= 1:
        shape = keys.shape[:-2] + (n,)
        return keys.reshape(shape).clone(), rbatch.reshape(shape).clone()
    if 4 * n >= 2**31:  # pad ranks reach 3n + row_len
        raise ValueError(f"{n} keys leave no int32 room for the pad ranks")
    s = _signed_keys(batch, "block_merge_runs_kv")
    dev = s.device
    l2, r2 = _ceil_pow2(l), _ceil_pow2(r)
    kb = torch.full((b, r2, l2), sentinel_for(s.dtype), dtype=s.dtype, device=dev)
    col = torch.arange(l2, dtype=torch.int32, device=dev)
    rb = torch.empty((b, r2, l2), dtype=torch.int32, device=dev)
    rb[:, :r] = 2 * n + col - l          # column pads 2n + j
    rb[:, r:] = 3 * n + col              # row pads 3n + j
    kb[:, :r, :l] = s
    rb[:, :r, :l] = rbatch
    kb[:, 1::2] = kb[:, 1::2].flip(-1)
    rb[:, 1::2] = rb[:, 1::2].flip(-1)
    kf, rf = kb.view(b, r2 * l2), rb.view(b, r2 * l2)
    merge_alternating_runs(kf, l2, rf, tile)
    shape = keys.shape[:-2] + (n,)
    out = from_signed_keys(kf[:, :n].contiguous(), keys.dtype)
    return out.reshape(shape), rf[:, :n].reshape(shape)
