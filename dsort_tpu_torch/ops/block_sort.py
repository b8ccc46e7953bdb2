"""Block-bitonic sort and run merge over hand-written CUDA kernels.

Counterpart of ``dsort_tpu/ops/block_sort.py``.  The reference runs the
bitonic network as six Pallas kernels shaped by the TPU's VMEM (K1 tile
sort, K1b level combiner, K2 cross stage, K2c orbit pass, K2a fused low
levels, K2b/K3 span tail).  On Hopper the network is carried by three CUDA
kernels in ``csrc/block_sort.cu``, each beside its plain PyTorch version
here:

  =============================  =========================  ==================
  CUDA kernel (wrapper)          replaces                   plain version
  =============================  =========================  ==================
  bitonic_tile_kernel            K1 (k_start=2), K1b        `tile_sort_plain`
  (`bitonic_tile`)               (k_start>2)
  bitonic_global_stage_kernel    K2, K2c (one stage j>=T    `global_stage_plain`
  (`bitonic_global_stage`)       per launch)
  bitonic_tile_merge_kernel      in-block tails of K2a,     `tile_merge_plain`
  (`bitonic_tile_merge`)         K2b/K3
  =============================  =========================  ==================

Every function works on a 2-D batch ``(rows, row_len)`` with ``row_len`` a
power of two and sorts each row independently; the top level of every row
is ascending.  The 64-bit ``(hi, lo)`` plane split of the reference is a
Mosaic constraint and is not copied: int64 keys are compared natively.
Unsigned and float keys ride as order-preserving signed ints
(`ops.float_order`).

A wrapper launches its kernel for a CUDA tensor and runs the plain version
only for a CPU tensor; anything else raises.  Each wrapper counts its
launches in ``<wrapper>.launches`` (`launch_counts` / `reset_launch_counts`).
"""

from __future__ import annotations

import torch

from dsort_tpu_torch.ops.float_order import from_signed_keys, to_signed_keys
from dsort_tpu_torch.ops.local_sort import sentinel_for

#: Tile size (keys) of the shared-memory kernels: 16 KB of int32 or 32 KB of
#: int64 per block, inside the 48 KB of static-launch shared memory.
TILE = 4096
_SMEM_BYTES = 48 * 1024
_KERNEL_DTYPES = (torch.int32, torch.int64)


def _is_pow2(v: int) -> bool:
    return v >= 1 and (v & (v - 1)) == 0


def _ceil_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# -- plain PyTorch versions (the same network, written with tensor ops) ------


def _stage_plain(x: torch.Tensor, k: int, j: int) -> torch.Tensor:
    """Stage ``(k, j)`` of the network on ``(rows, row_len)``, in place."""
    rows, row_len = x.shape
    v = x.view(rows, row_len // (2 * j), 2, j)
    a, b = v[:, :, 0, :], v[:, :, 1, :]
    # Bit k of the in-row index is constant across each 2j-block (k >= 2j).
    start = torch.arange(0, row_len, 2 * j, device=x.device)
    asc = ((start & k) == 0).view(1, -1, 1)
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    a.copy_(torch.where(asc, lo, hi))
    b.copy_(torch.where(asc, hi, lo))
    return x


def tile_sort_plain(x: torch.Tensor, tile: int, k_start: int = 2) -> torch.Tensor:
    """Levels ``k_start..tile`` of every ``tile``-key tile, in place."""
    k = k_start
    while k <= tile:
        j = k // 2
        while j >= 1:
            _stage_plain(x, k, j)
            j //= 2
        k *= 2
    return x


def global_stage_plain(x: torch.Tensor, k: int, j: int) -> torch.Tensor:
    """One stage ``(k, j)`` over whole rows, in place."""
    return _stage_plain(x, k, j)


def tile_merge_plain(x: torch.Tensor, tile: int, k: int) -> torch.Tensor:
    """Stages ``j = tile/2..1`` of level ``k``, in place."""
    j = tile // 2
    while j >= 1:
        _stage_plain(x, k, j)
        j //= 2
    return x


# -- kernel wrappers ---------------------------------------------------------


def _check(x: torch.Tensor, tile: int | None = None) -> None:
    if x.dim() != 2:
        raise ValueError(f"expected a (rows, row_len) tensor, got {tuple(x.shape)}")
    if not _is_pow2(x.shape[1]):
        raise ValueError(f"row_len must be a power of two, got {x.shape[1]}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel keys must be int32 or int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("kernel keys must be contiguous")
    if tile is not None:
        if not (_is_pow2(tile) and 2 <= tile <= x.shape[1]):
            raise ValueError(
                f"tile must be a power of two in [2, row_len={x.shape[1]}], got {tile}"
            )
        if tile * x.element_size() > _SMEM_BYTES:
            raise ValueError(
                f"tile of {tile} x {x.element_size()} B exceeds {_SMEM_BYTES} B "
                "of shared memory"
            )


def _launch(name: str, x: torch.Tensor, *args) -> None:
    from dsort_tpu_torch.ops._build import library

    suffix = "i32" if x.dtype == torch.int32 else "i64"
    fn = getattr(library(), f"dsort_{name}_{suffix}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.shape[0], x.shape[1], *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _route(x: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"block-bitonic kernels run on cuda or cpu, not {x.device}")


def bitonic_tile(x: torch.Tensor, tile: int, k_start: int = 2) -> torch.Tensor:
    """Levels ``k_start..tile`` inside every tile (K1 / K1b), in place."""
    _check(x, tile)
    if not (_is_pow2(k_start) and 2 <= k_start <= tile):
        raise ValueError(f"k_start must be a power of two in [2, {tile}], got {k_start}")
    if not _route(x):
        return tile_sort_plain(x, tile, k_start)
    _launch("bitonic_tile", x, tile, k_start)
    bitonic_tile.launches += 1
    return x


def bitonic_global_stage(x: torch.Tensor, k: int, j: int) -> torch.Tensor:
    """One compare-exchange stage ``(k, j)`` across whole rows (K2 / K2c),
    in place."""
    _check(x)
    if not (_is_pow2(k) and _is_pow2(j) and j < k <= x.shape[1]):
        raise ValueError(f"need powers of two j < k <= row_len, got k={k} j={j}")
    if not _route(x):
        return global_stage_plain(x, k, j)
    _launch("bitonic_global_stage", x, k, j)
    bitonic_global_stage.launches += 1
    return x


def bitonic_tile_merge(x: torch.Tensor, tile: int, k: int) -> torch.Tensor:
    """Stages ``j < tile`` of level ``k > tile`` inside every tile (the
    in-block tails of K2a / K2b/K3), in place."""
    _check(x, tile)
    if not (_is_pow2(k) and tile < k <= x.shape[1]):
        raise ValueError(f"k must be a power of two in ({tile}, row_len], got {k}")
    if not _route(x):
        return tile_merge_plain(x, tile, k)
    _launch("bitonic_tile_merge", x, tile, k)
    bitonic_tile_merge.launches += 1
    return x


WRAPPERS = {
    "bitonic_tile_kernel": bitonic_tile,
    "bitonic_global_stage_kernel": bitonic_global_stage,
    "bitonic_tile_merge_kernel": bitonic_tile_merge,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per CUDA kernel name since the last reset."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


reset_launch_counts()


# -- the host loop -----------------------------------------------------------


def _network(x: torch.Tensor, tile: int, k_start: int = 2) -> torch.Tensor:
    """Run levels ``k_start..row_len`` on every row of ``x``, in place."""
    row_len = x.shape[1]
    t = min(tile, row_len)
    k = k_start
    if k <= t:
        bitonic_tile(x, t, k)
        k = 2 * t
    while k <= row_len:
        j = k // 2
        while j >= t:
            bitonic_global_stage(x, k, j)
            j //= 2
        bitonic_tile_merge(x, t, k)
        k *= 2
    return x


def _as_rows(x: torch.Tensor, name: str) -> torch.Tensor:
    if x.dim() == 1:
        return x.unsqueeze(0)
    if x.dim() == 2:
        return x
    raise ValueError(f"{name} takes a 1-D array or a 2-D batch of rows, got {tuple(x.shape)}")


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
    s = to_signed_keys(rows)
    if s.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"block_sort takes 32- or 64-bit keys, got {x.dtype}")
    p = _ceil_pow2(n)
    buf = torch.full(
        (s.shape[0], p), sentinel_for(s.dtype), dtype=s.dtype, device=s.device
    )
    buf[:, :n] = s
    out = from_signed_keys(_network(buf, tile)[:, :n].contiguous(), x.dtype)
    return out.reshape(x.shape)


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
    if runs.dim() not in (2, 3):
        raise ValueError(
            f"block_merge_runs takes (R, L) runs or a (B, R, L) batch, got "
            f"{tuple(runs.shape)}"
        )
    batch = runs if runs.dim() == 3 else runs.unsqueeze(0)
    b, r, l = batch.shape
    n = r * l
    if r == 1 or n <= 1:
        return runs.reshape(runs.shape[:-2] + (n,)).clone()
    s = to_signed_keys(batch)
    if s.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"block_merge_runs takes 32- or 64-bit keys, got {runs.dtype}")
    l2, r2 = _ceil_pow2(l), _ceil_pow2(r)
    buf = torch.full(
        (b, r2, l2), sentinel_for(s.dtype), dtype=s.dtype, device=s.device
    )
    buf[:, :r, :l] = s
    buf[:, 1::2] = buf[:, 1::2].flip(-1)
    merged = _network(buf.view(b, r2 * l2), tile, k_start=2 * l2)[:, :n].contiguous()
    out = from_signed_keys(merged, runs.dtype)
    return out.reshape(runs.shape[:-2] + (n,))
