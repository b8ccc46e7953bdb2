"""Tile sort, stable key+index tile sort and radix histogram over CUDA kernels.

Counterpart of ``dsort_tpu/ops/pallas_sort.py`` (the module keeps the
reference's name so its counterpart is easy to find; nothing here is
Pallas).  The reference sorts ``(rows, 128)`` VMEM tiles with one bitonic
network per tile and merges the sorted tiles with the jnp merge tree
(`ops.bitonic.merge_sorted_runs`).  Its three Pallas kernels become three
CUDA kernels in ``csrc/tile_sort.cu``, each beside its plain PyTorch
version here:

  ===========================  ===================================  ============================
  CUDA kernel (wrapper)        replaces                             plain version
  ===========================  ===================================  ============================
  tile_sort_kernel             S1 `_tile_bitonic_kernel` (:37)      `tile_sort_plain`
  (`tile_sort`)
  tile_sort_kv_kernel          S2 `_tile_bitonic_kv_kernel` (:106)  `tile_sort_kv_plain`
  (`tile_sort_kv`)
  radix_histogram_kernel       S3 `_tile_histogram_kernel` (:223)   `radix_histogram_plain`
  (`radix_histogram`)
  ===========================  ===================================  ============================

A tile is ``tile_rows * 128`` keys, the reference's ``(tile_rows, 128)``
block read in row-major order; at the default ``tile_rows=256`` that is
32,768 keys.  S1 and S2 sort a tile of more than 4,096 keys with a
thread-block cluster of CTAs, each holding its share in registers
(`tile_sort_cluster_size`: 8 CTAs at the default tile;
``csrc/tile_sort.cu``).

`pallas_sort` and `pallas_sort_kv` work along the last axis over a batch of
rows, so the P shards of a virtual mesh take one call; unsigned and float
keys ride as signed ints (`ops.float_order`).  A wrapper launches its
kernel for a CUDA tensor and runs the plain version only for a CPU tensor;
anything else raises.  `launch_counts` counts the launches per kernel;
`reset_launch_counts` zeroes them.
"""

from __future__ import annotations

import threading

import torch

from dsort_tpu_torch.ops.bitonic import merge_sorted_runs, merge_sorted_runs_kv
from dsort_tpu_torch.ops.block_sort import _KERNEL_DTYPES, _as_rows, _ceil_pow2
from dsort_tpu_torch.ops.block_sort import tile_sort_plain as _levels_plain
from dsort_tpu_torch.ops.errors import KernelLaunchError
from dsort_tpu_torch.ops.float_order import _UNSIGNED_TO_SIGNED, from_signed_keys, to_signed_keys
from dsort_tpu_torch.ops.local_sort import _apply_perm, sentinel_for

LANES = 128
_HIST_DTYPES = {torch.int32: "i32", torch.int64: "i64", torch.uint32: "u32", torch.uint64: "u64"}
#: Dynamic shared memory one CTA may hold on sm_90 (csrc/tile_sort.cu kMaxSmem).
_SMEM_BYTES = 232448
_MAX_CLUSTER = 8
#: Keys (S1) or pairs (S2) one CTA holds at most, where shared memory
#: allows more.
_SORT_SHARE = 4096

_LAUNCHES = {"tile_sort_kernel": 0, "tile_sort_kv_kernel": 0, "radix_histogram_kernel": 0}
_LAUNCH_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, per CUDA kernel name."""
    return dict(_LAUNCHES)


def _route(x: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA tensor), False for the plain version
    (CPU tensor); raises for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"tile sort kernels run on cuda or cpu, not {x.device}")


def cluster_size(tile_rows: int, dtype: torch.dtype, kv: bool = False) -> int:
    """The fewest CTAs, a power of two, whose shares of a ``tile_rows``
    tile of ``dtype`` keys (and, with ``kv``, their int32 index) fit one
    CTA's shared memory: the least of S1's (S2's with ``kv``) cluster."""
    tile, key_bytes = tile_rows * LANES, dtype.itemsize + (4 if kv else 0)
    c = 1
    while tile // c * key_bytes > _SMEM_BYTES:
        c *= 2
    if c > _MAX_CLUSTER:
        raise ValueError(
            f"a tile of {tile} x {key_bytes} B needs more than {_MAX_CLUSTER} CTAs' shared memory"
        )
    return c


def tile_sort_cluster_size(tile_rows: int, dtype: torch.dtype, kv: bool = False) -> int:
    """CTAs per tile `tile_sort` (S1) launches with for ``tile_rows`` tiles
    of ``dtype`` keys, and with ``kv`` `tile_sort_kv` (S2) for the keys and
    their int32 index: shares of at most `_SORT_SHARE` keys (256 threads of
    16 keys, or pairs, a CTA), never fewer CTAs than shared memory needs
    (`cluster_size`), and at most 8.  On an H100 eight CTAs of 4,096 keys
    sorted a 32,768-key tile faster than one, two or four for both key
    types, and eight of 4,096 pairs beat four and 8 pairs a thread for S2
    (PERF.md §6)."""
    tile = tile_rows * LANES
    return min(_MAX_CLUSTER, max(cluster_size(tile_rows, dtype, kv), tile // _SORT_SHARE))


def _check_tiles(x: torch.Tensor, tile_rows: int, name: str) -> int:
    """Validate ``x`` for the tile kernels; returns the tile length."""
    if not (tile_rows >= 1 and tile_rows & (tile_rows - 1) == 0):
        raise ValueError(f"tile_rows must be a power of two, got {tile_rows}")
    tile = tile_rows * LANES
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name} keys must be int32 or int64, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} keys must be contiguous")
    if x.numel() % tile:
        raise ValueError(f"{name}: {x.numel()} keys are not whole tiles of {tile}")
    return tile


# -- plain PyTorch versions (the same network, written with tensor ops) ------


def tile_sort_plain(x: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """Sort every consecutive ``tile_rows * 128``-key tile of ``x``
    ascending, in place: levels ``2..tile`` of the network, each tile's top
    level ascending."""
    tile = tile_rows * LANES
    _levels_plain(x.view(-1, tile), tile)
    return x


def tile_sort_kv_plain(
    x: torch.Tensor, v: torch.Tensor, tile_rows: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """`tile_sort_plain` on ``(key, int32 index)`` pairs, in place; pairs
    compare lexicographically."""
    tile = tile_rows * LANES
    _levels_plain(x.view(-1, tile), tile, 2, v.view(-1, tile))
    return x, v


def _digits(x: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """``(x >> shift) & (2^bits - 1)``: arithmetic shift for signed keys
    (sign fill once ``shift`` reaches the width), logical for unsigned."""
    width = 8 * x.element_size()
    mask = (1 << bits) - 1
    if x.dtype in _UNSIGNED_TO_SIGNED:
        x = x.view(_UNSIGNED_TO_SIGNED[x.dtype])
        mask &= (1 << max(width - shift, 0)) - 1  # the bits a logical shift keeps
    return (x >> min(shift, width - 1)) & mask


def radix_histogram_plain(x: torch.Tensor, shift: int = 0, bits: int = 8) -> torch.Tensor:
    """Digit counts of ``x``, int32 ``(2^bits,)``: one ``index_add_`` of
    ones, the counts the kernel's atomics take."""
    d = _digits(x.reshape(-1), shift, bits).long()
    hist = torch.zeros(1 << bits, dtype=torch.int32, device=x.device)
    return hist.index_add_(0, d, torch.ones_like(d, dtype=torch.int32))


# -- kernel wrappers ---------------------------------------------------------


def _library():
    from dsort_tpu_torch.ops._build import library

    return library()


def tile_sort(x: torch.Tensor, tile_rows: int = 256) -> torch.Tensor:
    """Sort every ``tile_rows * 128``-key tile of contiguous int32/int64
    ``x`` ascending, in place (S1)."""
    tile = _check_tiles(x, tile_rows, "tile_sort")
    if not _route(x):
        return tile_sort_plain(x, tile_rows)
    suffix = "i32" if x.dtype == torch.int32 else "i64"
    with torch.cuda.device(x.device):
        err = getattr(_library(), f"dsort_tile_sort_{suffix}")(
            x.data_ptr(), x.numel() // tile, tile, tile_sort_cluster_size(tile_rows, x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError("tile_sort", err)
    with _LAUNCH_LOCK:  # slices launch from several threads
        _LAUNCHES["tile_sort_kernel"] += 1
    return x


def tile_sort_kv(
    x: torch.Tensor, v: torch.Tensor, tile_rows: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort every tile of ``(key, int32 index)`` pairs by ``(key, index)``,
    in place (S2); ``v`` is int32 of ``x``'s shape."""
    tile = _check_tiles(x, tile_rows, "tile_sort_kv")
    if v.dtype != torch.int32 or v.shape != x.shape or v.device != x.device \
            or not v.is_contiguous():
        raise ValueError(
            f"the index plane must be contiguous int32 of the keys' shape and device, got "
            f"{v.dtype} {tuple(v.shape)} on {v.device}"
        )
    if not _route(x):
        return tile_sort_kv_plain(x, v, tile_rows)
    suffix = "i32" if x.dtype == torch.int32 else "i64"
    with torch.cuda.device(x.device):
        err = getattr(_library(), f"dsort_tile_sort_kv_{suffix}")(
            x.data_ptr(), v.data_ptr(), x.numel() // tile, tile,
            tile_sort_cluster_size(tile_rows, x.dtype, kv=True),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError("tile_sort_kv", err)
    with _LAUNCH_LOCK:  # slices launch from several threads
        _LAUNCHES["tile_sort_kv_kernel"] += 1
    return x, v


def radix_histogram(
    x: torch.Tensor, shift: int = 0, bits: int = 8, tile_rows: int = 256
) -> torch.Tensor:
    """Histogram of the radix digit ``(x >> shift) & (2^bits - 1)`` over
    every element of ``x`` (S3): int32 ``(2^bits,)``, exact for every
    length.  ``tile_rows`` is the reference's tiling, kept for its
    signature; the kernel strides over the input without tiles or pads."""
    if x.dtype not in _HIST_DTYPES:
        raise TypeError(f"radix_histogram takes 32/64-bit integer keys, got {x.dtype}")
    if shift < 0 or not 0 <= bits <= 30:
        raise ValueError(f"need shift >= 0 and 0 <= bits <= 30, got shift={shift} bits={bits}")
    if not _route(x):
        return radix_histogram_plain(x, shift, bits)
    x = x.contiguous()
    if x.numel() == 0:
        return torch.zeros(1 << bits, dtype=torch.int32, device=x.device)
    out = torch.empty(1 << bits, dtype=torch.int32, device=x.device)  # the C entry zeroes it
    with torch.cuda.device(x.device):
        err = getattr(_library(), f"dsort_radix_histogram_{_HIST_DTYPES[x.dtype]}")(
            x.data_ptr(), x.numel(), shift, bits, out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError("radix_histogram", err)
    with _LAUNCH_LOCK:  # slices launch from several threads
        _LAUNCHES["radix_histogram_kernel"] += 1
    return out


# -- the sorts ---------------------------------------------------------------


def _padded_tiles(s: torch.Tensor, tile: int) -> torch.Tensor:
    """``(B, n)`` signed keys in a ``(B, num_tiles * tile)`` sentinel-padded
    buffer, ``num_tiles = ceil_pow2(ceil(n / tile))`` for the merge tree."""
    b, n = s.shape
    num_tiles = max(_ceil_pow2(-(-n // tile)), 1)
    buf = torch.full((b, num_tiles * tile), sentinel_for(s.dtype), dtype=s.dtype, device=s.device)
    buf[:, :n] = s
    return buf


def pallas_sort(x: torch.Tensor, tile_rows: int = 256) -> torch.Tensor:
    """Ascending sort of a 1-D tensor, or of every row of a 2-D batch: the
    tile kernel, then the bitonic merge tree, then a trim to ``n``.

    Each row pads with the sentinel to ``ceil_pow2(ceil(n / tile))`` tiles
    (the merge tree needs a power-of-two count); ``n <= 1`` returns the
    input, as in the reference.
    """
    rows = _as_rows(x, "pallas_sort")
    n = rows.shape[1]
    if n <= 1:
        return x
    tile = tile_rows * LANES
    buf = _padded_tiles(to_signed_keys(rows), tile)
    tile_sort(buf, tile_rows)
    runs = buf.view(buf.shape[0], -1, tile)
    out = merge_sorted_runs(runs) if runs.shape[1] > 1 else runs[:, 0]
    return from_signed_keys(out[:, :n].contiguous(), x.dtype).reshape(x.shape)


def pallas_sort_kv(
    keys: torch.Tensor, payload: torch.Tensor, tile_rows: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable key+payload sort along the last axis: ``(key, int32 index)``
    tile sorts, the key+index merge tree, then one gather of the payload
    rows by the sorted index (the reference gathers outside its kernel too).

    ``payload`` is ``keys.shape + (...)``.  No key value is reserved: pads
    carry indices above every real entry, so they sort after real
    sentinel-valued keys.
    """
    rows = _as_rows(keys, "pallas_sort_kv")
    b, n = rows.shape
    if n <= 1:
        return keys, payload
    if payload.shape[: keys.dim()] != keys.shape:
        raise ValueError(
            f"payload {tuple(payload.shape)} does not lead with the keys' shape {tuple(keys.shape)}"
        )
    tile = tile_rows * LANES
    kbuf = _padded_tiles(to_signed_keys(rows), tile)
    if kbuf.shape[1] > 2**31:
        raise ValueError(f"{kbuf.shape[1]} padded keys a row leave no int32 index")
    idx = torch.arange(kbuf.shape[1], dtype=torch.int32, device=kbuf.device)
    ibuf = idx.expand(b, -1).contiguous()
    tile_sort_kv(kbuf, ibuf, tile_rows)
    runs_k, runs_v = kbuf.view(b, -1, tile), ibuf.view(b, -1, tile)
    if runs_k.shape[1] > 1:
        out_k, perm = merge_sorted_runs_kv(runs_k, runs_v)
    else:
        out_k, perm = runs_k[:, 0], runs_v[:, 0]
    out_v = _apply_perm(payload.reshape((b, n) + payload.shape[keys.dim():]), perm[:, :n])
    out_k = from_signed_keys(out_k[:, :n].contiguous(), keys.dtype)
    return out_k.reshape(keys.shape), out_v.reshape(payload.shape)
