// Block-bitonic sort kernels for Hopper (sm_90a), plain C interface.
//
// The CUDA counterparts of the six Pallas kernels of
// dsort_tpu/ops/block_sort.py.  All three kernels run the standard bitonic
// network over a batch of `rows` independent rows of `row_len` keys
// (row_len a power of two), stored contiguously:  stage (k, j) pairs in-row
// index i with i + j (bit j of i clear) and orders the pair ascending iff
// bit k of the in-row index is clear.  The top level of every row
// (k == row_len) is therefore ascending, and one launch sorts or merges all
// P shards of the virtual mesh at once.
//
// The host loop (dsort_tpu_torch/ops/block_sort.py) composes them: one
// tile sort (levels k_start..T inside T-key tiles), then for every level
// k = 2T..row_len the global stages j = k/2..T followed by one tile merge
// (stages j = T/2..1 of level k inside each tile).
//
// The rank plane.  Every kernel takes an optional int32 plane `r` laid out
// like the keys (nullptr: keys alone).  With it, pairs compare
// lexicographically as (key, rank) and both planes move together: the
// counterpart of the reference's extra 32-bit plane in block_sort_pairs and
// block_merge_runs_kv, where the rank breaks key ties and comes back as the
// payload gather permutation.  One thread owns both members of a pair, so
// the swap decision is made once per pair and equal keys can never
// duplicate or lose a rank.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success).  Keys are int32_t or
// int64_t: unsigned and float keys reach here through the order-preserving
// signed mappings of ops/float_order.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileThreads = 512;
constexpr int kStageThreads = 256;

// Orders (a, ra) and (b, rb) ascending (asc) or descending, in place.
template <typename K, bool R>
__device__ __forceinline__ void compare_exchange(K& a, K& b, int32_t& ra,
                                                 int32_t& rb, bool asc) {
  if constexpr (!R) {
    const K lo = a < b ? a : b;
    const K hi = a < b ? b : a;
    a = asc ? lo : hi;
    b = asc ? hi : lo;
    return;
  }
  const bool a_gt = a > b || (a == b && ra > rb);
  const bool b_gt = b > a || (a == b && rb > ra);
  if (asc ? a_gt : b_gt) {
    const K tk = a;
    a = b;
    b = tk;
    const int32_t tr = ra;
    ra = rb;
    rb = tr;
  }
}

// Stages j = j_top..1 of level k on a shared-memory tile of T keys (and T
// ranks when R) whose first key sits at in-row offset row_off.
template <typename K, bool R>
__device__ __forceinline__ void tile_stages(K* s, int32_t* sr, int T,
                                            long long row_off, long long k,
                                            int j_top) {
  const int half = T >> 1;
  int32_t dummy_a = 0, dummy_b = 0;
  for (int j = j_top; j > 0; j >>= 1) {
    for (int q = threadIdx.x; q < half; q += blockDim.x) {
      const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
      const bool asc = ((row_off + i) & k) == 0;
      if constexpr (R)
        compare_exchange<K, R>(s[i], s[i + j], sr[i], sr[i + j], asc);
      else
        compare_exchange<K, R>(s[i], s[i + j], dummy_a, dummy_b, asc);
    }
    __syncthreads();
  }
}

// Loads tile blockIdx.x (keys, then ranks behind them in shared memory);
// returns its first flat index.
template <typename K, bool R>
__device__ __forceinline__ long long load_tile(K* s, int32_t* sr, const K* x,
                                               const int32_t* r, int T) {
  const long long base = static_cast<long long>(blockIdx.x) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    s[t] = x[base + t];
    if constexpr (R) sr[t] = r[base + t];
  }
  __syncthreads();
  return base;
}

template <typename K, bool R>
__device__ __forceinline__ void store_tile(const K* s, const int32_t* sr,
                                           K* x, int32_t* r, int T,
                                           long long base) {
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    x[base + t] = s[t];
    if constexpr (R) r[base + t] = sr[t];
  }
}

// Replaces K1 `_tile_sort_cm_kernel` (block_sort.py:419) at k_start == 2
// and K1b `_sort_levels_kernel` (block_sort.py:440) at k_start > 2 (the
// merge entry of block_merge_runs for runs shorter than a tile).
// Bound: every key (and rank) is read and written once; the
// log2(T)(log2(T)+1)/2 stages run out of shared memory, so on this card the
// limit is shared-memory bandwidth and the barrier per stage rather than
// HBM.  Design: one block per tile, 512 threads each owning T/1024 pairs
// per stage, one __syncthreads per stage; directions come from the in-row
// index, so the tile's top level takes its direction from the tile's
// parity inside the row, as K1's block parity does.
template <typename K, bool R>
__global__ void bitonic_tile_kernel(K* __restrict__ x, int32_t* __restrict__ r,
                                    long long row_len, int T,
                                    long long k_start) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  int32_t* sr = reinterpret_cast<int32_t*>(s + T);
  const long long base = load_tile<K, R>(s, sr, x, r, T);
  const long long row_off = base & (row_len - 1);
  for (long long k = k_start; k <= T; k <<= 1)
    tile_stages<K, R>(s, sr, T, row_off, k, static_cast<int>(k >> 1));
  store_tile<K, R>(s, sr, x, r, T, base);
}

// Replaces the cross stages of K2 `_cross_kernel` (block_sort.py:466) and
// K2c `_orbit_kernel` (block_sort.py:722): one compare-exchange stage at a
// distance j >= T, one thread per pair.
// Bound: HBM bytes, 2 n (itemsize [+ 4]) per stage (each key and rank read
// and written once).  Design: consecutive threads own consecutive pairs, so
// every load and store of a warp is coalesced; the level's stages are
// separate launches (fusing a level's stages into one residency, as K2c
// does on the TPU, is later work).
template <typename K, bool R>
__global__ void bitonic_global_stage_kernel(K* __restrict__ x,
                                            int32_t* __restrict__ r,
                                            long long rows, long long row_len,
                                            long long k, long long j) {
  const long long npairs = rows * (row_len >> 1);
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= npairs) return;
  const long long i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
  const bool asc = ((i & (row_len - 1)) & k) == 0;
  K a = x[i];
  K b = x[i + j];
  int32_t ra = 0, rb = 0;
  if constexpr (R) {
    ra = r[i];
    rb = r[i + j];
  }
  compare_exchange<K, R>(a, b, ra, rb, asc);
  x[i] = a;
  x[i + j] = b;
  if constexpr (R) {
    r[i] = ra;
    r[i + j] = rb;
  }
}

// Replaces the in-block merge tails of K2a `_span_low_kernel`
// (block_sort.py:567) and K2b/K3 `_span_tail_kernel` (block_sort.py:493):
// for a level k > T, every stage with j < T, inside the shared-memory
// resident tile.
// Bound: 2 n (itemsize [+ 4]) HBM bytes per launch; log2(T) shared-memory
// stages.  Design: as bitonic_tile_kernel, with the level's direction
// constant across the tile (bit k of the in-row index lies above the tile).
template <typename K, bool R>
__global__ void bitonic_tile_merge_kernel(K* __restrict__ x,
                                          int32_t* __restrict__ r,
                                          long long row_len, int T,
                                          long long k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  int32_t* sr = reinterpret_cast<int32_t*>(s + T);
  const long long base = load_tile<K, R>(s, sr, x, r, T);
  tile_stages<K, R>(s, sr, T, base & (row_len - 1), k, T >> 1);
  store_tile<K, R>(s, sr, x, r, T, base);
}

int tile_threads(int T) {
  const int half = T >> 1;
  return half < kTileThreads ? half : kTileThreads;
}

template <typename K>
size_t tile_smem(int T, bool ranked) {
  return static_cast<size_t>(T) * (sizeof(K) + (ranked ? sizeof(int32_t) : 0));
}

template <typename K>
int launch_tile(void* x, void* r, long long rows, long long row_len, int T,
                long long k_start, void* stream) {
  const unsigned int tiles = static_cast<unsigned int>(rows * row_len / T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r != nullptr)
    bitonic_tile_kernel<K, true><<<tiles, tile_threads(T), tile_smem<K>(T, true), st>>>(
        static_cast<K*>(x), static_cast<int32_t*>(r), row_len, T, k_start);
  else
    bitonic_tile_kernel<K, false><<<tiles, tile_threads(T), tile_smem<K>(T, false), st>>>(
        static_cast<K*>(x), nullptr, row_len, T, k_start);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_global_stage(void* x, void* r, long long rows, long long row_len,
                        long long k, long long j, void* stream) {
  const long long npairs = rows * (row_len >> 1);
  const unsigned int blocks =
      static_cast<unsigned int>((npairs + kStageThreads - 1) / kStageThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r != nullptr)
    bitonic_global_stage_kernel<K, true><<<blocks, kStageThreads, 0, st>>>(
        static_cast<K*>(x), static_cast<int32_t*>(r), rows, row_len, k, j);
  else
    bitonic_global_stage_kernel<K, false><<<blocks, kStageThreads, 0, st>>>(
        static_cast<K*>(x), nullptr, rows, row_len, k, j);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_tile_merge(void* x, void* r, long long rows, long long row_len,
                      int T, long long k, void* stream) {
  const unsigned int tiles = static_cast<unsigned int>(rows * row_len / T);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r != nullptr)
    bitonic_tile_merge_kernel<K, true><<<tiles, tile_threads(T), tile_smem<K>(T, true), st>>>(
        static_cast<K*>(x), static_cast<int32_t*>(r), row_len, T, k);
  else
    bitonic_tile_merge_kernel<K, false><<<tiles, tile_threads(T), tile_smem<K>(T, false), st>>>(
        static_cast<K*>(x), nullptr, row_len, T, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `r` is the int32 rank plane or nullptr for keys alone.
extern "C" {

int dsort_bitonic_tile_i32(void* x, void* r, long long rows, long long row_len,
                           int T, long long k_start, void* stream) {
  return launch_tile<int32_t>(x, r, rows, row_len, T, k_start, stream);
}

int dsort_bitonic_tile_i64(void* x, void* r, long long rows, long long row_len,
                           int T, long long k_start, void* stream) {
  return launch_tile<int64_t>(x, r, rows, row_len, T, k_start, stream);
}

int dsort_bitonic_global_stage_i32(void* x, void* r, long long rows,
                                   long long row_len, long long k, long long j,
                                   void* stream) {
  return launch_global_stage<int32_t>(x, r, rows, row_len, k, j, stream);
}

int dsort_bitonic_global_stage_i64(void* x, void* r, long long rows,
                                   long long row_len, long long k, long long j,
                                   void* stream) {
  return launch_global_stage<int64_t>(x, r, rows, row_len, k, j, stream);
}

int dsort_bitonic_tile_merge_i32(void* x, void* r, long long rows,
                                 long long row_len, int T, long long k,
                                 void* stream) {
  return launch_tile_merge<int32_t>(x, r, rows, row_len, T, k, stream);
}

int dsort_bitonic_tile_merge_i64(void* x, void* r, long long rows,
                                 long long row_len, int T, long long k,
                                 void* stream) {
  return launch_tile_merge<int64_t>(x, r, rows, row_len, T, k, stream);
}

}  // extern "C"
