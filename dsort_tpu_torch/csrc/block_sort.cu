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
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success).  Keys are int32_t or
// int64_t: unsigned and float keys reach here through the order-preserving
// signed mappings of ops/float_order.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileThreads = 512;
constexpr int kStageThreads = 256;

template <typename K>
__device__ __forceinline__ void compare_exchange(K& a, K& b, bool asc) {
  const K lo = a < b ? a : b;
  const K hi = a < b ? b : a;
  a = asc ? lo : hi;
  b = asc ? hi : lo;
}

// Stages j = j_top..1 of level k on a shared-memory tile of T keys whose
// first key sits at in-row offset row_off.
template <typename K>
__device__ __forceinline__ void tile_stages(K* s, int T, long long row_off,
                                            long long k, int j_top) {
  const int half = T >> 1;
  for (int j = j_top; j > 0; j >>= 1) {
    for (int q = threadIdx.x; q < half; q += blockDim.x) {
      const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
      const bool asc = ((row_off + i) & k) == 0;
      compare_exchange(s[i], s[i + j], asc);
    }
    __syncthreads();
  }
}

template <typename K>
__device__ __forceinline__ long long load_tile(K* s, const K* x, int T,
                                               long long row_len) {
  const long long base = static_cast<long long>(blockIdx.x) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) s[t] = x[base + t];
  __syncthreads();
  return base;
}

template <typename K>
__device__ __forceinline__ void store_tile(const K* s, K* x, int T,
                                           long long base) {
  for (int t = threadIdx.x; t < T; t += blockDim.x) x[base + t] = s[t];
}

// Replaces K1 `_tile_sort_cm_kernel` (block_sort.py:419) at k_start == 2
// and K1b `_sort_levels_kernel` (block_sort.py:440) at k_start > 2 (the
// merge entry of block_merge_runs for runs shorter than a tile).
// Bound: every key is read and written once (2 n itemsize bytes); the
// log2(T)(log2(T)+1)/2 stages run out of shared memory, so on this card the
// limit is shared-memory bandwidth and the barrier per stage rather than
// HBM.  Design: one block per tile, 512 threads each owning T/1024 pairs
// per stage, one __syncthreads per stage; directions come from the in-row
// index, so the tile's top level takes its direction from the tile's
// parity inside the row, as K1's block parity does.
template <typename K>
__global__ void bitonic_tile_kernel(K* __restrict__ x, long long rows,
                                    long long row_len, int T,
                                    long long k_start) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  const long long base = load_tile(s, x, T, row_len);
  const long long row_off = base & (row_len - 1);
  for (long long k = k_start; k <= T; k <<= 1)
    tile_stages(s, T, row_off, k, static_cast<int>(k >> 1));
  store_tile(s, x, T, base);
}

// Replaces the cross stages of K2 `_cross_kernel` (block_sort.py:466) and
// K2c `_orbit_kernel` (block_sort.py:722): one compare-exchange stage at a
// distance j >= T, one thread per pair.
// Bound: HBM bytes, 2 n itemsize per stage (each key read and written
// once).  Design: consecutive threads own consecutive pairs, so both
// loads and both stores of a warp are coalesced; the level's stages are
// separate launches (fusing a level's stages into one residency, as K2c
// does on the TPU, is later work).
template <typename K>
__global__ void bitonic_global_stage_kernel(K* __restrict__ x, long long rows,
                                            long long row_len, long long k,
                                            long long j) {
  const long long npairs = rows * (row_len >> 1);
  const long long q =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= npairs) return;
  const long long i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
  const bool asc = ((i & (row_len - 1)) & k) == 0;
  K a = x[i];
  K b = x[i + j];
  compare_exchange(a, b, asc);
  x[i] = a;
  x[i + j] = b;
}

// Replaces the in-block merge tails of K2a `_span_low_kernel`
// (block_sort.py:567) and K2b/K3 `_span_tail_kernel` (block_sort.py:493):
// for a level k > T, every stage with j < T, inside the shared-memory
// resident tile.
// Bound: 2 n itemsize HBM bytes per launch; log2(T) shared-memory stages.
// Design: as bitonic_tile_kernel, with the level's direction constant
// across the tile (bit k of the in-row index lies above the tile).
template <typename K>
__global__ void bitonic_tile_merge_kernel(K* __restrict__ x, long long rows,
                                          long long row_len, int T,
                                          long long k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  const long long base = load_tile(s, x, T, row_len);
  tile_stages(s, T, base & (row_len - 1), k, T >> 1);
  store_tile(s, x, T, base);
}

int tile_threads(int T) {
  const int half = T >> 1;
  return half < kTileThreads ? half : kTileThreads;
}

template <typename K>
int launch_tile(void* x, long long rows, long long row_len, int T,
                long long k_start, void* stream) {
  const long long tiles = rows * row_len / T;
  bitonic_tile_kernel<K>
      <<<static_cast<unsigned int>(tiles), tile_threads(T), T * sizeof(K),
         static_cast<cudaStream_t>(stream)>>>(static_cast<K*>(x), rows,
                                              row_len, T, k_start);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_global_stage(void* x, long long rows, long long row_len,
                        long long k, long long j, void* stream) {
  const long long npairs = rows * (row_len >> 1);
  const long long blocks = (npairs + kStageThreads - 1) / kStageThreads;
  bitonic_global_stage_kernel<K>
      <<<static_cast<unsigned int>(blocks), kStageThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(static_cast<K*>(x), rows,
                                              row_len, k, j);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_tile_merge(void* x, long long rows, long long row_len, int T,
                      long long k, void* stream) {
  const long long tiles = rows * row_len / T;
  bitonic_tile_merge_kernel<K>
      <<<static_cast<unsigned int>(tiles), tile_threads(T), T * sizeof(K),
         static_cast<cudaStream_t>(stream)>>>(static_cast<K*>(x), rows,
                                              row_len, T, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dsort_bitonic_tile_i32(void* x, long long rows, long long row_len, int T,
                           long long k_start, void* stream) {
  return launch_tile<int32_t>(x, rows, row_len, T, k_start, stream);
}

int dsort_bitonic_tile_i64(void* x, long long rows, long long row_len, int T,
                           long long k_start, void* stream) {
  return launch_tile<int64_t>(x, rows, row_len, T, k_start, stream);
}

int dsort_bitonic_global_stage_i32(void* x, long long rows, long long row_len,
                                   long long k, long long j, void* stream) {
  return launch_global_stage<int32_t>(x, rows, row_len, k, j, stream);
}

int dsort_bitonic_global_stage_i64(void* x, long long rows, long long row_len,
                                   long long k, long long j, void* stream) {
  return launch_global_stage<int64_t>(x, rows, row_len, k, j, stream);
}

int dsort_bitonic_tile_merge_i32(void* x, long long rows, long long row_len,
                                 int T, long long k, void* stream) {
  return launch_tile_merge<int32_t>(x, rows, row_len, T, k, stream);
}

int dsort_bitonic_tile_merge_i64(void* x, long long rows, long long row_len,
                                 int T, long long k, void* stream) {
  return launch_tile_merge<int64_t>(x, rows, row_len, T, k, stream);
}

}  // extern "C"
