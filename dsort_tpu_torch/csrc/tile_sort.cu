// Tile sort and radix histogram kernels for Hopper (sm_90a), plain C interface.
//
// The CUDA counterparts of the three Pallas kernels of
// dsort_tpu/ops/pallas_sort.py:
//
//   tile_sort_kernel<K>        S1 _tile_bitonic_kernel (pallas_sort.py:37)
//   tile_sort_kv_kernel<K>     S2 _tile_bitonic_kv_kernel (pallas_sort.py:106)
//   radix_histogram_kernel<K>  S3 _tile_histogram_kernel (pallas_sort.py:223)
//
// S1 / S2 sort every consecutive tile of T keys (T = tile_rows * 128, a
// power of two) ascending with the whole bitonic network: levels
// k = 2..T, distances j = k/2..1, the pair (i, i + j) of in-tile indices
// ordered ascending iff bit k of i is clear.  The reference's row-major
// (rows, 128) VMEM layout is the flat in-tile index here, so the network and
// its result are the same.  S2 carries an int32 index beside each key and
// orders pairs by (key, index) (the rank plane of bitonic_regs.cuh); the two
// holders of a pair decide its swap from one comparison, so equal keys can
// never duplicate or lose an index (pallas_sort.py:108-114).
//
// A tile is held by a thread-block cluster of C CTAs (a power of two up to
// 8; C = 1 is one CTA), each holding a contiguous L = T / C of it in
// registers, E consecutive keys (and indices) a thread.  A stage whose
// distance j is at least L pairs CTA r with CTA r ^ (j / L) at the same
// local offset, through distributed shared memory between two cluster
// barriers (`cluster_stage`); every other stage stays inside one CTA
// (`level_stages` of bitonic_regs.cuh, shared with K1 and the tile merge).
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns the launch's cudaError_t (0 on success).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic_regs.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTileThreads = 1024;
constexpr int kMaxSmem = 232448;  // dynamic shared memory of one CTA on sm_90
constexpr int kMaxCluster = 8;    // portable cluster size
constexpr int kHistThreads = 256;
constexpr int kSharedHistBits = 13;  // 32 KB of int32 buckets in shared memory

// S1's keys a thread (E): a CTA holds its share L of the tile in L / E
// threads, E = 16, or 32 at the one share of 32,768 keys (int32, the
// largest tile).  The share is ops/pallas_sort.py's tile_sort_cluster_size:
// 4,096 keys where the tile has more, up to 8 CTAs (8 CTAs of 256 threads
// at T = 32768).  On an H100 that form beat 1, 2 and 4 CTAs a tile for both
// key types (PERF.md §6; dsort_tpu_torch/tools/s1_forms.py).  Every
// instantiation keeps __launch_bounds__(1024): 64 registers a thread, so
// 1024 threads stay resident an SM in every form, and int64 and E = 32
// spill a few words.  Bounds matched to a form's threads remove the spill
// (95-104 registers) but halve the resident threads, and made int64 slower
// (PERF.md §6).
constexpr int kSortKeys = 16;

// S2's pairs a thread (E).  A CTA holds its share L of the tile in L / E
// threads; the share is ops/pallas_sort.py's tile_sort_cluster_size (kv),
// 4,096 pairs where the tile has more (8 CTAs of 256 threads at T = 32768)
// and at most 16,384 (what shared memory holds).  On an H100 E = 16 at 8
// CTAs beat E = 8 and 4 CTAs for both key types, though int64 spills (232
// bytes of spill stores) under the 64 registers of __launch_bounds__(1024)
// (PERF.md §6; dsort_tpu_torch/tools/s1_forms.py --kv).
constexpr int kKvKeys = 16;

// A stage at distance j = d L, d >= 1, across the CTAs of a cluster: every
// thread publishes its run (and, with R, its ranks) in its own CTA's shared
// memory, a cluster barrier, reads the run of the same thread in CTA
// rank ^ d and keeps its side; the second barrier holds every CTA's buffer
// until its partner has read it.  Both CTAs of a pair work, and none writes
// another's memory.
template <typename K, bool R, int E>
__device__ __forceinline__ void cluster_stage(K (&v)[E], int32_t (&q)[E], K* s, int32_t* sr,
                                              int rank, int d, bool desc) {
  constexpr int G = 4;  // keys per step, as smem_stage
  cg::cluster_group cluster = cg::this_cluster();
  put_chunks<K, E>(s, v);
  if constexpr (R) put_chunks<int32_t, E>(sr, q);
  cluster.sync();
  const K* ps = cluster.map_shared_rank(s, rank ^ d);
  const int32_t* psr = nullptr;
  if constexpr (R) psr = cluster.map_shared_rank(sr, rank ^ d);
  const bool up = (rank & d) != 0;
#pragma unroll
  for (int g = 0; g < E / G; ++g) {
    K p[G];
    int32_t pr[G] = {};
    get_chunks<K, G>(p, ps, threadIdx.x, g);
    if constexpr (R) get_chunks<int32_t, G>(pr, psr, threadIdx.x, g);
#pragma unroll
    for (int u = 0; u < G; ++u)
      order_with<K, R>(v[g * G + u], q[g * G + u], p[u], pr[u], up, desc);
  }
  cluster.sync();
}

// S1.  Bound: each key is read and written once, 2 T sizeof(K) HBM bytes a
// tile (0.16 ms at 8 x 2^23 int32 on H100 HBM3); against that stand
// T log2(T)(log2(T)+1)/4 compare-exchanges (120 stages at T = 32768), so
// the kernel is bound by instructions, not HBM.  Design: K1's, on a tile
// held by a cluster.  Each CTA holds its L = T / C keys E consecutive keys
// a thread in registers (L / E threads), loaded and stored 16 bytes at a
// time; of a level's stages j, those with j < E run inside the thread,
// E <= j < 32E on warp shuffles, 32E <= j < L through shared memory (the
// code of bitonic_regs.cuh, shared with K1 and the tile merge), and only
// j >= L across CTAs (`cluster_stage`).  At T = 32768, E = 16, C = 8: 54
// stages in the thread, 45 on shuffles, 15 in shared memory and 6 across
// CTAs, of 120.  Directions come from the in-tile index of the
// thread's first key, as K1's do from the in-row index; at k = T every tile
// ascends.
template <typename K, int E>
__global__ void __launch_bounds__(kTileThreads) tile_sort_kernel(K* __restrict__ x, int T, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  const int L = T / C;
  const int rank = static_cast<int>(blockIdx.x % C);
  const int i0 = rank * L + static_cast<int>(threadIdx.x) * E;
  K* run = x + static_cast<long long>(blockIdx.x / C) * T + i0;
  K v[E];
  int32_t q[E];  // no rank plane: the stage helpers take one and leave it be
  load_run<K, E>(v, run);
  thread_levels<K, false, E>(v, q, i0, 2);
  for (int k = 2 * E; k <= T; k <<= 1) {
    const bool desc = (i0 & k) != 0;
    int j = k >> 1;
    for (; j >= L; j >>= 1) cluster_stage<K, false, E>(v, q, s, nullptr, rank, j / L, desc);
    level_stages<K, false, E>(v, q, s, nullptr, j, desc);
  }
  store_run<K, E>(run, v);
}

// S2.  Bound: each key and index is read and written once, 2 T (sizeof(K)
// + 4) HBM bytes a tile (0.06 ms for the 2^23 records' int64 tiles on H100
// HBM3); against that stand the 120 stages of compare-exchanges at
// T = 32768, so, as for S1, the kernel is bound by instructions, not HBM.
// Design: S1's, with the index as the rank plane (`R = true` of every
// stage helper): each CTA holds its L = T / C pairs E a thread in
// registers (keys and indices loaded and stored 16 bytes at a time);
// stages j < E run in the thread, E <= j < 32E on shuffles, 32E <= j < L
// through shared memory, j >= L across CTAs, both CTAs of a pair working
// (at T = 32768, E = 16, C = 8: S1's 54 / 45 / 15 / 6 of the 120 stages).
template <typename K, int E>
__global__ void __launch_bounds__(kTileThreads)
    tile_sort_kv_kernel(K* __restrict__ x, int32_t* __restrict__ ix, int T, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int L = T / C;
  K* s = reinterpret_cast<K*>(smem_raw);
  int32_t* sr = reinterpret_cast<int32_t*>(s + L);
  const int rank = static_cast<int>(blockIdx.x % C);
  const int i0 = rank * L + static_cast<int>(threadIdx.x) * E;
  const long long at = static_cast<long long>(blockIdx.x / C) * T + i0;
  K v[E];
  int32_t q[E];
  load_run<K, E>(v, x + at);
  load_run<int32_t, E>(q, ix + at);
  thread_levels<K, true, E>(v, q, i0, 2);
  for (int k = 2 * E; k <= T; k <<= 1) {
    const bool desc = (i0 & k) != 0;
    int j = k >> 1;
    for (; j >= L; j >>= 1) cluster_stage<K, true, E>(v, q, s, sr, rank, j / L, desc);
    level_stages<K, true, E>(v, q, s, sr, j, desc);
  }
  store_run<K, E>(x + at, v);
  store_run<int32_t, E>(ix + at, q);
}

// The radix digit (x >> shift) & (2^bits - 1): an arithmetic shift for
// signed keys (sign fill from the top bit once shift >= width, as JAX's and
// torch's >> do), a logical one for unsigned keys.
template <typename K>
__device__ __forceinline__ int radix_digit(K x, int shift, unsigned int mask) {
  constexpr int width = 8 * sizeof(K);
  if constexpr (static_cast<K>(-1) < static_cast<K>(0)) {
    return static_cast<int>(static_cast<unsigned int>(x >> (shift < width ? shift : width - 1)) &
                            mask);
  } else {
    return shift < width ? static_cast<int>(static_cast<unsigned int>(x >> shift) & mask) : 0;
  }
}

// S3.  Bound: the input is read once (n sizeof(K) bytes) and 2^bits int32
// counts written.  The TPU kernel counts with a compare+reduce per bucket
// over each tile, carried across its sequential grid; blocks here run in
// parallel, so each CTA strides over the input, counts into a shared-memory
// histogram with shared atomics and adds its non-zero buckets to the zeroed
// output with global atomics.  Beyond 2^13 buckets the counts go to global
// atomics straight.  The ragged edge is masked, so no pads and no pad
// correction; integer atomics give exact counts in any order.
template <typename K>
__global__ void __launch_bounds__(kHistThreads)
    radix_histogram_kernel(const K* __restrict__ x, long long n, int shift, int bits,
                           int32_t* __restrict__ out) {
  extern __shared__ int32_t hist[];
  const int buckets = 1 << bits;
  const unsigned int mask = static_cast<unsigned int>(buckets - 1);
  const bool shared = bits <= kSharedHistBits;
  if (shared) {
    for (int b = threadIdx.x; b < buckets; b += blockDim.x) hist[b] = 0;
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int d = radix_digit<K>(x[i], shift, mask);
    if (shared)
      atomicAdd(hist + d, 1);
    else
      atomicAdd(out + d, 1);
  }
  if (shared) {
    __syncthreads();
    for (int b = threadIdx.x; b < buckets; b += blockDim.x)
      if (hist[b] != 0) atomicAdd(out + b, hist[b]);
  }
}

// True for a tile of T keys split over C CTAs: T and C powers of two, C at
// most kMaxCluster and at most T.
bool tile_shape_ok(int T, int C) {
  return T >= 2 && (T & (T - 1)) == 0 && C >= 1 && C <= kMaxCluster && (C & (C - 1)) == 0 &&
         T % C == 0;
}

// Launches `kernel` over `tiles` tiles, C CTAs per tile as one cluster,
// `threads` threads and `smem` bytes of dynamic shared memory a CTA.
template <typename... Params, typename... Args>
int launch_tiles(void (*kernel)(Params...), long long tiles, int C, int threads, long long smem,
                 void* stream, Args... args) {
  if (smem > kMaxSmem || tiles * C > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(tiles * C));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// S1 on shares of L = T / C keys, L / E threads a CTA: E = kSortKeys up to
// 16,384 keys a share, 32 (int32 only) at 32,768; refuses anything else.
template <typename K>
int launch_tile_sort(void* x, long long tiles, int T, int C, void* stream) {
  if (!tile_shape_ok(T, C) || T / C < kSortKeys) return static_cast<int>(cudaErrorInvalidValue);
  const int L = T / C;
  const long long smem = static_cast<long long>(L) * sizeof(K);
  K* xk = static_cast<K*>(x);
  if (L <= kSortKeys * kTileThreads)
    return launch_tiles(tile_sort_kernel<K, kSortKeys>, tiles, C, L / kSortKeys, smem, stream, xk,
                        T, C);
  if constexpr (sizeof(K) == 4)
    if (L == 2 * kSortKeys * kTileThreads)
      return launch_tiles(tile_sort_kernel<K, 2 * kSortKeys>, tiles, C, kTileThreads, smem, stream,
                          xk, T, C);
  return static_cast<int>(cudaErrorInvalidValue);
}

// S2 on shares of L = T / C pairs, L / kKvKeys threads a CTA, up to
// kKvKeys * 1024 pairs a share; refuses anything else.
template <typename K>
int launch_tile_sort_kv(void* x, void* v, long long tiles, int T, int C, void* stream) {
  if (!tile_shape_ok(T, C) || T / C < kKvKeys || T / C > kKvKeys * kTileThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = T / C;
  return launch_tiles(tile_sort_kv_kernel<K, kKvKeys>, tiles, C, L / kKvKeys,
                      static_cast<long long>(L) * (sizeof(K) + 4), stream, static_cast<K*>(x),
                      static_cast<int32_t*>(v), T, C);
}

template <typename K>
int launch_histogram(const void* x, long long n, int shift, int bits, void* out, void* stream) {
  if (bits < 0 || bits > 30 || shift < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long want = (n + kHistThreads - 1) / kHistThreads;
  const long long most = static_cast<long long>(sms) * 8;
  const unsigned int blocks = static_cast<unsigned int>(want < most ? want : most);
  const size_t smem = bits <= kSharedHistBits ? (static_cast<size_t>(1) << bits) * 4 : 0;
  radix_histogram_kernel<K><<<blocks, kHistThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(x), n, shift, bits, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `tiles` tiles of T keys each, contiguous from `x` (and `v`), sorted in
// place by clusters of C CTAs.
extern "C" {

int dsort_tile_sort_i32(void* x, long long tiles, int T, int C, void* stream) {
  return launch_tile_sort<int32_t>(x, tiles, T, C, stream);
}

int dsort_tile_sort_i64(void* x, long long tiles, int T, int C, void* stream) {
  return launch_tile_sort<int64_t>(x, tiles, T, C, stream);
}

int dsort_tile_sort_kv_i32(void* x, void* v, long long tiles, int T, int C, void* stream) {
  return launch_tile_sort_kv<int32_t>(x, v, tiles, T, C, stream);
}

int dsort_tile_sort_kv_i64(void* x, void* v, long long tiles, int T, int C, void* stream) {
  return launch_tile_sort_kv<int64_t>(x, v, tiles, T, C, stream);
}

// Adds the digit counts of n keys to `out` (2^bits int32, zeroed by the caller).
int dsort_radix_histogram_i32(const void* x, long long n, int shift, int bits, void* out,
                              void* stream) {
  return launch_histogram<int32_t>(x, n, shift, bits, out, stream);
}

int dsort_radix_histogram_i64(const void* x, long long n, int shift, int bits, void* out,
                              void* stream) {
  return launch_histogram<int64_t>(x, n, shift, bits, out, stream);
}

int dsort_radix_histogram_u32(const void* x, long long n, int shift, int bits, void* out,
                              void* stream) {
  return launch_histogram<uint32_t>(x, n, shift, bits, out, stream);
}

int dsort_radix_histogram_u64(const void* x, long long n, int shift, int bits, void* out,
                              void* stream) {
  return launch_histogram<uint64_t>(x, n, shift, bits, out, stream);
}

}  // extern "C"
