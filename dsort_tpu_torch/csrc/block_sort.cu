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
// k = 2T..row_len its cross stages j = k/2..T in groups of at most S_max
// consecutive stages, one global-stage launch a group, followed by one
// tile merge (stages j = T/2..1 of level k inside each tile).
//
// Where the tile lives.  The tile sort and the tile merge keep their tile
// in registers: each thread holds E consecutive keys, so a stage at
// distance j < E pairs keys of one thread, E <= j < 32E pairs two lanes of
// one warp (a shuffle), and only j >= 32E crosses warps, through shared
// memory (`level_stages`, bitonic_regs.cuh, which tile_sort.cu's S1 shares).
//
// The rank plane.  Every kernel takes an optional int32 plane `r` laid out
// like the keys (nullptr: keys alone).  With it, pairs compare
// lexicographically as (key, rank) and both planes move together: the
// counterpart of the reference's extra 32-bit plane in block_sort_pairs and
// block_merge_runs_kv, where the rank breaks key ties and comes back as the
// payload gather permutation.  Each pair gets one swap decision: where one
// thread owns both members it orders them in place; where they sit in two
// threads, each compares its entry with its partner's and takes the
// partner's iff the pair must swap, and the two agree on distinct entries
// (`order_with`).  So equal keys can never duplicate or lose a rank.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success).  Keys are int32_t or
// int64_t: unsigned and float keys reach here through the order-preserving
// signed mappings of ops/float_order.py.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic_regs.cuh"

namespace {

constexpr int kStageThreads = 256;

// Keys each thread holds in registers (E): 16 in bitonic_tile_kernel, 8 in
// bitonic_tile_merge_kernel; a tile of fewer keys runs on one thread with
// E = T.  On the card 16 beat 8 for every key type and plane in the tile
// sort (78 stages), and 8 beat 16 in the merge (12 stages), where more
// threads a tile shorten its load-compute-store chain.
constexpr int kTileKeys = 16;
constexpr int kMergeKeys = 8;
// Threads of the largest tile the wrapper admits (8192 int32 keys).
constexpr int kTileBlock = 8192 / kTileKeys;
constexpr int kMergeBlock = 8192 / kMergeKeys;

// S_max: the most consecutive stages of one level that a launch of
// bitonic_global_stage_kernel runs, per key type and plane (2^S keys, and
// ranks, a thread).  S = 1..S_max are instantiated; ops/block_sort.py's
// STAGES_MAX mirrors this table.  On an H100 a pass cost about the same
// at every S up to 6 for keys alone; with the rank plane S = 5 already
// takes ~254 registers and S = 6 spills and ran twice as long.
template <typename K, bool R>
constexpr int kStagesMax = R ? 5 : 6;

// Replaces K1 `_tile_sort_cm_kernel` (block_sort.py:419) at k_start == 2
// and K1b `_sort_levels_kernel` (block_sort.py:440) at k_start > 2 (the
// merge entry of block_merge_runs for runs shorter than a tile).
// Bound: every key (and rank) is read and written once, 2 n (itemsize
// [+ 4]) bytes: 0.16 ms at 8 x 2^23 int32 on H100 HBM3.  Against that stand
// n log2(T)(log2(T)+1)/4 compare-exchanges (78 stages at T = 4096), one to
// four instructions a key each: the kernel is bound by instructions, not HBM.
// Design: T/E threads per tile, each holding E consecutive keys (and ranks)
// in registers, loaded and stored 16 bytes at a time where the address
// allows.  Of a level's stages j, those with j < E run inside the thread,
// unrolled, with no memory and no barrier; E <= j < 32E take one shuffle a
// key (int64: two words; the rank one more) at lane distance j/E; only
// j >= 32E cross warps, through shared memory: each thread publishes its
// run, a barrier, reads its partner's run, a barrier (`smem_stage`, in a
// layout whose accesses meet no bank conflict).  At T = 4096, E = 16: 42
// stages in-thread, 30 on shuffles, 6 in shared memory, of 78.  Directions
// come from the in-row index, so the tile's top level takes its direction
// from the tile's parity inside the row, as K1's block parity does.
template <typename K, bool R, int E>
__global__ void __launch_bounds__(kTileBlock)
    bitonic_tile_kernel(K* __restrict__ x, int32_t* __restrict__ r, long long row_len,
                        int T, long long k_start) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  int32_t* sr = reinterpret_cast<int32_t*>(s + T);
  const long long first = static_cast<long long>(blockIdx.x) * T + threadIdx.x * E;
  // Bits 0..log2(T) of the in-row index of the thread's first key: all that
  // a level k <= T reads of it.
  const int i0 = static_cast<int>(first & (row_len - 1) & (2 * T - 1));
  K v[E];
  int32_t q[E];
  load_run<K, E>(v, x + first);
  if constexpr (R) load_run<int32_t, E>(q, r + first);
  thread_levels<K, R, E>(v, q, i0, k_start);
  for (int k = k_start > 2 * E ? static_cast<int>(k_start) : 2 * E; k <= T; k <<= 1)
    level_stages<K, R, E>(v, q, s, sr, k >> 1, (i0 & k) != 0);
  store_run<K, E>(x + first, v);
  if constexpr (R) store_run<int32_t, E>(r + first, q);
}

// Replaces K2 `_cross_kernel` (block_sort.py:466) and K2c `_orbit_kernel`
// (block_sort.py:722): the S consecutive stages j_top, j_top/2, ..,
// j_low = j_top >> (S-1) of level k, all at distances j >= T, in one pass.
// Bound: HBM bytes, 2 n (itemsize [+ 4]) a launch (each key and rank read
// and written once) whatever S is; the n S / 2 compare-exchanges stay far
// below it.  Design: the K2c orbit with registers in place of VMEM.  The
// stages vary only the S in-row index bits log2(j_low)..log2(j_top), so the
// keys split into closed groups of 2^S, base + e j_low for e < 2^S; thread
// g owns group g: the bits of g below log2(j_low) are the low bits of its
// base and the rest go above the S group bits.  Each thread loads its
// group (2^S independent loads in flight), runs the S stages in registers
// (`thread_tail`), and stores it back: no shared memory, no barrier, no
// atomic.  Consecutive threads hold consecutive columns, so with
// j_low >= 32 each of a warp's loads and stores is one contiguous run.
// k >= 2 j_top puts bit k of the in-row index above every group bit: one
// direction a thread.
template <typename K, bool R, int S>
__global__ void __launch_bounds__(kStageThreads)
    bitonic_global_stage_kernel(K* __restrict__ x, int32_t* __restrict__ r,
                                long long groups, long long row_len, long long k,
                                int lj_low) {
  constexpr int G = 1 << S;
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long j_low = 1LL << lj_low;
  const long long base = ((g >> lj_low) << (lj_low + S)) | (g & (j_low - 1));
  const bool asc = (base & (row_len - 1) & k) == 0;
  K v[G];
  int32_t q[G];
#pragma unroll
  for (int e = 0; e < G; ++e) v[e] = x[base + e * j_low];
  if constexpr (R) {
#pragma unroll
    for (int e = 0; e < G; ++e) q[e] = r[base + e * j_low];
  }
  thread_tail<K, R, G>(v, q, asc);
#pragma unroll
  for (int e = 0; e < G; ++e) x[base + e * j_low] = v[e];
  if constexpr (R) {
#pragma unroll
    for (int e = 0; e < G; ++e) r[base + e * j_low] = q[e];
  }
}

// Replaces the in-block merge tails of K2a `_span_low_kernel`
// (block_sort.py:567) and K2b/K3 `_span_tail_kernel` (block_sort.py:493):
// for a level k > T, the stages j = T/2..1 inside every T-key tile.
// Bound: HBM bytes, 2 n (itemsize [+ 4]) a launch (0.16 ms at 8 x 2^23
// int32); its n log2(T) / 2 compare-exchanges stay far below it.  Design:
// K1's last level on K1's layout, with E = kMergeKeys (T/E threads a
// tile, E consecutive keys and ranks each in registers, 16-byte loads and
// stores), through the same `level_stages`.  Bit k of the in-row index
// lies above the tile, so one direction serves the whole tile.  At
// T = 4096, E = 8: 4 stages through shared memory, 5 on shuffles, 3 in
// the thread, of 12.
template <typename K, bool R, int E>
__global__ void __launch_bounds__(kMergeBlock)
    bitonic_tile_merge_kernel(K* __restrict__ x, int32_t* __restrict__ r, long long row_len,
                              int T, long long k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  K* s = reinterpret_cast<K*>(smem_raw);
  int32_t* sr = reinterpret_cast<int32_t*>(s + T);
  const long long first = static_cast<long long>(blockIdx.x) * T + threadIdx.x * E;
  K v[E];
  int32_t q[E];
  load_run<K, E>(v, x + first);
  if constexpr (R) load_run<int32_t, E>(q, r + first);
  level_stages<K, R, E>(v, q, s, sr, T >> 1, (first & (row_len - 1) & k) != 0);
  store_run<K, E>(x + first, v);
  if constexpr (R) store_run<int32_t, E>(r + first, q);
}

template <typename K>
size_t tile_smem(int T, bool ranked) {
  return static_cast<size_t>(T) * (sizeof(K) + (ranked ? sizeof(int32_t) : 0));
}

// One launch, T/E threads a tile: the tile merge of level k > T (Merge), or
// levels k..T of the tile sort.
template <typename K, bool R, bool Merge, int E>
void launch_tile_e(K* x, int32_t* r, long long rows, long long row_len, int T, long long k,
                   cudaStream_t st) {
  const unsigned int tiles = static_cast<unsigned int>(rows * row_len / T);
  const size_t smem = tile_smem<K>(T, R);
  if constexpr (Merge)
    bitonic_tile_merge_kernel<K, R, E><<<tiles, T / E, smem, st>>>(x, r, row_len, T, k);
  else
    bitonic_tile_kernel<K, R, E><<<tiles, T / E, smem, st>>>(x, r, row_len, T, k);
}

// E = min(T, kMergeKeys or kTileKeys).
template <typename K, bool R, bool Merge>
void launch_tile_r(K* x, int32_t* r, long long rows, long long row_len, int T, long long k,
                   cudaStream_t st) {
  constexpr int e_max = Merge ? kMergeKeys : kTileKeys;
  switch (T < e_max ? T : e_max) {
    case 2: return launch_tile_e<K, R, Merge, 2>(x, r, rows, row_len, T, k, st);
    case 4: return launch_tile_e<K, R, Merge, 4>(x, r, rows, row_len, T, k, st);
    case 8: return launch_tile_e<K, R, Merge, 8>(x, r, rows, row_len, T, k, st);
    default: return launch_tile_e<K, R, Merge, e_max>(x, r, rows, row_len, T, k, st);
  }
}

template <typename K, bool Merge>
int launch_tile(void* x, void* r, long long rows, long long row_len, int T, long long k,
                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (r != nullptr)
    launch_tile_r<K, true, Merge>(static_cast<K*>(x), static_cast<int32_t*>(r), rows, row_len,
                                  T, k, st);
  else
    launch_tile_r<K, false, Merge>(static_cast<K*>(x), nullptr, rows, row_len, T, k, st);
  return static_cast<int>(cudaGetLastError());
}

// Launches the instantiation S == stages (S counts down from S_max).
template <typename K, bool R, int S>
int launch_stages(K* x, int32_t* r, long long n, long long row_len, long long k, int lj_low,
                  int stages, cudaStream_t st) {
  if (stages == S) {
    const long long groups = n >> S;
    const unsigned int blocks =
        static_cast<unsigned int>((groups + kStageThreads - 1) / kStageThreads);
    bitonic_global_stage_kernel<K, R, S><<<blocks, kStageThreads, 0, st>>>(x, r, groups,
                                                                            row_len, k, lj_low);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (S > 1)
    return launch_stages<K, R, S - 1>(x, r, n, row_len, k, lj_low, stages, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

// Stages j = j_top .. j_top >> (stages - 1) of level k; refuses (without
// launching) a stage count outside 1..S_max or a group that leaves the
// level's distances or the row.
template <typename K>
int launch_global_stage(void* x, void* r, long long rows, long long row_len, long long k,
                        long long j_top, int stages, void* stream) {
  const bool ranked = r != nullptr;
  const int s_max = ranked ? kStagesMax<K, true> : kStagesMax<K, false>;
  if (stages < 1 || stages > s_max || (j_top >> (stages - 1)) < 1 || 2 * j_top > k ||
      k > row_len)
    return static_cast<int>(cudaErrorInvalidValue);
  int lj_low = 0;
  while ((2LL << lj_low) <= (j_top >> (stages - 1))) ++lj_low;
  const long long n = rows * row_len;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ranked)
    return launch_stages<K, true, kStagesMax<K, true>>(
        static_cast<K*>(x), static_cast<int32_t*>(r), n, row_len, k, lj_low, stages, st);
  return launch_stages<K, false, kStagesMax<K, false>>(static_cast<K*>(x), nullptr, n, row_len,
                                                       k, lj_low, stages, st);
}

}  // namespace

// `r` is the int32 rank plane or nullptr for keys alone.
extern "C" {

int dsort_bitonic_tile_i32(void* x, void* r, long long rows, long long row_len,
                           int T, long long k_start, void* stream) {
  return launch_tile<int32_t, false>(x, r, rows, row_len, T, k_start, stream);
}

int dsort_bitonic_tile_i64(void* x, void* r, long long rows, long long row_len,
                           int T, long long k_start, void* stream) {
  return launch_tile<int64_t, false>(x, r, rows, row_len, T, k_start, stream);
}

int dsort_bitonic_global_stage_i32(void* x, void* r, long long rows,
                                   long long row_len, long long k, long long j,
                                   int stages, void* stream) {
  return launch_global_stage<int32_t>(x, r, rows, row_len, k, j, stages, stream);
}

int dsort_bitonic_global_stage_i64(void* x, void* r, long long rows,
                                   long long row_len, long long k, long long j,
                                   int stages, void* stream) {
  return launch_global_stage<int64_t>(x, r, rows, row_len, k, j, stages, stream);
}

// S_max of the global-stage kernel for keys of `key_bytes` (4 or 8), with
// the rank plane iff `ranked`; 0 for any other key width.
int dsort_bitonic_global_stages_max(int key_bytes, int ranked) {
  if (key_bytes == 4) return ranked ? kStagesMax<int32_t, true> : kStagesMax<int32_t, false>;
  if (key_bytes == 8) return ranked ? kStagesMax<int64_t, true> : kStagesMax<int64_t, false>;
  return 0;
}

int dsort_bitonic_tile_merge_i32(void* x, void* r, long long rows,
                                 long long row_len, int T, long long k,
                                 void* stream) {
  return launch_tile<int32_t, true>(x, r, rows, row_len, T, k, stream);
}

int dsort_bitonic_tile_merge_i64(void* x, void* r, long long rows,
                                 long long row_len, int T, long long k,
                                 void* stream) {
  return launch_tile<int64_t, true>(x, r, rows, row_len, T, k, stream);
}

}  // extern "C"
