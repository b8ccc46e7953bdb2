// Register-resident bitonic stages for Hopper (sm_90a), shared by the tile
// kernels of block_sort.cu (the tile sort and the tile merge) and tile_sort.cu
// (S1 and S2).
//
// A tile is held E consecutive keys a thread, in registers.  A stage at
// distance j < E pairs keys of one thread (`thread_levels`, `thread_tail`),
// E <= j < 32E pairs two lanes of one warp (`shfl_stage`), and j >= 32E
// crosses warps through shared memory (`smem_stage`); `level_stages` runs
// the stages j_top..1 of one level that way.  Each helper takes an optional
// int32 rank plane q beside the keys (R): pairs then compare as (key, rank)
// and both planes move together.

#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;

__host__ __device__ constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }

// Copies E consecutive values from p (global or shared memory) into a
// thread's registers, 16 bytes at a time where the address allows.
template <typename V, int E>
__device__ __forceinline__ void load_run(V (&v)[E], const V* p) {
  constexpr int kVec = 16 / sizeof(V);
  if constexpr (E % kVec == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int c = 0; c < E / kVec; ++c) {
        const int4 w = reinterpret_cast<const int4*>(p)[c];
        memcpy(&v[c * kVec], &w, sizeof(w));
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = p[e];
}

template <typename V, int E>
__device__ __forceinline__ void store_run(V* p, const V (&v)[E]) {
  constexpr int kVec = 16 / sizeof(V);
  if constexpr (E % kVec == 0) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int c = 0; c < E / kVec; ++c) {
        int4 w;
        memcpy(&w, &v[c * kVec], sizeof(w));
        reinterpret_cast<int4*>(p)[c] = w;
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < E; ++e) p[e] = v[e];
}

// Orders a pair in one thread's registers, (a, ra) and (b, rb), ascending
// (asc) or descending, in place.  With ranks, one comparison decides: swap
// iff "a > b" on (key, rank) equals "ascending"; a full (key, rank) tie
// then swaps two identical entries, which changes no bit.  (On an H100 this
// made the rank-plane tile sort ~1.6x faster than testing "a > b" and
// "b > a" apart.)
template <typename K, bool R>
__device__ __forceinline__ void order_pair(K& a, K& b, int32_t& ra, int32_t& rb, bool asc) {
  if constexpr (!R) {
    const K lo = a < b ? a : b;
    const K hi = a < b ? b : a;
    a = asc ? lo : hi;
    b = asc ? hi : lo;
  } else if (((a > b) | ((a == b) & (ra > rb))) == asc) {
    const K tk = a;
    a = b;
    b = tk;
    const int32_t tr = ra;
    ra = rb;
    rb = tr;
  }
}

// Levels k = max(2, k_start)..E: every stage pairs keys of one thread.  i0
// holds the low bits of the in-row index of the thread's first key.
template <typename K, bool R, int E>
__device__ __forceinline__ void thread_levels(K (&v)[E], int32_t (&q)[E], int i0,
                                              long long k_start) {
#pragma unroll
  for (int lk = 1; lk <= log2i(E); ++lk) {
    const int k = 1 << lk;
    if (k < k_start) continue;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
#pragma unroll
      for (int e = 0; e < E; ++e)
        if ((e & j) == 0)
          order_pair<K, R>(v[e], v[e + j], q[e], q[e + j], ((i0 | e) & k) == 0);
    }
  }
}

// Stages j = E/2..1 of a level k >= 2E, one direction for the whole thread.
template <typename K, bool R, int E>
__device__ __forceinline__ void thread_tail(K (&v)[E], int32_t (&q)[E], bool asc) {
#pragma unroll
  for (int lj = log2i(E) - 1; lj >= 0; --lj) {
    const int j = 1 << lj;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if ((e & j) == 0) order_pair<K, R>(v[e], v[e + j], q[e], q[e + j], asc);
  }
}

// This thread's side of a pair whose other member (p, pr) another thread
// holds; `up` says which member this thread holds.  The lower member takes
// the minimum when ascending.  With ranks, both threads decide from the one
// comparison "mine > partner": for distinct entries the two answers are
// complements and `up` flips one, so both take the same decision; a full
// tie leaves both threads with identical entries whichever way they go.
template <typename K, bool R>
__device__ __forceinline__ void order_with(K& v, int32_t& q, K p, int32_t pr, bool up,
                                           bool desc) {
  if constexpr (!R) {
    v = up == desc ? (p < v ? p : v) : (p > v ? p : v);
  } else if (((v > p) | ((v == p) & (q > pr))) != (desc != up)) {
    v = p;
    q = pr;
  }
}

// One stage at distance j = d E (d < 32): key e of this lane pairs key e of
// lane ^ d.
template <typename K, bool R, int E>
__device__ __forceinline__ void shfl_stage(K (&v)[E], int32_t (&q)[E], int d, bool up,
                                           bool desc, unsigned mask) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const K p = __shfl_xor_sync(mask, v[e], d);
    int32_t pr = 0;
    if constexpr (R) pr = __shfl_xor_sync(mask, q[e], d);
    order_with<K, R>(v[e], q[e], p, pr, up, desc);
  }
}

// Shared-memory image of every thread's run in 16-byte chunks, chunk c of
// thread t at c * threads + t: a warp's accesses to one chunk index, its
// own or its partners', fall on distinct banks.
template <typename V, int E>
__device__ __forceinline__ void put_chunks(V* s, const V (&v)[E]) {
  constexpr int kVec = 16 / sizeof(V);
#pragma unroll
  for (int c = 0; c < E / kVec; ++c) {
    int4 w;
    memcpy(&w, &v[c * kVec], sizeof(w));
    reinterpret_cast<int4*>(s)[c * blockDim.x + threadIdx.x] = w;
  }
}

// Values g N..g N + N - 1 of thread t's run (N a multiple of 16 bytes).
template <typename V, int N>
__device__ __forceinline__ void get_chunks(V (&v)[N], const V* s, int t, int g) {
  constexpr int kVec = 16 / sizeof(V);
#pragma unroll
  for (int c = 0; c < N / kVec; ++c) {
    const int4 w = reinterpret_cast<const int4*>(s)[(g * N / kVec + c) * blockDim.x + t];
    memcpy(&v[c * kVec], &w, sizeof(w));
  }
}

// One stage at distance j = d E with d >= 32, across warps: every thread
// publishes its run, reads its partner's (thread ^ d) and keeps its side.
template <typename K, bool R, int E>
__device__ __forceinline__ void smem_stage(K (&v)[E], int32_t (&q)[E], K* s, int32_t* sr,
                                           int d, bool up, bool desc) {
  constexpr int G = 4;  // keys per step: one 16-byte chunk of ranks
  put_chunks<K, E>(s, v);
  if constexpr (R) put_chunks<int32_t, E>(sr, q);
  __syncthreads();
#pragma unroll
  for (int g = 0; g < E / G; ++g) {
    K p[G];
    int32_t pr[G] = {};
    get_chunks<K, G>(p, s, threadIdx.x ^ d, g);
    if constexpr (R) get_chunks<int32_t, G>(pr, sr, threadIdx.x ^ d, g);
#pragma unroll
    for (int u = 0; u < G; ++u)
      order_with<K, R>(v[g * G + u], q[g * G + u], p[u], pr[u], up, desc);
  }
  __syncthreads();  // every partner read before the next stage writes
}

// Stages j = j_top..1 of one level (j_top >= E/2) on a tile held in
// registers, E consecutive keys (and ranks) a thread, in one direction for
// the whole thread: j >= 32E through shared memory, E <= j < 32E on warp
// shuffles (a partial warp shuffles under the mask of its threads), j < E
// inside the thread.  The one code path of every register-resident level,
// in the tile sort, the tile merge, S1 and S2.
template <typename K, bool R, int E>
__device__ __forceinline__ void level_stages(K (&v)[E], int32_t (&q)[E], K* s, int32_t* sr,
                                             int j_top, bool desc) {
  const int t = threadIdx.x;
  const unsigned mask = blockDim.x >= kWarp ? 0xffffffffu : (1u << blockDim.x) - 1u;
  int j = j_top;
  for (; j >= kWarp * E; j >>= 1)
    smem_stage<K, R, E>(v, q, s, sr, j / E, (t & (j / E)) != 0, desc);
  for (; j >= E; j >>= 1) shfl_stage<K, R, E>(v, q, j / E, (t & (j / E)) != 0, desc, mask);
  thread_tail<K, R, E>(v, q, !desc);
}

}  // namespace
