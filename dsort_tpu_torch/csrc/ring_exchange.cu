// Fused ring exchange kernels for Hopper (sm_90a), plain C interface.
//
// The CUDA counterparts of the two fused ring Pallas kernels of
// dsort_tpu/ops/ring_kernel.py: R1 `_fused_ring_kernel` (keys) and R2
// `_fused_ring_kv_kernel` (keys + payload records).  On the TPU each device
// runs one kernel that starts P-1 remote DMAs into per-step slots of its
// output and folds the landed runs through an in-kernel merge network.  On
// one card the P shards are rows of one tensor, so the remote copies of all
// P devices become ONE launch here (ring_exchange_kernel), the merge network
// is the block-bitonic kernels of block_sort.cu with their rank plane, and
// R2's in-kernel payload placement is gather_rows_kernel.
//
// Slot layout.  Step k of the ring moves source s = (d - k) mod P's bucket
// for destination d.  Row d of the key workspace holds P2 = ceil_pow2(P)
// slots of `slot` = ceil_pow2(max caps) keys: slot k carries that bucket
// (true length lens[s][d], starting at starts[s][d] of source s's sorted
// shard), then the sentinel up to slot.  Odd slots are written reversed, so
// each row is a sequence of alternately ascending and descending runs: the
// bitonic merge entry, ready for the block kernels at level 2 * slot with
// no pad or flip pass in between.  Slots k >= P (P not a power of two) are
// all sentinel.
//
// Tags (KV only).  The tag of position pos of slot k is the reference's
// tag plane, offs[k] + pos + is_pad * total (offs = partial sums of caps,
// total = sum(caps)), and 2 * total + pos beyond caps[k]: every slot stays
// sorted by (key, tag), real keys equal to the sentinel stay ahead of the
// pads, and after the merge the tags of the first `total` entries are the
// payload permutation.  Payload rows land flat, row offs[k] + pos of
// destination d, exactly the reference's step-ordered workspace; pad rows
// are zeroed so the workspace is fully defined.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success).
//
// Keys alone and records take two kernels: ring_exchange_kernel (R1, keys
// alone, 16-byte vectors; below) and ring_exchange_kv_kernel (R2's
// exchange, one key, tag and payload byte range a thread position).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 128;
constexpr int kThreads = 256;
constexpr long long kChunk = 2048;  // slot positions per block
constexpr int kWarp = 32;
constexpr int kGatherThreads = 256;  // 8 warps, 8 runs of 32 rows
constexpr int kRingThreads = 256;    // R1: 8 warps a block
constexpr int kRingItems = 4;        // R1: 16-byte vectors a lane, one warp chunk a warp

struct StepPlan {
  long long caps[kMaxShards];
  long long offs[kMaxShards];
};

// N keys moved as one word: 16 bytes in the vector form (N = 4 int32 or 2
// int64), the key itself at N = 1.
template <typename K, int N>
struct Pack {
  K e[N];
};

template <typename K, int N>
__device__ __forceinline__ Pack<K, N> load_pack(const K* p) {
  Pack<K, N> r;
  if constexpr (N == 1 && sizeof(K) == 4) {
    r.e[0] = __ldg(reinterpret_cast<const int*>(p));
  } else if constexpr (N == 1) {
    r.e[0] = __ldg(reinterpret_cast<const long long*>(p));
  } else if constexpr (sizeof(K) == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    r.e[0] = v.x;
    r.e[1] = v.y;
    r.e[2] = v.z;
    r.e[3] = v.w;
  } else {
    const longlong2 v = __ldg(reinterpret_cast<const longlong2*>(p));
    r.e[0] = v.x;
    r.e[1] = v.y;
  }
  return r;
}

template <typename K, int N>
__device__ __forceinline__ void store_pack(K* p, const Pack<K, N>& r) {
  if constexpr (N == 1)
    *p = r.e[0];
  else if constexpr (sizeof(K) == 4)
    *reinterpret_cast<int4*>(p) = make_int4(r.e[0], r.e[1], r.e[2], r.e[3]);
  else
    *reinterpret_cast<longlong2*>(p) = make_longlong2(r.e[0], r.e[1]);
}

// `r` from lane `src` of the warp, one shuffle a key.
template <typename K, int N>
__device__ __forceinline__ Pack<K, N> shfl_pack(const Pack<K, N>& r, int src) {
  Pack<K, N> out;
#pragma unroll
  for (int i = 0; i < N; ++i) out.e[i] = __shfl_sync(0xffffffffu, r.e[i], src);
  return out;
}

template <typename K>
__device__ __forceinline__ K key_max();
template <>
__device__ __forceinline__ int32_t key_max<int32_t>() { return INT32_MAX; }
template <>
__device__ __forceinline__ int64_t key_max<int64_t>() { return INT64_MAX; }

// Block-cooperative copy of n bytes between global buffers: the widest
// vector both addresses agree on modulo its width, with byte head and tail.
template <typename V>
__device__ __forceinline__ void copy_body(unsigned char* dst,
                                          const unsigned char* src,
                                          long long n) {
  const long long head = static_cast<long long>(
      (sizeof(V) - (reinterpret_cast<uintptr_t>(dst) & (sizeof(V) - 1))) &
      (sizeof(V) - 1));
  const long long h = head < n ? head : n;
  for (long long i = threadIdx.x; i < h; i += blockDim.x) dst[i] = src[i];
  const long long words = (n - h) / static_cast<long long>(sizeof(V));
  V* dv = reinterpret_cast<V*>(dst + h);
  const V* sv = reinterpret_cast<const V*>(src + h);
  for (long long i = threadIdx.x; i < words; i += blockDim.x) dv[i] = sv[i];
  for (long long i = h + words * sizeof(V) + threadIdx.x; i < n;
       i += blockDim.x)
    dst[i] = src[i];
}

__device__ __forceinline__ void block_copy(unsigned char* dst,
                                           const unsigned char* src,
                                           long long n) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(dst) ^
                      reinterpret_cast<uintptr_t>(src);
  if ((x & 15) == 0)
    copy_body<uint4>(dst, src, n);
  else if ((x & 7) == 0)
    copy_body<uint2>(dst, src, n);
  else if ((x & 3) == 0)
    copy_body<uint32_t>(dst, src, n);
  else
    copy_body<unsigned char>(dst, src, n);
}

__device__ __forceinline__ void block_zero(unsigned char* dst, long long n) {
  for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = 0;
}

// Keys m .. m + V - 1 of the 2V keys of a then b (0 <= m < V): the last
// V - m keys of a and the first m of b, by selects on m.
template <typename K, int V>
__device__ __forceinline__ Pack<K, V> shift_in(const Pack<K, V>& a, const Pack<K, V>& b, int m) {
  Pack<K, V> r;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    K x = a.e[i];
#pragma unroll
    for (int t = 1; t < V; ++t)
      if (m == t) x = i + t < V ? a.e[(i + t) % V] : b.e[(i + t) % V];
    r.e[i] = x;
  }
  return r;
}

// One warp chunk of R1: kSpan = 32 kRingItems consecutive vectors of a
// slot's positions.  Lane l takes chunk vectors t = 32 j + l (j <
// kRingItems), so each load and store instruction of the warp covers 32
// consecutive vectors, and issues every load before its first store.  The
// source is read as 16-byte aligned vectors from `a0`, m keys before the
// chunk's first position: position vector t is the last V - m keys of
// aligned vector t and the first m of t + 1, which lane l takes from lane
// l + 1 with one shuffle a key (lane 31 from lane 0's vector of the next j;
// lane 0 loads one vector past the chunk for the last j).  Aligned vector
// t is loaded only if t V < lim (it holds a real key), so no load leaves
// the 16 bytes around a real key; key i of vector t is real if t V + i <
// rel, else the sentinel; vector t is stored if t < nrem, at o + t V, or
// with its keys reversed at o - (t + 1) V in a reversed slot.
template <typename K, int V>
__device__ __forceinline__ void ring_chunk(const K* __restrict__ a0, K* __restrict__ o, int lim,
                                           int rel, int nrem, int m, bool rev, int lane) {
  constexpr int kSpan = kWarp * kRingItems;
  Pack<K, V> a[kRingItems + 1] = {};
#pragma unroll
  for (int j = 0; j < kRingItems; ++j) {
    const int t = j * kWarp + lane;
    if (t * V < lim) a[j] = load_pack<K, V>(a0 + t * V);
  }
  if constexpr (V > 1)
    if (m > 0 && lane == 0 && kSpan * V < lim) a[kRingItems] = load_pack<K, V>(a0 + kSpan * V);
  K* const o0 = rev ? o - V : o;  // vector t goes to o0 + t step
  const int step = rev ? -V : V;
#pragma unroll
  for (int j = 0; j < kRingItems; ++j) {
    const int t = j * kWarp + lane;
    Pack<K, V> v = a[j];
    if constexpr (V > 1) {
      Pack<K, V> c;  // lane 0 hands lane 31 its vector of the next j
#pragma unroll
      for (int i = 0; i < V; ++i) c.e[i] = lane == 0 ? a[j + 1].e[i] : a[j].e[i];
      v = shift_in<K, V>(a[j], shfl_pack<K, V>(c, (lane + 1) & (kWarp - 1)), m);
    }
    if (t >= nrem) continue;
    Pack<K, V> r;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int at = rev ? V - 1 - i : i;  // the key stored at place i
      r.e[i] = t * V + at < rel ? (rev ? v.e[V - 1 - i] : v.e[i]) : key_max<K>();
    }
    store_pack<K, V>(o0 + t * step, r);
  }
}

// Replaces the P-1 async remote copies of R1 `_fused_ring_kernel`
// (ring_kernel.py:280): every (destination, step) slot of the layout above,
// keys alone.
// Bound: HBM bytes — each bucket key read once and each slot key written
// once, (real + P sum(caps)) keys: 0.1703 ms at the 2^26 int32 plan (caps
// ~1.18M) on H100 HBM3.  The layout itself writes the whole power-of-two
// slot, P P2 slot keys: with slot = 2^21 that is 537 MB written and 268 MB
// read, 0.240 ms at 3.35 TB/s, a floor no kernel of this layout goes under
// (only a merge entry without the pad would).
// Design: 16-byte vectors aligned to the slot (V = 4 int32 or 2 int64
// keys; V = 1 where the slot or the workspace is not 16-byte aligned),
// kRingItems of them a lane, every load of a lane issued before its first
// store; one warp chunk (`ring_chunk`, 2 KB of slot) a warp, so a chunk
// never crosses a slot and the warp reads its (destination, step)'s start
// and length once; the misaligned source is read as aligned vectors and
// shifted into place with one shuffle a key; the sentinel runs are stored
// without loads.  On an H100 at the 2^26 int32 plan this form took 0.276 ms
// alone (2.9 TB/s; a contiguous torch copy_ moves 3.0 TB/s there), 2 or 8
// vectors a lane the same; a persistent grid (at most 8 blocks a SM, warps
// striding over chunks) and runs of 2-8 chunks a warp were slower (PERF.md
// §6; dsort_tpu_torch/tools/r1_s3_forms.py).
template <typename K, int V>
__global__ void __launch_bounds__(kRingThreads)
    ring_exchange_kernel(const K* __restrict__ xs, const long long* __restrict__ starts,
                         const long long* __restrict__ lens, K* __restrict__ wk, int P,
                         int P2, int p2_log2, long long n_local, long long slot,
                         int cps_log2, StepPlan plan) {
  constexpr int kSpan = kWarp * kRingItems;
  const int lane = static_cast<int>(threadIdx.x) & (kWarp - 1);
  const long long c = static_cast<long long>(blockIdx.x) * (kRingThreads / kWarp) +
                      static_cast<int>(threadIdx.x) / kWarp;  // this warp's chunk
  if (c >= (static_cast<long long>(P) * P2) << cps_log2) return;  // the whole warp
  const long long sl = c >> cps_log2;  // d * P2 + k
  const int d = static_cast<int>(sl >> p2_log2), k = static_cast<int>(sl & (P2 - 1));
  int len = 0;  // slot < 2^31 (the C entry)
  const K* src = xs;
  if (k < P) {
    const int s = d >= k ? d - k : d - k + P;
    const long long cap = plan.caps[k];
    const long long ln = __ldg(lens + s * P + d);
    len = static_cast<int>(ln < cap ? (ln > 0 ? ln : 0) : cap);
    src = xs + static_cast<long long>(s) * n_local + __ldg(starts + s * P + d);
  }
  const int m =
      len > 0 ? static_cast<int>((reinterpret_cast<uintptr_t>(src) / sizeof(K)) % V) : 0;
  const int ub = static_cast<int>(c & ((1LL << cps_log2) - 1)) * kSpan * V;  // first position
  const bool rev = (k & 1) != 0;
  ring_chunk<K, V>(src - m + ub, wk + sl * slot + (rev ? slot - ub : ub), len + m - ub,
                   len - ub, static_cast<int>(slot / V) - ub / V, m, rev, lane);
}

// Replaces the P-1 async remote copies of R2 `_fused_ring_kv_kernel`
// (ring_kernel.py:356).  Block (chunk, d * P2 + k) fills positions
// [chunk * kChunk, +kChunk) of slot k of destination d (layout above).
// Bound: HBM bytes — each bucket key and payload row read once, each slot
// key, tag and payload row written once; no arithmetic to speak of.
// Design: one launch for every (destination, step) slot of the whole
// virtual mesh; consecutive threads take consecutive positions, so key and
// tag loads and stores are coalesced (reversed slots store descending
// addresses, still one segment per warp); the payload rows of a chunk are
// one contiguous byte range on both sides, copied with the widest vector
// the two addresses allow (92-byte TeraSort rows are 4-byte aligned only,
// so a byte head and tail close the gap).
template <typename K>
__global__ void ring_exchange_kv_kernel(
    const K* __restrict__ xs, const long long* __restrict__ starts,
    const long long* __restrict__ lens, const unsigned char* __restrict__ pv,
    K* __restrict__ wk, int32_t* __restrict__ wt, unsigned char* __restrict__ wv,
    int P, int P2, long long n_local, long long slot, long long total,
    long long row_bytes, StepPlan plan) {
  const int d = blockIdx.y / P2;
  const int k = blockIdx.y % P2;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  const long long c1 = c0 + kChunk < slot ? c0 + kChunk : slot;
  long long cap = 0, off = 0, st = 0, len = 0;
  int s = 0;
  if (k < P) {
    s = (d - k + P) % P;
    cap = plan.caps[k];
    off = plan.offs[k];
    st = starts[s * P + d];
    len = lens[s * P + d];
    len = len < cap ? len : cap;
  }
  const long long row = (static_cast<long long>(d) * P2 + k) * slot;
  const bool rev = (k & 1) != 0;
  const K* src = xs + static_cast<long long>(s) * n_local + st;
  for (long long pos = c0 + threadIdx.x; pos < c1; pos += blockDim.x) {
    const long long at = row + (rev ? slot - 1 - pos : pos);
    wk[at] = pos < len ? src[pos] : key_max<K>();
    wt[at] = static_cast<int32_t>(
        pos < cap ? off + pos + (pos >= len ? total : 0) : 2 * total + pos);
  }
  const long long r1 = c1 < cap ? c1 : cap;
  const long long copied = r1 < len ? r1 : len;
  unsigned char* dst = wv + (static_cast<long long>(d) * total + off) * row_bytes;
  if (c0 < copied)
    block_copy(dst + c0 * row_bytes,
               pv + (static_cast<long long>(s) * n_local + st + c0) * row_bytes,
               (copied - c0) * row_bytes);
  const long long z0 = c0 > len ? c0 : len;
  if (z0 < r1) block_zero(dst + z0 * row_bytes, (r1 - z0) * row_bytes);
}

// Replaces R2's in-kernel payload placement (ring_kernel.py:467-477): out
// row i of destination d is workspace row tags[d][i] where that tag is a
// real position (< total), row 0 otherwise.
// Bound: HBM bytes, each output row written once, each gathered row and
// each tag read once (0.53 ms at the 2^23-record shape, 8 x 1,179,648 rows
// of 92 bytes, on H100 HBM3); no arithmetic to speak of.
// Design: one warp per run of 32 consecutive output rows of one
// destination (blockIdx.y).  The warp loads its 32 tags in one coalesced
// load; the run is one contiguous span of 32 W words of `out`, and lane l
// moves words l, l + 32, ... of it (W steps), taking each word's source
// row from the lane that loaded its tag (`__shfl_sync`), so every store of
// the warp is 32 consecutive words.  A word is 16 bytes where rows and both
// bases allow, else 4 (the 92-byte TeraSort rows), else 1 (odd widths).
// Index arithmetic is 32-bit (the C entry refuses total >= 2^29); byte
// offsets widen only in the multiply that forms each address, and the copy
// loop divides nothing.  (Staging the span in shared memory to store it 16
// bytes at a time was slower on an H100: PERF.md §6.)
template <typename V>
__global__ void __launch_bounds__(kGatherThreads)
    gather_rows_kernel(const V* __restrict__ ws, const int32_t* __restrict__ tags,
                       V* __restrict__ out, int total, long long tag_stride, int W) {
  const int lane = static_cast<int>(threadIdx.x) & (kWarp - 1);
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int i0 = (static_cast<int>(blockIdx.x) * (kGatherThreads / kWarp) + warp) * kWarp;
  if (i0 >= total) return;  // the whole warp
  const int d = static_cast<int>(blockIdx.y);
  const int n = total - i0 < kWarp ? total - i0 : kWarp;  // rows of this run
  const int t = lane < n ? __ldg(tags + d * tag_stride + i0 + lane) : 0;
  const int src = t >= 0 && t < total ? t : 0;
  const V* wsd = ws + static_cast<size_t>(d) * static_cast<unsigned>(total) * W;
  V* span = out + (static_cast<size_t>(d) * static_cast<unsigned>(total) + i0) * W;
  // Word f = lane + 32 m of the span is word w of row r: start at f = lane
  // and step 32 words, i.e. q rows and rem words.
  const int q = kWarp / W, rem = kWarp % W;
  int r = lane / W, w = lane % W;
#pragma unroll 4
  for (int m = 0, f = lane; m < W; ++m, f += kWarp) {
    const int s = __shfl_sync(0xffffffffu, src, r);
    if (r < n) span[f] = __ldg(wsd + static_cast<size_t>(static_cast<unsigned>(s)) * W + w);
    w += rem;
    r += q;
    if (w >= W) {
      w -= W;
      ++r;
    }
  }
}

template <typename K, int V>
int launch_keys(const K* xs, const long long* starts, const long long* lens, K* wk, int P,
                int P2, long long n_local, long long slot, const StepPlan& plan,
                cudaStream_t st) {
  if (slot >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);  // int positions
  // slot, V and kSpan are powers of two, so a slot's chunks are too.
  constexpr long long kSpan = kWarp * kRingItems;
  int cps_log2 = 0, p2_log2 = 0;
  while ((kSpan << cps_log2) < slot / V) ++cps_log2;
  while ((1 << p2_log2) < P2) ++p2_log2;
  constexpr int kWarpsPerBlock = kRingThreads / kWarp;
  const long long chunks = (static_cast<long long>(P) * P2) << cps_log2;
  const long long blocks = (chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ring_exchange_kernel<K, V><<<static_cast<unsigned int>(blocks), kRingThreads, 0, st>>>(
      xs, starts, lens, wk, P, P2, p2_log2, n_local, slot, cps_log2, plan);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int launch_exchange(const void* xs, const void* starts, const void* lens,
                    const void* pv, void* wk, void* wt, void* wv, int P,
                    long long n_local, long long slot, long long row_bytes,
                    const long long* caps, void* stream) {
  if (P < 2 || P > kMaxShards) return static_cast<int>(cudaErrorInvalidValue);
  StepPlan plan;
  long long total = 0;
  for (int k = 0; k < P; ++k) {
    plan.caps[k] = caps[k];
    plan.offs[k] = total;
    total += caps[k];
  }
  int P2 = 1;
  while (P2 < P) P2 <<= 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wt != nullptr) {
    const dim3 grid(static_cast<unsigned int>((slot + kChunk - 1) / kChunk),
                    static_cast<unsigned int>(P * P2));
    ring_exchange_kv_kernel<K><<<grid, kThreads, 0, st>>>(
        static_cast<const K*>(xs), static_cast<const long long*>(starts),
        static_cast<const long long*>(lens),
        static_cast<const unsigned char*>(pv), static_cast<K*>(wk),
        static_cast<int32_t*>(wt), static_cast<unsigned char*>(wv), P, P2,
        n_local, slot, total, row_bytes, plan);
    return static_cast<int>(cudaGetLastError());
  }
  // Keys alone: 16-byte vectors where every slot starts on a 16-byte
  // boundary (slot a multiple of V, the workspace 16-byte aligned).
  constexpr int kVec = 16 / static_cast<int>(sizeof(K));
  const K* x = static_cast<const K*>(xs);
  const long long* s0 = static_cast<const long long*>(starts);
  const long long* l0 = static_cast<const long long*>(lens);
  K* w = static_cast<K*>(wk);
  if (slot % kVec == 0 && (reinterpret_cast<uintptr_t>(wk) & 15) == 0)
    return launch_keys<K, kVec>(x, s0, l0, w, P, P2, n_local, slot, plan, st);
  return launch_keys<K, 1>(x, s0, l0, w, P, P2, n_local, slot, plan, st);
}

template <typename V>
int launch_gather(const void* ws, const void* tags, void* out, long long rows, long long total,
                  long long tag_stride, long long row_bytes, void* stream) {
  constexpr int kRuns = kGatherThreads / kWarp;  // runs of 32 rows a block
  const long long runs = (total + kWarp - 1) / kWarp;
  const dim3 grid(static_cast<unsigned int>((runs + kRuns - 1) / kRuns),
                  static_cast<unsigned int>(rows));
  gather_rows_kernel<V><<<grid, kGatherThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(ws), static_cast<const int32_t*>(tags), static_cast<V*>(out),
      static_cast<int>(total), tag_stride,
      static_cast<int>(row_bytes / static_cast<long long>(sizeof(V))));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Keys alone when `wt` is nullptr (pv and wv are then ignored); `caps` is a
// host array of P step capacities.
int dsort_ring_exchange_i32(const void* xs, const void* starts,
                            const void* lens, const void* pv, void* wk,
                            void* wt, void* wv, int P, long long n_local,
                            long long slot, long long row_bytes,
                            const long long* caps, void* stream) {
  return launch_exchange<int32_t>(xs, starts, lens, pv, wk, wt, wv, P, n_local,
                                  slot, row_bytes, caps, stream);
}

int dsort_ring_exchange_i64(const void* xs, const void* starts,
                            const void* lens, const void* pv, void* wk,
                            void* wt, void* wv, int P, long long n_local,
                            long long slot, long long row_bytes,
                            const long long* caps, void* stream) {
  return launch_exchange<int64_t>(xs, starts, lens, pv, wk, wt, wv, P, n_local,
                                  slot, row_bytes, caps, stream);
}

// Refuses, without launching, total >= 2^29 (the kv tags' int32 limit),
// more than 65,535 destinations and rows of 2^25 bytes or more.
int dsort_gather_rows(const void* ws, const void* tags, void* out,
                      long long rows, long long total, long long tag_stride,
                      long long row_bytes, void* stream) {
  if (rows < 0 || rows > 65535 || total < 0 || total >= (1LL << 29) || row_bytes < 0 ||
      row_bytes >= (1LL << 25))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || total == 0 || row_bytes == 0) return static_cast<int>(cudaSuccess);
  const uintptr_t a = reinterpret_cast<uintptr_t>(ws) |
                      reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(row_bytes);
  if ((a & 15) == 0)
    return launch_gather<uint4>(ws, tags, out, rows, total, tag_stride, row_bytes, stream);
  if ((a & 3) == 0)
    return launch_gather<uint32_t>(ws, tags, out, rows, total, tag_stride, row_bytes, stream);
  return launch_gather<unsigned char>(ws, tags, out, rows, total, tag_stride, row_bytes,
                                      stream);
}

}  // extern "C"
