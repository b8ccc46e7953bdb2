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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 128;
constexpr int kThreads = 256;
constexpr long long kChunk = 2048;  // slot positions per block
constexpr int kWarp = 32;
constexpr int kGatherThreads = 256;  // 8 warps, 8 runs of 32 rows

struct StepPlan {
  long long caps[kMaxShards];
  long long offs[kMaxShards];
};

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

// Replaces the P-1 async remote copies of R1 `_fused_ring_kernel`
// (ring_kernel.py:280, KV=false) and R2 `_fused_ring_kv_kernel`
// (ring_kernel.py:356, KV=true).  Block (chunk, d * P2 + k) fills positions
// [chunk * kChunk, +kChunk) of slot k of destination d (layout above).
// Bound: HBM bytes — each bucket key (and payload row) read once, each slot
// key (tag, payload row) written once; no arithmetic to speak of.
// Design: one launch for every (destination, step) slot of the whole
// virtual mesh; consecutive threads take consecutive positions, so key and
// tag loads and stores are coalesced (reversed slots store descending
// addresses, still one segment per warp); the payload rows of a chunk are
// one contiguous byte range on both sides, copied with the widest vector
// the two addresses allow (92-byte TeraSort rows are 4-byte aligned only,
// so a byte head and tail close the gap).
template <typename K, bool KV>
__global__ void ring_exchange_kernel(
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
    if constexpr (KV)
      wt[at] = static_cast<int32_t>(
          pos < cap ? off + pos + (pos >= len ? total : 0) : 2 * total + pos);
  }
  if constexpr (KV) {
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
  const dim3 grid(static_cast<unsigned int>((slot + kChunk - 1) / kChunk),
                  static_cast<unsigned int>(P * P2));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wt != nullptr)
    ring_exchange_kernel<K, true><<<grid, kThreads, 0, st>>>(
        static_cast<const K*>(xs), static_cast<const long long*>(starts),
        static_cast<const long long*>(lens),
        static_cast<const unsigned char*>(pv), static_cast<K*>(wk),
        static_cast<int32_t*>(wt), static_cast<unsigned char*>(wv), P, P2,
        n_local, slot, total, row_bytes, plan);
  else
    ring_exchange_kernel<K, false><<<grid, kThreads, 0, st>>>(
        static_cast<const K*>(xs), static_cast<const long long*>(starts),
        static_cast<const long long*>(lens), nullptr, static_cast<K*>(wk),
        nullptr, nullptr, P, P2, n_local, slot, total, 0, plan);
  return static_cast<int>(cudaGetLastError());
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
