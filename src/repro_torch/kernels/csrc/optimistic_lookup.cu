// optimistic_lookup: the paper's section 4.2 interpolation search on Hopper
// (sm_90a).
//
// Replaces the TPU kernel optimistic_lookup in
// src/repro/kernels/optimistic_lookup/kernel.py.  For each query key over a
// sorted uint32 key array of N entries:
//   est   = int(f32(key) * 2^-32 * N)            (float32, in this order)
//   start = clamp(est - window/2, 0, max(N - window, 0))
//   up to max_iters rounds: the window keys[start, start + window) holds the
//   key iff (start == 0 || w[0] <= key) && (start + window >= N ||
//   key <= w[window-1]); then idx = start + #(w < key) and found =
//   #(w == key) > 0; else the window moves by +-window.
// Two entries:
//   optimistic_lookup          idx (-1 when the budget ran out), found, and
//                              the rounds used, as the TPU kernel;
//   optimistic_lookup_resolve  idx and found with the unresolved queries
//                              resolved here, by a lower bound over the whole
//                              array: what the host's searchsorted fallback
//                              gave, in the same launch, with no host sync.
//
// What bounds it on this card: the launch, then memory latency.  The key array
// (4 MB on the main path) sits in L2, and a query needs a few dependent loads;
// reading the window 32 keys at a time took ceil(W/32) = 25 round trips a round
// at W = 800.  The design: one warp per query runs a 32-way search.  Lane j
// reads the pivot w[j (W-1) / 31], so lane 0 holds w[0] and lane 31 holds
// w[W-1]: the same load gives the window's bound test.  The pivots are sorted,
// so __ballot_sync(pivot < key) is a prefix of c lanes, and the first entry >=
// key lies between pivots c-1 and c: a segment of at most ceil((W-1)/31) - 1
// keys strictly between them, which one more warp load reads (up to W = 1024; a
// longer segment takes another pivot step first).  Since the window is sorted,
// #(w < key) is that lower bound, so idx, found and the rounds used are the
// reference's bit for bit, runs of equal keys included.  A round costs 2 round
// trips instead of ~27, and the resolve entry's search over the whole array
// ceil(log32 N) + 1.  On an H100 (700 W) at Q = 8192, N = 2^20, W = 800 the raw
// entry takes ~9.5 us, of which ~5 us is the time of a launched kernel that
// does no work; the 32 pivots still touch ~25 of the window's 128-byte lines,
// as the old loop did, in one load instead of 25.  Found is "some key the warp
// read equals the query": if the window holds the key, the entry at the lower
// bound does, and the warp reads it as a pivot or in the last segment.
//
// The estimate keeps the reference's float32 order (__uint2float_rn, then two
// __fmul_rn), so windows and the rounds used match it bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clamp_start(int s, int max_start) {
  return s < 0 ? 0 : (s > max_start ? max_start : s);
}

// The j-th of 32 pivots over [lo, lo + len): lo + floor(j (len - 1) / 31).
__device__ __forceinline__ int pivot_pos(int lo, int len, int j) {
  return lo + static_cast<int>(static_cast<unsigned long long>(j) *
                               static_cast<unsigned>(len - 1) / 31u);
}

// One 32-way step over [lo, hi), hi > lo, where the first entry >= key lies
// in [lo, hi]: narrows [lo, hi] to the entries strictly between the last
// pivot below the key and the first one at or above it.  `found` gains any
// pivot equal to the key.  Returns the pivot this lane read.
__device__ __forceinline__ uint32_t pivot_step(
    const uint32_t* __restrict__ keys, uint32_t key, int lane, int& lo,
    int& hi, bool& found) {
  const int len = hi - lo;
  const uint32_t v = __ldg(keys + pivot_pos(lo, len, lane));
  const int c = __popc(__ballot_sync(kFull, v < key));
  found |= __ballot_sync(kFull, v == key) != 0;
  const int new_lo = c == 0 ? lo : pivot_pos(lo, len, c - 1) + 1;
  if (c < 32) hi = pivot_pos(lo, len, c);
  lo = new_lo;
  return v;
}

// The first entry >= key, given that it lies in [lo, hi]: pivot steps until
// at most 32 entries are left, then one load of those.
__device__ __forceinline__ int lower_bound(const uint32_t* __restrict__ keys,
                                           uint32_t key, int lane, int lo,
                                           int hi, bool& found) {
  while (hi - lo > 32) pivot_step(keys, key, lane, lo, hi, found);
  if (hi > lo) {
    const bool valid = lane < hi - lo;
    const uint32_t v = valid ? __ldg(keys + lo + lane) : 0u;
    lo += __popc(__ballot_sync(kFull, valid && v < key));
    found |= __ballot_sync(kFull, valid && v == key) != 0;
  }
  return lo;
}

template <bool kResolve>
__global__ void lookup_kernel(const uint32_t* __restrict__ queries,
                              const uint32_t* __restrict__ keys,
                              int32_t* __restrict__ idx_out,
                              uint8_t* __restrict__ found_out,
                              int32_t* __restrict__ iters_out, int q, int n,
                              int window, int max_iters) {
  const int qi = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= q) return;                 // uniform across the warp
  const uint32_t key = __ldg(queries + qi);
  const float est_f = __fmul_rn(__fmul_rn(__uint2float_rn(key), 0x1p-32f),
                                static_cast<float>(n));
  const int est = __float2int_rz(est_f);
  const int max_start = n - window > 0 ? n - window : 0;
  int start = clamp_start(est - window / 2, max_start);
  bool done = false, found = false;
  int idx = -1, used = 0;
  for (int it = 0; it < max_iters && !done; ++it) {
    ++used;
    int lo = start, hi = start + window;
    bool hit = false;
    const uint32_t v = pivot_step(keys, key, lane, lo, hi, hit);
    const bool lo_ok = start == 0 || __shfl_sync(kFull, v, 0) <= key;
    const bool hi_ok =
        start + window >= n || key <= __shfl_sync(kFull, v, 31);
    if (lo_ok && hi_ok) {
      idx = lower_bound(keys, key, lane, lo, hi, hit);
      found = hit;
      done = true;
    } else {
      start = clamp_start(lo_ok ? start + window : start - window, max_start);
    }
  }
  if (kResolve && !done) {
    found = false;
    idx = lower_bound(keys, key, lane, 0, n, found);
  }
  if (lane == 0) {
    idx_out[qi] = idx;
    found_out[qi] = found;
    if (!kResolve) iters_out[qi] = used;
  }
}

template <bool kResolve>
int launch(const void* queries, const void* keys, void* idx, void* found,
           void* iters, int q, int n, int window, int max_iters,
           void* stream) {
  if (q > 0) {
    const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lookup_kernel<kResolve><<<blocks, kWarpsPerBlock * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(queries),
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(idx),
        static_cast<uint8_t*>(found), static_cast<int32_t*>(iters), q, n,
        window, max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// queries (q,), keys (n,) uint32, keys sorted ascending; 1 <= window <= n.
// idx, iters: int32 (q,); found: q bytes of 0/1 (torch.bool).
int optimistic_lookup(const void* queries, const void* keys, void* idx,
                      void* found, void* iters, int q, int n, int window,
                      int max_iters, void* stream) {
  return launch<false>(queries, keys, idx, found, iters, q, n, window,
                       max_iters, stream);
}

// The same, with no iters and no unresolved query: idx is the lower bound
// over the whole array where the rounds ran out.
int optimistic_lookup_resolve(const void* queries, const void* keys,
                              void* idx, void* found, int q, int n,
                              int window, int max_iters, void* stream) {
  return launch<true>(queries, keys, idx, found, nullptr, q, n, window,
                      max_iters, stream);
}

}  // extern "C"
