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
// Outputs idx (-1 when the budget ran out), found, and the rounds used.
//
// What bounds it on this card: memory latency and bytes.  A query reads one
// window of 800 keys (3.2 KB) per round, usually one round, from a key array
// of megabytes, and does one compare per key.  The design: one warp per
// query; the warp reads its window 32 consecutive keys at a time, so every
// load is one coalesced 128-byte transaction, and counts the keys below and
// equal to the query with __ballot_sync and __popc, with no shared memory and
// no reduction tree.  The window bound test reads only w[0] and w[window-1]
// (every lane the same address, one transaction), and the compare pass runs
// only in the round whose window holds the key; the reference computes the
// rank in every round and keeps the first one inside, which is the same
// answer.  The TPU kernel staged each window into VMEM one grid step at a
// time; here 8 queries share a block and the card keeps many blocks in
// flight.
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
  int found_idx = 0, used = 0;
  for (int it = 0; it < max_iters && !done; ++it) {
    ++used;
    const bool lo_ok = start == 0 || __ldg(keys + start) <= key;
    const bool hi_ok =
        start + window >= n || key <= __ldg(keys + start + window - 1);
    if (lo_ok && hi_ok) {
      int below = 0, equal = 0;
      for (int base = 0; base < window; base += 32) {
        const int j = base + lane;
        const bool valid = j < window;
        const uint32_t w = valid ? __ldg(keys + start + j) : 0u;
        below += __popc(__ballot_sync(kFull, valid && w < key));
        equal += __popc(__ballot_sync(kFull, valid && w == key));
      }
      found_idx = start + below;
      found = equal > 0;
      done = true;
    } else {
      start = clamp_start(lo_ok ? start + window : start - window, max_start);
    }
  }
  if (lane == 0) {
    idx_out[qi] = done ? found_idx : -1;
    found_out[qi] = found && done;
    iters_out[qi] = used;
  }
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
  if (q > 0) {
    const int blocks = (q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    lookup_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(queries),
        static_cast<const uint32_t*>(keys), static_cast<int32_t*>(idx),
        static_cast<uint8_t*>(found), static_cast<int32_t*>(iters), q, n,
        window, max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
