// bloom_check: k-probe Bloom-filter membership on Hopper (sm_90a).
//
// Replaces the two TPU kernels of src/repro/kernels/bloom_check/kernel.py:
//   bloom_check         one cell's bitset, one modulus for every query;
//   bloom_check_ragged  the fused multi-cell probe of the existence path
//                       (multi_exists), where every query carries its cell's
//                       word base `off` and modulus `nbits` into one packed
//                       buffer of all touched cells' bitsets.
// For each query: idx_i = (h1 + i*h2) mod 2^32 mod nbits, i < k; the query
// may be in the set iff bit (idx_i & 31) of word off + (idx_i >> 5) is set for
// every i.
//
// What bounds it on this card: the launch, then memory latency.  A query reads
// 16 bytes of hashes and gathers at most k = 7 words scattered over a bitset of
// megabytes (256 cells x 8 KiB on the main path); the arithmetic is a few
// integer operations per probe.  The design: one thread per query computes all
// k word indices and issues all k gathers (__ldg, through the read-only data
// cache) before it tests any bit, so a query waits for one round trip after its
// hashes, not k: a test between gathers would make each gather wait for the one
// before.  The k probes go in groups of 8, unrolled, with the probes past k
// predicated off, so every k <= 8 takes one group.  Blocks of 64 threads spread
// the 32768 queries of a main-path batch over 512 blocks, 3-4 a SM on all 132
// SMs (about 248 threads a SM); blocks of 256 left 4 SMs idle.  The TPU kernel
// loaded the whole bitset into VMEM and tested every probe of every query; here
// the 50 MB L2 holds the bitset (2 MiB on the main path, 9x one block's shared
// memory) and only the probed words move.  On an H100 (700 W) the main path's
// batch takes ~6.7 us, of which ~5 us is the time of a launched kernel that
// does no work.
//
// The arithmetic is uint32 throughout, so h1 + i*h2 wraps at 2^32 before the
// modulus exactly as the reference's u32 arithmetic does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kGroup = 8;              // probes whose gathers fly together

__device__ __forceinline__ uint8_t probe(uint32_t h1, uint32_t h2,
                                         uint32_t nbits,
                                         const uint32_t* __restrict__ bits,
                                         int k) {
  for (int i0 = 0; i0 < k; i0 += kGroup) {
    uint32_t idx[kGroup], word[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      idx[u] = (h1 + static_cast<uint32_t>(i0 + u) * h2) % nbits;
      word[u] = i0 + u < k ? __ldg(bits + (idx[u] >> 5)) : ~0u;
    }
    uint32_t all = 1u;
#pragma unroll
    for (int u = 0; u < kGroup; ++u) all &= word[u] >> (idx[u] & 31u);
    if (!(all & 1u)) return 0;
  }
  return 1;
}

__global__ void ragged_kernel(const uint32_t* __restrict__ h1,
                              const uint32_t* __restrict__ h2,
                              const int32_t* __restrict__ off,
                              const uint32_t* __restrict__ nbits,
                              const uint32_t* __restrict__ bits,
                              uint8_t* __restrict__ out, int q, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  out[i] = probe(__ldg(h1 + i), __ldg(h2 + i), __ldg(nbits + i),
                 bits + __ldg(off + i), k);
}

__global__ void flat_kernel(const uint32_t* __restrict__ h1,
                            const uint32_t* __restrict__ h2,
                            const uint32_t* __restrict__ bits,
                            uint8_t* __restrict__ out, uint32_t nbits, int q,
                            int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  out[i] = probe(__ldg(h1 + i), __ldg(h2 + i), nbits, bits, k);
}

inline int blocks_for(int q) { return (q + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h1, h2, nbits, bits: uint32; off: int32; out: q bytes of 0/1 (torch.bool).
int bloom_check_ragged(const void* h1, const void* h2, const void* off,
                       const void* nbits, const void* bits, void* out, int q,
                       int k, void* stream) {
  if (q > 0) {
    ragged_kernel<<<blocks_for(q), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(h1), static_cast<const uint32_t*>(h2),
        static_cast<const int32_t*>(off), static_cast<const uint32_t*>(nbits),
        static_cast<const uint32_t*>(bits), static_cast<uint8_t*>(out), q, k);
  }
  return static_cast<int>(cudaGetLastError());
}

int bloom_check(const void* h1, const void* h2, const void* bits, void* out,
                uint32_t nbits, int q, int k, void* stream) {
  if (q > 0) {
    flat_kernel<<<blocks_for(q), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(h1), static_cast<const uint32_t*>(h2),
        static_cast<const uint32_t*>(bits), static_cast<uint8_t*>(out), nbits,
        q, k);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
