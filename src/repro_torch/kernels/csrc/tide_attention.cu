// tide_attention: decode attention through the KV-WAL slot table on Hopper
// (sm_90a).
//
// Replaces the TPU kernel tide_attention of
// src/repro/kernels/tide_attention/kernel.py.  For one new query token per
// sequence b and every query head h, with kv-head kh = h / G (G = H / KH):
//   out[b, h] = softmax_p(scale * q[b, h] . K[b, p, kh]) @ V[b, p, kh]
// over the live positions p of sequence b: first_live[b] <= p < seq_len[b]
// and, with window > 0, p > seq_len[b] - 1 - window.  Position p lives at
// arena[b, table[b, p / blk], p % blk, kh]; K and V are never gathered into a
// contiguous copy.  Scores, softmax and sums are fp32; the output is cast to
// the element type.  A row with no live position writes 0 (the Pallas kernel
// writes 0 for seq_len == 0 but the mean of some V rows when
// first_live >= seq_len > 0; the JAX oracle the mean of all V rows).
//
// The design.  One CTA of 256 threads per (b, kh) computes all G query heads
// that share the kv-head, so every K/V byte is read from device memory once.
// A loop over the logical blocks j inside the CTA takes the place of the TPU
// kernel's sequential grid axis, and the CTA reads table[b, j] itself in place
// of the scalar prefetch.  Each iteration stages the live rows of one K tile
// and one V tile (blk rows of d elements, rows KH*d elements apart in the
// per-layer arena) into shared memory with coalesced 16-byte loads, computes
// the G x blk scores, and carries the online-softmax state m, l and the fp32
// accumulator (G x dv) in shared memory across blocks.  Blocks with no live
// row are skipped: blocks at or past seq_len, as the TPU kernel skips them,
// and blocks wholly below first_live or outside the window, whose
// contribution the TPU kernel wipes with alpha = exp(-1e30 - m) = 0 as soon as
// a live block follows.  Shared-memory rows are padded to an odd number of
// 16-byte units, so the 8 rows that one 16-byte access phase reads fall in
// different banks.  The table's entries are trusted to be < NB (the engine
// builds them); no bounds check is made on the device.
//
// Shared memory: at blk = 128, d = 128 the two tiles take 2 x 34 KB in bf16
// and 2 x 66 KB in fp32, above the 48 KB a launch gets by default, so the
// host entry raises the kernel's dynamic-shared-memory limit
// (cudaFuncAttributeMaxDynamicSharedMemorySize) before each launch.
//
// What bounds it on this card: device-memory bytes.  A decode step reads
// every live K/V row once, 2 x KH x d x 2 bytes a position in bf16, and does
// 2 x G x (dk + dv) flops on it: 4 flops a byte at G = 4, far below the ~295
// a byte at which the tensor cores would bind.  At Llama-3-8B decode shapes
// (B = 8, KH = 8, d = 128, bf16, mean length 1024) that is ~33.5 MB, ~10 us at
// 3.35 TB/s.  This first version is simple: B x KH = 64 CTAs leave half of
// the 132 SMs idle, a CTA waits for each block's loads before it computes,
// and the products run on the CUDA cores.  Splitting the block axis across
// CTAs (flash-decoding), double-buffering the tiles with cp.async or TMA, and
// wgmma are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Shape {
  int B, H, KH, NB, blk, dk, dv, window;
  float scale;
};

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;                 // elements per 16 bytes
  __device__ static float to_f32(float x) { return x; }
  __device__ static float from_f32(float x) { return x; }
  // acc + q[0..4) . (the four floats in x)
  __device__ static float dot(const float* q, uint4 x, float acc) {
    acc = fmaf(q[0], __uint_as_float(x.x), acc);
    acc = fmaf(q[1], __uint_as_float(x.y), acc);
    acc = fmaf(q[2], __uint_as_float(x.z), acc);
    return fmaf(q[3], __uint_as_float(x.w), acc);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ static __nv_bfloat16 from_f32(float x) {
    return __float2bfloat16(x);                  // round to nearest even
  }
  // A bf16 value is the upper half of the fp32 with the same bits, and the
  // lower-addressed element of each 32-bit word is its lower half.
  __device__ static float dot(const float* q, uint4 x, float acc) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc = fmaf(q[2 * i], __uint_as_float(w[i] << 16), acc);
      acc = fmaf(q[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u), acc);
    }
    return acc;
  }
};

// A shared-memory row of d elements, padded to an odd number of 16-byte units.
__host__ __device__ inline int padded_row(int d, int elem_bytes) {
  return ((d * elem_bytes / 16) | 1) * 16 / elem_bytes;
}

template <typename T>
size_t shared_bytes(int G, const Shape& s) {
  return sizeof(T) * (size_t)s.blk *
             (padded_row(s.dk, sizeof(T)) + padded_row(s.dv, sizeof(T))) +
         sizeof(float) * ((size_t)G * (s.dk + s.blk + s.dv) + 3 * (size_t)G);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// Stage rows [r0, r1) of one tile: row r from src + r * src_stride elements
// into dst + r * row elements, 16 bytes a thread, neighbouring threads on
// neighbouring addresses.
template <typename T>
__device__ __forceinline__ void stage(T* dst, int row, const T* src,
                                      size_t src_stride, int d, int r0,
                                      int r1) {
  constexpr int V = Elem<T>::kVec;
  const int per_row = d / V;
  const int n = (r1 - r0) * per_row;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = r0 + i / per_row, c = i % per_row;
    const uint4 x =
        __ldg(reinterpret_cast<const uint4*>(src + r * src_stride) + c);
    *reinterpret_cast<uint4*>(dst + r * row + c * V) = x;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tide_kernel(const T* __restrict__ q, const T* __restrict__ arena_k,
                const T* __restrict__ arena_v,
                const int32_t* __restrict__ table,
                const int32_t* __restrict__ seq_lens,
                const int32_t* __restrict__ first_live, T* __restrict__ out,
                Shape s) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int G = s.H / s.KH;
  const int row_k = padded_row(s.dk, sizeof(T));
  const int row_v = padded_row(s.dv, sizeof(T));
  T* k_tile = reinterpret_cast<T*>(smem);
  T* v_tile = k_tile + (size_t)s.blk * row_k;
  float* q_s = reinterpret_cast<float*>(v_tile + (size_t)s.blk * row_v);
  float* p_s = q_s + G * s.dk;                   // scores, then weights
  float* acc = p_s + G * s.blk;
  float* m_s = acc + G * s.dv;
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;

  // Live positions [lo, hi) of this sequence.
  const int seq_len = seq_lens[b];
  int lo = max(first_live[b], 0);
  if (s.window > 0) lo = max(lo, seq_len - s.window);
  const int hi = min(seq_len, s.NB * s.blk);
  T* o = out + ((size_t)b * s.H + (size_t)kh * G) * s.dv;
  if (lo >= hi) {
    for (int i = tid; i < G * s.dv; i += kThreads) o[i] = E::from_f32(0.f);
    return;
  }

  const T* qb = q + ((size_t)b * s.H + (size_t)kh * G) * s.dk;
  for (int i = tid; i < G * s.dk; i += kThreads) q_s[i] = E::to_f32(qb[i]);
  for (int i = tid; i < G * s.dv; i += kThreads) acc[i] = 0.f;
  const float neg_inf = -__int_as_float(0x7f800000);
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = neg_inf;
    l_s[g] = 0.f;
  }

  const int warp = tid / 32, lane = tid % 32;
  for (int j = lo / s.blk; j <= (hi - 1) / s.blk; ++j) {
    const int phys = table[(size_t)b * s.NB + j];
    const int start = j * s.blk;
    const int r0 = max(lo - start, 0), r1 = min(hi - start, s.blk);
    // Row 0 of head kh in physical block phys of sequence b.
    const size_t row0 = (((size_t)b * s.NB + phys) * s.blk) * s.KH + kh;
    stage(k_tile, row_k, arena_k + row0 * s.dk, (size_t)s.KH * s.dk, s.dk,
          r0, r1);
    stage(v_tile, row_v, arena_v + row0 * s.dv, (size_t)s.KH * s.dv, s.dv,
          r0, r1);
    __syncthreads();  // tiles staged; q_s, m_s, l_s, acc set before block 0

    for (int i = tid; i < G * s.blk; i += kThreads) {
      const int g = i / s.blk, r = i % s.blk;
      float sc = neg_inf;
      if (r >= r0 && r < r1) {
        const T* kr = k_tile + r * row_k;
        const float* qg = q_s + g * s.dk;
        float dot = 0.f;
        for (int c = 0; c < s.dk; c += V)
          dot = E::dot(qg + c, *reinterpret_cast<const uint4*>(kr + c), dot);
        sc = dot * s.scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pg = p_s + g * s.blk;
      float mx = neg_inf;
      for (int r = r0 + lane; r < r1; r += 32) mx = fmaxf(mx, pg[r]);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(mx));  // finite: r0 < r1
      float sum = 0.f;
      for (int r = r0 + lane; r < r1; r += 32) {
        const float p = expf(pg[r] - m_new);
        pg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first block
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * s.dv; i += kThreads) {
      const int g = i / s.dv, d = i % s.dv;
      const float* pg = p_s + g * s.blk;
      float a = acc[i] * alpha_s[g];
      for (int r = r0; r < r1; ++r)
        a = fmaf(pg[r], E::to_f32(v_tile[r * row_v + d]), a);
      acc[i] = a;
    }
    __syncthreads();  // before the next block overwrites tiles and weights
  }

  for (int i = tid; i < G * s.dv; i += kThreads)
    o[i] = E::from_f32(acc[i] / l_s[i / s.dv]);
}

template <typename T>
int launch(const void* q, const void* arena_k, const void* arena_v,
           const void* table, const void* seq_lens, const void* first_live,
           void* out, int B, int H, int KH, int NB, int blk, int dk, int dv,
           int window, float scale, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || dk % Elem<T>::kVec != 0 ||
      dv % Elem<T>::kVec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, H, KH, NB, blk, dk, dv, window, scale};
  const size_t smem = shared_bytes<T>(H / KH, s);
  cudaError_t err = cudaFuncSetAttribute(
      tide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tide_kernel<T><<<dim3(KH, B), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(arena_k),
      static_cast<const T*>(arena_v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(seq_lens),
      static_cast<const int32_t*>(first_live), static_cast<T*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B,H,dk), arena_k (B,NB,blk,KH,dk), arena_v (B,NB,blk,KH,dv), out
// (B,H,dv): contiguous, 16-byte aligned; table (B,NB), seq_lens and
// first_live (B,): int32.
int tide_attention_bf16(const void* q, const void* arena_k,
                        const void* arena_v, const void* table,
                        const void* seq_lens, const void* first_live,
                        void* out, int B, int H, int KH, int NB, int blk,
                        int dk, int dv, int window, float scale,
                        void* stream) {
  return launch<__nv_bfloat16>(q, arena_k, arena_v, table, seq_lens,
                               first_live, out, B, H, KH, NB, blk, dk, dv,
                               window, scale, stream);
}

int tide_attention_f32(const void* q, const void* arena_k, const void* arena_v,
                       const void* table, const void* seq_lens,
                       const void* first_live, void* out, int B, int H,
                       int KH, int NB, int blk, int dk, int dv, int window,
                       float scale, void* stream) {
  return launch<float>(q, arena_k, arena_v, table, seq_lens, first_live, out,
                       B, H, KH, NB, blk, dk, dv, window, scale, stream);
}

}  // extern "C"
