// ssd_scan: the fused Mamba-2 SSD chunk scan (arXiv:2405.21060) on Hopper
// (sm_90a).
//
// Replaces the TPU kernel ssd_scan_pallas of
// src/repro/kernels/ssd_scan/kernel.py.  Inputs x (b,l,h,p) and Bm, Cm
// (b,l,n) in bf16 or fp32 (one group: B and C are shared by every head), dt
// (b,l,h) and A (h,) in fp32, and an optional fp32 initial state (b,h,p,n);
// l is a multiple of the chunk c (the wrapper pads with dt = 0, which leaves
// the state unchanged).  For each (sequence, head) the chunks are walked in
// order, and for chunk rows i, j with cs = cumsum over the chunk of dt * A:
//   y[i]   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//          + exp(cs_i) C_i . state^T
//   state' = exp(cs_last) state + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j
// y is written in x's type, the final state in fp32.  Every product runs in
// fp32 on inputs upcast first, as the TPU kernel does; exp(cs_i - cs_j) is
// formed from the difference, never as exp(cs_i) * exp(-cs_j), which
// overflows.
//
// The design.  One CTA of 256 threads per (sequence, block of hb heads),
// hb = 4 at Mamba-2-1.3B widths; a loop over the chunks inside the CTA takes
// the place of the TPU kernel's sequential grid axis.  The TPU kernel holds a
// chunk's (hb,c,c) decay mask and (c,c) C.B^T in VMEM; at c = 256 each is
// 256 KB in fp32, more than the 227 KB of shared memory an SM has.  So the
// chunk is cut into row tiles of 64: for each row tile the CTA forms the
// 64 x c slice of G = C.B^T once (64 KB) and shares it across its hb heads,
// and each head's decay factors are formed from the c-long cumsum as its
// tile of G is staged.  The carried state lives in the final-state output
// itself (device memory, read back through L2), since hb heads of p x n fp32
// (128 KB at hb = 4) do not fit beside G.  Every product (G, the within-chunk
// term, the cross-chunk term, the state update) is one routine: a 64 x 64
// output tile, 4 x 4 outputs a thread in registers, its operands staged 32
// deep through shared memory by loaders that upcast and scale as they load.
//
// What bounds it on this card: operations.  The function needs the causal
// half of each chunk's c x c square, P = c(c+1)/2 pairs: per (sequence,
// chunk, head) 2Pp + 4cnp fp32 flops (every operand but x is fp32: decays,
// state), and per (sequence, chunk) 2Pn for C.B^T, which bf16 tensor cores
// compute exactly.  At b = 8, l = 2048 that is 51.6 GFLOP of fp32 work,
// 0.77 ms at the 67 TFLOP/s of the fp32 CUDA cores, against 0.09 ms of
// memory time for 298 MB of inputs and outputs.  This first version is simple: products on the
// CUDA cores in fp32, no overlap of staging and compute, and b x h / hb CTAs
// (128 at b = 8, only 16 for one long prompt).  wgmma on bf16 or tf32
// tiles, TMA and splitting a long sequence across CTAs are later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;         // output tile: kTile x kTile, 4 x 4 a thread
constexpr int kK = 32;            // depth of one staged slice
constexpr int kLd = kTile + 4;    // staged row stride in floats, 16-byte rows
constexpr size_t kMaxShared = 232448;

__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);                    // round to nearest even
}

// Operand loaders.  A loader gives element (m, k) of an operand, m the
// tile-local index of the output row (A) or column (B), k the absolute index
// of the contracted dimension; kFast says whether k is the contiguous one in
// memory, which picks the thread order of the staging loop.

// Row first + m of a (count x stride) matrix, element k, times
// exp(cs[first + m]) when cs is given; 0 past the last row.
template <typename T>
struct Rows {
  static constexpr bool kFast = true;
  const T* ptr;
  int stride, count, first;
  const float* cs;
  __device__ float operator()(int m, int k) const {
    const int r = first + m;
    if (r >= count) return 0.f;
    const float v = f32(ptr[(size_t)r * stride + k]);
    return cs ? v * expf(cs[r]) : v;
  }
};

// Element first + m of row k of a matrix with rows stride apart, times w[k]
// when w is given; 0 past column count.
template <typename T>
struct Cols {
  static constexpr bool kFast = false;
  const T* ptr;
  int stride, count, first;
  const float* w;
  __device__ float operator()(int m, int k) const {
    const int c = first + m;
    if (c >= count) return 0.f;
    const float v = f32(ptr[(size_t)k * stride + c]);
    return w ? v * w[k] : v;
  }
};

// The within-chunk weights of one head: G[i, j] exp(cs_i - cs_j) dt_j for
// j <= i < c, 0 elsewhere; G's row tile is in shared memory.
struct Weights {
  static constexpr bool kFast = true;
  const float* g;                               // row m of the tile, ldg apart
  const float* cs;
  const float* dt;
  int ldg, i0, c;
  __device__ float operator()(int m, int j) const {
    const int i = i0 + m;
    if (i >= c || j > i) return 0.f;
    return g[m * ldg + j] * expf(cs[i] - cs[j]) * dt[j];
  }
};

// S[kk][mm] = ld(mm, k0 + kk), zeros past K.
template <class L>
__device__ __forceinline__ void stage(float* S, const L& ld, int k0, int K) {
  for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
    int kk, mm;
    if (L::kFast) {
      kk = e % kK;
      mm = e / kK;
    } else {
      mm = e % kTile;
      kk = e / kTile;
    }
    const int k = k0 + kk;
    S[kk * kLd + mm] = k < K ? ld(mm, k) : 0.f;
  }
}

// acc += A (64 x K) . B (K x 64): thread (tx, ty) holds rows 4ty..4ty+3 and
// columns 4tx..4tx+3 of the tile.  Every thread of the CTA calls it.
template <class LA, class LB>
__device__ void gemm_tile(float (&acc)[4][4], const LA& la, const LB& lb,
                          int K, float* As, float* Bs) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < K; k0 += kK) {
    stage(As, la, k0, K);
    stage(Bs, lb, k0, K);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a =
          *reinterpret_cast<const float4*>(As + kk * kLd + ty * 4);
      const float4 b =
          *reinterpret_cast<const float4*>(Bs + kk * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // before the next slice overwrites the staged tiles
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

struct Shape {
  int b, l, h, p, n, c, hb;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ Bm,
               const T* __restrict__ Cm, const float* __restrict__ init,
               T* __restrict__ y, float* __restrict__ state, Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int cpad = (s.c + kTile - 1) / kTile * kTile;
  float* As = smem;
  float* Bs = As + kK * kLd;
  float* G = Bs + kK * kLd;                      // kTile x cpad
  float* dt_s = G + kTile * cpad;                // hb x cpad each
  float* cs_s = dt_s + s.hb * cpad;
  float* w_s = cs_s + s.hb * cpad;               // exp(cs_last - cs_j) dt_j

  const int h0 = blockIdx.x * s.hb, bi = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = tid % 16, ty = tid / 16;
  const size_t pn = (size_t)s.p * s.n;
  float* st0 = state + ((size_t)bi * s.h + h0) * pn;

  // The carried state starts as the initial state or zeros.
  const float* in0 = init ? init + ((size_t)bi * s.h + h0) * pn : nullptr;
  for (size_t e = tid; e < s.hb * pn; e += kThreads)
    st0[e] = in0 ? in0[e] : 0.f;
  __syncthreads();

  const int n_chunks = s.l / s.c;
  const size_t hp = (size_t)s.h * s.p;
  for (int z = 0; z < n_chunks; ++z) {
    const size_t row0 = (size_t)bi * s.l + (size_t)z * s.c;
    const T* xz = x + row0 * hp;
    const T* Bz = Bm + row0 * s.n;
    const T* Cz = Cm + row0 * s.n;
    T* yz = y + row0 * hp;

    // dt and the inclusive cumsum of dt * A of each head (one warp a head;
    // each lane scans cpad / 32 consecutive rows, then the lanes' totals).
    for (int hh = warp; hh < s.hb; hh += kWarps) {
      const float a = A[h0 + hh];
      const int per = cpad / 32, r0 = lane * per;
      float run = 0.f;
      for (int r = r0; r < r0 + per; ++r) {
        const float d = r < s.c ? dt[(row0 + r) * s.h + h0 + hh] : 0.f;
        dt_s[hh * cpad + r] = d;
        run += d * a;
        cs_s[hh * cpad + r] = run;
      }
      float before = run;                        // inclusive scan of totals
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(~0u, before, o);
        if (lane >= o) before += v;
      }
      before -= run;
      for (int r = r0; r < r0 + per; ++r) cs_s[hh * cpad + r] += before;
      __syncwarp();
      const float last = cs_s[hh * cpad + s.c - 1];
      for (int r = r0; r < r0 + per; ++r)
        w_s[hh * cpad + r] =
            r < s.c ? expf(last - cs_s[hh * cpad + r]) * dt_s[hh * cpad + r]
                    : 0.f;
    }
    __syncthreads();

    float acc[4][4];
    for (int i0 = 0; i0 < s.c; i0 += kTile) {
      const int jmax = min(s.c, i0 + kTile);    // columns j <= i of the tile
      // G rows i0.., columns 0..jmax: C . B^T, shared by the hb heads.
      for (int j0 = 0; j0 < jmax; j0 += kTile) {
        zero(acc);
        gemm_tile(acc, Rows<T>{Cz, s.n, s.c, i0, nullptr},
                  Rows<T>{Bz, s.n, jmax, j0, nullptr}, s.n, As, Bs);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            G[(ty * 4 + a) * cpad + j0 + tx * 4 + b] = acc[a][b];
      }
      __syncthreads();

      for (int hh = 0; hh < s.hb; ++hh) {
        const float* cs = cs_s + hh * cpad;
        const float* st = st0 + hh * pn;
        for (int p0 = 0; p0 < s.p; p0 += kTile) {
          zero(acc);
          gemm_tile(acc, Weights{G, cs, dt_s + hh * cpad, cpad, i0, s.c},
                    Cols<T>{xz + (size_t)(h0 + hh) * s.p, (int)hp, s.p, p0,
                            nullptr},
                    jmax, As, Bs);
          // Cross-chunk term from the state carried into this chunk.
          gemm_tile(acc, Rows<T>{Cz, s.n, s.c, i0, cs},
                    Rows<float>{st, s.n, s.p, p0, nullptr}, s.n, As, Bs);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + ty * 4 + a;
            if (i >= s.c) continue;
            T* yr = yz + (size_t)i * hp + (size_t)(h0 + hh) * s.p;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int pp = p0 + tx * 4 + b;
              if (pp < s.p) yr[pp] = from_f32<T>(acc[a][b]);
            }
          }
        }
      }
      __syncthreads();  // before the next row tile overwrites G
    }

    // State update, once every row of the chunk has read the old state.
    for (int hh = 0; hh < s.hb; ++hh) {
      const float decay = expf(cs_s[hh * cpad + s.c - 1]);
      float* st = st0 + hh * pn;
      for (int p0 = 0; p0 < s.p; p0 += kTile)
        for (int n0 = 0; n0 < s.n; n0 += kTile) {
          zero(acc);
          gemm_tile(acc,
                    Cols<T>{xz + (size_t)(h0 + hh) * s.p, (int)hp, s.p, p0,
                            w_s + hh * cpad},
                    Cols<T>{Bz, s.n, s.n, n0, nullptr}, s.c, As, Bs);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int pp = p0 + ty * 4 + a;
            if (pp >= s.p) continue;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int nn = n0 + tx * 4 + b;
              if (nn < s.n) {
                float* e = st + (size_t)pp * s.n + nn;
                *e = fmaf(decay, *e, acc[a][b]);
              }
            }
          }
        }
    }
    __syncthreads();  // the new state is visible before the next chunk
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* state, int b,
           int l, int h, int p, int n, int c, int hb, void* stream) {
  if (b <= 0 || l <= 0 || h <= 0 || p <= 0 || n <= 0 || c <= 0 || l % c ||
      hb <= 0 || hb > kWarps || h % hb)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t cpad = (c + kTile - 1) / kTile * kTile;
  const size_t smem =
      sizeof(float) * (2 * kK * kLd + kTile * cpad + 3 * (size_t)hb * cpad);
  if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s{b, l, h, p, n, c, hb};
  ssd_kernel<T><<<dim3(h / hb, b), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(state), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y (b,l,h,p) and Bm, Cm (b,l,n) in the entry's type; dt (b,l,h), A (h,),
// init (b,h,p,n) or null, state (b,h,p,n): fp32.  All contiguous; l a
// multiple of c; hb <= 8 divides h.
int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* init, void* y,
                  void* state, int b, int l, int h, int p, int n, int c,
                  int hb, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, state, b, l, h, p,
                               n, c, hb, stream);
}

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* init, void* y, void* state, int b,
                 int l, int h, int p, int n, int c, int hb, void* stream) {
  return launch<float>(x, dt, A, Bm, Cm, init, y, state, b, l, h, p, n, c,
                       hb, stream);
}

}  // extern "C"
