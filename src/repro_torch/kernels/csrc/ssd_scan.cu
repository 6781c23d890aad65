// ssd_scan: the fused Mamba-2 SSD chunk scan (arXiv:2405.21060) on Hopper
// (sm_90a), as three chunk-parallel passes on bf16 tensor cores.
//
// Replaces the TPU kernel ssd_scan_pallas of
// src/repro/kernels/ssd_scan/kernel.py.  Inputs x (b,l,h,p) and Bm, Cm
// (b,l,n) in bf16 or fp32 (one group: B and C are shared by every head), dt
// (b,l,h) and A (h,) in fp32, and an optional fp32 initial state (b,h,p,n);
// l is a multiple of the chunk c (the wrapper pads with dt = 0, which leaves
// the state unchanged).  For chunk z of a sequence and head, with cs the
// cumulative sum of dt * A over the chunk's rows:
//   y[i]   = sum_{j<=i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//          + exp(cs_i) C_i . state_z^T
//   state_{z+1} = exp(cs_last) state_z
//               + sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j
// y is written in x's type, the final state in fp32.  Every decay is formed
// from a difference, exp(cs_i - cs_j), never as exp(cs_i) * exp(-cs_j),
// which overflows.
//
// What bounds it on this card.  The function moves 298 MB at the Mamba-2
// prefill of 8 x 2048 (x and y dominate, 134 MB each in bf16), 0.089 ms at
// 3.35 TB/s, and needs ~52 GFLOP (the causal half of each chunk's c x c
// square, the cross-chunk term and the state update): 0.053 ms on bf16
// tensor cores, but 0.77 ms on the fp32 CUDA cores.  So the products must run
// on tensor cores, and the TPU kernel's grid must not be carried over: it
// walks the chunks of a (sequence, head block) in order, which on this card
// left 128 CTAs at 8 x 2048 and 16 on 132 SMs for one 16384-token prompt.
//
// The design: three passes whose grids cover (sequence, chunk, head), so a
// long prompt fills the card as a batch does.
// 1. Chunk states (ssd_states_kernel, grid (blocks of p x n, h, b * nc)):
//    S_z = sum_j exp(cs_last - cs_j) dt_j x_j (x) B_j for every chunk at
//    once, into fp32 scratch (b, nc, h, p, n) the wrapper allocates, and
//    cs_last into (b, nc, h).  The chunk's rows stream through a ring of
//    cp.async stages (every copy of a stage issued before any wait); the
//    weights exp(cs_last - cs_j) dt_j are formed once a chunk in shared
//    memory, and x is scaled by them and split into the parts below in the
//    registers of its mma fragments.
// 2. State passing (ssd_pass_kernel, grid (p n / 512, h, b)): a short walk
//    over the chunks of each (sequence, head), 4 state elements a thread:
//    prev_z = carry, carry = exp(cs_last_z) carry + S_z, from the initial
//    state or zeros.  prev_z is written as the parts below; the last carry
//    is the final state.
// 3. Chunk output: y_i = exp(cs_i) C_i . prev^T (the cross-chunk term,
//    first), then, a 16-column block of j at a time, G = C . B^T into the
//    mma's accumulator registers and W = G exp(cs_i - cs_j) dt_j (masked
//    j <= i, only on the diagonal block) in those registers, which the
//    m16n8k16 layout hands on as the A fragments of W . x without a trip
//    through shared memory.  Each decay is one ex2 on the special-function
//    unit (the accurate exp2f took a quarter of the pass).  At the Mamba-2
//    shape (p = 64, n = 128, c = 256, bf16, h a multiple of 8) one CTA takes
//    a whole chunk and a block of 8 heads (ssd_chunk_output_kernel, grid
//    (h / 8, b * nc), 8 warps): B stays in shared memory, C in registers,
//    and each head's x and starting state stream in once, double-buffered.
//    Any other shape takes row tiles of 64 rows, one head a CTA
//    (ssd_output_kernel, grid (row tiles x p blocks, h, b * nc)), the
//    heaviest tiles first.
// Products: mma.sync.m16n8k16 with fp32 accumulation, operands by ldmatrix
// from shared tiles whose rows are padded to an odd number of 16-byte units
// (no bank conflicts).  Inputs in bf16 are exact operands, so C . B^T is
// exact before it is widened (as the TPU kernel widens it, ROADMAP C.7).
// Every fp32 operand (the weighted x, W, the carried state) is split into a
// bf16 hi and lo part, v = hi + lo + O(2^-17 v), and multiplied twice
// ("split-bf16").  The fp32 entry, which no main path runs, splits its fp32
// inputs into three bf16 parts first (ssd_split_kernel), splits every
// computed operand into three, and keeps the six products whose parts' ranks
// sum to at most 2: fp32 accuracy on the same passes.
//
// Shapes: p and n multiples of 16, n at most 128 (Mamba-2's d_state, and all
// the card tests run), any chunk c (rows past c are zero-filled
// as they are staged, and carry dt = 0).  The Mamba-2 shape has instances of
// its own, with p, n and c fixed so that the loops unroll; any other shape
// takes the generic ones.  A CTA never allocates: scratch comes from the
// caller.  The host entries set each kernel's dynamic-shared-memory limit
// once per size and return every launch's cudaGetLastError().
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kRows = 64;          // rows of a staged slice or a row tile,
                                   // and the p columns of a block
constexpr int kStateCols = 128;    // the n columns of a pass-1 block
constexpr int kMaxN = 128;         // the widest state the entries take
constexpr size_t kSmemLimit = 232448;    // sm_90: 227 KB a block, opt-in
constexpr size_t kPairBudget = 115 * 1024;   // two CTAs an SM
constexpr size_t kTripleBudget = 75 * 1024;  // three CTAs an SM
constexpr float kLog2e = 1.4426950408889634f;

struct Shape {
  int b, l, h, p, n, c, nc;
  size_t x_plane, bc_plane;        // elements between the parts of x, B, C
};

// p, n and c fixed at compile time where the template says so (0: runtime).
template <int P, int N, int C>
__device__ __forceinline__ Shape with_dims(Shape s) {
  if (P > 0) s.p = P;
  if (N > 0) s.n = N;
  if (C > 0) s.c = C;
  return s;
}

__host__ __device__ constexpr int ld_of(int cols) {   // odd 16-byte units
  return ((cols / 8) | 1) * 8;
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst; zeros (and no read) when !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until the group of the oldest slice in a ring of `stages` has landed.
__device__ __forceinline__ void wait_ring(int stages) {
  if (stages == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a . b for one m16n8k16 tile: bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products of an operand in NA bf16 parts with one in NB parts: every
// pair whose ranks sum to less than the larger count (bf16 entry: one exact
// part times hi and lo; fp32 entry: the six pairs of rank sum <= 2).  b holds
// two n-tiles' fragments, (b[0], b[1]) and (b[2], b[3]); `half` picks one.
template <int NA, int NB>
__device__ __forceinline__ void mma_parts(float (&c)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][4],
                                          int half) {
  constexpr int kMax = NA > NB ? NA : NB;
#pragma unroll
  for (int ia = 0; ia < NA; ++ia)
#pragma unroll
    for (int ib = 0; ib < NB; ++ib)
      if (ia + ib < kMax)
        mma_bf16(c, a[ia], b[ib][2 * half], b[ib][2 * half + 1]);
}

// Two fp32 values as NP packed bf16 pairs, hi first: each part rounds what
// the parts before it left.
template <int NP>
__device__ __forceinline__ void split_pair(float lo, float hi,
                                           uint32_t (&out)[NP]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    out[k] = *reinterpret_cast<const uint32_t*>(&v);
    lo -= __low2float(v);
    hi -= __high2float(v);
  }
}

__device__ __forceinline__ void unpack8(float (&v)[8], uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    v[2 * i] = __low2float(b);
    v[2 * i + 1] = __high2float(b);
  }
}

// Copy rows [0, rows) of cols bf16 columns from src (rows src_ld elements
// apart) to dst (rows ld apart), 16 bytes a copy; rows >= rows_valid and
// columns >= cols_valid are zero-filled and not read (`safe` is a valid
// address for those).  Every thread calls it.
template <int NT = kThreads>
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           size_t src_ld, int rows,
                                           int rows_valid, int cols,
                                           int cols_valid, const void* safe) {
  const int units = cols / 8;
  for (int i = threadIdx.x; i < rows * units; i += NT) {
    const int r = i / units, u = i % units;
    const bool live = r < rows_valid && u * 8 < cols_valid;
    cp_async16(dst + r * ld + u * 8,
               live ? static_cast<const void*>(src + r * src_ld + u * 8)
                    : safe,
               live);
  }
}

// Chunk rows [0, rows) of one head: dt_s[r] = dt of row r (0 from row
// `valid` on), cs_s[r] = sum_{t <= r} dt_s[t] * a.  Each thread scans a run
// of consecutive rows, then the runs' totals are scanned across the block.
// Every thread calls it; it ends with a barrier.
__device__ void chunk_cumsum(const float* dt, size_t stride, int valid,
                             int rows, float a, float* dt_s, float* cs_s,
                             float* red) {
  const int per = (rows + kThreads - 1) / kThreads;
  const int r0 = threadIdx.x * per;
  float run = 0.f;
  for (int k = 0; k < per; ++k) {
    const int r = r0 + k;
    if (r < rows) {
      const float d = r < valid ? dt[(size_t)r * stride] : 0.f;
      dt_s[r] = d;
      run = __fadd_rn(run, __fmul_rn(d, a));
      cs_s[r] = run;
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(~0u, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  float before = incl - run;
  for (int w = 0; w < warp; ++w) before += red[w];
  for (int k = 0; k < per; ++k) {
    const int r = r0 + k;
    if (r < rows) cs_s[r] += before;
  }
  __syncthreads();
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error below
// 2^-22, denormal results flushed to 0): each decay of the chunk-output pass,
// where the accurate exp2f took a quarter of the pass's time.
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ------------------------------------------------- pass 1: chunk states

// Shared bytes: the chunk's dt, cs and weights (round_up(c, 64) floats
// each), the scan's warp totals, then `stages` slices of NR parts of B (64
// rows x 128 columns) and of x (64 x 64).
template <int NR>
struct StatesSmem {
  static constexpr int kLdB = ld_of(kStateCols);
  static constexpr int kLdX = ld_of(kRows);
  static constexpr size_t kStage = sizeof(bf16) * NR * kRows * (kLdB + kLdX);
  static size_t fixed(int c) {
    return sizeof(float) * (3 * (size_t)round_up(c, kRows) + 4);
  }
};

// One CTA: one head of one chunk, a 64 x 128 block of its p x n state.  A
// warp holds 32 x 64 of it (2 x 8 mma tiles): A = the weighted x (p x j;
// x staged [j][p] and read with ldmatrix.trans, then scaled by w_j and split
// into NW parts in the fragment's registers), B = B (j x n, staged [j][n],
// ldmatrix.trans).
template <int NR, int NW, int P, int N, int C>
__global__ void __launch_bounds__(kThreads)
    ssd_states_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      float* __restrict__ states, float* __restrict__ chunk_cs,
                      Shape shape, int stages) {
  using Sm = StatesSmem<NR>;
  constexpr int kLdB = Sm::kLdB, kLdX = Sm::kLdX;
  constexpr int kStage = NR * kRows * (kLdB + kLdX);   // elements
  extern __shared__ __align__(16) unsigned char smem[];
  const Shape s = with_dims<P, N, C>(shape);
  const int pblocks = (s.p + kRows - 1) / kRows;
  const int p0 = (blockIdx.x % pblocks) * kRows;
  const int n0 = (blockIdx.x / pblocks) * kStateCols;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z / s.nc, z = blockIdx.z % s.nc;
  const int crow = round_up(s.c, kRows);
  const size_t row0 = (size_t)bi * s.l + (size_t)z * s.c;
  const size_t hp = (size_t)s.h * s.p;

  float* dt_s = reinterpret_cast<float*>(smem);
  float* cs_s = dt_s + crow;
  float* w_s = cs_s + crow;
  float* red = w_s + crow;
  bf16* ring = reinterpret_cast<bf16*>(red + 4);

  const bf16* xc = x + row0 * hp + (size_t)hh * s.p + p0;
  const bf16* bc = Bm + row0 * s.n + n0;
  const int nslices = crow / kRows;
  auto issue = [&](int sl) {
    if (sl < nslices) {
      bf16* st = ring + (sl % stages) * kStage;
      const int valid = s.c - sl * kRows;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        stage_rows(st + r * kRows * kLdB, kLdB,
                   bc + r * s.bc_plane + (size_t)sl * kRows * s.n, s.n, kRows,
                   valid, kStateCols, s.n - n0, Bm);
        stage_rows(st + (NR * kLdB + r * kLdX) * kRows, kLdX,
                   xc + r * s.x_plane + (size_t)sl * kRows * hp, hp, kRows,
                   valid, kRows, s.p - p0, x);
      }
    }
    cp_async_commit();                  // an empty group past the end
  };
  for (int i = 0; i < stages - 1; ++i) issue(i);

  // The weights of the chunk's rows, once: exp(cs_last - cs_j) dt_j.
  chunk_cumsum(dt + row0 * s.h + hh, s.h, s.c, crow, A[hh], dt_s, cs_s, red);
  const float last = cs_s[crow - 1];    // rows past c add dt = 0
  for (int r = threadIdx.x; r < crow; r += kThreads)
    w_s[r] = exp2f((last - cs_s[r]) * kLog2e) * dt_s[r];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    chunk_cs[((size_t)bi * s.nc + z) * s.h + hh] = last;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int wm = warp % 2, wn = warp / 2;   // rows 32 wm, columns 64 wn
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int sl = 0; sl < nslices; ++sl) {
    wait_ring(stages);
    // Slice sl has landed for every thread, every thread is done with slice
    // sl - 1 (whose stage the next issue refills), and the weights are
    // visible.
    __syncthreads();
    issue(sl + stages - 1);
    const bf16* bsl = ring + (sl % stages) * kStage;
    const bf16* xsl = bsl + NR * kRows * kLdB;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      // The A fragment holds rows (p) g and g + 8 at columns (j) 2t, 2t + 1
      // (registers 0, 1) and 2t + 8, 2t + 9 (registers 2, 3).
      const float2 wl = *reinterpret_cast<const float2*>(
          w_s + sl * kRows + kk * 16 + 2 * t);
      const float2 wh = *reinterpret_cast<const float2*>(
          w_s + sl * kRows + kk * 16 + 8 + 2 * t);
      uint32_t a[2][NW][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          uint32_t raw[4];
          ldmatrix_x4_trans(
              raw, xsl + (r * kRows + kk * 16 + (lane & 7) +
                          ((lane >> 4) << 3)) * kLdX +
                       wm * 32 + mt * 16 + ((lane >> 3) & 1) * 8);
          float part[8];
          unpack8(part, make_uint4(raw[0], raw[1], raw[2], raw[3]));
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += part[e];
        }
        uint32_t pr[4][NW];
        split_pair<NW>(v[0] * wl.x, v[1] * wl.y, pr[0]);
        split_pair<NW>(v[2] * wl.x, v[3] * wl.y, pr[1]);
        split_pair<NW>(v[4] * wh.x, v[5] * wh.y, pr[2]);
        split_pair<NW>(v[6] * wh.x, v[7] * wh.y, pr[3]);
#pragma unroll
        for (int k = 0; k < NW; ++k)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][k][e] = pr[e][k];
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[NR][4];
#pragma unroll
        for (int r = 0; r < NR; ++r)
          ldmatrix_x4_trans(bb[r], bsl + (r * kRows + kk * 16 + (lane & 15)) *
                                             kLdB +
                                       wn * 64 + np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_parts<NW, NR>(acc[mt][2 * np], a[mt], bb, 0);
          mma_parts<NW, NR>(acc[mt][2 * np + 1], a[mt], bb, 1);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* out = states + (((size_t)bi * s.nc + z) * s.h + hh) * s.p * s.n;
  const int g = lane / 4;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int pr = p0 + wm * 32 + mt * 16 + g;
      const int col = n0 + wn * 64 + nt * 8 + 2 * t;
      if (col >= s.n) continue;
      if (pr < s.p)
        store_pair(out + (size_t)pr * s.n + col, acc[mt][nt][0],
                   acc[mt][nt][1]);
      if (pr + 8 < s.p)
        store_pair(out + (size_t)(pr + 8) * s.n + col, acc[mt][nt][2],
                   acc[mt][nt][3]);
    }
}

// ------------------------------------------------ pass 2: state passing

// One thread: 4 consecutive elements of one (sequence, head)'s p x n state,
// walked over the chunks with the next two chunks' loads in flight.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    ssd_pass_kernel(const float* __restrict__ states,
                    const float* __restrict__ chunk_cs,
                    const float* __restrict__ init, bf16* __restrict__ prev,
                    float* __restrict__ final_state, Shape s) {
  const size_t pn = (size_t)s.p * s.n;
  const size_t e0 = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e0 >= pn) return;
  const int hh = blockIdx.y, bi = blockIdx.z;
  const size_t bh = (size_t)bi * s.h + hh;
  float carry[4] = {0.f, 0.f, 0.f, 0.f};
  if (init) {
    const float4 v = *reinterpret_cast<const float4*>(init + bh * pn + e0);
    carry[0] = v.x, carry[1] = v.y, carry[2] = v.z, carry[3] = v.w;
  }
  const size_t first = (size_t)bi * s.nc * s.h + hh;   // (bi, z = 0, hh)
  auto load = [&](int z) {
    return z < s.nc ? *reinterpret_cast<const float4*>(
                          states + (first + (size_t)z * s.h) * pn + e0)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 ahead0 = load(0), ahead1 = load(1);
  for (int z = 0; z < s.nc; ++z) {
    const float4 sz = ahead0;
    ahead0 = ahead1;
    ahead1 = load(z + 2);
    const size_t zh = first + (size_t)z * s.h;
    const float decay = expf(chunk_cs[zh]);
    uint32_t parts[2][NW];
    split_pair<NW>(carry[0], carry[1], parts[0]);
    split_pair<NW>(carry[2], carry[3], parts[1]);
    bf16* dst = prev + zh * NW * pn + e0;
#pragma unroll
    for (int k = 0; k < NW; ++k)
      *reinterpret_cast<uint2*>(dst + k * pn) =
          make_uint2(parts[0][k], parts[1][k]);
    const float sv[4] = {sz.x, sz.y, sz.z, sz.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      carry[e] = __fadd_rn(__fmul_rn(carry[e], decay), sv[e]);
  }
  *reinterpret_cast<float4*>(final_state + bh * pn + e0) =
      make_float4(carry[0], carry[1], carry[2], carry[3]);
}

// ------------------------------------------------ pass 3: chunk output

// Shared bytes: dt and cs of rows [0, round_up(c, 64)), the scan's warp
// totals, the C tile (NR parts of 64 rows x n), prev (NW parts of 64 p rows
// x n), then `stages` slices of JS rows: NR parts of B (JS x n) and of x
// (JS x 64 p columns).
template <int NR, int NW, int JS>
struct OutputSmem {
  static constexpr int kLdX = ld_of(kRows);
  static size_t fixed(int c, int n) {
    return sizeof(float) * (2 * (size_t)round_up(c, kRows) + 4) +
           sizeof(bf16) * (NR + NW) * kRows * (size_t)ld_of(n);
  }
  static size_t stage(int n) {
    return sizeof(bf16) * NR * JS * (size_t)(ld_of(n) + kLdX);
  }
};

// One CTA: 64 rows of one chunk, one head, 64 p columns; warp w owns rows
// [16 w, 16 w + 16) of the tile.  y_off first (C . prev^T, A = C [i][n],
// B = prev [p][n]), then for every 16 columns j <= the warp's last row:
// G = C . B^T (B = B [j][n]) in registers, W from G, y += W . x (B = x
// [j][p], ldmatrix.trans).
template <typename T, int NR, int NW, int JS>
__global__ void __launch_bounds__(kThreads)
    ssd_output_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      const bf16* __restrict__ Cm,
                      const bf16* __restrict__ prev, T* __restrict__ y,
                      Shape shape, int stages) {
  using Sm = OutputSmem<NR, NW, JS>;
  constexpr int kLdX = Sm::kLdX;
  extern __shared__ __align__(16) unsigned char smem[];
  const Shape& s = shape;
  const int ldn = ld_of(s.n);
  const int pblocks = (s.p + kRows - 1) / kRows;
  const int rtiles = (s.c + kRows - 1) / kRows;
  const int rt = rtiles - 1 - (int)blockIdx.x / pblocks;   // longest first
  const int p0 = (blockIdx.x % pblocks) * kRows;
  const int hh = blockIdx.y;
  const int bi = blockIdx.z / s.nc, z = blockIdx.z % s.nc;
  const int i0 = rt * kRows;
  const int rows = i0 + kRows;                 // rows whose cs the tile reads
  const int i_end = min(rows, s.c);
  const int nsl = (i_end + JS - 1) / JS;       // slices of j <= the last row
  const size_t row0 = (size_t)bi * s.l + (size_t)z * s.c;
  const size_t hp = (size_t)s.h * s.p;

  float* dt_s = reinterpret_cast<float*>(smem);
  float* cs_s = dt_s + round_up(s.c, kRows);
  float* red = cs_s + round_up(s.c, kRows);
  bf16* c_s = reinterpret_cast<bf16*>(red + 4);
  bf16* pv_s = c_s + NR * kRows * ldn;
  bf16* ring = pv_s + NW * kRows * ldn;
  const int stage_elems = NR * JS * (ldn + kLdX);

  const bf16* xc = x + row0 * hp + (size_t)hh * s.p + p0;
  auto issue = [&](int sl) {
    if (sl < nsl) {
      bf16* st = ring + (sl % stages) * stage_elems;
      const int valid = s.c - sl * JS;
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        stage_rows(st + r * JS * ldn, ldn,
                   Bm + r * s.bc_plane + (row0 + (size_t)sl * JS) * s.n, s.n,
                   JS, valid, s.n, s.n, Bm);
        stage_rows(st + NR * JS * ldn + r * JS * kLdX, kLdX,
                   xc + r * s.x_plane + (size_t)sl * JS * hp, hp, JS, valid,
                   kRows, s.p - p0, x);
      }
    }
    cp_async_commit();
  };
  // Group 0: the C tile, the state this chunk starts from, and slice 0.
#pragma unroll
  for (int r = 0; r < NR; ++r)
    stage_rows(c_s + r * kRows * ldn, ldn,
               Cm + r * s.bc_plane + (row0 + i0) * s.n, s.n, kRows,
               s.c - i0, s.n, s.n, Cm);
  const size_t pn = (size_t)s.p * s.n;
  const bf16* pv =
      prev + (((size_t)bi * s.nc + z) * s.h + hh) * NW * pn + (size_t)p0 * s.n;
#pragma unroll
  for (int k = 0; k < NW; ++k)
    stage_rows(pv_s + k * kRows * ldn, ldn, pv + k * pn, s.n, kRows,
               s.p - p0, s.n, s.n, prev);
  for (int i = 0; i < stages - 1; ++i) issue(i);

  chunk_cumsum(dt + row0 * s.h + hh, s.h, s.c, rows, A[hh], dt_s, cs_s, red);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = i0 + 16 * warp;            // the warp's first row
  const bool active = strip < s.c;
  const int ia = strip + g, ib = ia + 8;       // this thread's two rows
  const float cs_a = cs_s[ia], cs_b = cs_s[ib];
  const int ksteps = s.n / 16;
  const int ptiles = min(kRows, s.p - p0) / 16;   // 16-column pairs of p

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // The warp's C fragment (rows strip.., columns 16 kk..) in NR parts.
  auto c_frag = [&](int kk, uint32_t (&ca)[NR][4]) {
#pragma unroll
    for (int r = 0; r < NR; ++r)
      ldmatrix_x4(ca[r], c_s + (r * kRows + 16 * warp + (lane & 15)) * ldn +
                             kk * 16 + (lane >> 4) * 8);
  };
  // acc += C (k-step kk) . prev^T.
  auto off_step = [&](int kk, const uint32_t (&ca)[NR][4]) {
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      if (pp >= ptiles) break;
      uint32_t pb[NW][4];
#pragma unroll
      for (int k = 0; k < NW; ++k)
        ldmatrix_x4(pb[k], pv_s + (k * kRows + 16 * pp + (lane & 7) +
                                   ((lane >> 4) << 3)) * ldn +
                               kk * 16 + ((lane >> 3) & 1) * 8);
      mma_parts<NR, NW>(acc[2 * pp], ca, pb, 0);
      mma_parts<NR, NW>(acc[2 * pp + 1], ca, pb, 1);
    }
  };
  // G = C . B^T for the 16 columns of j at row q of the staged slice bsl:
  // two n-tiles of j.
  auto g_block = [&](float (&gacc)[2][4], const bf16* bsl, int q) {
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t ca[NR][4], bb[NR][4];
      c_frag(kk, ca);
#pragma unroll
      for (int r = 0; r < NR; ++r)
        ldmatrix_x4(bb[r], bsl + (r * JS + 16 * q + (lane & 7) +
                                  ((lane >> 4) << 3)) * ldn +
                               kk * 16 + ((lane >> 3) & 1) * 8);
      mma_parts<NR, NR>(gacc[0], ca, bb, 0);
      mma_parts<NR, NR>(gacc[1], ca, bb, 1);
    }
  };
  // W = G exp(cs_i - cs_j) dt_j for j <= i (the mask only on the diagonal
  // block), in the accumulator layout: tile nt holds (row g, j = 8 nt + 2t,
  // +1) and (row g + 8, the same j); then, as the A fragments of W . x
  // (k = j): a0 = (g, 2t), a1 = (g + 8, 2t), a2 = (g, 2t + 8), a3 =
  // (g + 8, 2t + 8), in NW parts.
  auto w_block = [&](uint32_t (&wa)[NW][4], const float (&gacc)[2][4],
                     int jc) {
    const bool diag = jc + 15 > strip;
    float w[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = jc + 8 * nt + 2 * t;
      const float2 csj = *reinterpret_cast<const float2*>(cs_s + j);
      const float2 dtj = *reinterpret_cast<const float2*>(dt_s + j);
      w[nt][0] = gacc[nt][0] * exp2_sfu((cs_a - csj.x) * kLog2e) * dtj.x;
      w[nt][1] = gacc[nt][1] * exp2_sfu((cs_a - csj.y) * kLog2e) * dtj.y;
      w[nt][2] = gacc[nt][2] * exp2_sfu((cs_b - csj.x) * kLog2e) * dtj.x;
      w[nt][3] = gacc[nt][3] * exp2_sfu((cs_b - csj.y) * kLog2e) * dtj.y;
      if (diag) {
        // Above the diagonal cs_i - cs_j > 0 may overflow: select, not
        // multiply.
        w[nt][0] = j <= ia ? w[nt][0] : 0.f;
        w[nt][1] = j + 1 <= ia ? w[nt][1] : 0.f;
        w[nt][2] = j <= ib ? w[nt][2] : 0.f;
        w[nt][3] = j + 1 <= ib ? w[nt][3] : 0.f;
      }
    }
    uint32_t pr[4][NW];
    split_pair<NW>(w[0][0], w[0][1], pr[0]);
    split_pair<NW>(w[0][2], w[0][3], pr[1]);
    split_pair<NW>(w[1][0], w[1][1], pr[2]);
    split_pair<NW>(w[1][2], w[1][3], pr[3]);
#pragma unroll
    for (int k = 0; k < NW; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) wa[k][e] = pr[e][k];
  };
  // acc += W . x for the 16 rows of x at row q of the staged slice xsl.
  auto y_block = [&](const uint32_t (&wa)[NW][4], const bf16* xsl, int q) {
#pragma unroll
    for (int pp = 0; pp < 4; ++pp) {
      if (pp >= ptiles) break;
      uint32_t xb[NR][4];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        ldmatrix_x4_trans(xb[r], xsl + (r * JS + 16 * q + (lane & 15)) * kLdX +
                                     16 * pp + (lane >> 4) * 8);
      mma_parts<NW, NR>(acc[2 * pp], wa, xb, 0);
      mma_parts<NW, NR>(acc[2 * pp + 1], wa, xb, 1);
    }
  };

  for (int sl = 0; sl < nsl; ++sl) {
    wait_ring(stages);
    __syncthreads();
    issue(sl + stages - 1);
    if (sl == 0 && active) {
      // y_off = exp(cs_i) C_i . prev^T.
      for (int kk = 0; kk < ksteps; ++kk) {
        uint32_t ca[NR][4];
        c_frag(kk, ca);
        off_step(kk, ca);
      }
      const float ea = exp2f(cs_a * kLog2e), eb = exp2f(cs_b * kLog2e);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] *= ea;
        acc[i][1] *= ea;
        acc[i][2] *= eb;
        acc[i][3] *= eb;
      }
    }
    const bf16* bsl = ring + (sl % stages) * stage_elems;
    const bf16* xsl = bsl + NR * JS * ldn;
    // Blocks of 16 columns j <= the warp's last row.
#pragma unroll
    for (int q = 0; q < JS / 16; ++q) {
      const int jc = sl * JS + 16 * q;
      if (!active || jc > strip + 15 || jc >= s.c) break;
      float ga[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      uint32_t wa[NW][4];
      g_block(ga, bsl, q);
      w_block(wa, ga, jc);
      y_block(wa, xsl, q);
    }
  }
  cp_async_wait<0>();

  if (!active) return;
  T* yc = y + row0 * hp + (size_t)hh * s.p + p0;
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    if (pp >= ptiles) break;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int nt = 2 * pp + h2, col = 8 * nt + 2 * t;
      if (ia < s.c)
        store_pair(yc + (size_t)ia * hp + col, acc[nt][0], acc[nt][1]);
      if (ib < s.c)
        store_pair(yc + (size_t)ib * hp + col, acc[nt][2], acc[nt][3]);
    }
  }
}

// ------------------------- pass 3 at the Mamba-2 shape: a chunk a CTA

// At p = 64, n = 128, c = 256 in bf16, with h a multiple of 8, the chunk
// output runs one CTA per (sequence, chunk, block of 8 heads), 8 warps.  The
// row-tile CTAs of the generic kernel re-read the state each row tile starts
// from, the prefix of B and x below each tile, and C and B for every head:
// ~1.8 GB through L2 at 8 x 2048, which bound that kernel even with its
// products removed.  Here B stays in shared memory for all 8 heads, C stays
// in registers (warp w holds the fragments of its two 16-row strips, w and
// 15 - w, which have 17 blocks of 16 columns j between them, the same for
// every warp), and each head's x and starting state stream in once,
// double-buffered, while the head before is computed.  The two strips share
// every B and x fragment a warp loads.
constexpr int kChunkThreads = 256;
constexpr int kChunkHeads = 8;                 // heads a CTA, one a warp
constexpr int kMainP = 64, kMainN = 128, kMainC = 256;
constexpr int kLdN = ld_of(kMainN);
constexpr int kLdP = ld_of(kMainP);
constexpr int kHeadX = kMainC * kLdP;          // elements of a head's x
constexpr int kHeadBuf = kHeadX + 2 * kMainP * kLdN;   // ... and its state
static_assert(kHeadBuf >= kMainC * kLdN, "C is staged in a head buffer");

// Shared bytes: dt and cs by head ([head][row]; dt arrives [row][head] in
// the cs table and is transposed), B (c x n), two head buffers (C in the
// second one first).
struct ChunkSmem {
  static constexpr size_t kBytes =
      sizeof(float) * 2 * kChunkHeads * kMainC +
      sizeof(bf16) * ((size_t)kMainC * kLdN + 2 * (size_t)kHeadBuf);
};

__global__ void __launch_bounds__(kChunkThreads, 1)
    ssd_chunk_output_kernel(const bf16* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ A,
                            const bf16* __restrict__ Bm,
                            const bf16* __restrict__ Cm,
                            const bf16* __restrict__ prev,
                            bf16* __restrict__ y, Shape s) {
  constexpr int kP = kMainP, kN = kMainN, kC = kMainC, NW = 2;
  constexpr int HB = kChunkHeads;
  constexpr int NT = kChunkThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int h0 = blockIdx.x * HB;
  const int bi = blockIdx.y / s.nc, z = blockIdx.y % s.nc;
  const size_t row0 = (size_t)bi * s.l + (size_t)z * kC;
  const size_t hp = (size_t)s.h * kP;
  const size_t pn = (size_t)kP * kN;
  float* dt_s = reinterpret_cast<float*>(smem);
  float* cs_s = dt_s + HB * kC;
  bf16* b_s = reinterpret_cast<bf16*>(cs_s + HB * kC);
  bf16* buf0 = b_s + kC * kLdN;
  bf16* buf1 = buf0 + kHeadBuf;

  // Head k's x (c rows of p) and starting state (NW parts of p x n).
  auto issue_head = [&](int k, bf16* buf) {
    if (k < HB) {
      stage_rows<NT>(buf, kLdP, x + row0 * hp + (size_t)(h0 + k) * kP, hp,
                     kC, kC, kP, kP, x);
      const bf16* pv =
          prev + (((size_t)bi * s.nc + z) * s.h + h0 + k) * NW * pn;
#pragma unroll
      for (int part = 0; part < NW; ++part)
        stage_rows<NT>(buf + kHeadX + part * kP * kLdN, kLdN, pv + part * pn,
                       kN, kP, kP, kN, kN, prev);
    }
    cp_async_commit();
  };
  // Group 0: dt of the block's heads (HB contiguous floats a row), B and C.
  for (int i = threadIdx.x; i < kC * (HB / 4); i += NT) {
    const int r = i / (HB / 4), u = i % (HB / 4);
    cp_async16(cs_s + r * HB + u * 4, dt + (row0 + r) * s.h + h0 + u * 4,
               true);
  }
  stage_rows<NT>(b_s, kLdN, Bm + row0 * kN, kN, kC, kC, kN, kN, Bm);
  stage_rows<NT>(buf1, kLdN, Cm + row0 * kN, kN, kC, kC, kN, kN, Cm);
  cp_async_commit();
  issue_head(0, buf0);                    // group 1

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip[2] = {warp, 15 - warp};
  uint32_t cfr[2][kN / 16][1][4];
  cp_async_wait<1>();
  __syncthreads();
  {
    // cs of head `warp` over the chunk, 8 rows a lane then across the lanes,
    // from dt as staged ([row][head], in cs_s); C fragments of both strips.
    float d[8], c8[8];
    if (warp < HB) {
      const float a = A[h0 + warp];
      float run = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        d[r] = cs_s[(lane * 8 + r) * HB + warp];
        run = __fadd_rn(run, __fmul_rn(d[r], a));
        c8[r] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl += v;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) c8[r] += incl - run;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        ldmatrix_x4(cfr[u][kk][0], buf1 + (16 * strip[u] + (lane & 15)) *
                                              kLdN +
                                          kk * 16 + (lane >> 4) * 8);
    __syncthreads();                      // dt read, C read: both rewritable
    if (warp < HB)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        dt_s[warp * kC + lane * 8 + r] = d[r];
        cs_s[warp * kC + lane * 8 + r] = c8[r];
      }
  }
  issue_head(1, buf1);                    // group 2

  for (int k = 0; k < HB; ++k) {
    cp_async_wait<1>();                   // head k's group has landed
    __syncthreads();                      // ... for every thread; tables set
    const bf16* xs = k % 2 ? buf1 : buf0;
    const bf16* pv_s = xs + kHeadX;
    const float* csk = cs_s + k * kC;
    const float* dtk = dt_s + k * kC;
    float acc[2][8][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[u][i][q] = 0.f;
    // y_off = exp(cs_i) C_i . prev^T.
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t pb[NW][4];
#pragma unroll
        for (int part = 0; part < NW; ++part)
          ldmatrix_x4(pb[part], pv_s + (part * kP + 16 * pp + (lane & 7) +
                                        ((lane >> 4) << 3)) * kLdN +
                                    kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          mma_parts<1, NW>(acc[u][2 * pp], cfr[u][kk], pb, 0);
          mma_parts<1, NW>(acc[u][2 * pp + 1], cfr[u][kk], pb, 1);
        }
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float ea = exp2f(csk[16 * strip[u] + g] * kLog2e);
      const float eb = exp2f(csk[16 * strip[u] + g + 8] * kLog2e);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[u][i][0] *= ea;
        acc[u][i][1] *= ea;
        acc[u][i][2] *= eb;
        acc[u][i][3] *= eb;
      }
    }
    // For each block of 16 columns j <= the far strip's last row: G = C .
    // B^T, W, y += W . x, for the far strip and, while it reaches, the near.
    for (int blk = 0; blk <= strip[1]; ++blk) {
      const bool both = blk <= strip[0];
      float gacc[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int r = 0; r < 4; ++r) gacc[u][i][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t bb[1][4];
        ldmatrix_x4(bb[0], b_s + (16 * blk + (lane & 7) +
                                  ((lane >> 4) << 3)) * kLdN +
                               kk * 16 + ((lane >> 3) & 1) * 8);
        mma_parts<1, 1>(gacc[1][0], cfr[1][kk], bb, 0);
        mma_parts<1, 1>(gacc[1][1], cfr[1][kk], bb, 1);
        if (both) {
          mma_parts<1, 1>(gacc[0][0], cfr[0][kk], bb, 0);
          mma_parts<1, 1>(gacc[0][1], cfr[0][kk], bb, 1);
        }
      }
      // W in the accumulator layout, handed on as A fragments (see the
      // generic kernel's w_block).
      uint32_t wa[2][NW][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 0 && !both) continue;
        const int ia = 16 * strip[u] + g, ib = ia + 8;
        const float cs_a = csk[ia], cs_b = csk[ib];
        const bool diag = blk == strip[u];
        float w[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int j = 16 * blk + 8 * nt + 2 * t;
          const float2 csj = *reinterpret_cast<const float2*>(csk + j);
          const float2 dtj = *reinterpret_cast<const float2*>(dtk + j);
          w[nt][0] =
              gacc[u][nt][0] * exp2_sfu((cs_a - csj.x) * kLog2e) * dtj.x;
          w[nt][1] =
              gacc[u][nt][1] * exp2_sfu((cs_a - csj.y) * kLog2e) * dtj.y;
          w[nt][2] =
              gacc[u][nt][2] * exp2_sfu((cs_b - csj.x) * kLog2e) * dtj.x;
          w[nt][3] =
              gacc[u][nt][3] * exp2_sfu((cs_b - csj.y) * kLog2e) * dtj.y;
          if (diag) {
            w[nt][0] = j <= ia ? w[nt][0] : 0.f;
            w[nt][1] = j + 1 <= ia ? w[nt][1] : 0.f;
            w[nt][2] = j <= ib ? w[nt][2] : 0.f;
            w[nt][3] = j + 1 <= ib ? w[nt][3] : 0.f;
          }
        }
        uint32_t pr[4][NW];
        split_pair<NW>(w[0][0], w[0][1], pr[0]);
        split_pair<NW>(w[0][2], w[0][3], pr[1]);
        split_pair<NW>(w[1][0], w[1][1], pr[2]);
        split_pair<NW>(w[1][2], w[1][3], pr[3]);
#pragma unroll
        for (int part = 0; part < NW; ++part)
#pragma unroll
          for (int r = 0; r < 4; ++r) wa[u][part][r] = pr[r][part];
      }
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        uint32_t xb[1][4];
        ldmatrix_x4_trans(xb[0], xs + (16 * blk + (lane & 15)) * kLdP +
                                     16 * pp + (lane >> 4) * 8);
        mma_parts<NW, 1>(acc[1][2 * pp], wa[1], xb, 0);
        mma_parts<NW, 1>(acc[1][2 * pp + 1], wa[1], xb, 1);
        if (both) {
          mma_parts<NW, 1>(acc[0][2 * pp], wa[0], xb, 0);
          mma_parts<NW, 1>(acc[0][2 * pp + 1], wa[0], xb, 1);
        }
      }
    }
    // The head's y rows of both strips.
    bf16* yc = y + row0 * hp + (size_t)(h0 + k) * kP;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int ia = 16 * strip[u] + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = 8 * nt + 2 * t;
        store_pair(yc + (size_t)ia * hp + col, acc[u][nt][0], acc[u][nt][1]);
        store_pair(yc + (size_t)(ia + 8) * hp + col, acc[u][nt][2],
                   acc[u][nt][3]);
      }
    }
    __syncthreads();                      // every warp is done with the buffer
    issue_head(k + 2, k % 2 ? buf1 : buf0);
  }
  cp_async_wait<0>();
}

// ----------------------------------------- fp32 entry: split the inputs

// x, Bm and Cm (blockIdx.y = 0, 1, 2) as three bf16 planes each: plane k
// rounds what planes 0 .. k - 1 left.
__global__ void __launch_bounds__(256)
    ssd_split_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, bf16* __restrict__ xp,
                     bf16* __restrict__ bp, bf16* __restrict__ cp, size_t nx,
                     size_t nbc) {
  const float* src = blockIdx.y == 0 ? x : blockIdx.y == 1 ? Bm : Cm;
  bf16* dst = blockIdx.y == 0 ? xp : blockIdx.y == 1 ? bp : cp;
  const size_t count = blockIdx.y == 0 ? nx : nbc;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = src[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bf16 q = __float2bfloat16_rn(v);
      dst[k * count + i] = q;
      v -= __bfloat162float(q);
    }
  }
}

// ------------------------------------------------------------------ host

// Raise a kernel's dynamic-shared-memory limit to `bytes`, once per size
// above the largest it has been given on this device.
template <typename K>
cudaError_t allow_smem(K* kernel, std::atomic<int>* granted, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if ((int)bytes <= granted[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) granted[dev].store(static_cast<int>(bytes));
  return err;
}

// Three stages where they fit in `budget` (of one CTA's share of an SM),
// else two; 0 if two do not fit at all.
int ring_stages(size_t fixed, size_t stage, size_t budget = kPairBudget) {
  if (fixed + 3 * stage <= budget) return 3;
  if (fixed + 2 * stage <= kSmemLimit) return 2;
  return 0;
}

struct Args {
  const void *x, *dt, *A, *Bm, *Cm, *init;
  void *y, *state, *states, *chunk_cs, *prev, *parts;
  int b, l, h, p, n, c;
  cudaStream_t stream;
};

int chunk_output(const Shape& s, const bf16* x, const float* dt,
                 const float* A, const bf16* Bm, const bf16* Cm,
                 const bf16* prev, const Args& a) {
  constexpr size_t smem = ChunkSmem::kBytes;
  static_assert(smem <= kSmemLimit, "the chunk output fits one SM");
  static std::atomic<int> granted[64];
  cudaError_t err = allow_smem(ssd_chunk_output_kernel, granted, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_output_kernel<<<dim3(s.h / kChunkHeads, s.b * s.nc),
                            kChunkThreads, smem, a.stream>>>(
      x, dt, A, Bm, Cm, prev, static_cast<bf16*>(a.y), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P, int N, int C>
int run(const Args& a, const bf16* x, const bf16* Bm, const bf16* Cm) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NR = kF32 ? 3 : 1, NW = kF32 ? 3 : 2, JS = kF32 ? 32 : 64;
  Shape s{a.b, a.l, a.h, a.p, a.n, a.c, a.l / a.c,
          (size_t)a.b * a.l * a.h * a.p, (size_t)a.b * a.l * a.n};
  const auto* dt = static_cast<const float*>(a.dt);
  const auto* A = static_cast<const float*>(a.A);
  auto* states = static_cast<float*>(a.states);
  auto* chunk_cs = static_cast<float*>(a.chunk_cs);
  auto* prev = static_cast<bf16*>(a.prev);

  // Pass 1.
  using Ss = StatesSmem<NR>;
  const int st1 = ring_stages(Ss::fixed(s.c), Ss::kStage, kTripleBudget);
  if (st1 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem1 = Ss::fixed(s.c) + st1 * Ss::kStage;
  static std::atomic<int> granted1[64];
  auto* k1 = ssd_states_kernel<NR, NW, P, N, C>;
  cudaError_t err = allow_smem(k1, granted1, smem1);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pblocks = (s.p + kRows - 1) / kRows;
  const int nblocks = (s.n + kStateCols - 1) / kStateCols;
  k1<<<dim3(pblocks * nblocks, s.h, s.b * s.nc), kThreads, smem1,
       a.stream>>>(x, dt, A, Bm, states, chunk_cs, s, st1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // Pass 2.
  const size_t pn = (size_t)s.p * s.n;
  ssd_pass_kernel<NW><<<dim3((unsigned)((pn / 4 + kThreads - 1) / kThreads),
                             s.h, s.b),
                        kThreads, 0, a.stream>>>(
      states, chunk_cs, static_cast<const float*>(a.init), prev,
      static_cast<float*>(a.state), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // Pass 3: a chunk a CTA at the Mamba-2 shape, row tiles elsewhere.
  if constexpr (!kF32 && P == kMainP && N == kMainN && C == kMainC) {
    if (s.h % kChunkHeads == 0)
      return chunk_output(s, x, dt, A, Bm, Cm, prev, a);
  }
  using So = OutputSmem<NR, NW, JS>;
  const int st3 = ring_stages(So::fixed(s.c, s.n), So::stage(s.n));
  if (st3 == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem3 = So::fixed(s.c, s.n) + st3 * So::stage(s.n);
  static std::atomic<int> granted3[64];
  auto* k3 = ssd_output_kernel<T, NR, NW, JS>;
  err = allow_smem(k3, granted3, smem3);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rtiles = (s.c + kRows - 1) / kRows;
  k3<<<dim3(rtiles * pblocks, s.h, s.b * s.nc), kThreads, smem3,
       a.stream>>>(x, dt, A, Bm, Cm, prev, static_cast<T*>(a.y), s, st3);
  return static_cast<int>(cudaGetLastError());
}

bool valid(const Args& a) {
  return a.b > 0 && a.l > 0 && a.h > 0 && a.p > 0 && a.n > 0 && a.c > 0 &&
         a.l % a.c == 0 && a.p % 16 == 0 && a.n % 16 == 0 && a.n <= kMaxN &&
         a.states != nullptr && a.chunk_cs != nullptr && a.prev != nullptr &&
         (size_t)a.b * (a.l / a.c) <= 65535u && a.h <= 65535;
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y (b,l,h,p) and Bm, Cm (b,l,n) in the entry's type; dt (b,l,h), A (h,),
// init (b,h,p,n) or null, state (b,h,p,n): fp32.  All contiguous and 16-byte
// aligned; l a multiple of c; p and n multiples of 16, n <= 128.  Scratch:
// states (b, l/c, h, p, n) fp32, chunk_cs (b, l/c, h) fp32, prev (b, l/c, h,
// NW, p, n) bf16 with NW = 2 (bf16) or 3 (fp32), and for the fp32 entry
// parts: three bf16 planes of x, then of Bm, then of Cm.  Launches, in order on
// `stream`: [the fp32 split], chunk states, state passing, chunk output.
int ssd_scan_bf16(const void* x, const void* dt, const void* A,
                  const void* Bm, const void* Cm, const void* init, void* y,
                  void* state, void* states, void* chunk_cs, void* prev,
                  void* parts, int b, int l, int h, int p, int n, int c,
                  void* stream) {
  const Args a{x, dt, A, Bm, Cm, init, y, state, states, chunk_cs, prev,
               parts, b, l, h, p, n, c, static_cast<cudaStream_t>(stream)};
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* bb = static_cast<const bf16*>(Bm);
  const auto* cb = static_cast<const bf16*>(Cm);
  if (p == 64 && n == 128 && c == 256)       // Mamba-2
    return run<bf16, 64, 128, 256>(a, xb, bb, cb);
  return run<bf16, 0, 0, 0>(a, xb, bb, cb);
}

int ssd_scan_f32(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* init, void* y, void* state,
                 void* states, void* chunk_cs, void* prev, void* parts, int b,
                 int l, int h, int p, int n, int c, void* stream) {
  const Args a{x, dt, A, Bm, Cm, init, y, state, states, chunk_cs, prev,
               parts, b, l, h, p, n, c, static_cast<cudaStream_t>(stream)};
  if (!valid(a) || parts == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t nx = (size_t)b * l * h * p, nbc = (size_t)b * l * n;
  auto* xp = static_cast<bf16*>(parts);
  bf16* bp = xp + 3 * nx;
  bf16* cp = bp + 3 * nbc;
  const size_t most = nx > nbc ? nx : nbc;
  const unsigned blocks = (unsigned)((most + 255) / 256 < 8192
                                         ? (most + 255) / 256
                                         : 8192);
  ssd_split_kernel<<<dim3(blocks, 3), 256, 0, a.stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), xp, bp, cp, nx, nbc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return run<float, 0, 0, 0>(a, xp, bp, cp);
}

}  // extern "C"
