// tide_attention: decode attention through the KV-WAL slot table on Hopper
// (sm_90a), split across CTAs along each row's live range (flash-decoding).
//
// Replaces the TPU kernel tide_attention of
// src/repro/kernels/tide_attention/kernel.py.  For one new query token per
// sequence b and every query head h, with kv-head kh = h / G (G = H / KH):
//   out[b, h] = softmax_p(scale * q[b, h] . K[b, p, kh]) @ V[b, p, kh]
// over the live positions p of sequence b: first_live[b] <= p <
// min(seq_len[b], NB * blk) and, with window > 0, p > seq_len[b] - 1 - window.
// Position p lives at arena[b, table[b, p / blk], p % blk, kh]; K and V are
// never gathered into a contiguous copy.  Scores, softmax and sums are fp32;
// the output is cast to the element type.  A row with no live position
// writes 0 (the Pallas kernel writes 0 for seq_len == 0 but the mean of some
// V rows when first_live >= seq_len > 0; the JAX oracle the mean of all V
// rows).
//
// What bounds it on this card: device-memory bytes.  A decode step reads
// every live K/V row once, 2 x KH x d x 2 bytes a position in bf16, and does
// 4 x G x d flops on it: 4 flops a byte at G = 4 (Llama-3-8B), 16 at G = 16
// (RecurrentGemma-9B), below the ~295 a byte at which the tensor cores bind
// but, at G = 16, close to where the 67 TFLOP/s of fp32 FMAs would.
//
// The design.
// - Split pass, grid (S, KH * HC, B): CTA s of (b, kh) computes the row's
//   live range [lo, hi) on the device, cuts it into tiles of R positions
//   aligned to R, and takes slice s of S equal runs of those tiles.  R
//   comes from shared memory alone, not from blk: where R divides blk a
//   tile lies in one KV block, and a cursor walks the blocks; where it does
//   not (blk < R, or blk = 24 with R = 64), an instance of its own stages a
//   tile that spans several blocks in runs of at most blk rows, each row
//   finding its block in the table.  The split follows each
//   row's own live range, so rows of different lengths spread over the SMs.
//   S and R come from the host, from static shapes only (kernel.py,
//   split_plan); nothing here waits on the host.  A CTA covers up to 16
//   query heads of its kv-head; HC = ceil(G / 16) CTAs share a kv-head when
//   G > 16.
// - Staging: the CTA reads its slice's block ids from the table once, then
//   keeps a ring of 2-3 stages of K and V tiles in shared memory filled with
//   16-byte cp.async.cg copies, all of a stage's copies issued before any
//   wait, so tiles t + 1 and t + 2 load while tile t is computed.  Where R
//   divides blk, a cursor advances the next tile's stage, block and offset
//   without a division, and each thread keeps one 16-byte column of the
//   rows it copies; a tile that spans blocks divides once a copy.  Rows
//   outside [lo, hi) are never read from device memory: cp.async with a
//   source size of 0 writes zeros there, so the products never meet
//   uninitialised shared memory, and their masked score (-inf) and zero V
//   row add nothing.  Shared-memory rows are padded to an odd number of
//   16-byte units, so the 8 rows of one ldmatrix phase fall in different
//   banks.
// - bf16 products on the tensor cores, mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate), 4 warps.  Scores Q (16 x dk, G rows padded with zeros) . K^T
//   with the tile's positions split over the warps; q stays in shared memory
//   and each k-step's A fragment is read with ldmatrix, which keeps the
//   register count independent of d.  The online softmax runs on the score
//   registers in fp32, in log2 units (exp2); the row maximum crosses the
//   warps through shared memory, so every warp rescales with the same
//   running maximum.  The weights are rounded to bf16 into shared memory (and
//   the running sum adds the rounded weights, so the output is their exact
//   weighted mean), then P (16 x R) . V (R x dv) with the dv columns split
//   over the warps and V's B fragments read with ldmatrix.trans.  At the two
//   main shapes (dk = dv = 128 and 256, R = 64) the head dim is a template
//   constant, so the loops over d unroll and every index is a shift.  The
//   fp32 entry takes the same split, staging and combine with fp32 FMAs on
//   the CUDA cores and the online-softmax state in shared memory.
// - Combine pass, grid (H, B): each split writes its running maximum m, sum
//   l and unnormalised fp32 accumulator (dv) per query head to scratch that
//   the caller allocates; an empty slice writes m = -inf, l = 0 and a zero
//   accumulator.  The combine kernel rescales the S partials to their common
//   maximum, a batch of splits' loads in flight at once, and writes out (0
//   where every l is 0).  With S = 1 the split pass writes out itself.
//
// The table's entries are trusted to be < NB (the engine builds them); no
// bounds check is made on the device.  The host entries set each kernel's
// dynamic-shared-memory limit once, to the largest size it has been given,
// and return every launch's cudaGetLastError().
#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                 // query heads a CTA, the mma's M
constexpr int kMaxS = 256;                // splits a row (kernel.py caps S)
constexpr int kMaxDvMma = 256;            // dv columns the mma path holds
constexpr size_t kSmemLimit = 232448;     // sm_90: 227 KB a block, opt-in
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Shape {
  int B, H, KH, NB, blk, dk, dv, window, S, HC, stages;
  float scale;
};

__host__ __device__ inline int padded_row(int d, int elem_bytes) {
  return ((d * elem_bytes / 16) | 1) * 16 / elem_bytes;
}

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// What one CTA works on, and where its shared memory lies.
template <typename T>
struct Cta {
  const Shape& s;
  int b, kh, split, g0, Gc;           // query heads kh * G + g0 + [0, Gc)
  int lo, hi;                         // live positions of the row
  int t_begin, t_end;                 // this slice's tiles (index = pos / R)
  int row_k, row_v;                   // padded shared-memory rows, elements
  T* stage0;                          // stages x R x (row_k + row_v)
  unsigned char* rest;                // after the stages
};

// Shared bytes of the ring of stages.
template <typename T>
__host__ __device__ inline size_t stage_bytes(int R, int dk, int dv) {
  return sizeof(T) * (size_t)R *
         (padded_row(dk, sizeof(T)) + padded_row(dv, sizeof(T)));
}

// ------------------------------------------------ bf16: mma.sync products

template <int R>
struct MmaPath {
  using T = __nv_bfloat16;
  static constexpr int kNT = R / 8;                       // score n-tiles
  static constexpr int kNTW = (kNT + kWarps - 1) / kWarps;  // ... a warp
  static constexpr int kGroups = kMaxDvMma / 16 / kWarps;   // dv/16 a warp
  static constexpr int kPRow = R + 8;                     // odd 16-B units

  // Shared memory after the stages: q (16 x row_k bf16), P (16 x kPRow
  // bf16), and two 4 x 16 float tables for the row maxima and sums.
  __host__ __device__ static size_t rest_bytes(int dk, int dv) {
    return sizeof(T) * ((size_t)kRows * padded_row(dk, 2) + kRows * kPRow) +
           sizeof(float) * 2 * kWarps * kRows;
  }

  const Cta<T>& c;
  T* q_s;
  T* p_s;
  float* red_max;                   // [warp][row]
  float* red_l;                     // [warp][row]
  int warp, lane, g, t;             // fragment row g (and g + 8), column 2t
  float m_run[2], l_part[2];        // rows g, g + 8
  float acc[kGroups][2][4];         // dv columns 16 (warp + 4 i) + 8 j

  __device__ MmaPath(const Cta<T>& cta) : c(cta) {
    q_s = reinterpret_cast<T*>(c.rest);
    p_s = q_s + kRows * c.row_k;
    red_max = reinterpret_cast<float*>(p_s + kRows * kPRow);
    red_l = red_max + kWarps * kRows;
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    g = lane / 4;
    t = lane % 4;
    for (int r = 0; r < 2; ++r) {
      m_run[r] = neg_inf();
      l_part[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // q rows g0 .. g0 + Gc of this kv-head, zero rows up to 16.
  __device__ void load_q(const T* q) {
    const Shape& s = c.s;
    const int per_row = s.dk / 8;
    const T* qb = q + ((size_t)c.b * s.H + (size_t)c.kh * (s.H / s.KH) +
                       c.g0) * s.dk;
    for (int i = threadIdx.x; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row, col = (i % per_row) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < c.Gc) v = *reinterpret_cast<const uint4*>(qb + r * s.dk + col);
      *reinterpret_cast<uint4*>(q_s + r * c.row_k + col) = v;
    }
  }

  __device__ void tile(const T* kt, const T* vt, int start) {
    const Shape& s = c.s;
    // Scores: n-tiles warp, warp + 4, ... of the tile's R positions.
    float sc[kNTW][4];
#pragma unroll
    for (int i = 0; i < kNTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
    for (int kk = 0; kk < s.dk / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, q_s + (lane % 16) * c.row_k + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < kNTW; ++i) {
        const int j = warp + kWarps * i;
        if (j < kNT) {
          uint32_t bk[2];
          ldmatrix_x2(bk, kt + (j * 8 + lane % 8) * c.row_k + kk * 16 +
                              ((lane / 8) % 2) * 8);
          mma_bf16(sc[i], a, bk[0], bk[1]);
        }
      }
    }
    // Mask by position, and this warp's row maxima.  Scores are kept in
    // log2 units (scale * log2 e), so the weights are exp2 of differences.
    const float scale2 = s.scale * kLog2e;
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      const int j = warp + kWarps * i;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = start + j * 8 + 2 * t + (e & 1);
        const bool live = j < kNT && pos >= c.lo && pos < c.hi;
        sc[i][e] = live ? sc[i][e] * scale2 : neg_inf();
        mx[e / 2] = fmaxf(mx[e / 2], sc[i][e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], 2));
    }
    if (t == 0) {
      red_max[warp * kRows + g] = mx[0];
      red_max[warp * kRows + g + 8] = mx[1];
    }
    __syncthreads();
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = m_run[r];
      for (int w = 0; w < kWarps; ++w)
        m = fmaxf(m, red_max[w * kRows + g + 8 * r]);
      // Every tile of a slice holds a live position, so m is finite; the
      // guard keeps exp(-inf - -inf) out regardless.
      m_use[r] = m == neg_inf() ? 0.f : m;
      alpha[r] = exp2f(m_run[r] - m_use[r]);      // 0 on the first tile
      m_run[r] = m;
      l_part[r] *= alpha[r];
    }
    // Weights, rounded to bf16 into P; the sums add the rounded weights.
#pragma unroll
    for (int i = 0; i < kNTW; ++i) {
      const int j = warp + kWarps * i;
      if (j < kNT) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t w = pack_bf16(exp2f(sc[i][2 * r] - m_use[r]),
                                       exp2f(sc[i][2 * r + 1] - m_use[r]));
          const __nv_bfloat162 wb = *reinterpret_cast<const __nv_bfloat162*>(&w);
          l_part[r] += __low2float(wb) + __high2float(wb);
          *reinterpret_cast<uint32_t*>(p_s + (g + 8 * r) * kPRow + j * 8 +
                                       2 * t) = w;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha[e / 2];
    __syncthreads();
    // P . V: dv columns in groups of 16, group warp + 4 i for this warp.
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, p_s + (lane % 16) * kPRow + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int grp = warp + kWarps * i;
        if (grp < s.dv / 16) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vt + (kk * 16 + lane % 16) * c.row_v +
                                    grp * 16 + (lane / 16) * 8);
          mma_bf16(acc[i][0], a, bv[0], bv[1]);
          mma_bf16(acc[i][1], a, bv[2], bv[3]);
        }
      }
    }
  }

  // Sum l over the warps, then write (m, l, acc) to the partials, or out
  // itself when there is one split.
  __device__ void finish(T* out, float* part_ml, float* part_acc) {
    const Shape& s = c.s;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_part[r] += __shfl_xor_sync(~0u, l_part[r], 1);
      l_part[r] += __shfl_xor_sync(~0u, l_part[r], 2);
    }
    if (t == 0) {
      red_l[warp * kRows + g] = l_part[0];
      red_l[warp * kRows + g + 8] = l_part[1];
    }
    __syncthreads();
    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = 0.f;
      for (int w = 0; w < kWarps; ++w) l[r] += red_l[w * kRows + g + 8 * r];
    }
    const int h0 = c.kh * (s.H / s.KH) + c.g0;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= c.Gc) continue;
      const size_t bh = (size_t)c.b * s.H + h0 + row;
      if (s.S > 1 && warp == 0 && t == 0) {
        part_ml[2 * (bh * s.S + c.split)] = m_run[r] * kLn2;
        part_ml[2 * (bh * s.S + c.split) + 1] = l[r];
      }
      const float inv = 1.f / l[r];
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int grp = warp + kWarps * i;
        if (grp >= s.dv / 16) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = grp * 16 + j * 8 + 2 * t;
          const float x = acc[i][j][2 * r], y = acc[i][j][2 * r + 1];
          if (s.S > 1) {
            *reinterpret_cast<float2*>(
                part_acc + (bh * s.S + c.split) * s.dv + col) =
                make_float2(x, y);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out + bh * s.dv + col) =
                __floats2bfloat162_rn(x * inv, y * inv);
          }
        }
      }
    }
  }
};

// ------------------------------------------------ fp32: CUDA-core FMAs

template <int R>
struct FmaPath {
  using T = float;

  // Shared memory after the stages: q (16 x dk), scores then weights
  // (16 x R), the accumulator (16 x dv), and m, l, alpha (16 each).
  __host__ __device__ static size_t rest_bytes(int dk, int dv) {
    return sizeof(float) * ((size_t)kRows * (dk + R + dv) + 4 * kRows);
  }

  const Cta<T>& c;
  float *q_s, *p_s, *acc, *m_s, *l_s, *alpha_s;

  __device__ FmaPath(const Cta<T>& cta) : c(cta) {
    q_s = reinterpret_cast<float*>(c.rest);
    p_s = q_s + kRows * c.s.dk;
    acc = p_s + kRows * R;
    m_s = acc + kRows * c.s.dv;
    l_s = m_s + kRows;
    alpha_s = l_s + kRows;
    for (int i = threadIdx.x; i < c.Gc * c.s.dv; i += kThreads) acc[i] = 0.f;
    for (int gq = threadIdx.x; gq < kRows; gq += kThreads) {
      m_s[gq] = neg_inf();
      l_s[gq] = 0.f;
    }
  }

  __device__ void load_q(const T* q) {
    const Shape& s = c.s;
    const T* qb = q + ((size_t)c.b * s.H + (size_t)c.kh * (s.H / s.KH) +
                       c.g0) * s.dk;
    for (int i = threadIdx.x; i < c.Gc * s.dk; i += kThreads) q_s[i] = qb[i];
  }

  __device__ void tile(const T* kt, const T* vt, int start) {
    const Shape& s = c.s;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = threadIdx.x; i < c.Gc * R; i += kThreads) {
      const int gq = i / R, r = i % R, pos = start + r;
      float sc = neg_inf();
      if (pos >= c.lo && pos < c.hi) {
        const float* kr = kt + r * c.row_k;
        const float* qg = q_s + gq * s.dk;
        float dot = 0.f;
        for (int d = 0; d < s.dk; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          dot = fmaf(qg[d], k4.x, dot);
          dot = fmaf(qg[d + 1], k4.y, dot);
          dot = fmaf(qg[d + 2], k4.z, dot);
          dot = fmaf(qg[d + 3], k4.w, dot);
        }
        sc = dot * s.scale;
      }
      p_s[i] = sc;
    }
    __syncthreads();
    for (int gq = warp; gq < c.Gc; gq += kWarps) {
      float* pg = p_s + gq * R;
      float mx = neg_inf();
      for (int r = lane; r < R; r += 32) mx = fmaxf(mx, pg[r]);
      const float m_old = m_s[gq];
      const float m_new = fmaxf(m_old, warp_max(mx));
      const float m_use = m_new == neg_inf() ? 0.f : m_new;
      float sum = 0.f;
      for (int r = lane; r < R; r += 32) {
        const float p = expf(pg[r] - m_use);      // 0 where masked
        pg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_use);  // 0 on the first tile
        alpha_s[gq] = alpha;
        l_s[gq] = l_s[gq] * alpha + sum;
        m_s[gq] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < c.Gc * s.dv; i += kThreads) {
      const int gq = i / s.dv, d = i % s.dv;
      const float* pg = p_s + gq * R;
      float a = acc[i] * alpha_s[gq];
      for (int r = 0; r < R; ++r) a = fmaf(pg[r], vt[r * c.row_v + d], a);
      acc[i] = a;
    }
  }

  __device__ void finish(T* out, float* part_ml, float* part_acc) {
    const Shape& s = c.s;
    __syncthreads();
    const size_t bh0 = (size_t)c.b * s.H + c.kh * (s.H / s.KH) + c.g0;
    for (int i = threadIdx.x; i < c.Gc * s.dv; i += kThreads) {
      const int gq = i / s.dv, d = i % s.dv;
      const size_t bh = bh0 + gq;
      if (s.S > 1)
        part_acc[(bh * s.S + c.split) * s.dv + d] = acc[i];
      else
        out[bh * s.dv + d] = acc[i] / l_s[gq];
    }
    if (s.S > 1)
      for (int gq = threadIdx.x; gq < c.Gc; gq += kThreads) {
        part_ml[2 * ((bh0 + gq) * s.S + c.split)] = m_s[gq];
        part_ml[2 * ((bh0 + gq) * s.S + c.split) + 1] = l_s[gq];
      }
  }
};

template <typename T, int R>
using PathOf = typename std::conditional<std::is_same<T, float>::value,
                                         FmaPath<R>, MmaPath<R>>::type;

// Head dims fixed at compile time (D > 0, dk = dv = D) for the main decode
// shapes, so the loops over d unroll and every index is a shift; D = 0 takes
// them from the shape.
template <int D>
__device__ __forceinline__ Shape with_dims(Shape s) {
  if (D > 0) s.dk = s.dv = D;
  return s;
}

// ------------------------------------------------------------- split pass

// Copy the R rows of one tile, row r from src + r * KH * d elements into
// dst + r * row, 16 bytes a copy; rows at positions outside [lo, hi) are
// zero-filled and not read.  Each thread keeps one 16-byte column and walks
// the rows with a fixed stride where the row's units divide the block.
template <typename T, int R>
__device__ __forceinline__ void stage_rows(T* dst, int row, const T* src,
                                           int KH, int d, int start, int lo,
                                           int hi) {
  constexpr int kVec = 16 / sizeof(T);
  const int per = d / kVec;               // 16-byte units a row
  const size_t stride = (size_t)KH * d;
  if (kThreads % per == 0) {
    const int step = kThreads / per;
    int r = threadIdx.x / per;
    const int col = (threadIdx.x % per) * kVec;
    const T* sp = src + r * stride + col;
    T* dp = dst + r * row + col;
    for (; r < R; r += step, sp += step * stride, dp += step * row) {
      const bool live = start + r >= lo && start + r < hi;
      cp_async16(dp, live ? sp : src, live);
    }
  } else {
    for (int i = threadIdx.x; i < R * per; i += kThreads) {
      const int r = i / per, col = (i % per) * kVec;
      const bool live = start + r >= lo && start + r < hi;
      cp_async16(dst + r * row + col, live ? src + r * stride + col : src,
                 live);
    }
  }
}

// The same copies for a tile that may span KV blocks (R does not divide
// blk): the tile's rows fall in runs of at most blk rows, one run a block,
// and each live row takes its block from the slice's table entries
// (blocks[j - j0] holds table entry j).
template <typename T, int R>
__device__ __forceinline__ void stage_rows_span(
    T* dst, int row, const T* arena, const int* blocks, int j0,
    const Shape& s, int b, int kh, int d, int start, int lo, int hi) {
  constexpr int kVec = 16 / sizeof(T);
  const int per = d / kVec;               // 16-byte units a row
  for (int i = threadIdx.x; i < R * per; i += kThreads) {
    const int r = i / per, col = (i % per) * kVec, pos = start + r;
    const bool live = pos >= lo && pos < hi;
    const T* src = arena;
    if (live) {
      const int j = pos / s.blk;
      const size_t row0 =
          (((size_t)b * s.NB + blocks[j - j0]) * s.blk + (pos - j * s.blk)) *
              s.KH + kh;
      src = arena + row0 * d + col;
    }
    cp_async16(dst + r * row + col, src, live);
  }
}

template <typename T, int R, int D, bool kSpan>
__global__ void __launch_bounds__(kThreads)
    tide_split_kernel(const T* __restrict__ q, const T* __restrict__ arena_k,
                      const T* __restrict__ arena_v,
                      const int32_t* __restrict__ table,
                      const int32_t* __restrict__ seq_lens,
                      const int32_t* __restrict__ first_live,
                      T* __restrict__ out, float* __restrict__ part_ml,
                      float* __restrict__ part_acc, Shape shape) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shape s = with_dims<D>(shape);
  const int G = s.H / s.KH;
  Cta<T> c{s};
  c.split = blockIdx.x;
  c.kh = blockIdx.y / s.HC;
  c.g0 = (blockIdx.y % s.HC) * kRows;
  c.Gc = min(kRows, G - c.g0);
  c.b = blockIdx.z;
  c.row_k = padded_row(s.dk, sizeof(T));
  c.row_v = padded_row(s.dv, sizeof(T));

  // Live positions [lo, hi) of the row, its tiles, and this slice of them.
  const int seq_len = seq_lens[c.b];
  c.lo = max(first_live[c.b], 0);
  if (s.window > 0) c.lo = max(c.lo, seq_len - s.window);
  c.hi = min(seq_len, s.NB * s.blk);
  const int t0 = c.lo / R;
  const int n = c.lo < c.hi ? (c.hi + R - 1) / R - t0 : 0;
  c.t_begin = t0 + (int)((long long)c.split * n / s.S);
  c.t_end = t0 + (int)((long long)(c.split + 1) * n / s.S);

  const size_t bh0 = (size_t)c.b * s.H + (size_t)c.kh * G + c.g0;
  if (c.t_begin >= c.t_end) {             // an empty slice
    if (s.S > 1) {
      for (int gq = threadIdx.x; gq < c.Gc; gq += kThreads) {
        part_ml[2 * ((bh0 + gq) * s.S + c.split)] = neg_inf();
        part_ml[2 * ((bh0 + gq) * s.S + c.split) + 1] = 0.f;
      }
      // A zero accumulator, so the combine sums every split unguarded.
      for (int i = threadIdx.x; i < c.Gc * s.dv; i += kThreads)
        part_acc[((bh0 + i / s.dv) * s.S + c.split) * s.dv + i % s.dv] = 0.f;
    } else {
      for (int i = threadIdx.x; i < c.Gc * s.dv; i += kThreads)
        out[bh0 * s.dv + i] = T(0.f);
    }
    return;
  }

  const size_t stage_elems = (size_t)R * (c.row_k + c.row_v);
  c.stage0 = reinterpret_cast<T*>(smem);
  c.rest = smem + s.stages * stage_elems * sizeof(T);
  using Path = PathOf<T, R>;
  int* blocks = reinterpret_cast<int*>(
      c.rest + ((Path::rest_bytes(s.dk, s.dv) + 15) / 16) * 16);
  // The table entries of the slice's tiles.  A last tile that spans past
  // the arena's end (R does not divide NB * blk) holds no live row there.
  const int j0 = c.t_begin * R / s.blk;
  const int j1 = min((c.t_end * R - 1) / s.blk, s.NB - 1);
  for (int j = j0 + threadIdx.x; j <= j1; j += kThreads)
    blocks[j - j0] = table[(size_t)c.b * s.NB + j];
  Path path(c);
  path.load_q(q);
  __syncthreads();                        // block ids, q and state set

  // The next tile to stage: its index, stage slot, and logical block and
  // offset in it, advanced without a division where a tile lies in one
  // block (kSpan false: R divides blk).
  int ti_next = c.t_begin, slot_next = 0, j_next = j0;
  int off_next = c.t_begin * R - j0 * s.blk;
  auto issue = [&]() {
    if (ti_next < c.t_end) {
      T* kt = c.stage0 + slot_next * stage_elems;
      T* vt = kt + (size_t)R * c.row_k;
      if constexpr (!kSpan) {
        const int phys = blocks[j_next - j0];
        const size_t row0 =
            (((size_t)c.b * s.NB + phys) * s.blk + off_next) * s.KH + c.kh;
        stage_rows<T, R>(kt, c.row_k, arena_k + row0 * s.dk, s.KH, s.dk,
                         ti_next * R, c.lo, c.hi);
        stage_rows<T, R>(vt, c.row_v, arena_v + row0 * s.dv, s.KH, s.dv,
                         ti_next * R, c.lo, c.hi);
        off_next += R;
        if (off_next == s.blk) {
          off_next = 0;
          ++j_next;
        }
      } else {
        stage_rows_span<T, R>(kt, c.row_k, arena_k, blocks, j0, s, c.b, c.kh,
                              s.dk, ti_next * R, c.lo, c.hi);
        stage_rows_span<T, R>(vt, c.row_v, arena_v, blocks, j0, s, c.b, c.kh,
                              s.dv, ti_next * R, c.lo, c.hi);
      }
      ++ti_next;
      slot_next = slot_next + 1 == s.stages ? 0 : slot_next + 1;
    }
    cp_async_commit();                    // an empty group past the end
  };

  for (int i = 0; i < s.stages - 1; ++i) issue();
  int slot = 0;
  for (int ti = c.t_begin; ti < c.t_end; ++ti) {
    if (s.stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    // Tile ti has landed for every thread, and every thread is done with
    // tile ti - 1, whose stage the next issue refills.
    __syncthreads();
    issue();
    const T* kt = c.stage0 + slot * stage_elems;
    path.tile(kt, kt + (size_t)R * c.row_k, ti * R);
    slot = slot + 1 == s.stages ? 0 : slot + 1;
  }
  path.finish(out, part_ml, part_acc);
}

// ----------------------------------------------------------- combine pass

constexpr int kCombineThreads = 256;
constexpr int kCombineBatch = 8;          // splits whose loads fly together

// One CTA a (b, h): the S partials' weights in shared memory, then each
// thread sums one output column over the splits, a batch of splits' loads
// in flight at once.  An empty split has weight 0 and a zero accumulator.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    tide_combine_kernel(const float* __restrict__ part_ml,
                        const float* __restrict__ part_acc,
                        T* __restrict__ out, int H, int S, int dv) {
  __shared__ float m_s[kMaxS], l_s[kMaxS], w_s[kMaxS];
  const size_t bh = (size_t)blockIdx.y * H + blockIdx.x;
  for (int i = threadIdx.x; i < S; i += kCombineThreads) {
    m_s[i] = part_ml[2 * (bh * S + i)];
    l_s[i] = part_ml[2 * (bh * S + i) + 1];
  }
  __syncthreads();
  float m = neg_inf(), l = 0.f;
  for (int i = 0; i < S; ++i)
    if (l_s[i] > 0.f) m = fmaxf(m, m_s[i]);
  for (int i = 0; i < S; ++i)
    if (l_s[i] > 0.f) l += l_s[i] * expf(m_s[i] - m);
  for (int i = threadIdx.x; i < S; i += kCombineThreads)
    w_s[i] = l_s[i] > 0.f ? expf(m_s[i] - m) / l : 0.f;
  __syncthreads();
  const float* acc = part_acc + bh * S * dv;
  for (int d = threadIdx.x; d < dv; d += kCombineThreads) {
    float a = 0.f;
    int i = 0;
    for (; i + kCombineBatch <= S; i += kCombineBatch) {
      float x[kCombineBatch];
#pragma unroll
      for (int j = 0; j < kCombineBatch; ++j)
        x[j] = acc[(size_t)(i + j) * dv + d];
#pragma unroll
      for (int j = 0; j < kCombineBatch; ++j) a = fmaf(w_s[i + j], x[j], a);
    }
    for (; i < S; ++i) a = fmaf(w_s[i], acc[(size_t)i * dv + d], a);
    out[bh * dv + d] = T(a);
  }
}

// Raise the split kernel's dynamic-shared-memory limit to `bytes`, once per
// size above the largest it has been given on this device.
template <typename T, int R, int D, bool kSpan>
cudaError_t allow_smem(size_t bytes) {
  static std::atomic<int> granted[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if ((int)bytes <= granted[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(tide_split_kernel<T, R, D, kSpan>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) granted[dev].store(static_cast<int>(bytes));
  return err;
}

template <typename T, int R, int D, bool kSpan>
int launch_r(const void* q, const void* arena_k, const void* arena_v,
             const void* table, const void* seq_lens, const void* first_live,
             void* out, void* part_ml, void* part_acc, Shape s,
             cudaStream_t stream) {
  using Path = PathOf<T, R>;
  const size_t fixed = ((Path::rest_bytes(s.dk, s.dv) + 15) / 16) * 16 +
                       sizeof(int) * (size_t)s.NB;
  const size_t stage = stage_bytes<T>(R, s.dk, s.dv);
  s.stages = fixed + 3 * stage <= kSmemLimit ? 3 : 2;
  const size_t smem = fixed + s.stages * stage;
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem<T, R, D, kSpan>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tide_split_kernel<T, R, D, kSpan><<<dim3(s.S, s.KH * s.HC, s.B), kThreads,
                                      smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(arena_k),
      static_cast<const T*>(arena_v), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(seq_lens),
      static_cast<const int32_t*>(first_live), static_cast<T*>(out),
      static_cast<float*>(part_ml), static_cast<float*>(part_acc), s);
  err = cudaGetLastError();
  if (err != cudaSuccess || s.S == 1) return static_cast<int>(err);
  tide_combine_kernel<T><<<dim3(s.H, s.B), kCombineThreads, 0, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), s.H, s.S, s.dv);
  return static_cast<int>(cudaGetLastError());
}

// Tiles of R positions with runtime head dims: the spanning copies where R
// does not divide blk.
template <typename T, int R>
int launch_tile(bool span, const void* q, const void* arena_k,
                const void* arena_v, const void* table, const void* seq_lens,
                const void* first_live, void* out, void* part_ml,
                void* part_acc, const Shape& s, cudaStream_t st) {
  return span ? launch_r<T, R, 0, true>(q, arena_k, arena_v, table, seq_lens,
                                        first_live, out, part_ml, part_acc, s,
                                        st)
              : launch_r<T, R, 0, false>(q, arena_k, arena_v, table,
                                         seq_lens, first_live, out, part_ml,
                                         part_acc, s, st);
}

template <typename T>
int launch(const void* q, const void* arena_k, const void* arena_v,
           const void* table, const void* seq_lens, const void* first_live,
           void* out, void* part_ml, void* part_acc, int B, int H, int KH,
           int NB, int blk, int dk, int dv, int window, int S, int R,
           float scale, void* stream) {
  constexpr bool mma = std::is_same<T, __nv_bfloat16>::value;
  const int unit = mma ? 16 : 4;
  if (B <= 0 || KH <= 0 || H % KH != 0 || NB <= 0 || dk % unit != 0 ||
      dv % unit != 0 || (mma && dv > kMaxDvMma) || S < 1 || S > kMaxS ||
      blk <= 0 || (S > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / KH;
  const Shape s{B, H, KH, NB, blk, dk, dv, window, S,
                (G + kRows - 1) / kRows, 0, scale};
  const auto st = static_cast<cudaStream_t>(stream);
  const bool span = blk % R != 0;         // a tile may straddle KV blocks
  if constexpr (mma) {                    // the main decode shapes
    if (!span && R == 64 && dk == dv && dk == 128)
      return launch_r<T, 64, 128, false>(q, arena_k, arena_v, table,
                                         seq_lens, first_live, out, part_ml,
                                         part_acc, s, st);
    if (!span && R == 64 && dk == dv && dk == 256)
      return launch_r<T, 64, 256, false>(q, arena_k, arena_v, table,
                                         seq_lens, first_live, out, part_ml,
                                         part_acc, s, st);
  }
  switch (R) {
    case 64:
      return launch_tile<T, 64>(span, q, arena_k, arena_v, table, seq_lens,
                                first_live, out, part_ml, part_acc, s, st);
    case 32:
      return launch_tile<T, 32>(span, q, arena_k, arena_v, table, seq_lens,
                                first_live, out, part_ml, part_acc, s, st);
    case 16:
      return launch_tile<T, 16>(span, q, arena_k, arena_v, table, seq_lens,
                                first_live, out, part_ml, part_acc, s, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B,H,dk), arena_k (B,NB,blk,KH,dk), arena_v (B,NB,blk,KH,dv), out
// (B,H,dv): contiguous, 16-byte aligned; table (B,NB), seq_lens and
// first_live (B,): int32.  S splits of R-position tiles (R in {16, 32, 64},
// any blk); with S > 1, part_ml (B,H,S,2) and part_acc (B,H,S,dv) are
// fp32 scratch, else they may be null.
int tide_attention_bf16(const void* q, const void* arena_k,
                        const void* arena_v, const void* table,
                        const void* seq_lens, const void* first_live,
                        void* out, void* part_ml, void* part_acc, int B,
                        int H, int KH, int NB, int blk, int dk, int dv,
                        int window, int S, int R, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, arena_k, arena_v, table, seq_lens,
                               first_live, out, part_ml, part_acc, B, H, KH,
                               NB, blk, dk, dv, window, S, R, scale, stream);
}

int tide_attention_f32(const void* q, const void* arena_k, const void* arena_v,
                       const void* table, const void* seq_lens,
                       const void* first_live, void* out, void* part_ml,
                       void* part_acc, int B, int H, int KH, int NB, int blk,
                       int dk, int dv, int window, int S, int R, float scale,
                       void* stream) {
  return launch<float>(q, arena_k, arena_v, table, seq_lens, first_live, out,
                       part_ml, part_acc, B, H, KH, NB, blk, dk, dv, window,
                       S, R, scale, stream);
}

}  // extern "C"
