// Device code shared by the two Weiszfeld-step kernels
// (weiszfeld_step.cu and aircomp_weiszfeld_step.cu).
//
// One Weiszfeld step over a [K, d] client stack w and a guess g [d] is ONE
// cooperative launch of step_kernel, in one of two modes:
//   num/den mode  writes num [d] and den [], the TPU kernels' contract;
//   fused mode    also applies the guess update of the Weiszfeld loop:
//                   gm2: g_next = num / den
//                   gm:  n = noise_scale * z;  g_next = (num + n[:d]) / (den + n[d]) * s
//                 movement = ||g_in - g_next||, g_out = active ? g_next : g_in,
//                 steps += active, active &= movement > tol, and for gm the
//                 next step's scaler s = sqrt(mean(g_out^2)).  g_out is a
//                 separate buffer (other blocks still read g_in); an inactive
//                 step copies g_in to g_out bit for bit and skips the rest.
//
// Layout.  The grid is one block of 512 threads per SM.  Block b owns a
// rectangle of the stack: the rows of row slice s = b / C and the columns
// of column tile c = b % C (S slices x C tiles <= grid).  Each thread owns
// 8 fixed column pairs of the tile (tid + 512 m, m < 8: up to 8192
// columns), and keeps the guess, its accumulator and the current group of
// up to 4 rows in registers: a row is read from device memory once,
// straight into the registers that use it, with coalesced loads (a warp
// reads 256 neighbouring bytes of a row per load).  A pair is one 8-byte
// (f32) or 4-byte (bf16) load where the row allows it and two scalar loads
// where it does not: with d = 7850 every row start is 8-byte aligned, but
// every odd row starts 8 bytes off a 16-byte boundary (a bf16 row 4, 8 or
// 12 bytes off), so 16-byte loads would need a per-row head peel that
// breaks the fixed column ownership.  (A first version staged rows in
// shared memory with cp.async; on an H100 it measured slower than this
// layout at both main-path shapes, its per-row index arithmetic and its
// peeled head and tail costing more than the copy: PERF.md.)
// The block reduces each row's ||w_i - g||^2 (and ||w_i||^2, and the
// all-finite flag) over its columns, and then:
//   C == 1  the block holds whole rows, so it turns them into row weights
//           at once and adds coeff_i * w_i into its accumulators while the
//           rows are still in registers;
//   C  > 1  rows are split across blocks: the partials go per (row, tile)
//           to the workspace, a grid barrier, then each block combines its
//           rows' C partials in tile order and accumulates the same way
//           (from the registers when the slice is one group of rows, else
//           by a second read, which hits L2).
// Splitting rows halves a block's row at K=50 but adds a grid barrier: on
// an H100 a fused step took 13.3-13.9 us there with 2 or 3 tiles against
// 11.7-12.1 us with 1 (and about 2x as long at K=1000; PERF.md), so the
// tiling follows from d alone: rows split only where they are wider than
// 8192 columns.
// Each slice writes its accumulator [tile] and its sum of weights to the
// workspace; a grid barrier; then every block takes d / grid columns, sums
// the S partials of each column in slice order (interleaved lanes per
// column, met in a fixed order) and den in slice order, and writes num or
// the updated guess.  In fused mode each block's partial movement^2 and
// g_out^2 go to the workspace, and the last block to take the integer
// ticket (__threadfence, then atomicAdd on an int, which that block resets
// to 0 so a CUDA-graph replay starts clean) adds them in block order and
// writes active, steps and the scaler.  No float atomics anywhere, and
// every sum runs in a fixed order, so a rerun gives the same bits and the
// Weiszfeld stopping step is reproducible.
//
// Why a cooperative launch: the step has two all-to-all dependencies (a row
// weight needs the whole row; a column's num needs every row weight), and a
// last-block ticket alone would hand the whole column pass to one block.
// A cooperative launch guarantees every block is resident, so a grid
// barrier is legal, and it keeps the step at one launch.
//
// One stream per workspace.  The caller keeps one workspace (ticket and
// partials) per device and shape and passes it to every step of that
// shape, of both kernels.  Steps that share a workspace must run one after
// another, as the steps issued on one stream (or replayed from one CUDA
// graph) do: two steps running at the same time on two streams would mix
// their partials and their ticket, with no error.
//
// The wide plan.  The layout above needs every column tile of a row on a
// block of its own, so it holds while C = ceil(d / 8192) <= SMs (d up to
// 1,081,344 on an H100 SXM's 132 SMs).  Past that (the MNIST CNN's
// d = 3,274,634, ResNet-18's 11,173,962) wide_kernel takes the step, still
// one cooperative launch of one 512-thread block per SM, in three passes:
//   1. each block walks the column tiles b, b + G, ... (C is rounded up to
//      a multiple of the grid, so every block gets the same number of
//      tiles), reads each tile's rows in groups of kRows and writes each
//      (row, tile) partial ||w_i - g||^2, ||w_i||^2 and finite flag to the
//      workspace;
//   2. after a grid barrier one warp per row sums the row's C partials
//      (lane l takes tiles l, l + 32, ..., then the xor butterfly) and
//      writes its weight;
//   3. after a second barrier every block sums the K weights into den (the
//      same order in every block), reads its tiles' rows a second time and
//      takes num = sum_i coeff_i w_i per column in row order, skipping rows
//      of weight 0, then writes num or the updated guess.
// Nothing of the stack stays on chip between the distances and the
// weighted sum: a [K, d] stack of hundreds of MB is far past L2 (50 MB) and
// shared memory (132 x 227 KB), and no column's num can start before every
// row's weight is known, so two reads of the stack are the least traffic
// there.  The workspace is K x C partials (12 bytes each) and K weights,
// not S x d slice sums; the sums run in fixed orders with no float atomics,
// as in the one-pass plan.
//
// Bound on an H100: a step must read the stack once (K*d*bytes(dtype)),
// plus g_in, z and the fades, and write g_out (or num): bound by bytes at
// 3.35 TB/s (0.47 us at K=50, 9.4 us at K=1000, d=7850, f32).  The stack is
// read from device memory once at both sizes: each group of rows stays in
// registers between the distance and the weighted sum (at K=1000 the
// 31.4 MB stack is more than the 132 SMs' 227 KB of shared memory each,
// but a block holds only the rows of its group).  The S x d slice partials
// (4.1 MB each way at S = 132) go through L2.  What is left is latency:
// the launch, the grid barriers (one when C == 1) and the ticket.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace weiszfeld {

namespace cg = cooperative_groups;

// the reference's divide-by-zero guard (MNIST_Air_weight.py:151,:178) and
// the gm power-control threshold factor (:152)
constexpr float kDistClamp = 1e-4f;
constexpr float kThresholdFactor = 500.0f;
// |h|^2 floor of the fades (channel.HSQ_FLOOR)
constexpr float kHsqFloor = 1e-6f;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 8;                  // column pairs per thread
constexpr int kCols = 2 * kPairs;          // columns per thread
constexpr long long kTileMax = static_cast<long long>(kCols) * kThreads;
constexpr int kRows = 4;                   // rows per group in registers
constexpr int kBatch = 8;                  // partial sums loaded together
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* w;
  long long k, d;
  const float* g_in;
  float* g_out;         // fused mode
  float* num;           // num/den mode
  float* den;           // num/den mode
  const float* h_sq;    // num/den mode, AirComp: floored |h|^2 [K]
  const float* h_r;     // fused mode, AirComp: fades before fade_scale [K]
  const float* h_i;
  float fade_scale;
  const float* z;       // fused mode, AirComp: receiver normals [d+1] or null
  float noise_scale;
  float* scaler;        // AirComp: [1], read; fused mode: also written
  float p_max;
  float tol;
  int* active;          // fused mode
  long long* steps;     // fused mode
  // tiling (see Plan)
  int S, C;
  // workspace
  int* ticket;
  float2* red;          // [grid] partial movement^2, g_out^2
  float* denpart;       // [S]
  float2* part;         // [K * C] partial ||w - g||^2, ||w||^2 (C > 1)
  int* part_fin;        // [K * C] (C > 1)
  float* numpart;       // [S * d]
  float* coeff;         // [K] row weights (wide plan)
};

// Columns j and j + 1 of a row (0 past its width n): one 8-byte (f32) or
// 4-byte (bf16) load when the row's start allows it (vec), else two.
__device__ __forceinline__ void load_pair(const float* __restrict__ src, bool vec,
                                          int j, int n, float& a, float& b) {
  if (vec && j + 1 < n) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(src + j));
    a = v.x;
    b = v.y;
  } else {
    a = j < n ? __ldg(src + j) : 0.0f;
    b = j + 1 < n ? __ldg(src + j + 1) : 0.0f;
  }
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* __restrict__ src, bool vec,
                                          int j, int n, float& a, float& b) {
  if (vec && j + 1 < n) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src + j);
    a = __low2float(v);
    b = __high2float(v);
  } else {
    a = j < n ? __bfloat162float(src[j]) : 0.0f;
    b = j + 1 < n ? __bfloat162float(src[j + 1]) : 0.0f;
  }
}

// This thread's columns of the n-wide row segment src, in pair order.
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ src, int n, float* x) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) % (2 * sizeof(T))) == 0;
#pragma unroll
  for (int m = 0; m < kPairs; ++m) {
    load_pair(src, vec, 2 * (static_cast<int>(threadIdx.x) + kThreads * m), n,
              x[2 * m], x[2 * m + 1]);
  }
}

// xor butterfly: every lane ends with the same bits (each level adds the
// same two values, and a + b == b + a)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// sum over i = first, first + stride, ... < n of src[i * pitch], in that
// order, with kBatch loads in flight
__device__ __forceinline__ float strided_sum(const float* src, long long pitch,
                                             int first, int stride, int n) {
  float acc = 0.0f;
  for (int i0 = first; i0 < n; i0 += kBatch * stride) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * stride;
      v[u] = i < n ? __ldcg(src + i * pitch) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u * stride < n) acc += v[u];
    }
  }
  return acc;
}

// The weight of row `row` from its full ||w_i - g||^2, ||w_i||^2 and
// all-finite flag.
//   ideal step (kAir = false):  inv_i = 1 / max(||w_i - g||, 1e-4)
//   AirComp step (kAir = true): OMA2 truncated channel inversion on the
//     message m_i = [w_i * inv_i, s * inv_i] (width d + 1):
//       p_i = inv_i^2 (||w_i||^2 + s^2) / (d + 1) / h_sq_i
//       coeff_i = inv_i * sqrt(p_max / max(p_i, 500 s^2))
// A row with any non-finite entry gets 0: it is a point at infinity and
// transmits nothing.  In fused mode h_sq_i is formed here from the draws,
// bitwise as channel.rayleigh_fade and channel.floored_hsq form it.  ha, hb
// are the row's h_sq and 0 (num/den mode) or its two draws (fused mode),
// loaded ahead by load_channel.
template <bool kAir>
__device__ __forceinline__ float row_coeff(const Params& p, float ha, float hb,
                                           float dsq, float nsq, int finite,
                                           float s) {
  if (!finite) return 0.0f;
  const float inv = 1.0f / fmaxf(sqrtf(dsq), kDistClamp);
  if (!kAir) return inv;
  float h_sq = ha;
  if (p.h_sq == nullptr) {
    const float hr = __fmul_rn(ha, p.fade_scale);
    const float hi = __fmul_rn(hb, p.fade_scale);
    h_sq = __fadd_rn(__fmul_rn(hr, hr), __fmul_rn(hi, hi));
    h_sq = h_sq < kHsqFloor ? kHsqFloor : h_sq;  // a NaN stays NaN, as clamp
  }
  float pm = inv * inv * (nsq + s * s) / static_cast<float>(p.d + 1);
  pm = pm / h_sq;
  const float gain = sqrtf(p.p_max / fmaxf(pm, kThresholdFactor * s * s));
  return gain * inv;
}

// The channel inputs of row `row` for row_coeff.
template <bool kAir>
__device__ __forceinline__ void load_channel(const Params& p, long long row, float& ha,
                                             float& hb) {
  ha = hb = 0.0f;
  if (!kAir) return;
  if (p.h_sq != nullptr) {
    ha = p.h_sq[row];
  } else {
    ha = p.h_r[row];
    hb = p.h_i[row];
  }
}

// The fused mode's new guess of one column from its num, den, the scaler
// and (gm with a noisy receiver) its normal zj and the den's normal zd,
// each op rounded as torch rounds it.
template <bool kAir>
__device__ __forceinline__ float next_guess(const Params& p, float num, float den,
                                            float s, float zj, float zd) {
  if (!kAir) return __fdiv_rn(num, den);
  if (p.z != nullptr) {
    num = __fadd_rn(num, __fmul_rn(p.noise_scale, zj));
    den = __fadd_rn(den, __fmul_rn(p.noise_scale, zd));
  }
  return __fmul_rn(__fdiv_rn(num, den), s);
}

// The fused mode's end of a step: the block's partial movement^2 and
// g_out^2 go to the workspace, and the last block to take the integer
// ticket adds them in block order and writes active, steps and the scaler.
template <bool kAir>
__device__ __forceinline__ void finish_fused(const Params& p, float mv, float sq) {
  __shared__ float2 s_part[kWarps];
  __shared__ int s_last;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long G = gridDim.x;
  mv = warp_sum(mv);
  sq = warp_sum(sq);
  if (lane == 0) s_part[warp] = make_float2(mv, sq);
  __syncthreads();
  if (tid == 0) {
    float m = 0.0f, q = 0.0f;
    for (int i = 0; i < kWarps; ++i) {
      m += s_part[i].x;
      q += s_part[i].y;
    }
    p.red[b] = make_float2(m, q);
    __threadfence();
    s_last = atomicAdd(p.ticket, 1) == static_cast<int>(G - 1);
  }
  __syncthreads();
  if (!s_last || warp != 0) return;
  __threadfence();
  float m = 0.0f, q = 0.0f;
  for (long long i = lane; i < G; i += 32) {
    const float2 v = __ldcg(p.red + i);
    m += v.x;
    q += v.y;
  }
  m = warp_sum(m);
  q = warp_sum(q);
  if (lane == 0) {
    const float movement = sqrtf(m);
    *p.steps += 1;
    *p.active = movement > p.tol ? 1 : 0;  // a NaN movement stops, as in torch
    if (kAir) *p.scaler = sqrtf(q / static_cast<float>(p.d));
    *p.ticket = 0;
  }
}

template <typename T, bool kAir, bool kFused>
__global__ void __launch_bounds__(kThreads, 1) step_kernel(const Params p) {
  __shared__ float s_red[kWarps][kRows][2];
  __shared__ int s_fin[kWarps][kRows];
  __shared__ float s_coeff[kRows];
  __shared__ float s_lanes[kThreads];
  __shared__ float s_den;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long G = gridDim.x;
  const long long k = p.k;
  const long long d = p.d;
  // the columns this block finishes after the last barrier
  const long long j0 = b * d / G;
  const long long j1 = (b + 1) * d / G;

  // the ticket's writer runs after every read of the scaler
  const float s = kAir ? *p.scaler : 0.0f;

  // -- rows: distances, weights, per-slice weighted column sums ------------
  const int S = p.S, C = p.C;
  const bool has_rows = b < static_cast<long long>(S) * C;
  const long long sl = b / C;
  const long long ct = b % C;
  const long long r0 = sl * k / S, r1 = (sl + 1) * k / S;
  const long long c0 = ct * d / C;
  const int W = static_cast<int>((ct + 1) * d / C - c0);  // <= kTileMax
  const T* w = static_cast<const T*>(p.w);
  float g[kCols], acc[kCols], x[kRows][kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    acc[e] = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[r][e] = 0.0f;
  }
  float den_slice = 0.0f;  // thread 0: the slice's weights, in row order

  // rows rg .. rg + nr - 1 of the tile into x
  auto load_group = [&](long long rg, int nr) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr) load_cols(w + (rg + r) * d + c0, W, x[r]);
    }
  };
  // acc += coeff_r * x[r] over the group's rows, in row order; a row with
  // weight 0 is skipped, so a non-finite row never reaches the sum
  auto accumulate = [&](int nr) {
    float c[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      c[r] = r < nr ? s_coeff[r] : 0.0f;
      if (tid == 0 && r < nr) den_slice += c[r];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nr && c[r] != 0.0f) {
#pragma unroll
        for (int e = 0; e < kCols; ++e) acc[e] = fmaf(c[r], x[r][e], acc[e]);
      }
    }
  };
  const long long ngroups = has_rows ? (r1 - r0 + kRows - 1) / kRows : 0;
  // thread r < nr: row r's channel inputs
  float ha = 0.0f, hb = 0.0f;

  // the first group's loads go out before the flag is read
  if (has_rows) {
    load_cols(p.g_in + c0, W, g);
    load_group(r0, static_cast<int>(min(static_cast<long long>(kRows), r1 - r0)));
    if (tid < min(static_cast<long long>(kRows), r1 - r0)) load_channel<kAir>(p, r0 + tid, ha, hb);
  }
  if (kFused && *reinterpret_cast<volatile int*>(p.active) == 0) {
    for (long long j = j0 + tid; j < j1; j += kThreads) p.g_out[j] = p.g_in[j];
    return;  // every block reads the same flag, so none waits at a barrier
  }
  cg::grid_group grid = cg::this_grid();

  if (has_rows) {
    for (long long rg = r0; rg < r1; rg += kRows) {
      const int nr = static_cast<int>(min(static_cast<long long>(kRows), r1 - rg));
      if (rg != r0) {
        load_group(rg, nr);
        if (tid < nr) load_channel<kAir>(p, rg + tid, ha, hb);
      }
      float dsq[kRows], nsq[kRows];
      int fin[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        dsq[r] = 0.0f;
        nsq[r] = 0.0f;
        fin[r] = 1;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float diff = x[r][e] - g[e];
          dsq[r] = fmaf(diff, diff, dsq[r]);
          if (kAir) nsq[r] = fmaf(x[r][e], x[r][e], nsq[r]);
          fin[r] &= isfinite(x[r][e]) ? 1 : 0;
        }
      }
      // deterministic block reduction: thread r ends with row r's totals
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nr) continue;  // nr is the same in every thread
        const float a = warp_sum(dsq[r]);
        const float q = kAir ? warp_sum(nsq[r]) : 0.0f;
        const int f = __all_sync(kFull, fin[r]);
        if (lane == 0) {
          s_red[warp][r][0] = a;
          s_red[warp][r][1] = q;
          s_fin[warp][r] = f;
        }
      }
      __syncthreads();
      if (tid < nr) {
        float a = 0.0f, q = 0.0f;
        int f = 1;
        for (int i = 0; i < kWarps; ++i) {
          a += s_red[i][tid][0];
          q += s_red[i][tid][1];
          f &= s_fin[i][tid];
        }
        const long long row = rg + tid;
        if (C == 1) {
          s_coeff[tid] = row_coeff<kAir>(p, ha, hb, a, q, f, s);
        } else {
          p.part[row * C + ct] = make_float2(a, q);
          p.part_fin[row * C + ct] = f;
        }
      }
      __syncthreads();
      if (C == 1) {
        accumulate(nr);
        __syncthreads();  // s_red and s_coeff are reused by the next group
      }
    }
  }

  if (C > 1) {
    grid.sync();
    // a slice of one group still has its rows in x
    for (long long rg = r0; has_rows && rg < r1; rg += kRows) {
      const int nr = static_cast<int>(min(static_cast<long long>(kRows), r1 - rg));
      if (ngroups > 1) load_group(rg, nr);
      if (tid < nr) {
        const long long row = rg + tid;
        if (ngroups > 1) load_channel<kAir>(p, row, ha, hb);
        float a = 0.0f, q = 0.0f;
        int f = 1;
        for (int c = 0; c < C; ++c) {
          const float2 v = __ldcg(p.part + row * C + c);
          a += v.x;
          q += v.y;
          f &= __ldcg(p.part_fin + row * C + c);
        }
        s_coeff[tid] = row_coeff<kAir>(p, ha, hb, a, q, f, s);
      }
      __syncthreads();
      accumulate(nr);
      __syncthreads();
    }
  }

  if (has_rows) {
    float* dst = p.numpart + sl * d + c0;
#pragma unroll
    for (int m = 0; m < kPairs; ++m) {
      const int j = 2 * (tid + kThreads * m);
      if (j < W) dst[j] = acc[2 * m];
      if (j + 1 < W) dst[j + 1] = acc[2 * m + 1];
    }
    if (ct == 0 && tid == 0) p.denpart[sl] = den_slice;
  }

  // the column work of this block: L interleaved lanes per column, lane l
  // summing slices l, l + L, ...; the guess update's inputs are loaded
  // before the barrier
  const long long nb = j1 - j0;
  const int L = nb > 0 ? static_cast<int>(max(1LL, min(static_cast<long long>(kThreads) / nb, 32LL))) : 1;
  const int per = kThreads / L;  // columns per round
  const int l = tid / per;
  const int ci = tid % per;
  float g_pre = 0.0f, z_pre = 0.0f, zd = 0.0f;
  if (kFused && tid < per && j0 + tid < j1) {
    g_pre = p.g_in[j0 + tid];
    if (kAir && p.z != nullptr) {
      z_pre = p.z[j0 + tid];
      zd = p.z[d];
    }
  }
  grid.sync();

  // -- columns: num and den in slice order, then the guess update ---------
  if (warp == 0) {
    const float v = warp_sum(strided_sum(p.denpart, 1, lane, 32, S));
    if (lane == 0) s_den = kAir ? v * s : v;
  }
  __syncthreads();
  const float den = s_den;
  if (!kFused && b == 0 && tid == 0) *p.den = den;
  float mv = 0.0f, sq = 0.0f;
  for (long long base = j0; base < j1; base += per) {
    const long long j = base + ci;
    s_lanes[tid] = (l < L && j < j1) ? strided_sum(p.numpart + j, d, l, L, S) : 0.0f;
    __syncthreads();
    if (tid < per && base + tid < j1) {
      const long long jj = base + tid;
      float num = 0.0f;
      for (int i = 0; i < L; ++i) num += s_lanes[i * per + tid];
      if (!kFused) {
        p.num[jj] = num;
      } else {
        const float gi = base == j0 ? g_pre : p.g_in[jj];
        const float zj = kAir && p.z != nullptr ? (base == j0 ? z_pre : p.z[jj]) : 0.0f;
        const float gn = next_guess<kAir>(p, num, den, s, zj, zd);
        const float diff = gi - gn;
        mv = fmaf(diff, diff, mv);
        sq = fmaf(gn, gn, sq);
        p.g_out[jj] = gn;
      }
    }
    __syncthreads();  // s_lanes is reused
  }
  if (kFused) finish_fused<kAir>(p, mv, sq);
}

// The wide plan (C > SMs; see the note at the top): per-(row, tile)
// partials, row weights, then num by a second read of the stack.
template <typename T, bool kAir, bool kFused>
__global__ void __launch_bounds__(kThreads, 1) wide_kernel(const Params p) {
  __shared__ float s_red[kWarps][kRows][2];
  __shared__ int s_fin[kWarps][kRows];
  __shared__ float s_den;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long b = blockIdx.x;
  const long long G = gridDim.x;
  const long long k = p.k;
  const long long d = p.d;
  const long long C = p.C;
  const float s = kAir ? *p.scaler : 0.0f;
  if (kFused && *reinterpret_cast<volatile int*>(p.active) == 0) {
    for (long long j = b * d / G + tid; j < (b + 1) * d / G; j += kThreads) p.g_out[j] = p.g_in[j];
    return;  // every block reads the same flag, so none waits at a barrier
  }
  cg::grid_group grid = cg::this_grid();
  const T* w = static_cast<const T*>(p.w);

  // -- pass 1: the (row, tile) partials ------------------------------------
  for (long long ct = b; ct < C; ct += G) {
    const long long c0 = ct * d / C;
    const int W = static_cast<int>((ct + 1) * d / C - c0);  // <= kTileMax
    float g[kCols];
    load_cols(p.g_in + c0, W, g);
    for (long long rg = 0; rg < k; rg += kRows) {
      const int nr = static_cast<int>(min(static_cast<long long>(kRows), k - rg));
      float x[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < nr) load_cols(w + (rg + r) * d + c0, W, x[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= nr) continue;  // nr is the same in every thread
        float dsq = 0.0f, nsq = 0.0f;
        int fin = 1;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float diff = x[r][e] - g[e];
          dsq = fmaf(diff, diff, dsq);
          if (kAir) nsq = fmaf(x[r][e], x[r][e], nsq);
          fin &= isfinite(x[r][e]) ? 1 : 0;
        }
        const float a = warp_sum(dsq);
        const float q = kAir ? warp_sum(nsq) : 0.0f;
        const int f = __all_sync(kFull, fin);
        if (lane == 0) {
          s_red[warp][r][0] = a;
          s_red[warp][r][1] = q;
          s_fin[warp][r] = f;
        }
      }
      __syncthreads();
      if (tid < nr) {
        float a = 0.0f, q = 0.0f;
        int f = 1;
        for (int i = 0; i < kWarps; ++i) {
          a += s_red[i][tid][0];
          q += s_red[i][tid][1];
          f &= s_fin[i][tid];
        }
        p.part[(rg + tid) * C + ct] = make_float2(a, q);
        p.part_fin[(rg + tid) * C + ct] = f;
      }
      __syncthreads();  // s_red is reused by the next group
    }
  }
  grid.sync();

  // -- pass 2: one warp per row sums its C partials, then its weight -------
  for (long long row = b * kWarps + warp; row < k; row += G * kWarps) {
    const float* pr = reinterpret_cast<const float*>(p.part + row * C);
    const float a = warp_sum(strided_sum(pr, 2, lane, 32, static_cast<int>(C)));
    const float q = kAir ? warp_sum(strided_sum(pr + 1, 2, lane, 32, static_cast<int>(C))) : 0.0f;
    int f = 1;
    for (long long c = lane; c < C; c += 32) f &= __ldcg(p.part_fin + row * C + c);
    f = __all_sync(kFull, f);
    if (lane == 0) {
      float ha, hb;
      load_channel<kAir>(p, row, ha, hb);
      p.coeff[row] = row_coeff<kAir>(p, ha, hb, a, q, f, s);
    }
  }
  grid.sync();

  // -- pass 3: den, then num by a second read and the guess update ---------
  if (warp == 0) {
    const float v = warp_sum(strided_sum(p.coeff, 1, lane, 32, static_cast<int>(k)));
    if (lane == 0) s_den = kAir ? v * s : v;
  }
  __syncthreads();
  const float den = s_den;
  if (!kFused && b == 0 && tid == 0) *p.den = den;
  const float zd = kFused && kAir && p.z != nullptr ? p.z[d] : 0.0f;
  float mv = 0.0f, sq = 0.0f;
  for (long long ct = b; ct < C; ct += G) {
    const long long c0 = ct * d / C;
    const int W = static_cast<int>((ct + 1) * d / C - c0);
    float acc[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[e] = 0.0f;
    for (long long rg = 0; rg < k; rg += kRows) {
      const int nr = static_cast<int>(min(static_cast<long long>(kRows), k - rg));
      float c[kRows], x[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        c[r] = r < nr ? __ldcg(p.coeff + rg + r) : 0.0f;
        // a row of weight 0 is neither read nor added, so a non-finite
        // row never reaches the sum
        if (c[r] != 0.0f) load_cols(w + (rg + r) * d + c0, W, x[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (c[r] != 0.0f) {
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[e] = fmaf(c[r], x[r][e], acc[e]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int j = 2 * (tid + kThreads * (e / 2)) + (e % 2);
      if (j >= W) continue;
      const long long jj = c0 + j;
      if (!kFused) {
        p.num[jj] = acc[e];
      } else {
        const float zj = kAir && p.z != nullptr ? p.z[jj] : 0.0f;
        const float gn = next_guess<kAir>(p, acc[e], den, s, zj, zd);
        const float diff = p.g_in[jj] - gn;
        mv = fmaf(diff, diff, mv);
        sq = fmaf(gn, gn, sq);
        p.g_out[jj] = gn;
      }
    }
  }
  if (kFused) finish_fused<kAir>(p, mv, sq);
}

// The grid and tiling of a step for a [k, d] stack on the current device.
struct Plan {
  int grid, S, C, wide;
  size_t off_red, off_den, off_part, off_fin, off_num, off_coeff, bytes;
};

inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Rows split into column tiles only where they are wider than kTileMax;
// past SMs tiles the wide plan takes the step, with C rounded up to a
// multiple of the grid.
inline cudaError_t make_plan(long long k, long long d, Plan* pl) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (k < 1 || d < 1) return cudaErrorInvalidValue;
  const long long c = (d + kTileMax - 1) / kTileMax;
  pl->grid = sms;
  pl->wide = c > sms ? 1 : 0;
  pl->C = static_cast<int>(pl->wide ? (c + sms - 1) / sms * sms : c);
  pl->S = pl->wide ? 1 : static_cast<int>(std::min(k, sms / c));
  const bool split = pl->C > 1;
  size_t off = 16;  // the ticket
  pl->off_red = off;
  off = align16(off + sizeof(float2) * pl->grid);
  pl->off_den = off;
  off = align16(off + sizeof(float) * pl->S);
  pl->off_part = off;
  off = align16(off + (split ? sizeof(float2) * k * pl->C : 0));
  pl->off_fin = off;
  off = align16(off + (split ? sizeof(int) * k * pl->C : 0));
  pl->off_num = off;
  off = align16(off + (pl->wide ? 0 : sizeof(float) * pl->S * d));
  pl->off_coeff = off;
  off = align16(off + (pl->wide ? sizeof(float) * k : 0));
  pl->bytes = off;
  return cudaSuccess;
}

inline void bind_workspace(const Plan& pl, void* workspace, Params* p) {
  char* base = static_cast<char*>(workspace);
  p->S = pl.S;
  p->C = pl.C;
  p->ticket = reinterpret_cast<int*>(base);
  p->red = reinterpret_cast<float2*>(base + pl.off_red);
  p->denpart = reinterpret_cast<float*>(base + pl.off_den);
  p->part = reinterpret_cast<float2*>(base + pl.off_part);
  p->part_fin = reinterpret_cast<int*>(base + pl.off_fin);
  p->numpart = reinterpret_cast<float*>(base + pl.off_num);
  p->coeff = reinterpret_cast<float*>(base + pl.off_coeff);
}

template <typename T, bool kAir, bool kFused>
cudaError_t launch_one(Params p, void* workspace, cudaStream_t stream) {
  Plan pl;
  cudaError_t err = make_plan(p.k, p.d, &pl);
  if (err != cudaSuccess) return err;
  bind_workspace(pl, workspace, &p);
  void* args[] = {&p};
  const void* kernel = pl.wide ? reinterpret_cast<const void*>(wide_kernel<T, kAir, kFused>)
                               : reinterpret_cast<const void*>(step_kernel<T, kAir, kFused>);
  err = cudaLaunchCooperativeKernel(kernel, dim3(pl.grid), dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kAir, bool kFused>
cudaError_t launch(const Params& p, int w_is_bf16, void* workspace, cudaStream_t stream) {
  return w_is_bf16 ? launch_one<__nv_bfloat16, kAir, kFused>(p, workspace, stream)
                   : launch_one<float, kAir, kFused>(p, workspace, stream);
}

}  // namespace weiszfeld

// Bytes of workspace a step over a [k, d] stack needs on the current
// device (the same for an f32 and a bf16 stack); the first 16 bytes hold
// the ticket, which must be 0 before the first launch (the kernel leaves
// it 0).  Steps that share a workspace run in stream order (see the note
// at the top).  Negative on a CUDA error (its code, negated).
extern "C" long long weiszfeld_workspace_bytes(long long k, long long d) {
  weiszfeld::Plan pl;
  const cudaError_t err = weiszfeld::make_plan(k, d, &pl);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return static_cast<long long>(pl.bytes);
}
