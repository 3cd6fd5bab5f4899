// The Mosaic probe catalogues on Hopper: the kernels of the port of
// tools/fused_argmax_probe.py (T4, 20 pallas_calls), which the port of
// tools/pallas_probe.py (T5) shares for its elementwise, product and window
// probes.  On the TPU each probe tried one construct of the relay's Mosaic
// build; here each pallas_call's function is computed by one of the kernel
// templates below, beside a plain PyTorch version
// (pvot_torch/tools/fused_argmax_probe.py).  A TPU alignment trick (an offset
// in units of 8 rows, a roll that aligns a slab, staging through scratch)
// has no counterpart: the function it served does.
//
//   P1 tile_reduce_kernel   reduce_max :80, argmax_tiebreak :112,
//                           two_outputs :135: the maximum of a tile, or the
//                           first row-major index of it (ties to the smaller
//                           index: a (value desc, index asc) fold across
//                           threads and warps, no float atomics), broadcast
//                           to an (8, 128) tile, with an int32 tile of a
//                           constant for two_outputs.
//   P2 ew_kernel            smem_i32_in :164, u8_convert :735, scalar_align
//                           :915; T5 trivial, grid, smem: elementwise ops
//                           whose scalars the kernel reads from device
//                           memory (they sat in SMEM on the TPU).  u8 -> f32
//                           multiplies by float32(1/255), never divides.
//   P3 gemm_fma_kernel      dot_rhs_lane :341 (B given as (n, k)); T5
//                           dot_highest, scratch_copy_dot, unrolled_dots,
//                           selector_dot: float32 products (HIGHEST).  A is
//                           read as a[i * lda + k], so lda below k reads the
//                           concatenated row bands of scratch_copy_dot.
//      gemm_mma_kernel      dot_high_emul :287 (B as bf16 hi and lo planes);
//                           T5 matmul, big_matmul (1 bf16 pass) and dot_high
//                           (3 passes): warp-level mma.sync.m16n8k16 through
//                           tiers.cuh, float32 sums.
//   P4 window_kernel        dma_dyn_2d :769, dma_3d_lead :811, dma_u8_slab
//                           :859; T5 dyn_sublane, concat_lanes,
//                           aligned_dyn16, slice16_add: sums of row-shifted
//                           windows, the offsets read on the device.
//   P5 carry_sum_kernel     scratch_carry :379; offset_chain_kernel
//                           dyn_hbm_dma :445; gated_gemm_kernel when_heavy
//                           :501; gated_copy_kernel when_dma :958.  The TPU
//                           grid runs its steps in order on one core; here
//                           one block walks the steps in order with the
//                           carried state (counter, offset, flag) in shared
//                           memory, and the host never reads it.
//   P6 roll_kernel          roll_static :533, roll_strided :565, roll_traced
//                           :703: np.roll, out[r, c] = x[(r - sy) mod H,
//                           (c - sx - stride r) mod W], shifts read on the
//                           device.
//   P7 shear_corr_kernel    shear_dot :611, shear_dot_val :665 (one
//                           function): acc[y, dx] = sum_p sum_{l < L}
//                           w[y + p, l] t[p, (l - dx) mod M], float32.
//
// What bounds them on the H100: launch latency.  Every probe moves at most
// a few hundred KB and does at most a few tens of MFLOP, nanoseconds to
// about a microsecond of the card's peak rates, against microseconds for a
// launch; PERF.md has each one's time beside its bound.  They are checked
// microkernels of the constructs that a persistent chunk kernel is built
// from, not tuned.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "probe_gemm.cuh"
#include "tiers.cuh"

namespace {

using pvot_probe::blocked_dot;
using pvot_probe::kChunk;
using pvot_probe::pmod;
using pvot_tiers::hi_pair;
using pvot_tiers::lo_pair;
using pvot_tiers::mma_bf16;
using pvot_tiers::split_pack;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kU8Scale = static_cast<float>(1.0 / 255.0);  // jnp.float32(1 / 255)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint8_t v) {
  return __fmul_rn(static_cast<float>(v), kU8Scale);
}

int launch_status() { return static_cast<int>(cudaGetLastError()); }

// ---- P1: tile reduce ------------------------------------------------------

struct Arg {
  float val;
  int idx;
};

__device__ __forceinline__ bool arg_better(const Arg& a, const Arg& b) {
  return a.val > b.val || (a.val == b.val && a.idx < b.idx);
}

__device__ __forceinline__ Arg warp_arg(Arg a) {
  for (int off = 16; off > 0; off >>= 1) {
    Arg o;
    o.val = __shfl_xor_sync(0xffffffffu, a.val, off);
    o.idx = __shfl_xor_sync(0xffffffffu, a.idx, off);
    if (arg_better(o, a)) a = o;
  }
  return a;
}

enum ReduceMode { kMax = 0, kArgmax = 1 };

// One block: the best (value, first index) of x[0 .. n), written to every
// element of val (the maximum, or its index as float32) and `fill` to every
// element of idx (when given).
__global__ void __launch_bounds__(kThreads)
tile_reduce_kernel(const float* __restrict__ x, int n, int mode, float* __restrict__ val,
                   int32_t* __restrict__ idx, int fill, int out_n) {
  __shared__ Arg s_warp[kWarps];
  __shared__ Arg s_best;
  Arg best{-INFINITY, INT_MAX};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Arg c{x[i], i};
    if (arg_better(c, best)) best = c;
  }
  best = warp_arg(best);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x < 32) {
    best = threadIdx.x < kWarps ? s_warp[threadIdx.x] : Arg{-INFINITY, INT_MAX};
    best = warp_arg(best);
    if (threadIdx.x == 0) s_best = best;
  }
  __syncthreads();
  const float v = mode == kArgmax ? static_cast<float>(s_best.idx) : s_best.val;
  for (int i = threadIdx.x; i < out_n; i += kThreads) {
    val[i] = v;
    if (idx) idx[i] = fill;
  }
}

// ---- P2: elementwise with scalars from device memory ----------------------

enum EwOp { kAddI32 = 0, kMulF32 = 1, kTimes2 = 2, kPlus1 = 3, kU8 = 4, kAlign = 5 };

// out[i] for i < n: x + float(s_i32[si]), x * s_f32[si], 2 x, x + 1,
// float(u8) * float32(1/255); kAlign: from y0 = s[si], x0 = s[si + 1], lanes
// 0-3 of each w-wide row are (y0 >> 5) << 5, x0 & ~127 and the residuals,
// the other lanes 0 (int32 out).
__global__ void ew_kernel(int op, const void* __restrict__ x, const void* __restrict__ scal,
                          int si, void* __restrict__ out, int n, int w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  switch (op) {
    case kAddI32:
      of[i] = __fadd_rn(xf[i], static_cast<float>(static_cast<const int32_t*>(scal)[si]));
      break;
    case kMulF32:
      of[i] = __fmul_rn(xf[i], static_cast<const float*>(scal)[si]);
      break;
    case kTimes2:
      of[i] = __fmul_rn(xf[i], 2.0f);
      break;
    case kPlus1:
      of[i] = __fadd_rn(xf[i], 1.0f);
      break;
    case kU8:
      of[i] = to_f32(static_cast<const uint8_t*>(x)[i]);
      break;
    default: {  // kAlign
      const int32_t* s = static_cast<const int32_t*>(scal) + si;
      const int y0 = s[0], x0 = s[1];
      const int ya = (y0 >> 5) << 5, xa = x0 & ~127;
      const int lane = i % w;
      static_cast<int32_t*>(out)[i] =
          lane == 0 ? ya : lane == 1 ? xa : lane == 2 ? y0 - ya : lane == 3 ? x0 - xa : 0;
    }
  }
}

// ---- P3: products ---------------------------------------------------------

enum BKind { kBKN = 0, kBNK = 1, kBPlanes = 2 };  // B f32 (k, n); f32 (n, k); bf16 hi, lo (k, n)

constexpr int kFmaRows = 8, kFmaCols = 32;

// acc[r] += (A B)[r0 + r][j] over k in [k_lo, k_hi) for r < kFmaRows, in
// float32 FMAs: each chunk of kChunk terms sums on its own and joins acc[r]
// with one round-to-nearest addition.  Rows at or past m read 0.  Indices
// are 32-bit (pvot_probe_gemm refuses larger operands): with 64-bit row
// offsets the one-block gated_gemm_kernel took 220 us instead of 178 and
// gemm_fma_kernel twice as long on the H100.
template <int kB>
__device__ __forceinline__ void fma_rows(const float* __restrict__ a, int lda,
                                         const float* __restrict__ b, int ldb, int m, int r0,
                                         int j, int k_lo, int k_hi, float (&acc)[kFmaRows]) {
  for (int k0 = k_lo; k0 < k_hi; k0 += kChunk) {
    const int k1 = min(k_hi, k0 + kChunk);
    float part[kFmaRows];
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) part[r] = 0.0f;
    for (int kk = k0; kk < k1; ++kk) {
      const float bv = kB == kBKN ? b[kk * ldb + j] : b[j * ldb + kk];
#pragma unroll
      for (int r = 0; r < kFmaRows; ++r) {
        const float av = r0 + r < m ? a[(r0 + r) * lda + kk] : 0.0f;
        part[r] = fmaf(av, bv, part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kFmaRows; ++r) acc[r] = __fadd_rn(acc[r], part[r]);
  }
}

// C (m x n) = A B in float32 FMAs.  A block takes 8 rows and 32 columns, a
// lane a column, a warp one eighth of k; each warp's chunked sums and then
// the warps' partials add in a fixed order.
template <int kB>
__global__ void __launch_bounds__(kThreads)
gemm_fma_kernel(const float* __restrict__ a, int lda, const float* __restrict__ b, int ldb,
                float* __restrict__ c, int m, int n, int k) {
  __shared__ float s_part[kWarps][kFmaRows][kFmaCols];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * kFmaRows, j = blockIdx.x * kFmaCols + lane;
  const int per = (k + kWarps - 1) / kWarps;
  const int k_lo = warp * per, k_hi = min(k, k_lo + per);
  float acc[kFmaRows];
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.0f;
  if (j < n) fma_rows<kB>(a, lda, b, ldb, m, m0, j, k_lo, k_hi, acc);
#pragma unroll
  for (int r = 0; r < kFmaRows; ++r) s_part[warp][r][lane] = acc[r];
  __syncthreads();
  const int r = threadIdx.x >> 5;  // 8 rows x 32 columns: one output a thread
  if (m0 + r < m && j < n) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, s_part[w][r][lane]);
    c[static_cast<long long>(m0 + r) * n + j] = s;
  }
}

constexpr int kMmaChunk = 8;  // mma steps a fragment sums before it joins the float32 total

// A's hi/lo slot (tiers.cuh split_pack) at (row, col), 0 outside m x k.
__device__ __forceinline__ uint32_t a_slot(const float* a, long long lda, int m, int k, int row,
                                           int col) {
  return row < m && col < k ? split_pack(a[row * lda + col]) : 0u;
}

// B's hi/lo slot at (row, col), 0 outside k x n.
template <int kB>
__device__ __forceinline__ uint32_t b_slot(const void* b, const void* b_lo, int ldb, int k, int n,
                                           int row, int col) {
  if (row >= k || col >= n) return 0u;
  const long long at = static_cast<long long>(row) * ldb + col;
  if (kB == kBPlanes) {
    return static_cast<uint32_t>(static_cast<const uint16_t*>(b)[at]) |
           (static_cast<uint32_t>(static_cast<const uint16_t*>(b_lo)[at]) << 16);
  }
  return split_pack(static_cast<const float*>(b)[at]);
}

// C (m x n) = A B at kPasses bf16 passes (1: hi A hi B; 3: + hi A lo B + lo
// A hi B) on the tensor cores.  A block takes a 16 x 8 output tile, a warp
// one eighth of k in steps of 16; a fragment sums kMmaChunk steps and joins
// the warp's float32 total with one round-to-nearest addition (the tensor
// core's own sums are not round-to-nearest); the warps' totals add in a
// fixed order.
template <int kPasses, int kB>
__global__ void __launch_bounds__(kThreads)
gemm_mma_kernel(const float* __restrict__ a, long long lda, const void* __restrict__ b,
                const void* __restrict__ b_lo, int ldb, float* __restrict__ c, int m, int n,
                int k) {
  __shared__ float s_part[kWarps][16][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int m0 = blockIdx.y * 16, n0 = blockIdx.x * 8;
  const int steps = (k + 15) / 16;
  const int per = (steps + kWarps - 1) / kWarps;
  const int s_lo = warp * per, s_hi = min(steps, s_lo + per);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int s0 = s_lo; s0 < s_hi; s0 += kMmaChunk) {
    float frag[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const int s1 = min(s_hi, s0 + kMmaChunk);
    for (int s = s0; s < s1; ++s) {
      const int kc = 16 * s + 2 * q;
      // a0 (row g, k 2q), a1 (row g + 8, k 2q), a2 (row g, k 2q + 8), a3
      // (row g + 8, k 2q + 8), two k each; b0 (k 2q), b1 (k 2q + 8) at column g.
      const uint32_t x00 = a_slot(a, lda, m, k, m0 + g, kc), x01 = a_slot(a, lda, m, k, m0 + g, kc + 1);
      const uint32_t x10 = a_slot(a, lda, m, k, m0 + g + 8, kc),
                     x11 = a_slot(a, lda, m, k, m0 + g + 8, kc + 1);
      const uint32_t x20 = a_slot(a, lda, m, k, m0 + g, kc + 8),
                     x21 = a_slot(a, lda, m, k, m0 + g, kc + 9);
      const uint32_t x30 = a_slot(a, lda, m, k, m0 + g + 8, kc + 8),
                     x31 = a_slot(a, lda, m, k, m0 + g + 8, kc + 9);
      const uint32_t y00 = b_slot<kB>(b, b_lo, ldb, k, n, kc, n0 + g),
                     y01 = b_slot<kB>(b, b_lo, ldb, k, n, kc + 1, n0 + g);
      const uint32_t y10 = b_slot<kB>(b, b_lo, ldb, k, n, kc + 8, n0 + g),
                     y11 = b_slot<kB>(b, b_lo, ldb, k, n, kc + 9, n0 + g);
      const uint32_t ah0 = hi_pair(x00, x01), ah1 = hi_pair(x10, x11), ah2 = hi_pair(x20, x21),
                     ah3 = hi_pair(x30, x31);
      const uint32_t bh0 = hi_pair(y00, y01), bh1 = hi_pair(y10, y11);
      mma_bf16(frag, ah0, ah1, ah2, ah3, bh0, bh1);  // hi A * hi B
      if (kPasses == 3) {
        mma_bf16(frag, ah0, ah1, ah2, ah3, lo_pair(y00, y01), lo_pair(y10, y11));  // hi A * lo B
        mma_bf16(frag, lo_pair(x00, x01), lo_pair(x10, x11), lo_pair(x20, x21),
                 lo_pair(x30, x31), bh0, bh1);  // lo A * hi B
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], frag[i]);
  }
  // c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1).
  s_part[warp][g][2 * q] = acc[0];
  s_part[warp][g][2 * q + 1] = acc[1];
  s_part[warp][g + 8][2 * q] = acc[2];
  s_part[warp][g + 8][2 * q + 1] = acc[3];
  __syncthreads();
  if (threadIdx.x < 128) {
    const int r = threadIdx.x >> 3, col = threadIdx.x & 7;
    if (m0 + r < m && n0 + col < n) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, s_part[w][r][col]);
      c[static_cast<long long>(m0 + r) * n + n0 + col] = s;
    }
  }
}

// ---- P4: windows ----------------------------------------------------------

// out[b, r, c] = sum_{t < nk} X(b, oy + b bstep + t kstep + r + c / band,
// ox + c % band), added in order from 0, for b < nb, r < rows, c < cols;
// X(b, y, x) the pixel at frame b (x + b fs) row y column x as float32 (u8
// times float32(1/255)), 0 outside src_h x src_w; (oy, ox) = (off[0] ru,
// off[1] cu) read from device memory, or (0, 0) without off.
template <typename T>
__global__ void window_kernel(const T* __restrict__ x, long long fs, int ld, int src_h, int src_w,
                              const int32_t* __restrict__ off, int ru, int cu, int nb, int bstep,
                              int nk, int kstep, int rows, int cols, int band,
                              float* __restrict__ out) {
  const int oy = off ? off[0] * ru : 0, ox = off ? off[1] * cu : 0;
  const long long total = static_cast<long long>(nb) * rows * cols;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % cols);
    const long long br = i / cols;
    const int r = static_cast<int>(br % rows), b = static_cast<int>(br / rows);
    const int y_base = oy + b * bstep + r + c / band, xs = ox + c % band;
    const T* frame = x + b * fs;
    float acc = 0.0f;
    for (int t = 0; t < nk; ++t) {
      const int y = y_base + t * kstep;
      const bool in = y >= 0 && y < src_h && xs >= 0 && xs < src_w;
      acc = __fadd_rn(acc, in ? to_f32(frame[static_cast<long long>(y) * ld + xs]) : 0.0f);
    }
    out[i] = acc;
  }
}

// ---- P5: one block walks the steps ----------------------------------------

// scratch_carry: out[t] = (x[0] + ... + x[t]) + float(inc (t + 1)), tile
// elements a step; the running sums in registers, the counter in shared
// memory.
__global__ void __launch_bounds__(kThreads)
carry_sum_kernel(const float* __restrict__ x, int steps, int tile, int inc,
                 float* __restrict__ out) {
  __shared__ int s_cnt;
  constexpr int kPer = 8;  // tile <= kThreads * kPer (checked by the host)
  float acc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) acc[u] = 0.0f;
  if (threadIdx.x == 0) s_cnt = 0;
  for (int t = 0; t < steps; ++t) {
    __syncthreads();  // every thread read the counter of step t - 1
    if (threadIdx.x == 0) s_cnt += inc;
    __syncthreads();
    const float cnt = static_cast<float>(s_cnt);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < tile) {
        const long long at = static_cast<long long>(t) * tile + e;
        acc[u] = __fadd_rn(acc[u], x[at]);
        out[at] = __fadd_rn(acc[u], cnt);
      }
    }
  }
}

// dyn_hbm_dma: step t copies rows [o_t, o_t + rows) of x (h x w), o_t = unit
// u_t, u_0 = 0, u_{t+1} = u_t + int(x[o_t, 0]) (truncated, as astype(int32)
// does); a window past x writes zeros and ends the chain's growth.
__global__ void __launch_bounds__(kThreads)
offset_chain_kernel(const float* __restrict__ x, int h, int w, int steps, int rows, int unit,
                    float* __restrict__ out) {
  __shared__ int s_units;
  if (threadIdx.x == 0) s_units = 0;
  __syncthreads();
  for (int t = 0; t < steps; ++t) {
    const int row0 = s_units * unit;
    const bool in = row0 >= 0 && row0 + rows <= h;
    const long long n = static_cast<long long>(rows) * w;
    for (long long e = threadIdx.x; e < n; e += kThreads) {
      out[t * n + e] = in ? x[static_cast<long long>(row0) * w + e] : 0.0f;
    }
    __syncthreads();  // every thread read s_units
    if (threadIdx.x == 0 && in) s_units += __float2int_rz(x[static_cast<long long>(row0) * w]);
    __syncthreads();
  }
}

// when_heavy: step t writes a b (n x n, float32) when the carried flag is 1
// and zeros otherwise; the flag starts at 1 and flips every step.
__global__ void __launch_bounds__(512)
gated_gemm_kernel(const float* __restrict__ a, const float* __restrict__ b, int n, int steps,
                  float* __restrict__ out) {
  __shared__ int s_flag;
  if (threadIdx.x == 0) s_flag = 1;
  __syncthreads();
  const long long nn = static_cast<long long>(n) * n;
  const int tasks = (n + kFmaRows - 1) / kFmaRows * n;  // a task: 8 rows of one column
  for (int t = 0; t < steps; ++t) {
    float* o = out + t * nn;
    if (s_flag == 1) {  // uniform across the block
      for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
        const int r0 = task / n * kFmaRows, j = task % n;
        float acc[kFmaRows];
#pragma unroll
        for (int r = 0; r < kFmaRows; ++r) acc[r] = 0.0f;
        fma_rows<kBKN>(a, n, b, n, n, r0, j, 0, n, acc);
#pragma unroll
        for (int r = 0; r < kFmaRows; ++r) {
          if (r0 + r < n) o[(r0 + r) * n + j] = acc[r];
        }
      }
    } else {
      for (long long e = threadIdx.x; e < nn; e += blockDim.x) o[e] = 0.0f;
    }
    __syncthreads();  // every thread read the flag
    if (threadIdx.x == 0) s_flag = 1 - s_flag;
    __syncthreads();
  }
}

// when_dma: step t copies frame t's rows [y0, y0 + rows) and columns [x0,
// x0 + cols) of x (steps x h x w) when the carried flag is 1, zeros
// otherwise (no read); the flag starts at 1 and flips every step.
__global__ void __launch_bounds__(kThreads)
gated_copy_kernel(const float* __restrict__ x, int h, int w, int y0, int x0, int rows, int cols,
                  int steps, float* __restrict__ out) {
  __shared__ int s_flag;
  if (threadIdx.x == 0) s_flag = 1;
  __syncthreads();
  const int n = rows * cols;
  for (int t = 0; t < steps; ++t) {
    const bool on = s_flag == 1;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / cols, c = e % cols;
      out[static_cast<long long>(t) * n + e] =
          on ? x[(static_cast<long long>(t) * h + y0 + r) * w + x0 + c] : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x == 0) s_flag = 1 - s_flag;
    __syncthreads();
  }
}

// ---- P6: roll -------------------------------------------------------------

// out (out_h x w)[r, c] = x[src_r, (c - sx - stride r) mod w], src_r = 0
// (bcast: row 0 broadcast to out_h rows) or (r - sy) mod h; (sy, sx) read
// from device memory.
__global__ void roll_kernel(const float* __restrict__ x, int h, int w,
                            const int32_t* __restrict__ shifts, int stride, int out_h, int bcast,
                            float* __restrict__ out) {
  const int sy = shifts[0], sx = shifts[1];
  const int n = out_h * w;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int r = i / w, c = i % w;
    const int src_r = bcast ? 0 : pmod(r - sy, h);
    out[i] = x[src_r * w + pmod(c - sx - stride * r, w)];
  }
}

// ---- P7: shear correlation ------------------------------------------------

constexpr int kShearRows = 2;  // output rows a block

// acc[y, dx] = sum_{p < P} (sum_{l < L} w[y + p, l] t[p, (l - dx) mod M]),
// each inner sum a blocked float32 dot, y < ty, dx < tx (tx <= M).  A block
// stages its kShearRows + P - 1 rows of w and all of t in shared memory.
__global__ void __launch_bounds__(kThreads)
shear_corr_kernel(const float* __restrict__ w, int w_rows, int L, const float* __restrict__ t,
                  int M, int P, int ty, int tx, float* __restrict__ out) {
  extern __shared__ float s_mem[];
  const int rows = kShearRows + P - 1;
  float* s_w = s_mem;
  float* s_t = s_mem + rows * L;
  const int y0 = blockIdx.x * kShearRows;
  for (int e = threadIdx.x; e < rows * L; e += kThreads) {
    const int row = y0 + e / L;
    s_w[e] = row < w_rows ? w[row * L + e % L] : 0.0f;
  }
  for (int e = threadIdx.x; e < P * M; e += kThreads) s_t[e] = t[e];
  __syncthreads();
  for (int o = threadIdx.x; o < kShearRows * tx; o += kThreads) {
    const int yy = o / tx, dx = o % tx;
    if (y0 + yy >= ty) continue;
    float acc = 0.0f;
    for (int p = 0; p < P; ++p) {
      const float* wr = s_w + (yy + p) * L;
      const float* tr = s_t + p * M;
      acc = __fadd_rn(acc, blocked_dot(
                               L, [&](int l) { return wr[l]; },
                               [&](int l) { return tr[l < dx ? l - dx + M : l - dx]; }));
    }
    out[(y0 + yy) * tx + dx] = acc;
  }
}

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 1024 ? blocks : 1024);
}

}  // namespace

extern "C" {

// P1: x (n f32) -> val (out_n f32: the maximum, mode 0, or the first index
// of it as float32, mode 1) and, when idx is given, idx (out_n int32 of
// `fill`).  One block on `stream`; returns the CUDA error, or 0.
int pvot_probe_tile_reduce(const float* x, int n, int mode, float* val, int32_t* idx, int fill,
                           int out_n, void* stream) {
  if (n < 1 || out_n < 1 || (mode != kMax && mode != kArgmax)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tile_reduce_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, n, mode, val, idx,
                                                                            fill, out_n);
  return launch_status();
}

// P2: op (EwOp) over n elements of rows w wide; x f32 (u8 for kU8, unused
// for kAlign); scal int32 (kAddI32, kAlign) or f32 (kMulF32) in device
// memory, read at si.
int pvot_probe_ew(int op, const void* x, const void* scal, int si, void* out, int n, int w,
                  void* stream) {
  if (n < 1 || w < 1 || op < kAddI32 || op > kAlign) return static_cast<int>(cudaErrorInvalidValue);
  ew_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      op, x, scal, si, out, n, w);
  return launch_status();
}

// P3: c (m x n f32) = A B; A[i, kk] = a[i * lda + kk]; b_kind kBKN: b f32
// (k x n, rows ldb apart), kBNK: b f32 (n x k), kBPlanes: b and b_lo the
// bf16 hi and lo planes (k x n, uint16 bits); passes 0 (float32 FMAs; kBKN
// or kBNK), 1 or 3 (bf16 on the tensor cores; kBKN or kBPlanes).
int pvot_probe_gemm(const float* a, long long lda, const void* b, const void* b_lo, int b_kind,
                    int ldb, float* c, int m, int n, int k, int passes, void* stream) {
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (passes == 0) {
    if ((m - 1) * lda + k > INT_MAX || static_cast<long long>(k) * n > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid((n + kFmaCols - 1) / kFmaCols, (m + kFmaRows - 1) / kFmaRows);
    const float* bf = static_cast<const float*>(b);
    if (b_kind == kBKN) {
      gemm_fma_kernel<kBKN><<<grid, kThreads, 0, st>>>(a, static_cast<int>(lda), bf, ldb, c, m,
                                                       n, k);
    } else if (b_kind == kBNK) {
      gemm_fma_kernel<kBNK><<<grid, kThreads, 0, st>>>(a, static_cast<int>(lda), bf, ldb, c, m,
                                                       n, k);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_status();
  }
  const dim3 grid((n + 7) / 8, (m + 15) / 16);
  if (passes == 1 && b_kind == kBKN) {
    gemm_mma_kernel<1, kBKN><<<grid, kThreads, 0, st>>>(a, lda, b, b_lo, ldb, c, m, n, k);
  } else if (passes == 3 && b_kind == kBKN) {
    gemm_mma_kernel<3, kBKN><<<grid, kThreads, 0, st>>>(a, lda, b, b_lo, ldb, c, m, n, k);
  } else if (passes == 3 && b_kind == kBPlanes) {
    gemm_mma_kernel<3, kBPlanes><<<grid, kThreads, 0, st>>>(a, lda, b, b_lo, ldb, c, m, n, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}

// P4: see window_kernel; x u8 (x_u8 != 0) or f32, frames fs elements apart
// (0: one frame), rows ld apart; out nb x rows x cols f32.
int pvot_probe_window(const void* x, int x_u8, long long fs, int ld, int src_h, int src_w,
                      const int32_t* off, int ru, int cu, int nb, int bstep, int nk, int kstep,
                      int rows, int cols, int band, float* out, void* stream) {
  if (nb < 1 || nk < 1 || rows < 1 || cols < 1 || band < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(static_cast<long long>(nb) * rows * cols);
  if (x_u8) {
    window_kernel<uint8_t><<<grid, kThreads, 0, st>>>(static_cast<const uint8_t*>(x), fs, ld,
                                                      src_h, src_w, off, ru, cu, nb, bstep, nk,
                                                      kstep, rows, cols, band, out);
  } else {
    window_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x), fs, ld, src_h,
                                                    src_w, off, ru, cu, nb, bstep, nk, kstep,
                                                    rows, cols, band, out);
  }
  return launch_status();
}

// P5, scratch_carry: x and out steps x tile f32 (tile <= 2048).
int pvot_probe_carry_sum(const float* x, int steps, int tile, int inc, float* out, void* stream) {
  if (steps < 1 || tile < 1 || tile > kThreads * 8) return static_cast<int>(cudaErrorInvalidValue);
  carry_sum_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, steps, tile, inc,
                                                                          out);
  return launch_status();
}

// P5, dyn_hbm_dma: x h x w f32; out steps x rows x w f32.
int pvot_probe_offset_chain(const float* x, int h, int w, int steps, int rows, int unit,
                            float* out, void* stream) {
  if (h < 1 || w < 1 || steps < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  offset_chain_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, h, w, steps, rows,
                                                                             unit, out);
  return launch_status();
}

// P5, when_heavy: a, b n x n f32; out steps x n x n f32.
int pvot_probe_gated_gemm(const float* a, const float* b, int n, int steps, float* out,
                          void* stream) {
  if (n < 1 || steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  gated_gemm_kernel<<<1, 512, 0, static_cast<cudaStream_t>(stream)>>>(a, b, n, steps, out);
  return launch_status();
}

// P5, when_dma: x steps x h x w f32; out steps x rows x cols f32.
int pvot_probe_gated_copy(const float* x, int h, int w, int y0, int x0, int rows, int cols,
                          int steps, float* out, void* stream) {
  if (steps < 1 || rows < 1 || cols < 1 || y0 < 0 || x0 < 0 || y0 + rows > h || x0 + cols > w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  gated_copy_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, h, w, y0, x0, rows,
                                                                           cols, steps, out);
  return launch_status();
}

// P6: x h x w f32, shifts 2 int32 (sy, sx) in device memory; out out_h x w.
int pvot_probe_roll(const float* x, int h, int w, const int32_t* shifts, int stride, int out_h,
                    int bcast, float* out, void* stream) {
  if (h < 1 || w < 1 || out_h < 1 || (!bcast && out_h != h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  roll_kernel<<<grid_for(static_cast<long long>(out_h) * w), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(x, h, w, shifts, stride, out_h, bcast, out);
  return launch_status();
}

// P7: w (w_rows x L f32, w_rows >= ty + P - 1), t (P x M f32, L <= M, tx
// <= M); out ty x tx f32.
int pvot_probe_shear(const float* w, int w_rows, int L, const float* t, int M, int P, int ty,
                     int tx, float* out, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(kShearRows + P - 1) * L +
                                       static_cast<size_t>(P) * M);
  if (L < 1 || P < 1 || ty < 1 || tx < 1 || L > M || tx > M || w_rows < ty + P - 1 ||
      smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  shear_corr_kernel<<<(ty + kShearRows - 1) / kShearRows, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(w, w_rows, L, t, M, P, ty, tx, out);
  return launch_status();
}

}  // extern "C"
