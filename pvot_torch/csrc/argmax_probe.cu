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
//                           (3 passes): mma.sync.m16n8k16 through tiers.cuh,
//                           float32 sums.  Both take one plan (see P3 below):
//                           C in tiles, k split over blocks, operands staged.
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
// What bounds them on the H100.  Most probes move at most a few hundred KB
// and do at most a few tens of MFLOP: nanoseconds to about a microsecond at
// the card's peak rates, against microseconds for a launch, so they are
// launch-bound under any design; they are checked microkernels of the
// constructs a persistent chunk kernel is built from, not tuned.  The P3
// products are the exception: big_matmul reads 10.5 MB of float32 B (3.3
// us at 3.35 TB/s), dot_highest and its kin 1 MB (0.33 us), dot_rhs_lane
// does 71 MFLOP of float32 FMAs (1.06 us at 67 TFLOP/s), against a few
// blocks of scalar loads in their first port.  Their design (P3): k split
// over enough blocks to fill the card, the operands staged by 16-byte
// cp.async, and the splits added in a fixed order in the same launch.
// PERF.md has each probe's time beside its bound.  Build without
// --use_fast_math.

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

constexpr int kFmaRows = 8;  // rows of C a thread of gated_gemm_kernel sums

// acc[r] += (A B)[r0 + r][j] over k in [k_lo, k_hi) for r < kFmaRows, in
// float32 FMAs: each chunk of kChunk terms sums on its own and joins acc[r]
// with one round-to-nearest addition.  Rows at or past m read 0.  Indices
// are 32-bit (pvot_probe_gemm refuses larger operands): with 64-bit row
// offsets the one-block gated_gemm_kernel took 220 us instead of 178 and
// the first gemm_fma_kernel twice as long on the H100.  gated_gemm_kernel's
// own loop (the product kernels below stage their operands instead).
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

// The two product kernels share one plan (pvot_torch/tools/fused_argmax_probe.py
// `gemm_plan`, which the wrapper passes in with the tiling it assumed, and
// which must be one of the tilings here): C is cut into tiles of kTm x kTn,
// and k into `splits` ranges of k_split (a multiple of kGemmStep; the last
// takes the rest); block split * tiles + tile takes one tile over one
// range.  A block stages its range in stages of kStageK, by 16-byte
// cp.async, kStages deep (a row of A or B whose start is not 16-byte aligned
// takes plain 4- or 2-byte loads instead), and its threads sum their shares
// of each stage.  With one split the block writes C; with more it writes
// its float32 tile to the workspace and draws a ticket (an atomic add on the
// tile's int counter), and the block that draws the last one adds the
// splits' tiles in split order, each with one round-to-nearest addition,
// writes C and sets the counter back to 0.  No float atomics: two calls
// give the same bits.
constexpr int kGemmStep = 16;  // fused_argmax_probe.GEMM_K_STEP

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [r0, r0 + rows) x columns [c0, c0 + cols) of a row-major matrix (rows
// ld elements apart) into shared memory (rows dpitch apart), zeros at rows
// >= r_end or columns >= c_end.  vec (src 16-byte aligned, ld, cols and
// dpitch whole 16 bytes): 16-byte cp.async, neighbouring threads on
// neighbouring 16 bytes of a row, the bytes past c_end zero-filled; else an
// element a thread by plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int dpitch, const T* __restrict__ src, int ld,
                                           int r0, int rows, int r_end, int c0, int cols,
                                           int c_end, bool vec) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int per_row = cols / kV;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i - r * per_row) * kV;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < r_end && gc < c_end;
      cp_async16(dst + r * dpitch + c, in ? src + gr * ld + gc : src,
                 in ? min(kV, c_end - gc) * static_cast<int>(sizeof(T)) : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      const int gr = r0 + r, gc = c0 + c;
      dst[r * dpitch + c] = gr < r_end && gc < c_end ? src[gr * ld + gc] : T(0);
    }
  }
}

constexpr int kMaxSmem = 200 * 1024;  // the most dynamic shared memory a launch asks for

// This launch's dynamic shared memory, in floats.
__device__ __forceinline__ int dyn_smem_floats() {
  unsigned bytes;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(bytes));
  return static_cast<int>(bytes / 4);
}

// The shared memory a launch asks for: its blocks' stage buffers, the
// block's groups' totals of its tile (`groups` tiles), and room for every
// split's tile where the last block adds them (up to kMaxSmem; it takes
// them in batches past that).
int launch_smem(int stage_bytes, int buffers, int splits, int tile_floats, int groups) {
  long long need = 1LL * stage_bytes * buffers;
  need = need > 4LL * groups * tile_floats ? need : 4LL * groups * tile_floats;
  need = splits > 1 && need < 4LL * splits * tile_floats ? 4LL * splits * tile_floats : need;
  return static_cast<int>(need < kMaxSmem ? need : kMaxSmem);
}

// The stage buffers a plan's blocks use: no more than a split's stages (a
// launch asks for only those, and a one-stage product stays small).
__host__ __device__ constexpr int stage_buffers(int k_split, int stage_k, int stages) {
  return (k_split + stage_k - 1) / stage_k < stages ? (k_split + stage_k - 1) / stage_k : stages;
}

__device__ __forceinline__ bool aligned16(const void* p, int ld, int elem_bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (ld * elem_bytes) % 16 == 0;
}

// The block's tile of C (kTm x kTn row-major, at rows m0, columns n0) for
// split `split`: from the groups' totals s_part[w][e] for w < active <=
// kGroups (added in group order), element e = threadIdx.x + j kThreads in
// v[j];
// then as the plan above says.  The ticket is drawn by thread 0 after the
// block barrier with acquire-release at GPU scope (the release covers the
// block's partial, the acquire the earlier blocks'), and the last block
// reads the others' partials from L2 into s_buf (buf_floats, 16-byte
// aligned; it may overlap s_part).
template <int kTm, int kTn, int kGroups>
__device__ void finish_tile(const float* s_part, int active, float* s_buf, int buf_floats,
                            int* s_last, float* __restrict__ c, int m, int n, int m0, int n0,
                            int tile, int split, int splits, float* __restrict__ ws,
                            int* __restrict__ tickets) {
  constexpr int kT = kTm * kTn, kPer = (kT + kThreads - 1) / kThreads;
  float v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    v[j] = 0.0f;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) {
      if (e < kT && w < active) v[j] = __fadd_rn(v[j], s_part[w * kT + e]);
    }
  }
  if (splits > 1) {
    float* mine = ws + (tile * splits + split) * kT;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (threadIdx.x + j * kThreads < kT) mine[threadIdx.x + j * kThreads] = v[j];
    }
    __syncthreads();  // the block's partial is written, and s_part read
    if (threadIdx.x == 0) {
      int ticket;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(ticket)
                   : "l"(tickets + tile)
                   : "memory");
      *s_last = ticket == splits - 1;
    }
    __syncthreads();
    if (!*s_last) return;  // uniform across the block
    const float* first = ws + tile * splits * kT;
    const int batch = buf_floats / kT;  // splits staged at once
    float own[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) own[j] = v[j], v[j] = 0.0f;
    for (int s0 = 0; s0 < splits; s0 += batch) {
      const int nb = min(batch, splits - s0);
      for (int i = threadIdx.x; i < nb * kT / 4; i += kThreads) {
        if (s0 + 4 * i / kT != split) cp_async16(s_buf + 4 * i, first + s0 * kT + 4 * i, 16);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = threadIdx.x + j * kThreads;
        if (e < kT) {
#pragma unroll 8
          for (int s = 0; s < nb; ++s) {
            v[j] = __fadd_rn(v[j], s0 + s == split ? own[j] : s_buf[s * kT + e]);
          }
        }
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) tickets[tile] = 0;  // ready for the next launch
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / kTn, col = e % kTn;
    if (e < kT && m0 + r < m && n0 + col < n) c[(m0 + r) * n + n0 + col] = v[j];
  }
}

// The FMA kernel's tilings: a thread sums kRM rows x kRN columns; kRG x kCG
// threads cover a tile of kTm = kRM kRG rows and kTn = kCG kRN columns, and
// the block's kKw groups of them split each stage's k, one chunk of kChunk
// terms a group (the stage is kKw kChunk deep).  A is staged as rows of k,
// B (k, n) as rows of n, B (n, k) as rows of k (read along k by 16-byte
// copies, consumed along n: the transpose happens in the shared-memory
// reads).  Pitches: A and B (n, k) kStageK + 4 floats (a thread's float4
// along k; the quarter-warp's columns on distinct banks), B (k, n) kTn + 4.
template <int kB, typename S>
struct FmaTiling {
  static constexpr int kRM = S::kRM, kRG = S::kRG, kCG = S::kCG, kRN = S::kRN;
  static constexpr int kStages = S::kStages;
  static constexpr int kTm = kRM * kRG, kTn = kCG * kRN, kKw = kThreads / (kRG * kCG);
  static constexpr int kStageK = kKw * kChunk;
  static constexpr int kApitch = kStageK + 4;
  static constexpr int kBrows = kB == kBKN ? kStageK : kTn;
  static constexpr int kBpitch = kB == kBKN ? kTn + 4 : kStageK + 4;
  static constexpr int kStageFloats = kTm * kApitch + kBrows * kBpitch;
  static_assert(kKw * kRG * kCG == kThreads, "a tiling takes every thread");
};
// fma: 8 x 16, a thread 2 rows x 1 column, 4 k-groups of a 64-deep stage
// (a few rows against a long k, or a short one: latency- and load-bound,
// short chains); fma wide: 16 x 64, a thread 8 x 4, 8 k-groups of 128
// (FMA-bound: dot_rhs_lane).  3 stages each.  fused_argmax_probe.GEMM_FMA
// and GEMM_FMA_WIDE name them (tile, k-groups, stage k) to the launch.
struct FmaSmall {
  static constexpr int kRM = 2, kRG = 4, kCG = 16, kRN = 1, kStages = 3;
};
struct FmaWide {
  static constexpr int kRM = 8, kRG = 2, kCG = 16, kRN = 4, kStages = 3;
};

// C = A B in float32 FMAs over one tile and one split (the plan above).
// A[i, kk] = a[i * lda + kk], so lda below k reads the overlapping row bands
// of scratch_copy_dot.  Each thread's chunk of kChunk terms sums in FMAs
// and joins its total with one round-to-nearest addition; the k-groups'
// totals then add in group order, and the splits' in split order.  Bound:
// dot_highest and the band products by B's 1 MB (0.33 us), which the
// split spreads over 256 blocks; dot_rhs_lane by its 71 MFLOP at the FP32
// rate (1.06 us), for which the wide tiling keeps 8 x 4 sums a thread: a
// float4 read from shared memory feeds 16 FMAs (A) or 32 (B).
template <int kB, typename S>
__global__ void __launch_bounds__(kThreads, 2)
gemm_fma_kernel(const float* __restrict__ a, int lda, const float* __restrict__ b, int ldb,
                float* __restrict__ c, int m, int n, int k, int tiles_n, int tiles, int splits,
                int k_split, float* __restrict__ ws, int* __restrict__ tickets) {
  using Tl = FmaTiling<kB, S>;
  constexpr int kTm = Tl::kTm, kTn = Tl::kTn, kStageK = Tl::kStageK, kStages = Tl::kStages;
  constexpr int kRM = Tl::kRM, kRG = Tl::kRG, kCG = Tl::kCG, kRN = Tl::kRN;
  constexpr int kAp = Tl::kApitch, kBp = Tl::kBpitch;
  extern __shared__ __align__(16) float s_mem[];
  __shared__ int s_last;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int m0 = tile / tiles_n * kTm, n0 = tile % tiles_n * kTn;
  const int k_lo = split * k_split, k_hi = min(k, k_lo + k_split);
  if (splits == 1 && k <= kChunk) {
    // One chunk in all (selector_dot's k = 16): nothing to reuse across a
    // stage, so no staging.  A thread an output, its chunk read into
    // registers and summed in FMAs, joined to 0 as the staged path's
    // totals are (a staged launch took 0.4 us more on a 1.7 us probe).
    for (int e = threadIdx.x; e < kTm * kTn; e += kThreads) {
      const int i = m0 + e / kTn, j = n0 + e % kTn;
      if (i >= m || j >= n) continue;
      float part = 0.0f;
      for (int kk = 0; kk < k; ++kk) {
        part = fmaf(a[i * lda + kk], kB == kBKN ? b[kk * ldb + j] : b[j * ldb + kk], part);
      }
      c[i * n + j] = __fadd_rn(0.0f, part);
    }
    return;
  }
  const int cg = threadIdx.x % kCG, rg = threadIdx.x / kCG % kRG, kw = threadIdx.x / (kCG * kRG);
  const bool a_vec = aligned16(a, lda, 4), b_vec = aligned16(b, ldb, 4);
  const int n_stages = (k_hi - k_lo + kStageK - 1) / kStageK;
  auto issue = [&](int st) {
    float* s_a = s_mem + (st % kStages) * Tl::kStageFloats;
    float* s_b = s_a + kTm * kAp;
    const int kb = k_lo + st * kStageK;
    const int kc = min(kStageK, (k_hi - kb + kChunk - 1) / kChunk * kChunk);  // chunks in range
    stage_tile<float>(s_a, kAp, a, lda, m0, kTm, m, kb, kc, k_hi, a_vec);
    if constexpr (kB == kBKN) {
      stage_tile<float>(s_b, kBp, b, ldb, kb, kc, k_hi, n0, kTn, n, b_vec);
    } else {
      stage_tile<float>(s_b, kBp, b, ldb, n0, kTn, n, kb, kc, k_hi, b_vec);
    }
  };
  float acc[kRM][kRN];
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[r][j] = 0.0f;
  }
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st landed; every thread is done with stage st - 1
    if (st + kStages - 1 < n_stages) issue(st + kStages - 1);
    cp_async_commit();
    if (k_lo + st * kStageK + kw * kChunk >= k_hi) continue;  // the group's chunk: past the range
    const float* s_a = s_mem + (st % kStages) * Tl::kStageFloats + kRM * rg * kAp + kw * kChunk;
    const float* s_b = s_mem + (st % kStages) * Tl::kStageFloats + kTm * kAp;
    float part[kRM][kRN];
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) part[r][j] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 4) {
      float bv[4][kRN];  // B at k = kk + t, this thread's columns
      if constexpr (kB == kBKN) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float* row = s_b + (kw * kChunk + kk + t) * kBp;
          if constexpr (kRN == 4) {
            const float4 v = *reinterpret_cast<const float4*>(row + 4 * cg);
            bv[t][0] = v.x, bv[t][1] = v.y, bv[t][2] = v.z, bv[t][3] = v.w;
          } else {
            bv[t][0] = row[cg];
          }
        }
      } else {  // columns cg + j kCG, each a float4 along k
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          const float4 v =
              *reinterpret_cast<const float4*>(s_b + (cg + j * kCG) * kBp + kw * kChunk + kk);
          bv[0][j] = v.x, bv[1][j] = v.y, bv[2][j] = v.z, bv[3][j] = v.w;
        }
      }
#pragma unroll
      for (int r = 0; r < kRM; ++r) {
        const float4 av = *reinterpret_cast<const float4*>(s_a + r * kAp + kk);
#pragma unroll
        for (int j = 0; j < kRN; ++j) {
          part[r][j] = fmaf(av.x, bv[0][j], part[r][j]);
          part[r][j] = fmaf(av.y, bv[1][j], part[r][j]);
          part[r][j] = fmaf(av.z, bv[2][j], part[r][j]);
          part[r][j] = fmaf(av.w, bv[3][j], part[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRM; ++r) {
#pragma unroll
      for (int j = 0; j < kRN; ++j) acc[r][j] = __fadd_rn(acc[r][j], part[r][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: the groups' totals, then the tile
  const int active = min(Tl::kKw, (k_hi - k_lo + kChunk - 1) / kChunk);  // groups that summed
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int col = kB == kBKN ? kRN * cg + j : cg + j * kCG;
      s_mem[(kw * kTm + kRM * rg + r) * kTn + col] = acc[r][j];
    }
  }
  __syncthreads();
  finish_tile<kTm, kTn, Tl::kKw>(s_mem, active, s_mem, dyn_smem_floats(), &s_last, c, m, n, m0,
                                 n0, tile, split, splits, ws, tickets);
}

// The mma kernel's tiling: a tile of 8 rows (m) x 16 columns (n), computed
// as its transpose, C^T = B^T A^T, so that n takes the 16-row side of
// mma.m16n8k16 and the 8 rows of A its n8 side: no padded rows for the
// probes' m = 8.  Warp w takes k [32 w, 32 w + 32) of each 256-deep stage
// (two mma steps); 3 stages.  A is staged as rows of k (pitch 264 floats:
// a lane's float2 (k 2q, 2q + 1) conflict-free), B f32 as rows of n (pitch
// 20: the lanes' 8 scalars of an operand conflict-free), B's bf16 planes
// as rows of n (pitch 24: the 8 rows of an ldmatrix on distinct banks).
constexpr int kMmaTm = 8, kMmaTn = 16, kMmaStageK = kWarps * 32, kMmaStages = 3;
constexpr int kMmaApitch = kMmaStageK + 8, kMmaBpitch = kMmaTn + 4, kMmaPpitch = kMmaTn + 8;
constexpr int kMmaChunk = 8;  // mma steps a fragment sums before it joins (GEMM_MMA_CHUNK)
__host__ __device__ constexpr int mma_stage_bytes(int kB) {
  return 4 * kMmaTm * kMmaApitch +
         (kB == kBPlanes ? 2 * 2 * kMmaStageK * kMmaPpitch : 4 * kMmaStageK * kMmaBpitch);
}

// mma.m16n8k16's A registers (rows n, columns k) from 16 k-rows of a bf16
// plane staged as rows of n: the four 8 x 8 matrices (k 0-7 | 8-15) x (n
// 0-7 | 8-15), transposed as loaded.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* plane,
                                                  int k) {
  const int lane = threadIdx.x & 31, mat = lane >> 3;
  const uint16_t* row = plane + (k + (mat >> 1) * 8 + (lane & 7)) * kMmaPpitch + (mat & 1) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// C = A B at kPasses bf16 passes (1: hi A hi B; 3: + hi A lo B + lo A hi B)
// on the tensor cores, over one tile and one split (the plan above).  A's
// and a float32 B's hi/lo come from tiers.cuh's split_pack as each value
// leaves shared memory; B's planes come by ldmatrix.  A fragment sums
// kMmaChunk steps and joins the warp's float32 total with one
// round-to-nearest addition (the tensor core's own sums are not
// round-to-nearest); the warps' totals add in warp order, the splits' in
// split order.  Bound: big_matmul by its 10.5 MB of float32 B (3.3 us at
// 3.35 TB/s), which the split streams through 264 blocks three stages
// deep; the bf16 products themselves take nanoseconds of the tensor cores.
template <int kPasses, int kB>
__global__ void __launch_bounds__(kThreads, 2)
gemm_mma_kernel(const float* __restrict__ a, int lda, const void* __restrict__ b,
                const void* __restrict__ b_lo, int ldb, float* __restrict__ c, int m, int n,
                int k, int tiles_n, int tiles, int splits, int k_split, float* __restrict__ ws,
                int* __restrict__ tickets) {
  constexpr int kStageFloats = mma_stage_bytes(kB) / 4;
  extern __shared__ __align__(16) float s_mem[];
  __shared__ int s_last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int m0 = tile / tiles_n * kMmaTm, n0 = tile % tiles_n * kMmaTn;
  const int k_lo = split * k_split, k_hi = min(k, k_lo + k_split);
  const bool a_vec = aligned16(a, lda, 4);
  const bool b_vec = kB == kBPlanes ? aligned16(b, ldb, 2) && aligned16(b_lo, ldb, 2)
                                    : aligned16(b, ldb, 4);
  const int n_stages = (k_hi - k_lo + kMmaStageK - 1) / kMmaStageK;
  auto issue = [&](int st) {
    float* s_a = s_mem + (st % kMmaStages) * kStageFloats;
    const int kb = k_lo + st * kMmaStageK;
    const int kc = min(kMmaStageK, (k_hi - kb + 15) / 16 * 16);  // the steps in range
    stage_tile<float>(s_a, kMmaApitch, a, lda, m0, kMmaTm, m, kb, kc, k_hi, a_vec);
    float* s_b = s_a + kMmaTm * kMmaApitch;
    if constexpr (kB == kBPlanes) {
      uint16_t* s_hi = reinterpret_cast<uint16_t*>(s_b);
      stage_tile<uint16_t>(s_hi, kMmaPpitch, static_cast<const uint16_t*>(b), ldb, kb, kc, k_hi,
                           n0, kMmaTn, n, b_vec);
      stage_tile<uint16_t>(s_hi + kMmaStageK * kMmaPpitch, kMmaPpitch,
                           static_cast<const uint16_t*>(b_lo), ldb, kb, kc, k_hi, n0, kMmaTn, n,
                           b_vec);
    } else {
      stage_tile<float>(s_b, kMmaBpitch, static_cast<const float*>(b), ldb, kb, kc, k_hi, n0,
                        kMmaTn, n, b_vec);
    }
  };
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, frag[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int in_frag = 0;  // mma steps summed in frag
  for (int st = 0; st < kMmaStages - 1; ++st) {
    if (st < n_stages) issue(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // stage st landed; every warp is done with stage st - 1
    if (st + kMmaStages - 1 < n_stages) issue(st + kMmaStages - 1);
    cp_async_commit();
    const float* s_a = s_mem + (st % kMmaStages) * kStageFloats;
    const float* s_b = s_a + kMmaTm * kMmaApitch;
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      const int kk = warp * 32 + step * 16;  // the step's first k in the stage
      if (k_lo + st * kMmaStageK + kk >= k_hi) break;  // uniform across the warp
      // B operand = A^T (k x 8 rows of A): b0 (k 2q, 2q + 1), b1 (+ 8), row g.
      const float2 x0 = *reinterpret_cast<const float2*>(s_a + g * kMmaApitch + kk + 2 * q);
      const float2 x1 = *reinterpret_cast<const float2*>(s_a + g * kMmaApitch + kk + 2 * q + 8);
      const uint32_t xa = split_pack(x0.x), xb = split_pack(x0.y), xc = split_pack(x1.x),
                     xd = split_pack(x1.y);
      const uint32_t ah0 = hi_pair(xa, xb), ah1 = hi_pair(xc, xd);
      // A operand = B^T (16 columns of B x k): a0 (n g, k 2q, 2q + 1), a1 (n g
      // + 8), a2 (n g, k + 8), a3 (n g + 8, k + 8).
      uint32_t bh[4], bl[4];
      if constexpr (kB == kBPlanes) {
        const uint16_t* s_hi = reinterpret_cast<const uint16_t*>(s_b);
        ldmatrix_x4_trans(bh, s_hi, kk);
        if constexpr (kPasses == 3) ldmatrix_x4_trans(bl, s_hi + kMmaStageK * kMmaPpitch, kk);
      } else {
        const float* col = s_b + (kk + 2 * q) * kMmaBpitch + g;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* p = col + (i >> 1) * 8 * kMmaBpitch + (i & 1) * 8;
          const uint32_t y0 = split_pack(p[0]), y1 = split_pack(p[kMmaBpitch]);
          bh[i] = hi_pair(y0, y1);
          bl[i] = lo_pair(y0, y1);
        }
      }
      mma_bf16(frag, bh[0], bh[1], bh[2], bh[3], ah0, ah1);  // hi A * hi B
      if constexpr (kPasses == 3) {
        mma_bf16(frag, bl[0], bl[1], bl[2], bl[3], ah0, ah1);  // hi A * lo B
        mma_bf16(frag, bh[0], bh[1], bh[2], bh[3], lo_pair(xa, xb),
                 lo_pair(xc, xd));  // lo A * hi B
      }
      if (++in_frag == kMmaChunk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], frag[i]), frag[i] = 0.0f;
        in_frag = 0;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(acc[i], frag[i]);
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: the warps' totals, then the tile
  // c0 (n g, m 2q), c1 (n g, m 2q + 1), c2 (n g + 8, m 2q), c3 (n g + 8, m 2q + 1).
  const int active = min(kWarps, (k_hi - k_lo + 31) / 32);  // warps that summed
  float* mine = s_mem + warp * kMmaTm * kMmaTn;
  mine[2 * q * kMmaTn + g] = acc[0];
  mine[(2 * q + 1) * kMmaTn + g] = acc[1];
  mine[2 * q * kMmaTn + g + 8] = acc[2];
  mine[(2 * q + 1) * kMmaTn + g + 8] = acc[3];
  __syncthreads();
  finish_tile<kMmaTm, kMmaTn, kWarps>(s_mem, active, s_mem, dyn_smem_floats(), &s_last, c, m, n,
                                      m0, n0, tile, split, splits, ws, tickets);
}

// Let `kernel` take up to kMaxSmem of dynamic shared memory (above 48 KB a
// kernel has to ask), once a kernel.
cudaError_t allow_smem(const void* kernel) {
  static const void* granted[8];
  static int n_granted = 0;
  for (int i = 0; i < n_granted; ++i) {
    if (granted[i] == kernel) return cudaSuccess;
  }
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && n_granted < 8) granted[n_granted++] = kernel;
  return err;
}

// The grid of a plan over kTm x kTn tiles, or -1 where the plan does not
// cover k once (every split non-empty, k_split a multiple of kGemmStep) or
// its workspace (ws_floats) and tickets (n_tickets) are short.
long long gemm_blocks(int tm, int tn, int m, int n, int k, int splits, int k_split,
                      const float* ws, long long ws_floats, const int* tickets, int n_tickets) {
  const long long tiles = static_cast<long long>((m + tm - 1) / tm) * ((n + tn - 1) / tn);
  if (splits < 1 || k_split < kGemmStep || k_split % kGemmStep != 0 ||
      static_cast<long long>(splits - 1) * k_split >= k ||
      static_cast<long long>(splits) * k_split < k || tiles * splits > INT_MAX) {
    return -1;
  }
  if (splits > 1 && (ws == nullptr || tickets == nullptr || ws_floats > INT_MAX ||
                     tiles * splits * tm * tn > ws_floats || tiles > n_tickets)) {
    return -1;
  }
  return tiles * splits;
}

template <int kB, typename S>
int launch_fma(const float* a, int lda, const float* b, int ldb, float* c, int m, int n, int k,
               int splits, int k_split, float* ws, long long ws_floats, int* tickets,
               int n_tickets, cudaStream_t st) {
  using Tl = FmaTiling<kB, S>;
  const long long blocks = gemm_blocks(Tl::kTm, Tl::kTn, m, n, k, splits, k_split, ws,
                                       ws_floats, tickets, n_tickets);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(gemm_fma_kernel<kB, S>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_n = (n + Tl::kTn - 1) / Tl::kTn;
  const int smem = launch_smem(4 * Tl::kStageFloats,
                               stage_buffers(k_split, Tl::kStageK, Tl::kStages), splits,
                               Tl::kTm * Tl::kTn, Tl::kKw);
  gemm_fma_kernel<kB, S><<<static_cast<int>(blocks), kThreads, smem, st>>>(
      a, lda, b, ldb, c, m, n, k, tiles_n, static_cast<int>(blocks) / splits, splits, k_split, ws,
      tickets);
  return launch_status();
}

template <int kPasses, int kB>
int launch_mma(const float* a, int lda, const void* b, const void* b_lo, int ldb, float* c, int m,
               int n, int k, int splits, int k_split, float* ws, long long ws_floats,
               int* tickets, int n_tickets, cudaStream_t st) {
  const int smem = launch_smem(mma_stage_bytes(kB), stage_buffers(k_split, kMmaStageK, kMmaStages),
                               splits, kMmaTm * kMmaTn, kWarps);
  const long long blocks = gemm_blocks(kMmaTm, kMmaTn, m, n, k, splits, k_split, ws, ws_floats,
                                       tickets, n_tickets);
  if (blocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(reinterpret_cast<const void*>(gemm_mma_kernel<kPasses, kB>));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_n = (n + kMmaTn - 1) / kMmaTn;
  gemm_mma_kernel<kPasses, kB><<<static_cast<int>(blocks), kThreads, smem, st>>>(
      a, lda, b, b_lo, ldb, c, m, n, k, tiles_n, static_cast<int>(blocks) / splits, splits,
      k_split, ws, tickets);
  return launch_status();
}

// The kernels' tiling whose tile, groups and stage (tm x tn, g groups of a
// stage of sk k) a plan names, as fused_argmax_probe.GemmTiling: a plan made
// for another tiling is refused, since the wrapper sizes the workspace and
// the numpy model of the order of sums by it.
template <typename Tl>
bool is_fma_tiling(int tm, int tn, int g, int sk) {
  return tm == Tl::kTm && tn == Tl::kTn && g == Tl::kKw && sk == Tl::kStageK;
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
// or kBNK; the FMA kernel's small or wide tiling), 1 or 3 (bf16 on the
// tensor cores; kBKN or, at 3, kBPlanes; the mma kernel's tiling).  The
// plan (fused_argmax_probe.py gemm_plan): the tiling (tile_m x tile_n,
// `groups` groups of a stage of stage_k k), `splits` ranges of k_split k;
// with splits > 1, ws (ws_floats f32) holds the splits' tiles and tickets
// (n_tickets int32, zero) a counter a tile, which the launch leaves at zero.
// Returns cudaErrorInvalidValue on what the kernels do not take, else the
// launch's CUDA error or 0.
int pvot_probe_gemm(const float* a, long long lda, const void* b, const void* b_lo, int b_kind,
                    int ldb, float* c, int m, int n, int k, int passes, int tile_m, int tile_n,
                    int groups, int stage_k, int splits, int k_split, float* ws,
                    long long ws_floats, int* tickets, int n_tickets, void* stream) {
  const int inval = static_cast<int>(cudaErrorInvalidValue);
  if (m < 1 || n < 1 || k < 1 || lda < 1) return inval;
  // 32-bit indices (fma_rows says why): A's last row, B and C.
  const long long b_rows = b_kind == kBNK ? n : k, b_cols = b_kind == kBNK ? k : n;
  if (ldb < b_cols || (m - 1) * lda + k > INT_MAX || (b_rows - 1) * ldb + b_cols > INT_MAX ||
      static_cast<long long>(m) * n > INT_MAX) {
    return inval;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ld = static_cast<int>(lda);
  if (passes == 0) {
    const float* bf = static_cast<const float*>(b);
    const bool small = is_fma_tiling<FmaTiling<kBKN, FmaSmall>>(tile_m, tile_n, groups, stage_k);
    const bool wide = is_fma_tiling<FmaTiling<kBKN, FmaWide>>(tile_m, tile_n, groups, stage_k);
    if (small && b_kind == kBKN) {
      return launch_fma<kBKN, FmaSmall>(a, ld, bf, ldb, c, m, n, k, splits, k_split, ws,
                                        ws_floats, tickets, n_tickets, st);
    } else if (small && b_kind == kBNK) {
      return launch_fma<kBNK, FmaSmall>(a, ld, bf, ldb, c, m, n, k, splits, k_split, ws,
                                        ws_floats, tickets, n_tickets, st);
    } else if (wide && b_kind == kBKN) {
      return launch_fma<kBKN, FmaWide>(a, ld, bf, ldb, c, m, n, k, splits, k_split, ws,
                                       ws_floats, tickets, n_tickets, st);
    } else if (wide && b_kind == kBNK) {
      return launch_fma<kBNK, FmaWide>(a, ld, bf, ldb, c, m, n, k, splits, k_split, ws,
                                       ws_floats, tickets, n_tickets, st);
    }
    return inval;
  }
  if (tile_m != kMmaTm || tile_n != kMmaTn || groups != kWarps || stage_k != kMmaStageK) {
    return inval;
  }
  if (passes == 1 && b_kind == kBKN) {
    return launch_mma<1, kBKN>(a, ld, b, b_lo, ldb, c, m, n, k, splits, k_split, ws, ws_floats,
                               tickets, n_tickets, st);
  } else if (passes == 3 && b_kind == kBKN) {
    return launch_mma<3, kBKN>(a, ld, b, b_lo, ldb, c, m, n, k, splits, k_split, ws, ws_floats,
                               tickets, n_tickets, st);
  } else if (passes == 3 && b_kind == kBPlanes) {
    return launch_mma<3, kBPlanes>(a, ld, b, b_lo, ldb, c, m, n, k, splits, k_split, ws,
                                   ws_floats, tickets, n_tickets, st);
  }
  return inval;
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
