// Dense NCC maps and the fused region argmax on Hopper: the port of
// pvot/ops/ncc_pallas.py `_ncc_pallas_padded` (:406, K4: `_ncc_kernel` :179
// over `_score_tile` :90-176) and `_ncc_argmax_padded` (:531, K5:
// `_ncc_argmax_kernel` :234), both at their f32 tier (highest=True; the
// shear and operator forms compute the same scores) and at the 3-pass bf16
// tier of the `pallas_fast` engine (highest=False: `_dot_hl3`, :63-87, on
// the operator form, :137-147).
//
// Lanes.  One launch serves L lanes (grid.y): lane l reads its image at
// img + l * lane_stride (0: every lane reads one frame), from its origin
// (x0, y0) in that image (K5's region, read in place: no slice copy), with
// its template at tpl + l * tpl_stride (0: one template for all) and its
// t_mean / t_std at l * stat_stride.  A lane scores out_h x out_w map
// positions; position (oy, ox) correlates the image's pixels (y0 + oy + i,
// x0 + ox + j), i < th, j < tw, and pixels past the image read 0.  That
// covers `ncc_map_pallas` (one lane), `ncc_map_pallas_batched` (N frames,
// one template: the frame grid axis of the vmapped kernel), the vmapped
// global pass of the multi-object and multi-stream steps (per-lane
// templates) and K5 for K objects or S streams in one launch per frame step
// (pvot/parallel/multi.py:110-122).
//
// A block computes one 8 x 16 tile of one lane's map with 256 threads.  It
// stages the centered template (tpl - t_mean, rows zero-padded to a
// multiple of 4 columns) and the tile's input rows (u8 scaled by
// float32(1/255), as ensure_gray_f32 does, or f32) in shared memory: the
// whole template when it fits the 110 KB budget (two blocks an SM), else
// chunks of rows.  Eight warps split each chunk's template rows; a thread
// keeps four neighbouring outputs in registers and reads four taps per step
// as float4 (padding columns hold 0 and add exactly 0).  Box sums run
// separably: each input row's sums over tw columns, then a column of row
// sums.  The warps' partials add in a fixed order; sum_tc (the centered
// template's sum) is a block reduction in a fixed order, the same in every
// block.  The score is JAX's epilogue, (acc - mean * sum_tc) / ((sqrt(max(
// var, 1e-6)) + 1e-6) * (t_std + 1e-6) * N), with round-to-nearest
// intrinsics.
//
// K5 masks every position outside the lane's window (region coordinates,
// inclusive) to -inf and keeps the block's best (value desc, y asc, x asc:
// row-major first occurrence, `_ncc_argmax_kernel`'s rule); the blocks of
// a lane publish their best, and the last block to finish (an integer
// counter per lane; no float atomics) folds them under the same total order
// and writes (value, x0 + x, y0 + y).  A window with every position masked
// gives (-inf, x0, y0): the order's first position, as JAX's flat-index
// minimum does.
//
// What bounds it on the H100: FP32 FMA issue.  A K5 local frame at 720p /
// 80x80 / r60 scores 121 x 121 positions, 93.7 M FMA (2.80 us at 67
// TFLOP/s); a K4 global frame at 720p / 80x80 scores 641 x 1201 positions,
// 4.93 G FMA (0.1471 ms).  Bytes are small beside them: a 0.9 MB frame.
// The f32 tier keeps the correlation on FP32 FMAs from shared memory.  The
// 3-pass tier (kPasses 3) runs it on the tensor cores with warp-level
// mma.sync.m16n8k16.bf16 (tiers.cuh): corr(hi w, hi t) + corr(hi w, lo t) +
// corr(lo w, hi t), the template staged as hi/lo slots and the window split
// in place after its float32 box sums, in the bytes of the float32 rows, so
// both tiers stage the same rows; its bound is 3 bf16 passes at 989 TFLOP/s
// (0.57 us for a K5 local frame), below the latency of one launch.  The
// tensor core's float32 sums are not round-to-nearest: each template row's
// fragment starts from 0 and joins the thread's float32 sums with one
// round-to-nearest addition.  In the pallas_fast engine only the region
// scores (K5, and K4's region path past the span gate) run the tier; its
// full maps stay float32 (pvot/ops/backends.py:212-214).  Measured times are
// in PERF.md.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiers.cuh"

namespace {

using pvot_tiers::row_mma;
using pvot_tiers::split_pack;
using pvot_tiers::split_rows_in_place;
using pvot_tiers::tile_output;

constexpr int kTileH = 8;                              // output rows per tile
constexpr int kTileW = 16;                             // output columns per tile
constexpr int kRx = 4;                                 // outputs per thread along x
constexpr int kGroupThreads = kTileH * kTileW / kRx;   // 32: one warp covers a tile
constexpr int kGroups = 8;                             // template-row groups
constexpr int kThreads = kGroupThreads * kGroups;      // 256
constexpr int kOut = kTileH * kTileW;                  // outputs per tile
constexpr int kSmemBudget = 110 * 1024;                // two blocks an SM
constexpr int kLane = 6;                               // x0, y0, rx0, rx1, ry0, ry1
constexpr int kBig = 1 << 30;
constexpr float kU8Scale = static_cast<float>(1.0 / 255.0);
constexpr float kEps = static_cast<float>(1e-6);
constexpr float kVarFloor = static_cast<float>(1e-6);

__host__ __device__ constexpr int round_up4(int v) { return (v + 3) & ~3; }

// Input-tile row stride: room for kTileW outputs and tw4 taps, rounded so
// that consecutive rows start 16 banks apart (as in ncc_mega.cu).
__host__ __device__ constexpr int in_stride(int tw4) {
  return kTileW + tw4 + ((16 - (kTileW + tw4) % 32) + 32) % 32;
}

// Dynamic shared memory of a block staging `rows` template rows: the
// centered rows, the input rows, their row sums and squares, and the warps'
// partial correlations.
__host__ __device__ constexpr int smem_bytes(int rows, int tw) {
  return static_cast<int>(sizeof(float)) *
         (rows * round_up4(tw) + (rows + kTileH - 1) * in_stride(round_up4(tw)) +
          2 * (rows + kTileH - 1) * kTileW + kGroups * kOut);
}

// Template rows a block stages at once: all th when they fit the budget,
// else the most that do; -1 if not one row does.
int chunk_rows(int th, int tw) {
  for (int rows = th; rows >= 1; --rows) {
    if (smem_bytes(rows, tw) <= kSmemBudget) return rows;
  }
  return -1;
}

struct Geometry {
  int img_h, img_w;          // image extent: pixels past it read 0
  long long row_stride;      // elements from one image row to the next
  long long lane_stride;     // elements from one lane's image to the next (0: shared)
  int out_h, out_w;          // map positions per lane
  int tiles_x, n_tiles;      // 8 x 16 tiles per lane
  int th, tw, rows;          // template extent, rows staged at once
  long long tpl_stride;      // elements from one lane's template to the next (0: shared)
  int stat_stride;           // elements from one lane's t_mean / t_std to the next
};

struct Best {
  float val;
  int y, x;
};

// (value desc, y asc, x asc): row-major first occurrence.
__device__ __forceinline__ bool lex_better(const Best& a, const Best& b) {
  return a.val > b.val || (a.val == b.val && (a.y < b.y || (a.y == b.y && a.x < b.x)));
}

__device__ __forceinline__ Best empty_best() { return Best{-INFINITY, kBig, kBig}; }

__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.val = __shfl_xor_sync(0xffffffffu, b.val, off);
    o.y = __shfl_xor_sync(0xffffffffu, b.y, off);
    o.x = __shfl_xor_sync(0xffffffffu, b.x, off);
    if (lex_better(o, b)) b = o;
  }
  return b;
}

// Block-wide lexicographic best; every thread gets it.
__device__ Best block_best(Best b, Best* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  b = warp_best(b);
  __syncthreads();
  if (lane == 0) scratch[warp] = b;
  __syncthreads();
  b = lane < kThreads / 32 ? scratch[lane] : empty_best();
  return warp_best(b);
}

// Block-wide sum in a fixed tree order; every thread gets it.
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < kThreads / 32 ? scratch[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float pixel(const uint8_t* p) {
  return __fmul_rn(static_cast<float>(*p), kU8Scale);
}
__device__ __forceinline__ float pixel(const float* p) { return *p; }

// K4 (kArgmax false): lane l's scores to out + l * out_h * out_w.  K5
// (kArgmax true): lane l's masked argmax to out + 3 * l as (value, x, y) in
// the image's coordinates, through per-block partials (part_val, part_yx:
// n_tiles a lane) and a per-lane counter `done` (zero before the launch, and
// again after it).  lanes: kLane ints a lane (origin and window), or null
// for origin (0, 0) (K4 only).  kPasses: the correlation's tier, 0 for
// float32 FMAs, 3 for the bf16 hi/lo passes of tiers.cuh (the `pallas_fast`
// engine's region scores); the template's and then the window's hi/lo slots
// take the float32 rows' bytes, so every tier stages the same rows.
template <typename Pix, bool kArgmax, int kPasses>
__global__ void __launch_bounds__(kThreads)
ncc_kernel(const Pix* __restrict__ img, const int32_t* __restrict__ lanes,
           const float* __restrict__ tpl, const float* __restrict__ t_mean,
           const float* __restrict__ t_std, Geometry g, float* __restrict__ out,
           float* part_val, int32_t* part_yx, int32_t* done) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Best s_best[kThreads / 32];
  __shared__ float s_sum[kThreads / 32];
  __shared__ int s_last;
  const int l = blockIdx.y, tile = blockIdx.x;
  const int tw4 = round_up4(g.tw);
  const int in_w = in_stride(tw4);
  const int in_wl = kTileW + tw4;  // input columns a tile reads
  const int in_h = g.rows + kTileH - 1;
  float* s_tc = smem;                     // rows x tw4 centered template rows
  float* s_in = s_tc + g.rows * tw4;      // in_h x in_w input rows
  float* s_rs = s_in + in_h * in_w;       // in_h x kTileW row sums
  float* s_rq = s_rs + in_h * kTileW;     // in_h x kTileW row sums of squares
  float* s_red = s_rq + in_h * kTileW;    // kGroups x kOut partial correlations

  const int x0 = lanes != nullptr ? lanes[l * kLane] : 0;
  const int y0 = lanes != nullptr ? lanes[l * kLane + 1] : 0;
  const Pix* im = img + l * g.lane_stride;
  const float* tp = tpl + l * g.tpl_stride;
  const float mean_t = t_mean[l * g.stat_stride];
  const float t_den = __fadd_rn(t_std[l * g.stat_stride], kEps);
  const int oy0 = (tile / g.tiles_x) * kTileH, ox0 = (tile % g.tiles_x) * kTileW;

  const int group = threadIdx.x / kGroupThreads;
  const int lt = threadIdx.x % kGroupThreads;
  const int ty = lt / (kTileW / kRx), tx = lt % (kTileW / kRx);
  const int o = threadIdx.x, y = o / kTileW, x = o % kTileW;  // output of threads < kOut

  float acc[kRx];
#pragma unroll
  for (int k = 0; k < kRx; ++k) acc[k] = 0.0f;
  float bs = 0.0f, bq = 0.0f;  // thread o's window sums, over all chunks
  float tsum = 0.0f;           // this thread's share of sum_tc

  for (int r0 = 0; r0 < g.th; r0 += g.rows) {
    const int cr = min(g.rows, g.th - r0);
    const int in_rows = cr + kTileH - 1;
    if (r0 > 0) __syncthreads();  // the previous chunk's readers are done
    for (int idx = threadIdx.x; idx < cr * tw4; idx += kThreads) {
      const int i = idx / tw4, j = idx % tw4;
      float v = 0.0f;
      if (j < g.tw) {
        v = __fsub_rn(tp[static_cast<size_t>(r0 + i) * g.tw + j], mean_t);
        tsum = __fadd_rn(tsum, v);
      }
      if constexpr (kPasses == 0) {
        s_tc[idx] = v;
      } else {
        reinterpret_cast<uint32_t*>(s_tc)[idx] = split_pack(v);
      }
    }
    for (int idx = threadIdx.x; idx < in_rows * in_wl; idx += kThreads) {
      const int r = idx / in_wl, c = idx % in_wl;
      const int gy = y0 + oy0 + r0 + r, gx = x0 + ox0 + c;
      s_in[r * in_w + c] = (gy < g.img_h && gx < g.img_w)
                               ? pixel(im + static_cast<long long>(gy) * g.row_stride + gx)
                               : 0.0f;
    }
    __syncthreads();

    // Box sums, separably: each input row's sums over tw columns ...
    for (int e = threadIdx.x; e < in_rows * kTileW; e += kThreads) {
      const int r = e / kTileW, xx = e % kTileW;
      const float* row = s_in + r * in_w + xx;
      float rs = 0.0f, rq = 0.0f;
      for (int j = 0; j < g.tw; ++j) {
        rs = __fadd_rn(rs, row[j]);
        rq = fmaf(row[j], row[j], rq);
      }
      s_rs[e] = rs;
      s_rq[e] = rq;
    }
    if constexpr (kPasses != 0) {
      __syncthreads();  // the box sums have read the float32 window rows
      split_rows_in_place(s_in, in_rows, in_wl, in_w);
      __syncthreads();
    }
    // ... while each warp correlates its share of the chunk's rows, four
    // neighbouring outputs a thread, four taps a step (or a template row a
    // step on the tensor cores, at a bf16 tier).
    const int i_begin = group * cr / kGroups, i_end = (group + 1) * cr / kGroups;
    for (int i = i_begin; i < i_end; ++i) {
      if constexpr (kPasses == 0) {
        const float* in_row = s_in + (ty + i) * in_w + tx * kRx;
        const float* t_row = s_tc + i * tw4;
        float4 a = *reinterpret_cast<const float4*>(in_row);
        for (int j0 = 0; j0 < tw4; j0 += 4) {
          const float4 b = *reinterpret_cast<const float4*>(in_row + j0 + 4);
          const float4 tv = *reinterpret_cast<const float4*>(t_row + j0);
          const float wv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
          for (int k = 0; k < kRx; ++k) {
            acc[k] = fmaf(wv[k], tv.x, acc[k]);
            acc[k] = fmaf(wv[k + 1], tv.y, acc[k]);
            acc[k] = fmaf(wv[k + 2], tv.z, acc[k]);
            acc[k] = fmaf(wv[k + 3], tv.w, acc[k]);
          }
          a = b;
        }
      } else {
        float c[4];
        row_mma<kPasses>(c, reinterpret_cast<const uint32_t*>(s_in) + i * in_w,
                         reinterpret_cast<const uint32_t*>(s_tc) + i * tw4, in_w, in_wl, g.tw);
#pragma unroll
        for (int k = 0; k < kRx; ++k) acc[k] = __fadd_rn(acc[k], c[k]);
      }
    }
    __syncthreads();  // row sums are in shared memory
    if (o < kOut) {   // ... then the column of row sums over the chunk's rows
      for (int i = 0; i < cr; ++i) {
        bs = __fadd_rn(bs, s_rs[(y + i) * kTileW + x]);
        bq = __fadd_rn(bq, s_rq[(y + i) * kTileW + x]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRx; ++k) {
    s_red[group * kOut + (kPasses == 0 ? lt * kRx + k : tile_output(lt, k))] = acc[k];
  }
  const float sum_tc = block_sum(tsum, s_sum);  // its barriers publish s_red too

  Best best = empty_best();
  if (o < kOut) {
    float a = 0.0f;
    for (int gi = 0; gi < kGroups; ++gi) a = __fadd_rn(a, s_red[gi * kOut + o]);
    const float n = static_cast<float>(g.th * g.tw);
    const float mean = __fdiv_rn(bs, n);
    const float var = __fsub_rn(__fdiv_rn(bq, n), __fmul_rn(mean, mean));
    const float sd = __fsqrt_rn(fmaxf(var, kVarFloor));
    const float cov = __fsub_rn(a, __fmul_rn(mean, sum_tc));
    const float den = __fmul_rn(__fmul_rn(__fadd_rn(sd, kEps), t_den), n);
    const float score = __fdiv_rn(cov, den);
    const int oy = oy0 + y, ox = ox0 + x;
    if (oy < g.out_h && ox < g.out_w) {
      if (kArgmax) {
        const int32_t* w = lanes + l * kLane;
        const bool in_window = ox >= w[2] && ox <= w[3] && oy >= w[4] && oy <= w[5];
        best = Best{in_window ? score : -INFINITY, oy, ox};
      } else {
        out[(static_cast<size_t>(l) * g.out_h + oy) * g.out_w + ox] = score;
      }
    }
  }
  if (!kArgmax) return;

  best = block_best(best, s_best);
  if (threadIdx.x == 0) {
    const size_t slot = static_cast<size_t>(l) * g.n_tiles + tile;
    part_val[slot] = best.val;
    part_yx[2 * slot] = best.y;
    part_yx[2 * slot + 1] = best.x;
    __threadfence();
    s_last = atomicAdd(&done[l], 1) == g.n_tiles - 1;
  }
  __syncthreads();
  if (!s_last) return;  // uniform per block
  Best fold = empty_best();
  for (int i = threadIdx.x; i < g.n_tiles; i += kThreads) {
    const size_t slot = static_cast<size_t>(l) * g.n_tiles + i;
    const Best c{__ldcg(part_val + slot), __ldcg(part_yx + 2 * slot),
                 __ldcg(part_yx + 2 * slot + 1)};
    if (lex_better(c, fold)) fold = c;
  }
  fold = block_best(fold, s_best);
  if (threadIdx.x == 0) {
    out[3 * l] = fold.val;
    out[3 * l + 1] = static_cast<float>(x0 + fold.x);
    out[3 * l + 2] = static_cast<float>(y0 + fold.y);
    done[l] = 0;  // ready for the next launch
  }
}

// Let the instantiation use `smem` bytes of dynamic shared memory (once per
// larger size) and prefer the largest shared-memory carveout.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int* granted) {
  if (smem <= *granted) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) *granted = smem;
  return err;
}

template <typename Pix, bool kArgmax, int kPasses>
int launch(const Pix* img, int img_h, int img_w, long long row_stride, long long lane_stride,
           const int32_t* lanes, int n_lanes, int out_h, int out_w, const float* tpl,
           long long tpl_stride, int th, int tw, const float* t_mean, const float* t_std,
           int stat_stride, float* out, float* part_val, int32_t* part_yx, int32_t* done,
           cudaStream_t stream) {
  static int granted = 0;
  Geometry g{};
  g.img_h = img_h; g.img_w = img_w; g.row_stride = row_stride; g.lane_stride = lane_stride;
  g.out_h = out_h; g.out_w = out_w;
  g.tiles_x = (out_w + kTileW - 1) / kTileW;
  g.n_tiles = ((out_h + kTileH - 1) / kTileH) * g.tiles_x;
  g.th = th; g.tw = tw; g.rows = chunk_rows(th, tw);
  g.tpl_stride = tpl_stride; g.stat_stride = stat_stride;
  if (g.rows < 1 || out_h < 1 || out_w < 1 || th < 1 || tw < 1 || n_lanes < 1 ||
      n_lanes > 65535 || (kArgmax && lanes == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(g.rows, tw);
  auto kernel = ncc_kernel<Pix, kArgmax, kPasses>;
  cudaError_t err = allow_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(g.n_tiles, n_lanes), kThreads, smem, stream>>>(
      img, lanes, tpl, t_mean, t_std, g, out, part_val, part_yx, done);
  return static_cast<int>(cudaGetLastError());
}

// launch() at the tier `passes`: 0 (float32) or 3 (bf16 hi/lo); another
// tier is refused.
template <typename Pix, bool kArgmax>
int launch_tier(int passes, const Pix* img, int img_h, int img_w, long long row_stride,
                long long lane_stride, const int32_t* lanes, int n_lanes, int out_h, int out_w,
                const float* tpl, long long tpl_stride, int th, int tw, const float* t_mean,
                const float* t_std, int stat_stride, float* out, float* part_val,
                int32_t* part_yx, int32_t* done, cudaStream_t stream) {
  if (passes == 0) {
    return launch<Pix, kArgmax, 0>(img, img_h, img_w, row_stride, lane_stride, lanes, n_lanes,
                                   out_h, out_w, tpl, tpl_stride, th, tw, t_mean, t_std,
                                   stat_stride, out, part_val, part_yx, done, stream);
  }
  if (passes == 3) {
    return launch<Pix, kArgmax, 3>(img, img_h, img_w, row_stride, lane_stride, lanes, n_lanes,
                                   out_h, out_w, tpl, tpl_stride, th, tw, t_mean, t_std,
                                   stat_stride, out, part_val, part_yx, done, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// K4: n_lanes dense NCC maps, one launch on `stream`, no synchronisation.
// img: u8 (img_u8 != 0) or f32 pixels; lane l's image at img + l *
// lane_stride elements, rows row_stride apart, img_h x img_w of them; lanes:
// null (every origin (0, 0)) or kLane ints a lane whose first two are the
// origin (x0, y0); tpl: th x tw f32 rows at tpl + l * tpl_stride; t_mean,
// t_std: f32 at l * stat_stride; out: n_lanes x out_h x out_w f32; passes:
// the tier, 0 (float32) or 3 (bf16 hi/lo).  Returns the CUDA error of the
// launch, or 0.
int pvot_ncc_map(const void* img, int img_u8, int img_h, int img_w, long long row_stride,
                 long long lane_stride, const int32_t* lanes, int n_lanes, int out_h, int out_w,
                 const float* tpl, long long tpl_stride, int th, int tw, const float* t_mean,
                 const float* t_std, int stat_stride, float* out, int passes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_u8) {
    return launch_tier<uint8_t, false>(passes, static_cast<const uint8_t*>(img), img_h, img_w,
                                       row_stride, lane_stride, lanes, n_lanes, out_h, out_w,
                                       tpl, tpl_stride, th, tw, t_mean, t_std, stat_stride, out,
                                       nullptr, nullptr, nullptr, s);
  }
  return launch_tier<float, false>(passes, static_cast<const float*>(img), img_h, img_w,
                                   row_stride, lane_stride, lanes, n_lanes, out_h, out_w, tpl,
                                   tpl_stride, th, tw, t_mean, t_std, stat_stride, out, nullptr,
                                   nullptr, nullptr, s);
}

// K5: n_lanes fused region scores + window mask + argmax, one launch on
// `stream`.  As K4, with lanes required: lane l's kLane ints are its region
// origin (x0, y0) in the image and its window [rx0, rx1] x [ry0, ry1] in
// region coordinates; the region is out_h x out_w positions (the span).
// out: n_lanes x 3 f32 (value, x, y), x and y in the image's coordinates.
// part_val (n_lanes x n_tiles f32), part_yx (n_lanes x n_tiles x 2 i32) and
// done (n_lanes i32, zero; left zero) are scratch, n_tiles = ceil(out_h / 8)
// * ceil(out_w / 16).  passes: the tier, as in pvot_ncc_map.
int pvot_ncc_region_argmax(const void* img, int img_u8, int img_h, int img_w,
                           long long row_stride, long long lane_stride, const int32_t* lanes,
                           int n_lanes, int out_h, int out_w, const float* tpl,
                           long long tpl_stride, int th, int tw, const float* t_mean,
                           const float* t_std, int stat_stride, float* out, float* part_val,
                           int32_t* part_yx, int32_t* done, int passes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (img_u8) {
    return launch_tier<uint8_t, true>(passes, static_cast<const uint8_t*>(img), img_h, img_w,
                                      row_stride, lane_stride, lanes, n_lanes, out_h, out_w,
                                      tpl, tpl_stride, th, tw, t_mean, t_std, stat_stride, out,
                                      part_val, part_yx, done, s);
  }
  return launch_tier<float, true>(passes, static_cast<const float*>(img), img_h, img_w,
                                  row_stride, lane_stride, lanes, n_lanes, out_h, out_w, tpl,
                                  tpl_stride, th, tw, t_mean, t_std, stat_stride, out, part_val,
                                  part_yx, done, s);
}

// Template rows a block stages at once (see chunk_rows), for the wrapper's
// checks and the build report.
int pvot_ncc_chunk_rows(int th, int tw) { return chunk_rows(th, tw); }

}  // extern "C"
