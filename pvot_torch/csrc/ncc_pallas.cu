// Dense NCC maps and the fused region argmax on Hopper: the port of
// pvot/ops/ncc_pallas.py `_ncc_pallas_padded` (:406, K4: `_ncc_kernel` :179
// over `_score_tile` :90-176) and `_ncc_argmax_padded` (:531, K5:
// `_ncc_argmax_kernel` :234), both at their f32 tier (highest=True; the
// shear and operator forms compute the same scores) and at the 3-pass bf16
// tier of the `pallas_fast` engine (highest=False: `_dot_hl3`, :63-87, on
// the operator form, :137-147).
//
// Lanes.  One launch serves L lanes: lane l reads its image at img + l *
// lane_stride (0: every lane reads one frame), from its origin (x0, y0) in
// that image (K5's region, read in place: no slice copy), with its template
// at tpl + l * tpl_stride (0: one template for all) and its t_mean / t_std
// at l * stat_stride.  A lane scores out_h x out_w map positions; position
// (oy, ox) correlates the image's pixels (y0 + oy + i, x0 + ox + j), i < th,
// j < tw, and pixels past the image read 0.  That covers `ncc_map_pallas`
// (one lane), `ncc_map_pallas_batched` (N frames, one template), the
// vmapped global pass of the multi-object and multi-stream steps (per-lane
// templates) and K5 for K objects or S streams in one launch per frame step
// (pvot/parallel/multi.py:110-122).
//
// The tile body (one source for K4 and K5).  A lane's map is cut into
// tiles of kTileH x 16 outputs, items in lane-major order.  The grid is
// persistent: at most SMs x (blocks an SM) blocks of 256 threads, each
// walking a contiguous run of items, so a block stages a lane's template
// once per run of that lane (K5 at 720p/80/r60: 128 tiles, one a block).  A
// step of a block (an item, or one row chunk of it for a template too large
// to stage whole) stages:
//   - the template rows by cp.async (16-byte copies when the rows are
//     16-byte aligned, else 4-byte ones), issued first, centered in shared
//     memory once they land;
//   - the window rows: u8 as aligned 16-byte vectors realigned in
//     registers, a thread's loads all issued before the first is used
//     (K1's load_window), f32 by 4-byte cp.async with zero fill past the
//     image (an L2 prefetch of the next tile's window, as K1 has, was
//     tried and made K4 slower);
//   - the box row sums run while the template is still landing, then the
//     correlation, then the column sums.
// Eight warps split the template rows (the template-row groups); a lane
// keeps kRx neighbouring outputs of one row in registers (4 for 8-row
// tiles, 8 for 16-row tiles, which halves the window loads per FMA) and
// reads four taps a step as float4 (padding columns hold 0 and add exactly
// 0).  Row sums take four columns an item, eight independent chains.  K4
// takes 16-row tiles wherever their plan fits two blocks an SM, else 8-row
// ones; K5 takes 8-row tiles.
//
// Bit for bit the earlier kernel's (one 8 x 16 tile a block).  Whatever
// the tile, every output keeps that kernel's order of sums: the template
// rows in chunks of its `chunk_rows` (its plan, 8-row tiles in a 110 KB
// budget), in each chunk the 8 groups `group * cr / 8`, each group's
// FMA chain over its rows and taps in order, the groups' partials added
// 0..7; the row sums over j in order and the column of row sums in row
// order across chunks; sum_tc with thread t summing the chunk-local padded
// indices t, t + 256, ... (padding skipped), then the fixed block_sum tree.
// The score is JAX's epilogue, (acc - mean * sum_tc) / ((sqrt(max(var,
// 1e-6)) + 1e-6) * (t_std + 1e-6) * N), with round-to-nearest intrinsics.
//
// K5 masks every position outside the lane's window (region coordinates,
// inclusive) to -inf and keeps the block's best (value desc, y asc, x asc:
// row-major first occurrence, `_ncc_argmax_kernel`'s rule); each tile
// publishes its best, and the block that finishes a lane's last tile (an
// integer counter per lane; no float atomics) folds them under the same
// total order and writes (value, x0 + x, y0 + y).  A window with every
// position masked gives (-inf, x0, y0): the order's first position, as
// JAX's flat-index minimum does.
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
// both tiers stage the same rows; a warp runs row_mma on each 8 x 16 half
// of its tile; its bound is 3 bf16 passes at 989 TFLOP/s (0.57 us for a K5
// local frame).  The tensor core's float32 sums are not round-to-nearest:
// each template row's fragment starts from 0 and joins the thread's float32
// sums with one round-to-nearest addition.  In the pallas_fast engine only
// the region scores (K5, and K4's region path past the span gate) run the
// tier; its full maps stay float32 (pvot/ops/backends.py:212-214).
// Measured times are in PERF.md.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiers.cuh"

namespace {

using pvot_tiers::row_mma;
using pvot_tiers::split_pack;
using pvot_tiers::split_rows_in_place;
using pvot_tiers::tile_output;

constexpr int kTileW = 16;                             // output columns per tile
constexpr int kGroups = 8;                             // template-row groups, a warp each
constexpr int kThreads = 32 * kGroups;                 // 256
constexpr int kParentBudget = 110 * 1024;              // the parent's plan (chunk_rows)
constexpr int kTwoBlocks = 115712;                     // bytes a block, two blocks an SM
constexpr int kStaticBytes = 256;                      // static shared memory, rounded up
constexpr int kLane = 6;                               // x0, y0, rx0, rx1, ry0, ry1
constexpr int kBig = 1 << 30;
constexpr float kU8Scale = static_cast<float>(1.0 / 255.0);
constexpr float kEps = static_cast<float>(1e-6);
constexpr float kVarFloor = static_cast<float>(1e-6);

__host__ __device__ constexpr int round_up4(int v) { return (v + 3) & ~3; }

// The parent plan, the earlier one-tile-a-block kernel's: its input-tile
// row stride (8-row tiles, consecutive rows 16 banks apart) and shared
// memory.  Its chunk rows fix which template rows each group sums, so
// every plan keeps them.
__host__ __device__ constexpr int parent_in_stride(int tw4) {
  return kTileW + tw4 + ((16 - (kTileW + tw4) % 32) + 32) % 32;
}
constexpr int parent_smem_bytes(int rows, int tw) {
  return static_cast<int>(sizeof(float)) *
         (rows * round_up4(tw) + (rows + 7) * parent_in_stride(round_up4(tw)) +
          2 * (rows + 7) * kTileW + kGroups * 8 * kTileW);
}

// Template rows of a chunk: all th when they fit the parent's budget, else
// the most that do; -1 if not one row does.
int chunk_rows(int th, int tw) {
  for (int rows = th; rows >= 1; --rows) {
    if (parent_smem_bytes(rows, tw) <= kParentBudget) return rows;
  }
  return -1;
}

// Input-tile row stride: room for 16 outputs and tw4 taps, rounded so that a
// quarter warp's window loads meet no bank conflict: 8-row tiles keep the
// parent's (two rows of four float4, 16 banks apart); 16-row tiles put
// eight rows of one float4 4 banks apart (float32) or, for row_mma's
// 8-byte loads, four rows 8 banks apart.
__host__ __device__ constexpr int in_stride(int tw4, int tile_h, int passes) {
  return tile_h == 8 ? parent_in_stride(tw4)
                     : kTileW + tw4 +
                           (((passes == 0 ? 4 : 8) - (kTileW + tw4) % 32) + 32) % 32;
}

// Dynamic shared memory of a block staging `rows` template rows beside a
// tile_h-row tile: the centered rows, the input rows, their row sums and
// squares, and the groups' partial correlations (for tile_h 8 the parent's).
__host__ __device__ constexpr int smem_bytes(int rows, int tw, int tile_h, int passes) {
  return static_cast<int>(sizeof(float)) *
         (rows * round_up4(tw) +
          (rows + tile_h - 1) * in_stride(round_up4(tw), tile_h, passes) +
          2 * (rows + tile_h - 1) * kTileW + kGroups * tile_h * kTileW);
}

// The tile height of a launch: K5 8; K4 16 where that plan fits two blocks
// an SM, else 8 (which does: it is the parent's).
int tile_height(bool argmax, int rows, int tw, int passes) {
  if (argmax) return 8;
  return smem_bytes(rows, tw, 16, passes) + kStaticBytes <= kTwoBlocks ? 16 : 8;
}

struct Geometry {
  int img_h, img_w;          // image extent: pixels past it read 0
  long long row_stride;      // elements from one image row to the next
  long long lane_stride;     // elements from one lane's image to the next (0: shared)
  int out_h, out_w;          // map positions per lane
  int tiles_x, n_tiles;      // tiles per lane
  int n_items;               // n_lanes * n_tiles
  int th, tw, rows;          // template extent, rows of a chunk (the parent's)
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// 4 bytes from src, or zeros when n is 0 (src is not read then).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies but the n most recent groups have landed.
template <int n>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// A chunk's template rows, cr x tw floats from src (global memory), into
// s_tc (rows tw4 apart) as they are, asynchronously, as one group.
__device__ void fetch_template(float* s_tc, const float* src, int cr, int tw, int tw4) {
  if ((tw & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int idx = threadIdx.x; idx < cr * tw / 4; idx += kThreads) {
      cp_async16(s_tc + 4 * idx, src + 4 * idx);  // tw == tw4: the rows are contiguous
    }
  } else {
    for (int idx = threadIdx.x; idx < cr * tw; idx += kThreads) {
      const int i = idx / tw, j = idx - i * tw;
      cp_async4(s_tc + i * tw4 + j, src + idx, 4);
    }
  }
  cp_commit();
}

// The landed chunk centered in place, tpl - t_mean (0 in the padding
// columns), as float32 or as hi/lo slots; thread t walks the parent's
// indices t, t + 256, ... and adds each value to its sum_tc share.
template <int kPasses>
__device__ void center_chunk(float* s_tc, int cr, int tw, int tw4, float mean_t, float& tsum) {
#pragma unroll 4
  for (int idx = threadIdx.x; idx < cr * tw4; idx += kThreads) {
    const int j = idx % tw4;
    float v = 0.0f;
    if (j < tw) {
      v = __fsub_rn(s_tc[idx], mean_t);
      tsum = __fadd_rn(tsum, v);
    }
    if constexpr (kPasses == 0) {
      s_tc[idx] = v;
    } else {
      reinterpret_cast<uint32_t*>(s_tc)[idx] = split_pack(v);
    }
  }
}

// Window rows gy0 .. gy0 + in_rows - 1 by columns gx0 .. gx0 + in_wl - 1 of a
// u8 image as u8 * float32(1/255), 0 past the image, into s_in (rows in_w
// apart).  A thread takes 16 columns of a row: the aligned 16-byte vector
// that holds their first byte and, when the row is not aligned, the next
// one, realigned in registers (K1's load_window, mega_body.cuh); kBatch
// groups a thread, all their loads issued before the first is used.
constexpr int kBatch = 4;

__device__ void load_window(float* s_in, const uint8_t* im, int img_h, int img_w,
                            long long row_stride, int gy0, int gx0, int in_rows, int in_wl,
                            int in_w) {
  const int nv = (in_wl + 15) >> 4;  // 16-column groups a row
  const int n = in_rows * nv;
  const int w_lim = min(img_w - gx0, in_wl);
  for (int base = threadIdx.x; base < n; base += kBatch * kThreads) {
    uint4 a[kBatch], b[kBatch];
    int lim[kBatch], mis[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = base + q * kThreads;
      a[q] = b[q] = make_uint4(0u, 0u, 0u, 0u);
      lim[q] = mis[q] = 0;
      if (idx >= n) continue;
      const int r = idx / nv, c0 = 16 * (idx - r * nv);
      const int gy = gy0 + r;
      lim[q] = gy < img_h ? w_lim : 0;  // columns taken from the image
      if (c0 < lim[q]) {
        const uint8_t* at = im + static_cast<long long>(gy) * row_stride + gx0 + c0;
        mis[q] = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 15);
        const uint4* vp = reinterpret_cast<const uint4*>(at - mis[q]);
        a[q] = __ldg(vp);
        if (mis[q] != 0 && c0 + 16 - mis[q] < lim[q]) b[q] = __ldg(vp + 1);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = base + q * kThreads;
      if (idx >= n) continue;
      const int r = idx / nv, c0 = 16 * (idx - r * nv);
      const uint32_t v[8] = {a[q].x, a[q].y, a[q].z, a[q].w, b[q].x, b[q].y, b[q].z, b[q].w};
      const int m = mis[q] >> 2, sh = 8 * (mis[q] & 3);
      float* dst = s_in + r * in_w + c0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // words k + m and k + m + 1 of v, by selects
        if (c0 + 4 * k >= in_wl) break;
        const uint32_t lo = m == 0 ? v[k] : m == 1 ? v[k + 1] : m == 2 ? v[k + 2] : v[k + 3];
        const uint32_t hi = m == 0 ? v[k + 1] : m == 1 ? v[k + 2] : m == 2 ? v[k + 3] : v[k + 4];
        const uint32_t w = __funnelshift_r(lo, hi, sh);
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t byte = c0 + 4 * k + e < lim[q] ? (w >> (8 * e)) & 0xffu : 0u;
          f[e] = __fmul_rn(static_cast<float>(byte), kU8Scale);
        }
        reinterpret_cast<float4*>(dst)[k] = make_float4(f[0], f[1], f[2], f[3]);
      }
    }
  }
}

// The same window of an f32 image, by 4-byte cp.async, zeros past the
// image, as one group: a warp a row, a lane a column.
__device__ void fetch_window(float* s_in, const float* im, int img_h, int img_w,
                             long long row_stride, int gy0, int gx0, int in_rows, int in_wl,
                             int in_w) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < in_rows; r += kThreads / 32) {
    const int gy = gy0 + r;
    const float* row = im + static_cast<long long>(gy) * row_stride + gx0;
    for (int c = lane; c < in_wl; c += 32) {
      const bool inside = gy < img_h && gx0 + c < img_w;
      cp_async4(s_in + r * in_w + c, inside ? row + c : im, inside ? 4 : 0);
    }
  }
  cp_commit();
}

// Each staged input row's sums over tw columns (and of squares), for the
// tile's 16 output columns: an item is a row's four neighbouring columns,
// eight independent chains, each over j in order.
__device__ void row_sums(const float* s_in, float* s_rs, float* s_rq, int in_rows, int in_w,
                         int tw) {
  for (int e = threadIdx.x; e < in_rows * (kTileW / 4); e += kThreads) {
    const int r = e / (kTileW / 4), x = 4 * (e % (kTileW / 4));
    const float* row = s_in + r * in_w + x;
    float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float4 a = *reinterpret_cast<const float4*>(row);
    int j0 = 0;
#pragma unroll 4
    for (; j0 + 4 <= tw; j0 += 4) {  // whole steps of four taps
      const float4 b = *reinterpret_cast<const float4*>(row + j0 + 4);
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rs[k] = __fadd_rn(rs[k], w[k + t]);
          rq[k] = fmaf(w[k + t], w[k + t], rq[k]);
        }
      }
      a = b;
    }
    if (j0 < tw) {  // the last tw % 4 taps
      const float4 b = *reinterpret_cast<const float4*>(row + j0 + 4);
      const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if (j0 + t >= tw) break;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rs[k] = __fadd_rn(rs[k], w[k + t]);
          rq[k] = fmaf(w[k + t], w[k + t], rq[k]);
        }
      }
    }
    *reinterpret_cast<float4*>(s_rs + r * kTileW + x) = make_float4(rs[0], rs[1], rs[2], rs[3]);
    *reinterpret_cast<float4*>(s_rq + r * kTileW + x) = make_float4(rq[0], rq[1], rq[2], rq[3]);
  }
}

// K4 (kArgmax false): lane l's scores to out + l * out_h * out_w.  K5
// (kArgmax true): lane l's masked argmax to out + 3 * l as (value, x, y) in
// the image's coordinates, through per-tile partials (part_val, part_yx:
// n_tiles a lane) and a per-lane counter `done` (zero before the launch, and
// again after it).  lanes: kLane ints a lane (origin and window), or null
// for origin (0, 0) (K4 only).  kPasses: the correlation's tier, 0 for
// float32 FMAs, 3 for the bf16 hi/lo passes of tiers.cuh (the `pallas_fast`
// engine's region scores).  kTileH: output rows a tile, 8 or 16.
template <typename Pix, bool kArgmax, int kPasses, int kTileH>
__global__ void __launch_bounds__(kThreads, 2)
ncc_kernel(const Pix* __restrict__ img, const int32_t* __restrict__ lanes,
           const float* __restrict__ tpl, const float* __restrict__ t_mean,
           const float* __restrict__ t_std, Geometry g, float* __restrict__ out,
           float* part_val, int32_t* part_yx, int32_t* done) {
  constexpr int kOut = kTileH * kTileW;        // outputs a tile
  constexpr int kRx = kOut / 32;               // a lane's outputs: 4 or 8
  constexpr bool kF32 = sizeof(Pix) == 4;
  extern __shared__ __align__(16) float smem[];
  __shared__ Best s_best[kThreads / 32];
  __shared__ float s_sum[kThreads / 32];
  __shared__ int s_last;
  const int tw4 = round_up4(g.tw);
  const int in_w = in_stride(tw4, kTileH, kPasses);
  const int in_wl = kTileW + tw4;  // input columns a tile reads
  const int max_in = g.rows + kTileH - 1;
  float* s_tc = smem;                     // rows x tw4 centered template rows
  float* s_in = s_tc + g.rows * tw4;      // input rows, in_w apart
  float* s_rs = s_in + max_in * in_w;     // input rows x 16 row sums
  float* s_rq = s_rs + max_in * kTileW;   // ... of squares
  float* s_red = s_rq + max_in * kTileW;  // kGroups x kOut partial correlations

  const int group = threadIdx.x >> 5, lt = threadIdx.x & 31;
  // float32 tier: lane lt holds outputs (ty, kRx * tx + k), k < kRx.
  const int ty = kRx == 4 ? lt >> 2 : lt & 15;
  const int tx = kRx == 4 ? lt & 3 : lt >> 4;
  const int o = threadIdx.x, y = o / kTileW, x = o % kTileW;  // output of threads < kOut

  // This block's items: a contiguous run, lane-major.
  const int per = g.n_items / gridDim.x, extra = g.n_items % gridDim.x;
  const int begin = blockIdx.x * per + min(static_cast<int>(blockIdx.x), extra);
  const int end = begin + per + (static_cast<int>(blockIdx.x) < extra ? 1 : 0);
  const int n_chunks = (g.th + g.rows - 1) / g.rows;
  int cur_l = -1;
  float sum_tc = 0.0f, tsum = 0.0f;

  for (int it = begin; it < end; ++it) {
    const int l = it / g.n_tiles, tile = it - l * g.n_tiles;
    const int x0 = lanes != nullptr ? lanes[l * kLane] : 0;
    const int y0 = lanes != nullptr ? lanes[l * kLane + 1] : 0;
    const Pix* im = img + l * g.lane_stride;
    const float* tp = tpl + l * g.tpl_stride;
    const float mean_t = t_mean[l * g.stat_stride];
    const float t_den = __fadd_rn(t_std[l * g.stat_stride], kEps);
    const int oy0 = (tile / g.tiles_x) * kTileH, ox0 = (tile % g.tiles_x) * kTileW;
    const bool new_lane = l != cur_l;
    cur_l = l;

    float acc[kRx];
#pragma unroll
    for (int k = 0; k < kRx; ++k) acc[k] = 0.0f;
    float bs = 0.0f, bq = 0.0f;  // thread o's window sums, over all chunks

    for (int c = 0; c < n_chunks; ++c) {
      const int r0 = c * g.rows, cr = min(g.rows, g.th - r0);
      const int in_rows = cr + kTileH - 1;
      const bool stage_tpl = n_chunks > 1 || new_lane;
      __syncthreads();  // the previous step's readers are done
      if (stage_tpl && c == 0) tsum = 0.0f;
      // The window first for f32 (its own cp.async group, waited for
      // before the template's); for u8 the template's copies go first and
      // land while this thread's window loads wait.
      if constexpr (kF32) {
        fetch_window(s_in, reinterpret_cast<const float*>(im), g.img_h, g.img_w,
                     g.row_stride, y0 + oy0 + r0, x0 + ox0, in_rows, in_wl, in_w);
        if (stage_tpl) fetch_template(s_tc, tp + static_cast<long long>(r0) * g.tw, cr, g.tw, tw4);
        if (stage_tpl) cp_wait<1>(); else cp_wait<0>();
      } else {
        if (stage_tpl) fetch_template(s_tc, tp + static_cast<long long>(r0) * g.tw, cr, g.tw, tw4);
        load_window(s_in, reinterpret_cast<const uint8_t*>(im), g.img_h, g.img_w, g.row_stride,
                    y0 + oy0 + r0, x0 + ox0, in_rows, in_wl, in_w);
      }
      __syncthreads();  // the window is in shared memory

      // Box sums, separably: each input row's sums over tw columns, while
      // the template lands ...
      row_sums(s_in, s_rs, s_rq, in_rows, in_w, g.tw);
      if (stage_tpl) cp_wait<0>();
      __syncthreads();  // the template has landed; the row sums have read the window
      if (stage_tpl) center_chunk<kPasses>(s_tc, cr, g.tw, tw4, mean_t, tsum);
      if constexpr (kPasses != 0) split_rows_in_place(s_in, in_rows, in_wl, in_w);
      __syncthreads();
      if (stage_tpl && c == n_chunks - 1) sum_tc = block_sum(tsum, s_sum);

      // ... the correlation: each warp its group's share of the chunk's
      // rows, kRx neighbouring outputs a lane, four taps a step (or a
      // template row a step and an 8 x 16 half of the tile at a time on the
      // tensor cores, at a bf16 tier) ...
      const int i_begin = group * cr / kGroups, i_end = (group + 1) * cr / kGroups;
      for (int i = i_begin; i < i_end; ++i) {
        if constexpr (kPasses == 0) {
          const float* in_row = s_in + (ty + i) * in_w + tx * kRx;
          const float* t_row = s_tc + i * tw4;
          float cur[kRx];
#pragma unroll
          for (int q = 0; q < kRx / 4; ++q) {
            const float4 v = *reinterpret_cast<const float4*>(in_row + 4 * q);
            cur[4 * q] = v.x; cur[4 * q + 1] = v.y; cur[4 * q + 2] = v.z; cur[4 * q + 3] = v.w;
          }
#pragma unroll 4
          for (int j0 = 0; j0 < tw4; j0 += 4) {
            const float4 nx = *reinterpret_cast<const float4*>(in_row + j0 + kRx);
            const float4 tv = *reinterpret_cast<const float4*>(t_row + j0);
            float wv[kRx + 4];
#pragma unroll
            for (int k = 0; k < kRx; ++k) wv[k] = cur[k];
            wv[kRx] = nx.x; wv[kRx + 1] = nx.y; wv[kRx + 2] = nx.z; wv[kRx + 3] = nx.w;
            const float t4[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
#pragma unroll
              for (int k = 0; k < kRx; ++k) acc[k] = fmaf(wv[k + t], t4[t], acc[k]);
            }
#pragma unroll
            for (int k = 0; k < kRx; ++k) cur[k] = wv[k + 4];
          }
        } else {
#pragma unroll
          for (int h = 0; h < kTileH / 8; ++h) {
            float cf[4];
            row_mma<kPasses>(cf, reinterpret_cast<const uint32_t*>(s_in) + (8 * h + i) * in_w,
                             reinterpret_cast<const uint32_t*>(s_tc) + i * tw4, in_w, in_wl,
                             g.tw);
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[4 * h + k] = __fadd_rn(acc[4 * h + k], cf[k]);
          }
        }
      }
      // ... then the column of row sums over the chunk's rows.
      if (o < kOut) {
#pragma unroll 8
        for (int i = 0; i < cr; ++i) {
          bs = __fadd_rn(bs, s_rs[(y + i) * kTileW + x]);
          bq = __fadd_rn(bq, s_rq[(y + i) * kTileW + x]);
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kRx; ++k) {
      const int out_k = kPasses == 0 ? ty * kTileW + tx * kRx + k
                                     : (k / 4) * 128 + tile_output(lt, k % 4);
      s_red[group * kOut + out_k] = acc[k];
    }
    __syncthreads();  // the partials are in shared memory

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
        if constexpr (kArgmax) {
          const int32_t* w = lanes + l * kLane;
          const bool in_window = ox >= w[2] && ox <= w[3] && oy >= w[4] && oy <= w[5];
          best = Best{in_window ? score : -INFINITY, oy, ox};
        } else {
          out[(static_cast<size_t>(l) * g.out_h + oy) * g.out_w + ox] = score;
        }
      }
    }
    if constexpr (kArgmax) {
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
      if (s_last) {  // uniform per block: this block folds lane l
        Best fold = empty_best();
        for (int i = threadIdx.x; i < g.n_tiles; i += kThreads) {
          const size_t slot = static_cast<size_t>(l) * g.n_tiles + i;
          const Best cand{__ldcg(part_val + slot), __ldcg(part_yx + 2 * slot),
                          __ldcg(part_yx + 2 * slot + 1)};
          if (lex_better(cand, fold)) fold = cand;
        }
        fold = block_best(fold, s_best);
        if (threadIdx.x == 0) {
          out[3 * l] = fold.val;
          out[3 * l + 1] = static_cast<float>(x0 + fold.x);
          out[3 * l + 2] = static_cast<float>(y0 + fold.y);
          done[l] = 0;  // ready for the next launch
        }
      }
    }
  }
}

// Let the instantiation `kernel` use `smem` bytes of dynamic shared memory
// (once per larger size) with the largest shared-memory carveout, and set
// *resident to the blocks of it the card holds at once at that size, SMs x
// blocks an SM.  `cache` is the instantiation's own: {granted bytes, device,
// bytes, resident} of its last query.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, int (&cache)[4], int* resident) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > cache[0]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    cache[0] = smem;
    cache[2] = -1;
  }
  if (dev != cache[1] || smem != cache[2]) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cache[1] = dev;
    cache[2] = smem;
    cache[3] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *resident = cache[3];
  return cudaSuccess;
}

template <typename Pix, bool kArgmax, int kPasses, int kTileH>
int launch_tiles(const Geometry& g, const Pix* img, const int32_t* lanes, const float* tpl,
                 const float* t_mean, const float* t_std, float* out, float* part_val,
                 int32_t* part_yx, int32_t* done, cudaStream_t stream) {
  static int cache[4] = {0, -1, -1, 0};
  const int smem = smem_bytes(g.rows, g.tw, kTileH, kPasses);
  auto kernel = ncc_kernel<Pix, kArgmax, kPasses, kTileH>;
  int resident = 0;
  cudaError_t err = prepare(kernel, smem, cache, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = min(g.n_items, resident);
  kernel<<<grid, kThreads, smem, stream>>>(img, lanes, tpl, t_mean, t_std, g, out, part_val,
                                           part_yx, done);
  return static_cast<int>(cudaGetLastError());
}

template <typename Pix, bool kArgmax, int kPasses>
int launch(const Pix* img, int img_h, int img_w, long long row_stride, long long lane_stride,
           const int32_t* lanes, int n_lanes, int out_h, int out_w, const float* tpl,
           long long tpl_stride, int th, int tw, const float* t_mean, const float* t_std,
           int stat_stride, float* out, float* part_val, int32_t* part_yx, int32_t* done,
           cudaStream_t stream) {
  Geometry g{};
  g.img_h = img_h; g.img_w = img_w; g.row_stride = row_stride; g.lane_stride = lane_stride;
  g.out_h = out_h; g.out_w = out_w;
  g.th = th; g.tw = tw; g.rows = chunk_rows(th, tw);
  g.tpl_stride = tpl_stride; g.stat_stride = stat_stride;
  if (g.rows < 1 || out_h < 1 || out_w < 1 || th < 1 || tw < 1 || n_lanes < 1 ||
      (kArgmax && lanes == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_h = tile_height(kArgmax, g.rows, tw, kPasses);
  g.tiles_x = (out_w + kTileW - 1) / kTileW;
  g.n_tiles = ((out_h + tile_h - 1) / tile_h) * g.tiles_x;
  if (static_cast<long long>(g.n_tiles) * n_lanes >= kBig) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g.n_items = g.n_tiles * n_lanes;
  if (tile_h == 16) {
    return launch_tiles<Pix, kArgmax, kPasses, 16>(g, img, lanes, tpl, t_mean, t_std, out,
                                                   part_val, part_yx, done, stream);
  }
  return launch_tiles<Pix, kArgmax, kPasses, 8>(g, img, lanes, tpl, t_mean, t_std, out,
                                                part_val, part_yx, done, stream);
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

// Template rows a chunk holds (see chunk_rows), for the wrapper's checks and
// the build report.
int pvot_ncc_chunk_rows(int th, int tw) { return chunk_rows(th, tw); }

// The launch plan of K4 (argmax 0) or K5 (argmax 1) for a th x tw template
// at the tier `passes`: its tile height, or -1 if no row fits; *smem gets
// the block's dynamic shared-memory bytes.  The wrapper mirrors it
// (ops/ncc_pallas.py `ncc_plan`).
int pvot_ncc_plan(int th, int tw, int argmax, int passes, int* smem) {
  const int rows = chunk_rows(th, tw);
  if (rows < 1) return -1;
  const int tile_h = tile_height(argmax != 0, rows, tw, passes);
  *smem = smem_bytes(rows, tw, tile_h, passes);
  return tile_h;
}

}  // extern "C"
