// The body of the chunk kernels K1-K3 (ncc_mega.cu) and of K1's rung ladder
// (mega_breakdown.cu): the score and commit kernels of one frame step, the
// helpers they need and the host-side launch setup.  Each translation unit
// that includes this header instantiates its own kernels (an anonymous
// namespace): ncc_mega.cu only the production stage, kFull, and
// mega_breakdown.cu the ladder's stages of K1's main-path case.  The design
// and the numerics are described at the top of ncc_mega.cu.
//
// Stages (kStage, the rung ladder of tools/mega_breakdown.py on the card).
// Every kernel here takes a stage, kFull by default, and every stage boundary
// is an `if constexpr`, so the kFull kernels are the production code and a
// rung compiles K1's two launches cut off after its stage:
//   kEmpty     score: lane_work (mode, window clamp) and each item's tile;
//              commit: the walk (bx + 1, by + (t & 1), as
//              tools/mega_breakdown.py:126-131) and a one-value record;
//   kDma       + the window rows' u8 loads from global memory;
//   kConvert   + the u8 -> f32 convert and the shared-memory store;
//   kScoreBox  + the template staging, the box sums and the normalisation,
//              the correlation left out (acc = 0);
//   kScore     + the correlation (float32 FMAs, or row_mma with the window
//              rows' in-place split) and the split-tile combine;
//   kArgmax    + the block best and partials; the commit's fold, gate and
//              bbox/state commit, without the EMA;
//   kFull      + the template EMA and stats: production.
// A rung before kArgmax leaves its work observable as a checksum in record
// field 4: each score block writes its part to its partial slot (an integer
// in part_yx for kEmpty-kConvert, a float in part_val for kScoreBox and
// kScore; 0 from a block without an item), and the walk commit folds the
// slots in a fixed order (the integer sum modulo 2^24, exact in float32):
//   kEmpty     the sum over items of the tile origin, oy0 + ox0;
//   kDma       the sum of the bytes each item loads (its unit's input rows,
//              0 past the frame);
//   kConvert   the sum of the converted values' bit patterns, read back from
//              shared memory;
//   kScoreBox  the sum over each item's outputs in the window of sd + s, the
//              window's standard deviation over the item's rows (a half of
//              them when two blocks share the tile) and the score with acc = 0;
//   kScore     the sum over the window of |score|.
// The ladder is instantiated only for K1's main-path case (kWhole, kOne, no
// kExt, no kBatch).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tiers.cuh"

namespace {

using pvot_tiers::row_mma;
using pvot_tiers::split_pack;
using pvot_tiers::split_rows_in_place;
using pvot_tiers::tile_output;

constexpr int kTileH = 8;                     // output rows per tile
constexpr int kTileW = 16;                    // output columns per tile
constexpr int kRx = 4;                        // outputs per thread along x
constexpr int kGroupThreads = kTileH * kTileW / kRx;  // 32: one warp, one tile
constexpr int kSplit = 16;                    // template-row groups
constexpr int kScoreThreads = kGroupThreads * kSplit;  // 512
constexpr int kOut = kTileH * kTileW;         // outputs per tile
constexpr int kCommitThreads = 1024;
constexpr int kEmaPerThread = 20;             // template pixels kept in registers
constexpr int kBig = 1 << 30;
constexpr int kRecord = 10;                   // record fields, O_* order
constexpr int kStateI = 8;                    // bx, by, bw, bh, lost, use_global, n_valid, _
constexpr int kStateF = 4;                    // t_mean, t_std, sum_tc, _
constexpr int kSmemLimit = 232448;            // dynamic shared memory of one block
constexpr float kU8Scale = static_cast<float>(1.0 / 255.0);
constexpr float kEps = static_cast<float>(1e-6);
constexpr float kVarFloor = static_cast<float>(1e-6);
// The stages of the header comment, in order.
constexpr int kEmpty = 0, kDma = 1, kConvert = 2, kScoreBox = 3, kScore = 4, kArgmax = 5,
              kFull = 6;
constexpr uint32_t kChecksumMask = (1u << 24) - 1;  // integer checksums modulo 2^24

__host__ __device__ constexpr int round_up4(int v) { return (v + 3) & ~3; }

// Input-tile row stride: room for kTileW outputs and tw4 taps, rounded so
// that consecutive rows start 16 banks apart (conflict-free float4 reads by
// the two rows of a quarter warp, and by the row-sum pass).
__host__ __device__ constexpr int in_stride(int tw4) {
  return kTileW + tw4 + ((16 - (kTileW + tw4) % 32) + 32) % 32;
}

// One lane's work in the current frame, in the score block's shared memory.
struct LaneWork {
  int ry0, rx0, ry1, rx1;  // inclusive region of map positions
  int tiles_x, n_tiles;
  int do_global, split;    // split: 2 when two blocks share each tile
  int begin, n_items;      // the lane's items in the block's union
  float t_mean, t_den, sum_tc;  // template stats (t_den = t_std + 1e-6)
  int th, tw;              // the lane's template extent
};

// The lane table of a launch with n_lanes lanes; a one-lane launch has none.
__host__ __device__ constexpr int lane_table_bytes(int n_lanes) {
  return n_lanes > 1 ? (n_lanes * static_cast<int>(sizeof(LaneWork)) + 15) / 16 * 16 : 0;
}

// Dynamic shared memory of one score block staging `rows` template rows, in
// bytes (pvot_torch/ops/ncc_mega.py MegaGeometry.smem_bytes mirrors it):
// the lane table, the centered template rows, the input rows, their row sums,
// and for both halves the row groups' partial correlations and the outputs'
// column sums.
__host__ __device__ constexpr int score_smem_bytes(int rows, int tw, int n_lanes) {
  return lane_table_bytes(n_lanes) +
         static_cast<int>(sizeof(float)) *
             (rows * round_up4(tw) + (rows + kTileH - 1) * in_stride(round_up4(tw)) +
              2 * (rows + kTileH - 1) * kTileW + 2 * kSplit * kOut + 4 * kOut);
}

// Template rows a score block stages at once: all th when they fit, else the
// fewest equal chunks of the longer half that fit; -1 if none does.
int stage_rows(int th, int tw, int n_lanes) {
  if (score_smem_bytes(th, tw, n_lanes) <= kSmemLimit) return th;
  const int half = th - th / 2;
  for (int n = 1; n <= half; ++n) {
    const int ck = (half + n - 1) / n;
    if (score_smem_bytes(ck, tw, n_lanes) <= kSmemLimit) return ck;
  }
  return -1;
}

struct Params {
  int frame_h, frame_w, th, tw, out_h, out_w;  // th, tw: the template buffer's (bucket's)
  int radius_x, radius_y, lost_threshold, enable_global;
  int n_lanes;
  int n_slots;          // partial slots per lane: one per score block
  int max_split_tiles;  // split scratch per lane, in tiles
  int stage_rows;
  long long frame_stride;  // elements from one lane's frames to the next's (0: shared)
  long long frame_px;      // elements of one frame
  const int32_t* ext;      // per-lane (th, tw), or null: every lane th x tw
  float min_conf, global_conf, strong_conf, lr, one_minus_lr;
};

// A lane's template extent and the extent of its score map: the launch's
// (every lane th x tw), or lane l's own from the extent table.
struct Extent {
  int th, tw, out_h, out_w;
};

__device__ __forceinline__ Extent launch_extent(const Params& p) {
  return Extent{p.th, p.tw, p.out_h, p.out_w};
}

__device__ __forceinline__ Extent lane_extent(const Params& p, int l) {  // p.ext not null
  const int th = p.ext[2 * l], tw = p.ext[2 * l + 1];
  return Extent{th, tw, p.frame_h - th + 1, p.frame_w - tw + 1};
}

// Mode of frame t from a lane's state (pvot/ops/ncc_mega.py:541-573) and the
// inclusive block of map positions the frame scores.
struct Mode {
  bool use_global;  // this frame's computed flag (sets the threshold)
  bool do_global;   // the argmax runs over the full map
  bool valid;       // t < n_valid
  int ry0, ry1, rx0, rx1;
};

__device__ __forceinline__ bool bbox_outside(int bx, int by, int bw, int bh,
                                             const Params& p) {
  const int cx = bx + (bw >> 1), cy = by + (bh >> 1);
  const bool center_out = cx < 0 || cx >= p.frame_w || cy < 0 || cy >= p.frame_h;
  const bool box_out =
      bx + bw < 0 || bx >= p.frame_w || by + bh < 0 || by >= p.frame_h;
  return center_out || box_out;
}

__device__ Mode frame_mode(const int32_t* si, const Params& p, int t, const Extent& e) {
  const int bx = si[0], by = si[1], bw = si[2], bh = si[3];
  const int lost = si[4], useg = si[5], n_valid = si[6];
  Mode m;
  m.use_global = p.enable_global &&
                 (useg != 0 || bbox_outside(bx, by, bw, bh, p) ||
                  lost >= p.lost_threshold);
  const int cx = bx + (bw >> 1), cy = by + (bh >> 1);
  const int min_tx = max(0, cx - p.radius_x - (e.tw >> 1));
  const int max_tx = min(e.out_w - 1, cx + p.radius_x - (e.tw >> 1));
  const int min_ty = max(0, cy - p.radius_y - (e.th >> 1));
  const int max_ty = min(e.out_h - 1, cy + p.radius_y - (e.th >> 1));
  const bool window_valid = max_tx >= min_tx && max_ty >= min_ty;
  m.valid = t < n_valid;
  m.do_global = (m.use_global || !window_valid) && m.valid;
  if (m.do_global) {
    m.ry0 = 0; m.ry1 = e.out_h - 1; m.rx0 = 0; m.rx1 = e.out_w - 1;
  } else {  // empty when the window collapsed on a frame past n_valid
    m.ry0 = min_ty; m.ry1 = max_ty; m.rx0 = min_tx; m.rx1 = max_tx;
  }
  return m;
}

struct Best {
  float val;
  int y, x;
};

// (value desc, y asc, x asc): pvot/ops/ncc_mega.py:487 _lex_better.
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

// Block-wide lexicographic best; every thread gets the result.  `scratch`
// holds one Best per warp.
__device__ Best block_best(Best b, Best* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  b = warp_best(b);
  __syncthreads();  // scratch may still be read from an earlier call
  if (lane == 0) scratch[warp] = b;
  __syncthreads();
  b = lane < n_warps ? scratch[lane] : empty_best();
  return warp_best(b);
}

// Block-wide sums of a pair of floats in a fixed tree order; every thread
// gets the result.
__device__ float2 block_sum2(float2 v, float2* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < n_warps ? scratch[lane] : make_float2(0.0f, 0.0f);
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// Block-wide sum of 32-bit integers modulo 2^32 (exact in any order); every
// thread gets the result.  The ladder's integer checksums.
__device__ __forceinline__ uint32_t block_sum_u32(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < n_warps ? scratch[lane] : 0u;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One lane's centered template rows, tpl - t_mean, from `src` (rows x tw4,
// zero-padded) into s_tc, by threads begin, begin + step, ...  Padding
// columns stay 0, so they add exactly 0 to the correlation.
__device__ __forceinline__ void stage_template(float* s_tc, const float* src, float t_mean,
                                               int rows, int tw, int tw4, int begin, int step) {
  for (int idx = begin; idx < rows * tw4 / 4; idx += step) {
    const float4 v = reinterpret_cast<const float4*>(src)[idx];
    const int j = (4 * idx) % tw4;
    reinterpret_cast<float4*>(s_tc)[idx] = make_float4(
        j < tw ? __fsub_rn(v.x, t_mean) : 0.0f, j + 1 < tw ? __fsub_rn(v.y, t_mean) : 0.0f,
        j + 2 < tw ? __fsub_rn(v.z, t_mean) : 0.0f, j + 3 < tw ? __fsub_rn(v.w, t_mean) : 0.0f);
  }
}

// stage_template for the tiers (tiers.cuh): each centered value (0 in the padding
// columns) as its hi/lo slot, in the bytes the float32 rows take.
__device__ __forceinline__ void stage_template_split(uint32_t* s_tc, const float* src,
                                                     float t_mean, int rows, int tw, int tw4,
                                                     int begin, int step) {
  for (int idx = begin; idx < rows * tw4 / 4; idx += step) {
    const float4 v = reinterpret_cast<const float4*>(src)[idx];
    const int j = (4 * idx) % tw4;
    reinterpret_cast<uint4*>(s_tc)[idx] = make_uint4(
        j < tw ? split_pack(__fsub_rn(v.x, t_mean)) : 0u,
        j + 1 < tw ? split_pack(__fsub_rn(v.y, t_mean)) : 0u,
        j + 2 < tw ? split_pack(__fsub_rn(v.z, t_mean)) : 0u,
        j + 3 < tw ? split_pack(__fsub_rn(v.w, t_mean)) : 0u);
  }
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One lane's work in frame t from its state (si, sf: the lane's slots) and
// extent, unsplit; the caller decides whether two blocks share each tile.
__device__ LaneWork lane_work(const int32_t* si, const float* sf, const Params& p, int t,
                              const Extent& e) {
  const Mode m = frame_mode(si, p, t, e);
  LaneWork w;
  w.th = e.th; w.tw = e.tw;
  w.ry0 = m.ry0; w.rx0 = m.rx0; w.ry1 = m.ry1; w.rx1 = m.rx1;
  const int reg_h = m.ry1 - m.ry0 + 1, reg_w = m.rx1 - m.rx0 + 1;
  w.tiles_x = reg_w > 0 ? (reg_w + kTileW - 1) / kTileW : 0;
  w.n_tiles = reg_h > 0 ? ((reg_h + kTileH - 1) / kTileH) * w.tiles_x : 0;
  w.do_global = m.do_global;
  w.split = 1; w.begin = 0; w.n_items = 0;
  w.t_mean = sf[0];
  w.t_den = __fadd_rn(sf[1], kEps);
  w.sum_tc = sf[2];
  return w;
}

// kWhole: the whole template is staged at once (stage_rows == th).  kOne:
// the launch has one lane (K1); every thread derives its work into
// registers, and there is no lane table.  kExt: the lanes have extents of
// their own (K3's bucketed mode; never with kOne); without it every lane has
// the launch's, as constant over the whole launch as in a one-lane one.
// kPasses: the score tier, 0 for float32 FMAs, else the bf16 passes of
// row_mma (the template rows and, after the box sums, the window rows held
// as hi/lo slots in the float32 rows' bytes: one shared-memory plan for
// every tier).  kStage: the ladder's stage (the header comment).  The body
// of score_kernel (float32) and score_kernel_tier.
template <bool kWhole, bool kOne, bool kExt, int kPasses, int kStage = kFull>
__device__ __forceinline__ void score_body(
    const uint8_t* __restrict__ frames, const float* __restrict__ tpl,
    const int32_t* __restrict__ si, const float* __restrict__ sf,
    float* __restrict__ part_val, int32_t* __restrict__ part_yx, float* split_part,
    int32_t* split_count, Params p, int t) {
  static_assert(kStage == kFull || (kWhole && kOne && !kExt),
                "the ladder has K1's main-path case only");
  extern __shared__ __align__(16) float smem[];
  __shared__ Best s_best[kScoreThreads / 32];
  __shared__ int s_last, s_n_items;
  // Strides and shared-memory plan come from the template buffer (the
  // bucket); a lane's extent (th, tw in the item loop) may be smaller.
  const int tw4 = round_up4(p.tw);               // template row stride, zero-padded
  const int mid1 = p.th / 2;                     // the launch extent's halves
  const int in_wl1 = kTileW + tw4;               // and input columns
  const int in_w = in_stride(tw4);               // input row stride (multiple of 4)
  const int in_h = p.stage_rows + kTileH - 1;
  const int nl = p.n_lanes;

  LaneWork* lanes = reinterpret_cast<LaneWork*>(smem);  // the lane table (none if kOne)
  float* s_tc = smem + (kOne ? 0 : lane_table_bytes(nl) / 4);  // staged rows x tw4, centered
  float* s_in = s_tc + p.stage_rows * tw4;        // in_h x in_w input rows
  float* s_rs = s_in + in_h * in_w;               // in_h x kTileW row sums
  float* s_rq = s_rs + in_h * kTileW;             // in_h x kTileW row sums of squares
  float* s_red = s_rq + in_h * kTileW;            // 2 halves x kSplit x kOut partials
  float* s_col = s_red + 2 * kSplit * kOut;        // 2 halves x (sum, sum sq) x kOut

  LaneWork one{};  // kOne: the lane's work
  int n_items;
  if (kOne) {
    one = lane_work(si, sf, p, t, launch_extent(p));
    // A local frame has too few tiles to fill the card: two blocks share
    // each tile then, one half of the template rows each (the "items").
    one.split = (!one.do_global && 2 * one.n_tiles <= static_cast<int>(gridDim.x)) ? 2 : 1;
    one.n_items = one.n_tiles * one.split;
    n_items = one.n_items;
    if (static_cast<int>(blockIdx.x) >= n_items) {  // uniform per block: no work this frame
      if (threadIdx.x == 0) {
        if constexpr (kStage < kArgmax) {  // a checksum slot that adds nothing
          part_val[blockIdx.x] = 0.0f;
          part_yx[2 * blockIdx.x] = 0;
        } else {
          part_val[blockIdx.x] = -INFINITY;
          part_yx[2 * blockIdx.x] = kBig;
          part_yx[2 * blockIdx.x + 1] = kBig;
        }
      }
      return;
    }
    if constexpr (kWhole && kPasses == 0 && kStage >= kScoreBox) {
      stage_template(s_tc, tpl, one.t_mean, p.th, p.tw, tw4, threadIdx.x, blockDim.x);
    } else if constexpr (kWhole && kStage >= kScoreBox) {
      stage_template_split(reinterpret_cast<uint32_t*>(s_tc), tpl, one.t_mean, p.th, p.tw, tw4,
                           threadIdx.x, blockDim.x);
    }
  } else {
    if (threadIdx.x < 32) {
      // Warp 0: each lane's mode, window and tiles; two blocks share each
      // local tile only if every item still gets a block of its own; then
      // the lanes' items end to end (exclusive prefix sum).  Thread `lane`
      // owns table entries lane, lane + 32, ...
      const int lane = threadIdx.x;
      int want = 0;
      for (int base = 0; base < nl; base += 32) {
        const int l = base + lane;
        int v = 0;
        if (l < nl) {
          lanes[l] = lane_work(si + l * kStateI, sf + l * kStateF, p, t,
                               kExt ? lane_extent(p, l) : launch_extent(p));
          v = lanes[l].n_tiles * (lanes[l].do_global ? 1 : 2);
          // This block's partial for the lane stays empty unless one of its
          // items scores the lane.
          const int slot = l * p.n_slots + blockIdx.x;
          part_val[slot] = -INFINITY;
          part_yx[2 * slot] = kBig;
          part_yx[2 * slot + 1] = kBig;
        }
        want += warp_sum(v);
      }
      const bool split = want <= static_cast<int>(gridDim.x);
      int carry = 0;
      for (int base = 0; base < nl; base += 32) {
        const int l = base + lane;
        int v = 0;
        if (l < nl) {
          lanes[l].split = (split && !lanes[l].do_global) ? 2 : 1;
          v = lanes[l].n_tiles * lanes[l].split;
        }
        int inc = v;
        for (int off = 1; off < 32; off <<= 1) {
          const int u = __shfl_up_sync(0xffffffffu, inc, off);
          if (lane >= off) inc += u;
        }
        if (l < nl) {
          lanes[l].begin = carry + inc - v;
          lanes[l].n_items = v;
        }
        carry += __shfl_sync(0xffffffffu, inc, 31);
      }
      if (lane == 0) s_n_items = carry;
    }
    __syncthreads();
    n_items = s_n_items;
    if (static_cast<int>(blockIdx.x) >= n_items) return;  // uniform per block: no work
  }

  const int group = threadIdx.x / kGroupThreads;
  const int lt = threadIdx.x % kGroupThreads;
  const int ty = lt / (kTileW / kRx), tx = lt % (kTileW / kRx);
  const int o = threadIdx.x, y = o / kTileW, x = o % kTileW;  // output of threads < kOut
  Best best = empty_best();
  int cur = kOne ? 0 : -1;        // the lane of the last item
  int tc_lane = kWhole && kOne ? 0 : -1;  // what s_tc holds: lane and first row
  int tc_row = kWhole && kOne ? 0 : -1;
  bool fresh = true;              // no unit has used shared memory yet
  uint32_t ichk = 0;              // the ladder's checksums (kStage < kArgmax)
  float fchk = 0.0f;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    int l = 0;
    if (!kOne) {
      l = cur < 0 ? 0 : cur;
      while (item >= lanes[l].begin + lanes[l].n_items) ++l;  // items run lane by lane
      if (l != cur) {
        if (cur >= 0) {
          best = block_best(best, s_best);
          if (threadIdx.x == 0) {
            const int slot = cur * p.n_slots + blockIdx.x;
            part_val[slot] = best.val;
            part_yx[2 * slot] = best.y;
            part_yx[2 * slot + 1] = best.x;
          }
          best = empty_best();
        }
        cur = l;
      }
    }
    const LaneWork& w = kOne ? one : lanes[l];
    // The lane's extent, or the launch's, fixed for the whole loop.
    const int th = kExt ? w.th : p.th, tw = kExt ? w.tw : p.tw;
    const int tw4e = kExt ? round_up4(tw) : tw4;     // its template columns, zero-padded
    const int mid = kExt ? th / 2 : mid1;            // halves: rows [0, mid), [mid, th)
    const int in_wl = kExt ? kTileW + tw4e : in_wl1;  // input columns read
    const int split = w.split;
    const int local = item - w.begin;
    const int tile = local / split, half = local % split;
    const int h_lo = split == 2 ? half : 0, h_hi = split == 2 ? half + 1 : 2;
    const int oy0 = w.ry0 + (tile / w.tiles_x) * kTileH;
    const int ox0 = w.rx0 + (tile % w.tiles_x) * kTileW;
    if constexpr (kStage == kEmpty) {
      if (threadIdx.x == 0) ichk += static_cast<uint32_t>(oy0 + ox0);
      continue;
    }

    float acc[kRx];
#pragma unroll
    for (int k = 0; k < kRx; ++k) acc[k] = 0.0f;
    if (!kWhole && o < kOut) {  // thread o's column sums of each half, carried across units
#pragma unroll
      for (int c = 0; c < 4; ++c) s_col[c * kOut + o] = 0.0f;
    }
    // Stage units: the item's rows at once when the whole template is
    // staged, else one chunk of one half at a time (chunks start at the
    // half's first row).
    const int row_hi = h_hi == 1 ? mid : th;
    for (int u0 = h_lo == 0 ? 0 : mid; u0 < row_hi;) {
      const int u1 = kWhole ? row_hi : min(u0 + p.stage_rows, u0 < mid ? mid : th);
      const int t_row = kWhole ? 0 : u0;
      if (!fresh) __syncthreads();  // the previous unit's readers are done with it
      fresh = false;
      if (kStage >= kScoreBox && (tc_lane != l || tc_row != t_row)) {
        const float* src = tpl + (static_cast<size_t>(l) * p.th + t_row) * tw4;
        if constexpr (kPasses == 0) {
          stage_template(s_tc, src, w.t_mean, kWhole ? th : u1 - u0, tw, tw4, threadIdx.x,
                         blockDim.x);
        } else {
          stage_template_split(reinterpret_cast<uint32_t*>(s_tc), src, w.t_mean,
                               kWhole ? th : u1 - u0, tw, tw4, threadIdx.x, blockDim.x);
        }
        tc_lane = l;
        tc_row = t_row;
      }
      const int in_rows = u1 - u0 + kTileH - 1;  // input rows u0 .. u1 + kTileH - 2
      const uint8_t* frame = frames + l * p.frame_stride + t * p.frame_px;
      if constexpr (kStage == kDma) {
#pragma unroll 4
        for (int idx = threadIdx.x; idx < in_rows * in_wl; idx += blockDim.x) {
          const int r = idx / in_wl, c = idx % in_wl;
          const int gy = oy0 + u0 + r, gx = ox0 + c;
          if (gy < p.frame_h && gx < p.frame_w) {
            ichk += frame[static_cast<size_t>(gy) * p.frame_w + gx];
          }
        }
        u0 = u1;
        continue;
      }
#pragma unroll 4
      for (int idx = threadIdx.x; idx < in_rows * in_wl; idx += blockDim.x) {
        const int r = idx / in_wl, c = idx % in_wl;
        const int gy = oy0 + u0 + r, gx = ox0 + c;
        const float v = (gy < p.frame_h && gx < p.frame_w)
                            ? static_cast<float>(frame[static_cast<size_t>(gy) * p.frame_w + gx])
                            : 0.0f;
        s_in[r * in_w + c] = __fmul_rn(v, kU8Scale);
      }
      __syncthreads();
      if constexpr (kStage == kConvert) {  // each thread reads back what it stored
        for (int idx = threadIdx.x; idx < in_rows * in_wl; idx += blockDim.x) {
          ichk += __float_as_uint(s_in[(idx / in_wl) * in_w + idx % in_wl]);
        }
        u0 = u1;
        continue;
      }

      // Box sums, separably: each input row's sums over tw columns ...
      for (int e = threadIdx.x; e < in_rows * kTileW; e += blockDim.x) {
        const int r = e / kTileW, xx = e % kTileW;
        const float* row = s_in + r * in_w + xx;
        float rs = 0.0f, rq = 0.0f;
        for (int j = 0; j < tw; ++j) {
          rs += row[j];
          rq = fmaf(row[j], row[j], rq);
        }
        s_rs[r * kTileW + xx] = rs;
        s_rq[r * kTileW + xx] = rq;
      }
      if constexpr (kPasses != 0 && kStage >= kScore) {
        __syncthreads();  // the box sums have read the float32 window rows
        split_rows_in_place(s_in, in_rows, in_wl, in_w);
        __syncthreads();
      }

      // ... while each thread correlates 4 neighbouring outputs over its
      // group's share of each half's rows, as far as this unit holds them,
      // 4 taps per step from float4 loads (padding columns of the template
      // hold 0 and add exactly 0).  The shares are cut from the whole half,
      // so a group adds the same rows in the same order however the half is
      // chunked.  A half's partials go to shared memory in the unit that
      // ends it.  (No correlation before kScore.)
#pragma unroll
      for (int h = 0; h < (kStage >= kScore ? 2 : 0); ++h) {
        if (h < h_lo || h >= h_hi) continue;
        const int hs = h == 0 ? 0 : mid, he = h == 0 ? mid : th;
        const int c0 = max(u0, hs), c1 = min(u1, he);
        // Half 1 hands out its row shares in reverse, so that a warp's two
        // shares of an odd split add up evenly.
        const int gs = h == 0 ? group : kSplit - 1 - group;
        const int i_begin = max(c0, hs + gs * (he - hs) / kSplit);
        const int i_end = min(c1, hs + (gs + 1) * (he - hs) / kSplit);
        for (int i = i_begin; i < i_end; ++i) {
          if constexpr (kPasses == 0) {
            const float* in_row = s_in + (ty + i - u0) * in_w + tx * kRx;
            const float* t_rowp = s_tc + (i - t_row) * tw4;
            float4 a = *reinterpret_cast<const float4*>(in_row);
            for (int j0 = 0; j0 < tw4e; j0 += 4) {
              const float4 b = *reinterpret_cast<const float4*>(in_row + j0 + 4);
              const float4 tv = *reinterpret_cast<const float4*>(t_rowp + j0);
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
            row_mma<kPasses>(c, reinterpret_cast<const uint32_t*>(s_in) + (i - u0) * in_w,
                             reinterpret_cast<const uint32_t*>(s_tc) + (i - t_row) * tw4, in_w,
                             in_wl, tw);
#pragma unroll
            for (int k = 0; k < kRx; ++k) acc[k] = __fadd_rn(acc[k], c[k]);
          }
        }
        if (kWhole || (u0 < he && u1 >= he)) {
#pragma unroll
          for (int k = 0; k < kRx; ++k) {
            const int out = kPasses == 0 ? lt * kRx + k : tile_output(lt, k);
            s_red[(h * kSplit + group) * kOut + out] = acc[k];
            acc[k] = 0.0f;
          }
        }
      }
      __syncthreads();  // row sums and partial correlations are in shared memory

      // The column of row sums over each half's rows in this unit.
      if (!kWhole && o < kOut) {
        for (int h = h_lo; h < h_hi; ++h) {
          const int c0 = max(u0, h == 0 ? 0 : mid), c1 = min(u1, h == 0 ? mid : th);
          float bs = s_col[(2 * h) * kOut + o], bq = s_col[(2 * h + 1) * kOut + o];
          for (int i = c0; i < c1; ++i) {
            bs += s_rs[(y + i - u0) * kTileW + x];
            bq += s_rq[(y + i - u0) * kTileW + x];
          }
          s_col[(2 * h) * kOut + o] = bs;
          s_col[(2 * h + 1) * kOut + o] = bq;
        }
      }
      u0 = u1;
    }

    // One thread per output: each half's group partials in a fixed order,
    // then half 0 + half 1 (the sum of two terms does not depend on which
    // block of a shared tile adds it).
    float a_o = 0.0f, bs_o = 0.0f, bq_o = 0.0f;
    if (o < kOut) {
      for (int h = h_lo; h < h_hi; ++h) {
        if constexpr (kStage >= kScore) {
          float a_h = 0.0f;
          for (int g = 0; g < kSplit; ++g) a_h = __fadd_rn(a_h, s_red[(h * kSplit + g) * kOut + o]);
          a_o = __fadd_rn(a_o, a_h);
        }
        float bs_h, bq_h;
        if (kWhole) {  // the column of row sums over the half, as the chunks add it
          bs_h = 0.0f;
          bq_h = 0.0f;
          const int u_first = h_lo == 0 ? 0 : mid;  // the one unit's first row
          for (int i = h == 0 ? 0 : mid; i < (h == 0 ? mid : th); ++i) {
            bs_h += s_rs[(y + i - u_first) * kTileW + x];
            bq_h += s_rq[(y + i - u_first) * kTileW + x];
          }
        } else {
          bs_h = s_col[(2 * h) * kOut + o];
          bq_h = s_col[(2 * h + 1) * kOut + o];
        }
        bs_o = __fadd_rn(bs_o, bs_h);
        bq_o = __fadd_rn(bq_o, bq_h);
      }
    }
    if (kStage >= kScore && split == 2) {
      // Both halves publish; the later one adds the other's partials.
      const size_t cell = static_cast<size_t>(l) * p.max_split_tiles + tile;
      float* mine = split_part + (cell * 2 + half) * 3 * kOut;
      if (o < kOut) {
        mine[o] = a_o;
        mine[kOut + o] = bs_o;
        mine[2 * kOut + o] = bq_o;
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) s_last = atomicAdd(&split_count[cell], 1) == 1;
      __syncthreads();
      if (!s_last) continue;  // uniform per block
      const float* other = split_part + (cell * 2 + 1 - half) * 3 * kOut;
      if (o < kOut) {
        a_o = __fadd_rn(a_o, __ldcg(other + o));
        bs_o = __fadd_rn(bs_o, __ldcg(other + kOut + o));
        bq_o = __fadd_rn(bq_o, __ldcg(other + 2 * kOut + o));
      }
      if (threadIdx.x == 0) split_count[cell] = 0;  // ready for the next frame
    }
    const int oy = oy0 + y, ox = ox0 + x;
    if (o < kOut && oy <= w.ry1 && ox <= w.rx1) {
      const float n = static_cast<float>(th * tw);
      const float mean = __fdiv_rn(bs_o, n);
      const float var = __fsub_rn(__fdiv_rn(bq_o, n), __fmul_rn(mean, mean));
      const float sd = __fsqrt_rn(fmaxf(var, kVarFloor));
      const float cov = __fsub_rn(a_o, __fmul_rn(mean, w.sum_tc));
      const float den = __fmul_rn(__fmul_rn(__fadd_rn(sd, kEps), w.t_den), n);
      const Best cand{__fdiv_rn(cov, den), oy, ox};
      if constexpr (kStage == kScoreBox) {
        fchk += __fadd_rn(sd, cand.val);
      } else if constexpr (kStage == kScore) {
        fchk += fabsf(cand.val);
      } else if (lex_better(cand, best)) {
        best = cand;
      }
    }
  }

  if constexpr (kStage == kEmpty) {  // the ladder (kOne): slot blockIdx.x
    if (threadIdx.x == 0) part_yx[2 * blockIdx.x] = static_cast<int32_t>(ichk);
  } else if constexpr (kStage < kScoreBox) {
    __shared__ uint32_t s_chk[kScoreThreads / 32];
    ichk = block_sum_u32(ichk, s_chk);
    if (threadIdx.x == 0) part_yx[2 * blockIdx.x] = static_cast<int32_t>(ichk);
  } else if constexpr (kStage < kArgmax) {
    __shared__ float2 s_fchk[kScoreThreads / 32];
    fchk = block_sum2(make_float2(fchk, 0.0f), s_fchk).x;
    if (threadIdx.x == 0) part_val[blockIdx.x] = fchk;
  } else {
    best = block_best(best, s_best);
    if (threadIdx.x == 0) {
      const int slot = cur * p.n_slots + blockIdx.x;
      part_val[slot] = best.val;
      part_yx[2 * slot] = best.y;
      part_yx[2 * slot + 1] = best.x;
    }
  }
}

// The float32 tier, with its register budget left to ptxas (64 registers,
// two blocks an SM at 80 x 80).
template <bool kWhole, bool kOne, bool kExt, int kStage = kFull>
__global__ void __launch_bounds__(kScoreThreads)
score_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ tpl,
             const int32_t* __restrict__ si, const float* __restrict__ sf,
             float* __restrict__ part_val, int32_t* __restrict__ part_yx,
             float* split_part, int32_t* split_count, Params p, int t) {
  score_body<kWhole, kOne, kExt, 0, kStage>(frames, tpl, si, sf, part_val, part_yx, split_part,
                                            split_count, p, t);
}

// The bf16 tiers ask for two blocks an SM (at most 64 registers a thread):
// left free, ptxas gave the 2- and 3-pass K1 kernels 90 registers, one block
// an SM, and a local frame's items half the card in a second wave.
template <bool kWhole, bool kOne, bool kExt, int kPasses, int kStage = kFull>
__global__ void __launch_bounds__(kScoreThreads, 2)
score_kernel_tier(const uint8_t* __restrict__ frames, const float* __restrict__ tpl,
                  const int32_t* __restrict__ si, const float* __restrict__ sf,
                  float* __restrict__ part_val, int32_t* __restrict__ part_yx,
                  float* split_part, int32_t* split_count, Params p, int t) {
  score_body<kWhole, kOne, kExt, kPasses, kStage>(frames, tpl, si, sf, part_val, part_yx,
                                                  split_part, split_count, p, t);
}

// Look-ahead record of a frame that is not scored: the state as it stands,
// score -1, no update (pvot/ops/ncc_mega.py:294-311).
__device__ __forceinline__ void lookahead_row(float* row, const int32_t* si) {
  row[0] = static_cast<float>(si[0]);
  row[1] = static_cast<float>(si[1]);
  row[2] = static_cast<float>(si[2]);
  row[3] = static_cast<float>(si[3]);
  row[4] = -1.0f;
  row[5] = 0.0f;
  row[6] = 0.0f;
  row[7] = static_cast<float>(si[4]);
  row[8] = static_cast<float>(si[5]);
  row[9] = 0.0f;
}


// kExt: the lanes have extents of their own (the score kernel's kExt).
// kBatch: the look-ahead cadence (batch > 1; the state's n_valid field then
// holds n_full, so frame t is valid only below it): frame t is the last of a
// batch, the launch also writes the look-ahead records of the batch's
// earlier frames from the state before this commit, and a frame past n_full
// records -1 as its score.  kStage: the ladder's stage (the header comment).
template <bool kExt, bool kBatch, int kStage = kFull>
__global__ void __launch_bounds__(kCommitThreads)
commit_kernel(const uint8_t* __restrict__ frames, float* __restrict__ tpl,
              int32_t* __restrict__ si, float* __restrict__ sf,
              const float* __restrict__ part_val, const int32_t* __restrict__ part_yx,
              float* __restrict__ rows, Params p, int t, int n_frames, int batch) {
  __shared__ Best s_best[kCommitThreads / 32];
  __shared__ float2 s_sum2[kCommitThreads / 32];
  const int s = blockIdx.x;
  // The lane's template extent, in a th x tw4 buffer.
  const Extent ext = kExt ? lane_extent(p, s) : launch_extent(p);
  const int tw4 = round_up4(p.tw);
  const uint8_t* frame = frames + s * p.frame_stride + t * p.frame_px;
  tpl += static_cast<size_t>(s) * p.th * tw4;
  si += s * kStateI;
  sf += s * kStateF;
  part_val += static_cast<size_t>(s) * p.n_slots;
  part_yx += 2 * static_cast<size_t>(s) * p.n_slots;
  float* row = rows + (static_cast<size_t>(s) * n_frames + t) * kRecord;

  if constexpr (kStage < kArgmax) {
    // The walk: the window moves every frame as in production, and the
    // record holds the score blocks' checksums, folded in a fixed order.
    float chk;
    if constexpr (kStage < kScoreBox) {
      __shared__ uint32_t s_chk[kCommitThreads / 32];
      uint32_t v = 0;
      for (int i = threadIdx.x; i < p.n_slots; i += blockDim.x) {
        v += static_cast<uint32_t>(part_yx[2 * i]);
      }
      chk = static_cast<float>(block_sum_u32(v, s_chk) & kChecksumMask);
    } else {
      float v = 0.0f;
      for (int i = threadIdx.x; i < p.n_slots; i += blockDim.x) v += part_val[i];
      chk = block_sum2(make_float2(v, 0.0f), s_sum2).x;
    }
    if (threadIdx.x == 0) {
      si[0] = min(si[0] + 1, p.frame_w - ext.tw - 1);
      si[1] = min(si[1] + (t & 1), p.frame_h - ext.th - 1);
      for (int k = 0; k < kRecord; ++k) row[k] = 0.0f;
      row[4] = chk;
    }
    return;
  }

  const Mode m = frame_mode(si, p, t, ext);
  const int bx = si[0], by = si[1], bw = si[2], bh = si[3];
  const int lost = si[4], useg = si[5];
  const float t_mean = sf[0], t_std = sf[1], sum_tc = sf[2];
  if constexpr (kBatch) {
    for (int u = t - batch + 1 + static_cast<int>(threadIdx.x); u < t; u += blockDim.x) {
      lookahead_row(row + static_cast<long long>(u - t) * kRecord, si);
    }
  }

  Best best = empty_best();
  for (int i = threadIdx.x; i < p.n_slots; i += blockDim.x) {
    const Best c{part_val[i], part_yx[2 * i], part_yx[2 * i + 1]};
    if (lex_better(c, best)) best = c;
  }
  best = block_best(best, s_best);

  // Gate and commit (pvot/ops/ncc_mega.py:719-764).
  const float threshold = m.use_global ? p.global_conf : p.min_conf;
  const bool accept = m.valid && best.val >= threshold;
  const int new_bx = accept ? best.x : bx, new_by = accept ? best.y : by;
  const int new_bw = accept ? ext.tw : bw, new_bh = accept ? ext.th : bh;
  const int new_lost = accept ? 0 : (m.valid ? lost + 1 : lost);
  const bool new_outside = bbox_outside(new_bx, new_by, new_bw, new_bh, p);
  const int new_useg =
      m.valid ? ((accept && !new_outside) ? 0 : static_cast<int>(m.use_global)) : useg;

  // Template EMA + stats (pvot/ops/ncc_mega.py:766-787), inside the lane's
  // extent only (the bucket's padding stays 0, :772-787).  `strong` is
  // uniform across the block; the winner lies in the map, so the patch lies
  // in the frame.
  const bool strong = kStage == kFull && accept && best.val >= p.strong_conf;
  float new_mean = t_mean, new_std = t_std, new_sum_tc = sum_tc;
  if (strong) {
    // Pixel idx = threadIdx.x + k * kCommitThreads.  The first kEmaPerThread
    // of each thread stay in registers across the EMA and stats passes; the
    // rest (templates above 20,480 pixels) are read back from device memory.
    const int n_px = ext.th * ext.tw;
    const float n = static_cast<float>(n_px);
    float v[kEmaPerThread];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kEmaPerThread; ++k) {
      const int idx = threadIdx.x + k * kCommitThreads;
      v[k] = 0.0f;
      if (idx < n_px) {
        const int i = idx / ext.tw, j = idx % ext.tw;
        const float patch = __fmul_rn(
            static_cast<float>(frame[static_cast<size_t>(best.y + i) * p.frame_w + best.x + j]),
            kU8Scale);
        float* px = tpl + i * tw4 + j;
        v[k] = __fadd_rn(__fmul_rn(p.one_minus_lr, *px), __fmul_rn(p.lr, patch));
        *px = v[k];
        s1 += v[k];
        s2 = fmaf(v[k], v[k], s2);
      }
    }
    for (int idx = threadIdx.x + kEmaPerThread * kCommitThreads; idx < n_px;
         idx += kCommitThreads) {
      const int i = idx / ext.tw, j = idx % ext.tw;
      const float patch = __fmul_rn(
          static_cast<float>(frame[static_cast<size_t>(best.y + i) * p.frame_w + best.x + j]),
          kU8Scale);
      float* px = tpl + i * tw4 + j;
      const float e = __fadd_rn(__fmul_rn(p.one_minus_lr, *px), __fmul_rn(p.lr, patch));
      *px = e;
      s1 += e;
      s2 = fmaf(e, e, s2);
    }
    const float2 tot = block_sum2(make_float2(s1, s2), s_sum2);
    new_mean = __fdiv_rn(tot.x, n);
    const float var = __fsub_rn(__fdiv_rn(tot.y, n), __fmul_rn(new_mean, new_mean));
    new_std = __fadd_rn(__fsqrt_rn(fmaxf(var, 0.0f)), kEps);
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < kEmaPerThread; ++k) {
      if (threadIdx.x + k * kCommitThreads < n_px) c += __fsub_rn(v[k], new_mean);
    }
    for (int idx = threadIdx.x + kEmaPerThread * kCommitThreads; idx < n_px;
         idx += kCommitThreads) {
      c += __fsub_rn(tpl[(idx / ext.tw) * tw4 + idx % ext.tw], new_mean);  // this thread's own store
    }
    new_sum_tc = block_sum2(make_float2(c, 0.0f), s_sum2).x;
  }

  __syncthreads();  // every thread has read si / sf before thread 0 writes
  if (threadIdx.x == 0) {
    si[0] = new_bx; si[1] = new_by; si[2] = new_bw; si[3] = new_bh;
    si[4] = new_lost; si[5] = new_useg;
    sf[0] = new_mean; sf[1] = new_std; sf[2] = new_sum_tc;
    row[0] = static_cast<float>(new_bx);
    row[1] = static_cast<float>(new_by);
    row[2] = static_cast<float>(new_bw);
    row[3] = static_cast<float>(new_bh);
    row[4] = kBatch && !m.valid ? -1.0f : best.val;
    row[5] = accept ? 1.0f : 0.0f;
    row[6] = 0.0f;  // O_POISON: this kernel never poisons
    row[7] = static_cast<float>(new_lost);
    row[8] = static_cast<float>(new_useg);
    row[9] = m.do_global ? 1.0f : 0.0f;
  }
}

using ScoreKernel = void (*)(const uint8_t*, const float*, const int32_t*, const float*,
                            float*, int32_t*, float*, int32_t*, Params, int);
using CommitKernel = void (*)(const uint8_t*, float*, int32_t*, float*, const float*,
                              const int32_t*, float*, Params, int, int, int);

// A launch's parameters: n_lanes lanes (frame_stride apart, ext their
// extents or null), n_blocks score blocks, the tracker's configuration.
Params make_params(long long frame_stride, int n_lanes, int frame_h, int frame_w, int th,
                   int tw, const int32_t* ext, int n_blocks, int radius_x, int radius_y,
                   int lost_threshold, int enable_global, float min_conf, float global_conf,
                   float strong_conf, float lr, float one_minus_lr) {
  Params p{};
  p.frame_h = frame_h; p.frame_w = frame_w; p.th = th; p.tw = tw;
  p.out_h = frame_h - th + 1; p.out_w = frame_w - tw + 1;
  p.radius_x = radius_x; p.radius_y = radius_y;
  p.lost_threshold = lost_threshold; p.enable_global = enable_global;
  p.n_lanes = n_lanes;
  p.n_slots = n_blocks;
  p.max_split_tiles = n_blocks / 2;
  p.stage_rows = stage_rows(th, tw, n_lanes);
  p.frame_stride = frame_stride;
  p.frame_px = static_cast<long long>(frame_h) * frame_w;
  p.ext = ext;
  p.min_conf = min_conf; p.global_conf = global_conf; p.strong_conf = strong_conf;
  p.lr = lr; p.one_minus_lr = one_minus_lr;
  return p;
}

// Lets a score block use `smem` bytes of dynamic shared memory, and asks for
// the largest shared-memory carveout: two 94 KB blocks (the 80 x 80 geometry)
// fit an SM only there; the default carveout left room for one.
cudaError_t set_score_smem(ScoreKernel kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The frame steps of one chunk on `stream`: a score launch of n_blocks blocks
// and a commit launch of a block per lane for each frame t with t % batch ==
// batch - 1.  Returns the first CUDA error, or 0.
int launch_steps(ScoreKernel score, CommitKernel commit, const Params& p, int n_blocks,
                 int n_frames, int batch, const uint8_t* frames, float* tpl, int32_t* state_i,
                 float* state_f, float* part_val, int32_t* part_yx, float* split_part,
                 int32_t* split_count, float* rows, cudaStream_t stream) {
  const int smem = score_smem_bytes(p.stage_rows, p.tw, p.n_lanes);
  cudaError_t err = set_score_smem(score, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int t = batch - 1; t < n_frames; t += batch) {
    score<<<n_blocks, kScoreThreads, smem, stream>>>(
        frames, tpl, state_i, state_f, part_val, part_yx, split_part, split_count, p, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    commit<<<p.n_lanes, kCommitThreads, 0, stream>>>(frames, tpl, state_i, state_f, part_val,
                                                     part_yx, rows, p, t, n_frames, batch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace
