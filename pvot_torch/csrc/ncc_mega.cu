// Single-stream tracking chunk on Hopper: the port of pvot/ops/ncc_mega.py
// `_mega_kernel` (:170) with `_scored_frame_body` (:496), `_shear_score_tiles`
// (:318) and `_lex_better` (:487), entry `mega_track_chunk` (:818), at its f32
// tier (highest=True, inkernel_global=True, batch=1).
//
// What it computes, per frame t of a chunk, in stream order and with the
// tracker state resident in device memory (the host never waits inside a
// chunk):
//
//   (a) score_kernel — a fixed grid of blocks (the wrapper passes 2 x the SM
//       count).  Every block derives the frame's mode and window from the
//       state (frame_mode below, pvot/ops/ncc_mega.py:541-561), then
//       grid-strides over 8 x 16 output tiles of either the clamped local
//       window or, on a global frame, the whole (H-th+1) x (W-tw+1) map, so a
//       global frame runs across all SMs.  A local frame has too few tiles to
//       fill the card, so there two blocks share each tile, one half of the
//       template rows each; the later of the two (an atomic count per tile)
//       adds the other's partial sums.  A block stages the centered template
//       (tpl - t_mean; the template lives in device memory with its rows
//       zero-padded to a multiple of 4 columns) and its u8 input tile,
//       converted as v * float32(1/255), in shared memory.  Box sums run separably (row
//       sums over tw columns, then a column of th row sums).  For the
//       correlation sum(w * (tpl - t_mean)), 16 warps split the template rows;
//       each thread keeps four neighbouring outputs in registers and reads 4
//       taps per step as float4; the warps' partials add in a fixed order.  The
//       score is (acc - mean * sum_tc) / ((sqrt(max(var, 1e-6)) + 1e-6) *
//       (t_std + 1e-6) * N).  The block writes its best (value, y, x) under the
//       lexicographic order (value desc, y asc, x asc) to a partials buffer.
//       That order is total, so partials fold in any order to the row-major
//       first-occurrence argmax; no atomics touch the values.
//   (b) commit_kernel — one block folds the partials, applies the gate
//       (0.4 local / 0.6 when use_global), the bbox commit, the lost counter
//       and the use_global reset, runs the 0.7-gated template EMA from the u8
//       frame at the new bbox, recomputes mean, std (+1e-6) and sum_tc with
//       block reductions (pvot/ops/ncc_mega.py:769-787), and writes the
//       frame's 10-lane record and the next state.  Frames t >= n_valid commit nothing (:563-573).
//
// What bounds it on the H100 at 720p / 80x80 / r=60.  A local frame scores
// 121 x 121 positions, about 94 M FMA: at the FP32 peak that is a few
// microseconds, so local frames are latency- and launch-bound: two launches a
// frame, and inside each a chain of dependent phases (copy, stage, sum,
// publish, reduce), each a round trip to L2 or a barrier.  A global frame
// scores 641 x 1201 positions, about 4.9 G FMA, and is bound by FP32 issue
// and shared-memory loads on all SMs.  Measured times are in PERF.md.  Later
// work: tensor cores (wgmma, split-precision) for the correlation, TMA
// staging, one persistent launch per chunk in place of 2F launches, and CUDA
// graphs.
//
// Numerics.  The epilogue, the u8 conversion and the EMA use explicit
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs that
// the plain PyTorch version (pvot_torch/ops/ncc_mega.py) does not do; only the
// sums themselves run in another order.  Build without --use_fast_math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 8;                     // output rows per tile
constexpr int kTileW = 16;                    // output columns per tile
constexpr int kRx = 4;                        // outputs per thread along x
constexpr int kGroupThreads = kTileH * kTileW / kRx;  // 32: one warp, one tile
constexpr int kSplit = 16;                    // template-row groups
constexpr int kScoreThreads = kGroupThreads * kSplit;  // 512
constexpr int kCommitThreads = 1024;
constexpr int kEmaPerThread = 20;             // template pixels <= 1024 * 20
constexpr int kBig = 1 << 30;
constexpr int kLanes = 10;                    // record lanes, O_* order
constexpr float kU8Scale = static_cast<float>(1.0 / 255.0);
constexpr float kEps = static_cast<float>(1e-6);
constexpr float kVarFloor = static_cast<float>(1e-6);

__host__ __device__ constexpr int round_up4(int v) { return (v + 3) & ~3; }

// Input-tile row stride: room for kTileW outputs and tw4 taps, rounded so
// that consecutive rows start 16 banks apart (conflict-free float4 reads by
// the two rows of a quarter warp, and by the row-sum pass).
__host__ __device__ constexpr int in_stride(int tw4) {
  return kTileW + tw4 + ((16 - (kTileW + tw4) % 32) + 32) % 32;
}

// Dynamic shared memory of one score block, in bytes (the wrapper's envelope
// check, pvot_torch/ops/ncc_mega.py MegaGeometry.smem_bytes, mirrors it).
int score_smem_bytes(int th, int tw) {
  const int tw4 = round_up4(tw), in_h = kTileH + th - 1, in_w = in_stride(tw4);
  return static_cast<int>(sizeof(float)) *
         (th * tw4 + in_h * in_w + 2 * in_h * kTileW + kSplit * kTileH * kTileW);
}

struct Params {
  int frame_h, frame_w, th, tw, out_h, out_w;
  int radius_x, radius_y, lost_threshold, enable_global, n_valid;
  float min_conf, global_conf, strong_conf, lr, one_minus_lr;
};

// Mode of frame t from the state (pvot/ops/ncc_mega.py:541-573) and the
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

__device__ Mode frame_mode(const int32_t* si, const Params& p, int t) {
  const int bx = si[0], by = si[1], bw = si[2], bh = si[3];
  const int lost = si[4], useg = si[5];
  Mode m;
  m.use_global = p.enable_global &&
                 (useg != 0 || bbox_outside(bx, by, bw, bh, p) ||
                  lost >= p.lost_threshold);
  const int cx = bx + (bw >> 1), cy = by + (bh >> 1);
  const int min_tx = max(0, cx - p.radius_x - (p.tw >> 1));
  const int max_tx = min(p.out_w - 1, cx + p.radius_x - (p.tw >> 1));
  const int min_ty = max(0, cy - p.radius_y - (p.th >> 1));
  const int max_ty = min(p.out_h - 1, cy + p.radius_y - (p.th >> 1));
  const bool window_valid = max_tx >= min_tx && max_ty >= min_ty;
  m.valid = t < p.n_valid;
  m.do_global = (m.use_global || !window_valid) && m.valid;
  if (m.do_global) {
    m.ry0 = 0; m.ry1 = p.out_h - 1; m.rx0 = 0; m.rx1 = p.out_w - 1;
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

__global__ void __launch_bounds__(kScoreThreads)
score_kernel(const uint8_t* __restrict__ frame, const float* __restrict__ tpl,
             const int32_t* __restrict__ si, const float* __restrict__ sf,
             float* __restrict__ part_val, int32_t* __restrict__ part_yx,
             float* split_part, int32_t* split_count, int max_split_tiles,
             Params p, int t) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Best s_best[kScoreThreads / 32];
  __shared__ int s_last;
  const int th = p.th, tw = p.tw;
  const int tw4 = round_up4(tw);                 // template row stride, zero-padded
  const int in_h = kTileH + th - 1;
  const int in_wl = kTileW + tw4;                // input columns read
  const int in_w = in_stride(tw4);               // input row stride (multiple of 4)
  constexpr int n_out = kTileH * kTileW;
  float* s_tc = smem;                            // th x tw4 centered template
  float* s_in = s_tc + th * tw4;                 // in_h x in_w input tile
  float* s_rs = s_in + in_h * in_w;              // in_h x kTileW row sums
  float* s_rq = s_rs + in_h * kTileW;            // in_h x kTileW row sums of squares
  float* s_red = s_rq + in_h * kTileW;           // kSplit x n_out partial correlations

  const Mode m = frame_mode(si, p, t);
  const int reg_h = m.ry1 - m.ry0 + 1, reg_w = m.rx1 - m.rx0 + 1;
  const int tiles_x = reg_w > 0 ? (reg_w + kTileW - 1) / kTileW : 0;
  const int n_tiles = reg_h > 0 ? ((reg_h + kTileH - 1) / kTileH) * tiles_x : 0;
  // A local frame has too few tiles to fill the card: there two blocks share
  // each tile, one half of the template rows each (the "items").
  const int split = (!m.do_global && n_tiles <= max_split_tiles) ? 2 : 1;
  const int n_items = n_tiles * split;
  if (blockIdx.x >= n_items) {  // uniform per block: no work this frame
    if (threadIdx.x == 0) {
      part_val[blockIdx.x] = -INFINITY;
      part_yx[2 * blockIdx.x] = kBig;
      part_yx[2 * blockIdx.x + 1] = kBig;
    }
    return;
  }

  const float t_den = __fadd_rn(sf[1], kEps);  // t_std + 1e-6
  const float sum_tc = sf[2];
  const float n = static_cast<float>(th * tw);
  // The centered template, tpl - t_mean; its padding columns stay 0, so
  // they add exactly 0 to the correlation.
  const float t_mean = sf[0];
  for (int idx = threadIdx.x; idx < th * tw4 / 4; idx += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(tpl)[idx];
    const int j = (4 * idx) % tw4;
    reinterpret_cast<float4*>(s_tc)[idx] = make_float4(
        j < tw ? __fsub_rn(v.x, t_mean) : 0.0f, j + 1 < tw ? __fsub_rn(v.y, t_mean) : 0.0f,
        j + 2 < tw ? __fsub_rn(v.z, t_mean) : 0.0f, j + 3 < tw ? __fsub_rn(v.w, t_mean) : 0.0f);
  }

  const int group = threadIdx.x / kGroupThreads;
  const int lt = threadIdx.x % kGroupThreads;
  const int ty = lt / (kTileW / kRx), tx = lt % (kTileW / kRx);
  Best best = empty_best();

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item / split, half = item % split;
    const int r0 = half * th / split, r1 = (half + 1) * th / split;  // template rows
    const int oy0 = m.ry0 + (tile / tiles_x) * kTileH;
    const int ox0 = m.rx0 + (tile % tiles_x) * kTileW;
    const int in_rows = r1 - r0 + kTileH - 1;    // input rows r0 .. r1 + kTileH - 2
    __syncthreads();  // the previous item's readers are done with shared memory
#pragma unroll 4
    for (int idx = threadIdx.x; idx < in_rows * in_wl; idx += blockDim.x) {
      const int r = r0 + idx / in_wl, c = idx % in_wl;
      const int gy = oy0 + r, gx = ox0 + c;
      const float v = (gy < p.frame_h && gx < p.frame_w)
                          ? static_cast<float>(frame[static_cast<size_t>(gy) * p.frame_w + gx])
                          : 0.0f;
      s_in[r * in_w + c] = __fmul_rn(v, kU8Scale);
    }
    __syncthreads();

    // Box sums, separably: each input row's sums over tw columns ...
    for (int e = threadIdx.x; e < in_rows * kTileW; e += blockDim.x) {
      const int r = r0 + e / kTileW, x = e % kTileW;
      const float* row = s_in + r * in_w + x;
      float rs = 0.0f, rq = 0.0f;
      for (int j = 0; j < tw; ++j) {
        rs += row[j];
        rq = fmaf(row[j], row[j], rq);
      }
      s_rs[r * kTileW + x] = rs;
      s_rq[r * kTileW + x] = rq;
    }

    // ... while each thread correlates 4 neighbouring outputs over its
    // group's share of the item's template rows, 4 taps per step from float4
    // loads (padding columns of the template hold 0 and add exactly 0).
    float acc[kRx];
#pragma unroll
    for (int k = 0; k < kRx; ++k) acc[k] = 0.0f;
    const int i_begin = r0 + group * (r1 - r0) / kSplit;
    const int i_end = r0 + (group + 1) * (r1 - r0) / kSplit;
    for (int i = i_begin; i < i_end; ++i) {
      const float* in_row = s_in + (ty + i) * in_w + tx * kRx;
      const float* t_row = s_tc + i * tw4;
      float4 a = *reinterpret_cast<const float4*>(in_row);
      for (int j0 = 0; j0 < tw4; j0 += 4) {
        const float4 b = *reinterpret_cast<const float4*>(in_row + j0 + 4);
        const float4 tv = *reinterpret_cast<const float4*>(t_row + j0);
        const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int k = 0; k < kRx; ++k) {
          acc[k] = fmaf(w[k], tv.x, acc[k]);
          acc[k] = fmaf(w[k + 1], tv.y, acc[k]);
          acc[k] = fmaf(w[k + 2], tv.z, acc[k]);
          acc[k] = fmaf(w[k + 3], tv.w, acc[k]);
        }
        a = b;
      }
    }
#pragma unroll
    for (int k = 0; k < kRx; ++k) s_red[group * n_out + lt * kRx + k] = acc[k];
    __syncthreads();  // row sums and partial correlations are in shared memory

    // One thread per output: the groups' partials in a fixed order, and the
    // column of row sums over the item's template rows.
    const int o = threadIdx.x, y = o / kTileW, x = o % kTileW;
    float a_o = 0.0f, bs = 0.0f, bq = 0.0f;
    if (o < n_out) {
      for (int g = 0; g < kSplit; ++g) a_o = __fadd_rn(a_o, s_red[g * n_out + o]);
      for (int i = r0; i < r1; ++i) {
        bs += s_rs[(y + i) * kTileW + x];
        bq += s_rq[(y + i) * kTileW + x];
      }
    }
    if (split == 2) {
      // Both halves publish; the later one adds the other's partials (a sum
      // of two terms, so the result does not depend on which is later).
      float* mine = split_part + (tile * 2 + half) * 3 * n_out;
      if (o < n_out) {
        mine[o] = a_o;
        mine[n_out + o] = bs;
        mine[2 * n_out + o] = bq;
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) s_last = atomicAdd(&split_count[tile], 1) == 1;
      __syncthreads();
      if (!s_last) continue;  // uniform per block
      const float* other = split_part + (tile * 2 + 1 - half) * 3 * n_out;
      if (o < n_out) {
        a_o = __fadd_rn(a_o, __ldcg(other + o));
        bs = __fadd_rn(bs, __ldcg(other + n_out + o));
        bq = __fadd_rn(bq, __ldcg(other + 2 * n_out + o));
      }
      if (threadIdx.x == 0) split_count[tile] = 0;  // ready for the next frame
    }
    const int oy = oy0 + y, ox = ox0 + x;
    if (o < n_out && oy <= m.ry1 && ox <= m.rx1) {
      const float mean = __fdiv_rn(bs, n);
      const float var = __fsub_rn(__fdiv_rn(bq, n), __fmul_rn(mean, mean));
      const float sd = __fsqrt_rn(fmaxf(var, kVarFloor));
      const float cov = __fsub_rn(a_o, __fmul_rn(mean, sum_tc));
      const float den = __fmul_rn(__fmul_rn(__fadd_rn(sd, kEps), t_den), n);
      const Best cand{__fdiv_rn(cov, den), oy, ox};
      if (lex_better(cand, best)) best = cand;
    }
  }

  best = block_best(best, s_best);
  if (threadIdx.x == 0) {
    part_val[blockIdx.x] = best.val;
    part_yx[2 * blockIdx.x] = best.y;
    part_yx[2 * blockIdx.x + 1] = best.x;
  }
}

__global__ void __launch_bounds__(kCommitThreads)
commit_kernel(const uint8_t* __restrict__ frame, float* __restrict__ tpl,
              int32_t* __restrict__ si, float* __restrict__ sf,
              const float* __restrict__ part_val, const int32_t* __restrict__ part_yx,
              int n_parts, float* __restrict__ row, Params p, int t) {
  __shared__ Best s_best[kCommitThreads / 32];
  __shared__ float2 s_sum2[kCommitThreads / 32];
  const Mode m = frame_mode(si, p, t);
  const int bx = si[0], by = si[1], bw = si[2], bh = si[3];
  const int lost = si[4], useg = si[5];
  const float t_mean = sf[0], t_std = sf[1], sum_tc = sf[2];

  Best best = empty_best();
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x) {
    const Best c{part_val[i], part_yx[2 * i], part_yx[2 * i + 1]};
    if (lex_better(c, best)) best = c;
  }
  best = block_best(best, s_best);

  // Gate and commit (pvot/ops/ncc_mega.py:719-764).
  const float threshold = m.use_global ? p.global_conf : p.min_conf;
  const bool accept = m.valid && best.val >= threshold;
  const int new_bx = accept ? best.x : bx, new_by = accept ? best.y : by;
  const int new_bw = accept ? p.tw : bw, new_bh = accept ? p.th : bh;
  const int new_lost = accept ? 0 : (m.valid ? lost + 1 : lost);
  const bool new_outside = bbox_outside(new_bx, new_by, new_bw, new_bh, p);
  const int new_useg =
      m.valid ? ((accept && !new_outside) ? 0 : static_cast<int>(m.use_global)) : useg;

  // Template EMA + stats (pvot/ops/ncc_mega.py:766-787).  `strong` is
  // uniform across the block; the winner lies in the map, so the patch lies
  // in the frame.
  const bool strong = accept && best.val >= p.strong_conf;
  float new_mean = t_mean, new_std = t_std, new_sum_tc = sum_tc;
  if (strong) {
    // Each thread keeps its pixels (idx = threadIdx.x + k * kCommitThreads)
    // in registers across the EMA and stats passes.
    const int n_px = p.th * p.tw, tw4 = round_up4(p.tw);
    const float n = static_cast<float>(n_px);
    float v[kEmaPerThread];
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < kEmaPerThread; ++k) {
      const int idx = threadIdx.x + k * kCommitThreads;
      v[k] = 0.0f;
      if (idx < n_px) {
        const int i = idx / p.tw, j = idx % p.tw;
        const float patch = __fmul_rn(
            static_cast<float>(frame[static_cast<size_t>(best.y + i) * p.frame_w + best.x + j]),
            kU8Scale);
        float* px = tpl + i * tw4 + j;
        v[k] = __fadd_rn(__fmul_rn(p.one_minus_lr, *px), __fmul_rn(p.lr, patch));
        *px = v[k];
        s += v[k];
        s2 = fmaf(v[k], v[k], s2);
      }
    }
    const float2 tot = block_sum2(make_float2(s, s2), s_sum2);
    new_mean = __fdiv_rn(tot.x, n);
    const float var = __fsub_rn(__fdiv_rn(tot.y, n), __fmul_rn(new_mean, new_mean));
    new_std = __fadd_rn(__fsqrt_rn(fmaxf(var, 0.0f)), kEps);
    float c = 0.0f;
#pragma unroll
    for (int k = 0; k < kEmaPerThread; ++k) {
      if (threadIdx.x + k * kCommitThreads < n_px) c += __fsub_rn(v[k], new_mean);
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
    row[4] = best.val;
    row[5] = accept ? 1.0f : 0.0f;
    row[6] = 0.0f;  // O_POISON: this kernel never poisons
    row[7] = static_cast<float>(new_lost);
    row[8] = static_cast<float>(new_useg);
    row[9] = m.do_global ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" {

// Runs one chunk: 2 * n_frames launches on `stream`, no synchronisation.
// state_i = [bx, by, bw, bh, lost, use_global, _, _], state_f = [t_mean,
// t_std, sum_tc, _] and tpl (th x round_up4(tw), zero-padded columns) are read
// and updated in place; rows is (n_frames, 10).
// part_val / part_yx hold n_parts per-block winners; split_part (max_split_tiles
// x 2 x 3 x kTileH*kTileW floats) and split_count (max_split_tiles ints, zero)
// serve local frames whose tiles two blocks share.  Returns the first CUDA
// error, or 0.
int pvot_mega_track_chunk(const uint8_t* frames, int n_frames, int frame_h, int frame_w,
                          int th, int tw, int n_valid, int32_t* state_i, float* state_f,
                          float* tpl, float* part_val, int32_t* part_yx,
                          int n_parts, float* split_part, int32_t* split_count,
                          int max_split_tiles, float* rows, int radius_x, int radius_y,
                          int lost_threshold, int enable_global, float min_conf,
                          float global_conf, float strong_conf, float lr,
                          float one_minus_lr, void* stream) {
  Params p{frame_h, frame_w, th, tw, frame_h - th + 1, frame_w - tw + 1,
           radius_x, radius_y, lost_threshold, enable_global, n_valid,
           min_conf, global_conf, strong_conf, lr, one_minus_lr};
  const int smem = score_smem_bytes(th, tw);
  cudaError_t err = cudaFuncSetAttribute(
      score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t frame_px = static_cast<size_t>(frame_h) * frame_w;
  for (int t = 0; t < n_frames; ++t) {
    const uint8_t* frame = frames + t * frame_px;
    score_kernel<<<n_parts, kScoreThreads, smem, s>>>(
        frame, tpl, state_i, state_f, part_val, part_yx, split_part, split_count,
        max_split_tiles, p, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    commit_kernel<<<1, kCommitThreads, 0, s>>>(frame, tpl, state_i, state_f, part_val,
                                               part_yx, n_parts, rows + t * kLanes, p, t);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

const char* pvot_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
