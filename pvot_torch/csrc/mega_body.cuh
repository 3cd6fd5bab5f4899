// The body of the chunk kernels K1-K3 (ncc_mega.cu) and of K1's rung ladder
// (mega_breakdown.cu): the persistent chunk kernel that walks a chunk's
// scored frame steps, the helpers it needs and the host-side launch setup.
// Each translation unit that includes this header instantiates its own
// kernels (an anonymous namespace): ncc_mega.cu only the production stage,
// kFull, and mega_breakdown.cu the ladder's stages of K1's main-path case.
// The design and the numerics are described at the top of ncc_mega.cu.
//
// Stages (kStage, the rung ladder of tools/mega_breakdown.py on the card).
// Every kernel here takes a stage, kFull by default, and every stage boundary
// is an `if constexpr`, so the kFull kernels are the production code and a
// rung compiles K1's persistent kernel cut off after its stage:
//   kEmpty     each step: the table (the deferred commit of the previous
//              frame, here the walk bx + 1, by + (t & 1), as
//              tools/mega_breakdown.py:126-131; the lane's mode and window),
//              each item's tile, the fold of the partials, a one-value record
//              and the grid barrier;
//   kDma       + the window rows' u8 loads from global memory;
//   kConvert   + the u8 -> f32 convert and the shared-memory store;
//   kScoreBox  + the template staging, the box sums and the normalisation,
//              the correlation left out (acc = 0);
//   kScore     + the correlation (float32 FMAs, or row_mma with the window
//              rows' in-place split) and the split-tile combine;
//   kArgmax    + the block best and partials; the deferred commit's gate and
//              bbox/state commit, without the EMA;
//   kFull      + the template EMA and stats: production.
// A rung before kArgmax leaves its work observable as a checksum in record
// field 4: each block that scores a frame publishes its part (an integer for
// kEmpty-kConvert, a float for kScoreBox and kScore), and the last of them
// folds the parts in a fixed order (the integer sum modulo 2^24, exact in
// float32):
//   kEmpty     the sum over items of the tile origin, oy0 + ox0;
//   kDma       the sum of the bytes each item loads (its unit's input rows,
//              0 past the frame);
//   kConvert   the sum of the converted values' bit patterns, read back from
//              shared memory;
//   kScoreBox  the sum over each item's outputs in the window of sd + s, the
//              window's standard deviation over the item's rows (a half of
//              them when two blocks share the tile) and the score with acc = 0;
//   kScore     the sum over the window of |score|.
// The ladder is instantiated for K1's main-path case (kWhole, kOne, no kExt,
// batch 1) and for its float32 row-chunk case in the resident plan
// (chunk_kernel_resident).

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
constexpr int kRun = 4;                       // the most items a block takes at once
constexpr int kThreads = kGroupThreads * kSplit;  // 512 threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kVirtual = 2 * kThreads;        // the template stats' reduction tree
constexpr int kOut = kTileH * kTileW;         // outputs per tile
constexpr int kBig = 1 << 30;
constexpr int kRecord = 10;                   // record fields, O_* order
constexpr int kStateI = 8;                    // bx, by, bw, bh, lost, use_global, n_valid, _
constexpr int kStateF = 4;                    // t_mean, t_std, sum_tc, _
// Shared memory of one block is 227 KB (232,448 bytes), static and dynamic
// together; the dynamic plan (score_smem_bytes) keeps 3 KB for the static.
constexpr int kStaticSmem = 3072;
constexpr int kSmemLimit = 232448 - kStaticSmem;
constexpr float kU8Scale = static_cast<float>(1.0 / 255.0);
constexpr float kEps = static_cast<float>(1e-6);
constexpr float kVarFloor = static_cast<float>(1e-6);
// A block that waits at a grid barrier longer than this traps (a launch
// error) rather than hang the card.
constexpr unsigned long long kBarrierTimeoutNs = 20ull * 1000 * 1000 * 1000;
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

// One lane's work in the current frame step, in the block's shared memory:
// the lane table, rebuilt by every block at every step from the previous
// step's state and winner (the deferred commit).
struct LaneWork {
  int ry0, rx0, ry1, rx1;  // inclusive region of map positions
  int tiles_x, n_tiles;
  int do_global, split;    // split: 2 when two blocks share each tile
  int begin, n_items;      // the lane's items in the union
  float t_mean, t_den, sum_tc, t_std;  // template stats (t_den = t_std + 1e-6)
  int th, tw;              // the lane's template extent
  int ema;                 // the deferred commit updates the template this step
  int ready;               // t_mean .. t_std are this step's (0 while an EMA is pending)
  int wy, wx;              // the previous scored frame's winner: the EMA's patch
  // The lane's state for this step (after the deferred commit) and the
  // committed frame's record fields, for the owner to write.
  int bx, by, bw, bh, lost, useg, n_valid, pad;
  float score, sf_pad;
  int accept, gused;
  int next_done;           // the owner has written the next step's template
};

// The lane table of a launch with n_lanes lanes; a one-lane launch keeps its
// one entry in static shared memory.
__host__ __device__ constexpr int lane_table_bytes(int n_lanes) {
  return n_lanes > 1 ? (n_lanes * static_cast<int>(sizeof(LaneWork)) + 15) / 16 * 16 : 0;
}

// Dynamic shared memory of one block staging `rows` template rows, in bytes
// (pvot_torch/ops/ncc_mega.py score_smem_bytes mirrors it): the lane table,
// the centered template rows, the input rows, their row sums, and for both
// halves the row groups' partial correlations and the outputs' column sums.
__host__ __device__ constexpr int score_smem_bytes(int rows, int tw, int n_lanes) {
  return lane_table_bytes(n_lanes) +
         static_cast<int>(sizeof(float)) *
             (rows * round_up4(tw) + (rows + kTileH - 1) * in_stride(round_up4(tw)) +
              2 * (rows + kTileH - 1) * kTileW + 2 * kSplit * kOut + 4 * kOut);
}

// Template rows a block stages at once: all th when they fit, else the
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

// Words a row of a patch tw bytes wide takes in fetch_issue's buffer.
__host__ __device__ constexpr int patch_words(int tw) { return (tw + 6) / 4; }

// The plans of a launch's shared memory (plan_of), each its own kernel.
// Whole: the template staged whole beside an 8 x 16 tile's input rows
// (chunk_kernel, chunk_kernel_tier<true, ...>).  Resident, at float32 where
// the template does not stage whole (chunk_kernel_resident): each lane's
// centered template staged once a step when a block first meets the lane
// and kept for the block's run of its items, which are 32 x 16 tiles whose
// window rows come in one template half at a time (the next half's bytes
// loaded into registers while the current one's sums are added).  Chunked,
// where neither fits (chunk_kernel_rows, chunk_kernel_tier<false, ...>):
// template and window rows staged in chunks of stage_rows rows of an 8 x 16
// tile.  The sums of an output run in one order in every plan.
constexpr int kPlanWhole = 0, kPlanResident = 1, kPlanChunked = 2;
constexpr int kResTileH = 32;                  // the resident plan's tile: 32 x kTileW
static_assert(kResTileH * kTileW == kThreads, "the resident plan's outputs are one a thread");
static_assert(kResTileH == 32, "a warp's lanes are the resident plan's tile rows");
constexpr int kResPartStride = kTileW + 4;     // a tile row of share partials (no bank twice)
constexpr int kResPart = kResTileH * kResPartStride;  // one share's partials
constexpr int kPreSlots = 3;                   // 16-column groups of the next half a thread holds

// The resident plan's window row stride: room for kTileW outputs and tw4
// taps, an odd multiple of 4 floats modulo 32 banks, so that the float4
// reads of 8 consecutive rows by a quarter warp meet no bank twice.
__host__ __device__ constexpr int res_in_stride(int tw4) {
  return (kTileW + tw4) % 8 == 0 ? kTileW + tw4 + 4 : kTileW + tw4;
}

// Window rows of the resident plan's longer template half.
__host__ __device__ constexpr int res_in_rows(int th) { return th - th / 2 + kResTileH - 1; }

// Floats of the resident plan after the template: the window rows, their
// row sums and sums of squares, and the partials of half the shares (the
// shares' partials are added in two rounds of 8).
__host__ __device__ constexpr int res_work_floats(int th, int tw) {
  return res_in_rows(th) * res_in_stride(round_up4(tw)) + 2 * res_in_rows(th) * kTileW +
         kSplit / 2 * kResPart;
}

// Dynamic shared memory of the resident plan, in bytes (pvot_torch/ops/
// ncc_mega.py plan mirrors it): the lane table, the whole centered
// template, then res_work_floats.
__host__ __device__ constexpr int resident_smem_bytes(int th, int tw, int n_lanes) {
  return lane_table_bytes(n_lanes) +
         static_cast<int>(sizeof(float)) * (th * round_up4(tw) + res_work_floats(th, tw));
}

// The plan of a launch: whole when the template stages whole; else resident
// for the float32 tier (passes 0) when the whole template, the longer
// half's window rows and the rest fit, the EMA's patch bytes fit where the
// window rows go, and the half's 16-column groups fit kPreSlots a thread;
// else chunked (-1: not even chunks fit).
int plan_of(int th, int tw, int n_lanes, int passes) {
  const int rows = stage_rows(th, tw, n_lanes);
  if (rows < 1) return -1;
  if (rows == th) return kPlanWhole;
  const int groups = res_in_rows(th) * ((kTileW + round_up4(tw) + 15) / 16);
  const bool fits = resident_smem_bytes(th, tw, n_lanes) <= kSmemLimit &&
                    th * patch_words(tw) <= res_work_floats(th, tw) &&
                    groups <= kPreSlots * kThreads;
  return passes == 0 && fits ? kPlanResident : kPlanChunked;
}

// Dynamic shared memory of a plan's launch, in bytes.
int plan_smem_bytes(int plan, int th, int tw, int n_lanes) {
  return plan == kPlanResident ? resident_smem_bytes(th, tw, n_lanes)
                               : score_smem_bytes(stage_rows(th, tw, n_lanes), tw, n_lanes);
}

struct Params {
  int frame_h, frame_w, th, tw, out_h, out_w;  // th, tw: the template buffer's (bucket's)
  int radius_x, radius_y, lost_threshold, enable_global;
  int n_lanes;
  int n_slots;          // partial slots per lane: one per block
  int max_split_tiles;  // split scratch per lane, in tiles
  int stage_rows;
  int n_frames, batch, n_steps;  // n_steps = n_frames / batch scored frame steps
  long long frame_stride;  // elements from one lane's frames to the next's (0: shared)
  long long frame_px;      // elements of one frame
  const int32_t* ext;      // per-lane (th, tw), or null: every lane th x tw
  float min_conf, global_conf, strong_conf, lr, one_minus_lr;
};

// The device buffers of one chunk.  Buffers [0] and [1] of the state and the
// template are by step parity: the state and template that step k scores
// with are in [(k - 1) & 1] ([0], the caller's, for k = 0), and the lane's
// owner block writes the next ones into [k & 1]; the partials and winners of
// step k go to part_*[k & 1] and win_*[k & 1].  After the chunk the state and
// template are in [n_steps & 1].
struct Buffers {
  const uint8_t* frames;
  float* rows;
  int32_t* state_i[2];
  float* state_f[2];
  float* tpl[2];
  float* win_val[2];
  int32_t* win_yx[2];
  float* part_val[2];     // by parity: n_lanes x n_slots partial bests (or checksums)
  int32_t* part_yx[2];
  float* split_part;      // n_lanes x max_split_tiles x 2 halves x 3 x kOut
  int32_t* split_count;   // n_lanes x max_split_tiles arrivals (zeroed at launch)
  int32_t* lane_count;    // n_lanes arrivals at the fold (zeroed at launch)
  unsigned int* barrier;  // grid-barrier arrivals (zeroed at launch)
  unsigned int* tpl_step;  // K1: 1 + the last step whose next template is written (zeroed)
};

// Buffer [i] of a pair in the kernel's parameters, without indexing the
// parameter array at run time (which would copy it to local memory).
template <class T>
__device__ __forceinline__ T* sel(T* const (&pair)[2], int i) {
  return i ? pair[1] : pair[0];
}

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

// A lane's integer state.
struct Ints {
  int bx, by, bw, bh, lost, useg, n_valid, pad;
};

__device__ __forceinline__ Ints load_ints(const int32_t* si) {
  return Ints{__ldcg(si), __ldcg(si + 1), __ldcg(si + 2), __ldcg(si + 3),
              __ldcg(si + 4), __ldcg(si + 5), __ldcg(si + 6), __ldcg(si + 7)};
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

__device__ Mode frame_mode(const Ints& s, const Params& p, int t, const Extent& e) {
  Mode m;
  m.use_global = p.enable_global &&
                 (s.useg != 0 || bbox_outside(s.bx, s.by, s.bw, s.bh, p) ||
                  s.lost >= p.lost_threshold);
  const int cx = s.bx + (s.bw >> 1), cy = s.by + (s.bh >> 1);
  const int min_tx = max(0, cx - p.radius_x - (e.tw >> 1));
  const int max_tx = min(e.out_w - 1, cx + p.radius_x - (e.tw >> 1));
  const int min_ty = max(0, cy - p.radius_y - (e.th >> 1));
  const int max_ty = min(e.out_h - 1, cy + p.radius_y - (e.th >> 1));
  const bool window_valid = max_tx >= min_tx && max_ty >= min_ty;
  m.valid = t < s.n_valid;
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

// The winner a lane that scored nothing gets: no position, or for a ladder
// rung a checksum of 0.
template <int kStage>
__device__ __forceinline__ Best no_winner() {
  return kStage < kArgmax ? Best{0.0f, 0, 0} : empty_best();
}

// The deferred commit of frame tc (pvot/ops/ncc_mega.py:719-764): the gate,
// the bbox, the lost counter and the use_global reset from the lane's state
// before it and the frame's winner; `strong` says the template EMA runs.  A
// ladder rung before kArgmax walks the box instead and records the winner's
// value, its checksum.
struct Commit {
  Ints s;           // the state after the commit (n_valid as before)
  bool accept, strong, do_global;
  float score;      // the record's score field
};

template <int kStage>
__device__ Commit commit_of(const Ints& prev, const Best& best, const Params& p, int tc,
                           const Extent& e) {
  Commit c;
  c.s = prev;
  if constexpr (kStage < kArgmax) {
    c.s.bx = min(prev.bx + 1, p.frame_w - e.tw - 1);
    c.s.by = min(prev.by + (tc & 1), p.frame_h - e.th - 1);
    c.accept = c.strong = c.do_global = false;
    c.score = best.val;
    return c;
  }
  const Mode m = frame_mode(prev, p, tc, e);
  const float threshold = m.use_global ? p.global_conf : p.min_conf;
  c.accept = m.valid && best.val >= threshold;
  if (c.accept) {
    c.s.bx = best.x; c.s.by = best.y; c.s.bw = e.tw; c.s.bh = e.th;
  }
  c.s.lost = c.accept ? 0 : (m.valid ? prev.lost + 1 : prev.lost);
  const bool new_outside = bbox_outside(c.s.bx, c.s.by, c.s.bw, c.s.bh, p);
  c.s.useg = m.valid ? ((c.accept && !new_outside) ? 0 : static_cast<int>(m.use_global))
                     : prev.useg;
  // The EMA runs inside the lane's extent only (the bucket's padding stays
  // 0, :772-787); the winner lies in the map, so the patch lies in the frame.
  c.strong = kStage == kFull && c.accept && best.val >= p.strong_conf;
  c.do_global = m.do_global;
  c.score = p.batch > 1 && !m.valid ? -1.0f : best.val;
  return c;
}

// Look-ahead record of a frame that is not scored: the state as it stands,
// score -1, no update (pvot/ops/ncc_mega.py:294-311).
__device__ __forceinline__ void lookahead_row(float* row, const Ints& s) {
  row[0] = static_cast<float>(s.bx);
  row[1] = static_cast<float>(s.by);
  row[2] = static_cast<float>(s.bw);
  row[3] = static_cast<float>(s.bh);
  row[4] = -1.0f;
  row[5] = 0.0f;
  row[6] = 0.0f;
  row[7] = static_cast<float>(s.lost);
  row[8] = static_cast<float>(s.useg);
  row[9] = 0.0f;
}

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
  b = warp_best(b);
  __syncthreads();  // scratch may still be read from an earlier call
  if (lane == 0) scratch[warp] = b;
  __syncthreads();
  b = lane < kWarps ? scratch[lane] : empty_best();
  return warp_best(b);
}

__device__ __forceinline__ float2 warp_sum2(float2 v) {
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// Block-wide sums of a pair of floats in a fixed tree order; every thread
// gets the result.
__device__ float2 block_sum2(float2 v, float2* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum2(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return warp_sum2(lane < kWarps ? scratch[lane] : make_float2(0.0f, 0.0f));
}

// block_sum2 of a 1,024-thread block (the tree of the template stats, which
// earlier versions of this kernel reduced on a 1,024-thread commit block),
// held by 512 threads: `a` is virtual thread threadIdx.x's pair, `b` virtual
// thread threadIdx.x + 512's.  Warp w of this block holds virtual warps w and
// w + 16, so the shuffles, the 32 warp sums in `scratch` and the last warp's
// tree are the 1,024-thread block's, bit for bit.
__device__ float2 block_sum2_virtual(float2 a, float2 b, float2* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum2(a);
  b = warp_sum2(b);
  __syncthreads();
  if (lane == 0) {
    scratch[warp] = a;
    scratch[warp + kWarps] = b;
  }
  __syncthreads();
  return warp_sum2(scratch[lane]);
}

// Block-wide sum of 32-bit integers modulo 2^32 (exact in any order); every
// thread gets the result.  The ladder's integer checksums.
__device__ __forceinline__ uint32_t block_sum_u32(uint32_t v, uint32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < kWarps ? scratch[lane] : 0u;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Every block of the grid waits here until all have arrived (barrier
// `index`, counting from 0; the launch zeroed the counter): a release add
// and an acquire spin, so every block's writes before it are visible to
// every block's reads after it.  The cooperative launch makes every block
// resident, so the spin ends; one that has not ended after
// kBarrierTimeoutNs traps.
__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int index) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int target = (index + 1) * gridDim.x;
    // Arrive, releasing the block's writes (the block barrier above makes
    // them this thread's to release), then spin until every block has.
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    unsigned long long t0;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    for (unsigned int spin = 1;; ++spin) {
      unsigned int seen;
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (seen >= target) break;
      if (spin % 1024 == 0) {
        unsigned long long now;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
        if (now - t0 > kBarrierTimeoutNs) __trap();
      }
    }
  }
  __syncthreads();
}

// One template pixel after the EMA (pvot/ops/ncc_mega.py:766-772):
// (1 - lr) * old + lr * u8 * float32(1/255), each step rounded to nearest.
__device__ __forceinline__ float ema_px(float old, uint8_t px, const Params& p) {
  const float patch = __fmul_rn(static_cast<float>(px), kU8Scale);
  return __fadd_rn(__fmul_rn(p.one_minus_lr, old), __fmul_rn(p.lr, patch));
}

struct Stats {
  float mean, std, sum_tc;
};

// A lane's template after the commit's EMA and its stats (pvot/ops/
// ncc_mega.py:766-787): src the template before it (th x tw inside rows of
// tw4), patch the frame at the winner (rows frame_w apart).  The EMA values
// go to `dst` when given (the owner's copy for the next step) and, with
// kStash, uncentered into `stash` at the template's layout (the whole
// template staged in shared memory); without kStash the second pass
// recomputes them.  The sums run in the order of a 1,024-thread block:
// virtual thread v adds pixels v, v + 1024, ... (mean and sum of squares,
// then sum_tc = sum(v - mean)), then block_sum2_virtual; so the stats do not
// depend on the block's size.
// Virtual thread v's pixels v, v + 1024, ... of a th x tw template as (row,
// column), stepped without a division a pixel: the order of the template
// stats (a 1,024-thread block's, the commit block of earlier versions of this
// kernel), so that they do not depend on the block's size.
struct PixelWalk {
  int i, j, di, dj, th, tw;
  __device__ PixelWalk(int v, int th_, int tw_)
      : i(v / tw_), j(v % tw_), di(kVirtual / tw_), dj(kVirtual % tw_), th(th_), tw(tw_) {}
  __device__ bool more() const { return i < th; }
  __device__ void next() {
    i += di;
    j += dj;
    if (j >= tw) {
      j -= tw;
      ++i;
    }
  }
};

// A whole lane's template after the commit's EMA, in place in s_tc (th x tw
// inside rows of tw4, fetched there as it was before the EMA), with the
// patch's bytes in pbuf (fetch_issue's layout; patch: the frame at the
// winner), and its stats (pvot/ops/ncc_mega.py:766-787): the EMA and the
// first pass (mean and sum of squares) in one walk, then sum_tc = sum(v -
// mean), each in the 1,024-thread order (PixelWalk, block_sum2_virtual).
// `next` (the owner's): also the EMA's values, the template for the next
// step, padding columns included.
__device__ Stats ema_stats_whole(float* s_tc, const uint32_t* pbuf, const uint8_t* patch,
                                 int th, int tw, int tw4, const Params& p, float2* scratch,
                                 float* next) {
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(pbuf);
  const int pw4 = 4 * ((tw + 6) / 4);
  const int off0 = static_cast<int>(reinterpret_cast<uintptr_t>(patch) & 3);
  const int wrap = p.frame_w & 3;
  float2 acc[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (PixelWalk w(h * kThreads + static_cast<int>(threadIdx.x), th, tw); w.more(); w.next()) {
      const int pos = w.i * tw4 + w.j;
      const float v =
          ema_px(s_tc[pos], bytes[w.i * pw4 + ((off0 + w.i * wrap) & 3) + w.j], p);
      s_tc[pos] = v;
      acc[h].x += v;
      acc[h].y = fmaf(v, v, acc[h].y);
    }
  }
  const float2 tot = block_sum2_virtual(acc[0], acc[1], scratch);
  const float n = static_cast<float>(th * tw);
  Stats s;
  s.mean = __fdiv_rn(tot.x, n);
  const float var = __fsub_rn(__fdiv_rn(tot.y, n), __fmul_rn(s.mean, s.mean));
  s.std = __fadd_rn(__fsqrt_rn(fmaxf(var, 0.0f)), kEps);
  float c[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (PixelWalk w(h * kThreads + static_cast<int>(threadIdx.x), th, tw); w.more(); w.next()) {
      c[h] += __fsub_rn(s_tc[w.i * tw4 + w.j], s.mean);
    }
  }
  s.sum_tc = block_sum2_virtual(make_float2(c[0], 0.0f), make_float2(c[1], 0.0f), scratch).x;
  if (next != nullptr) {
    for (int i = threadIdx.x; i < th * tw4 / 4; i += blockDim.x) {
      reinterpret_cast<float4*>(next)[i] = reinterpret_cast<const float4*>(s_tc)[i];
    }
  }
  return s;
}

// n floats (a multiple of 4) from src (global memory, through L2) into dst
// (shared memory), asynchronously: cp_wait waits for them.
__device__ __forceinline__ void fetch_async(float* dst, const float* src, int n) {
  for (int idx = threadIdx.x; idx < n / 4; idx += blockDim.x) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + 4 * idx));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + 4 * idx)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// A whole lane's template, rows x tw4 floats from src (global memory, read
// through L2; null: already on its way), into s_tc as it is, and with
// `patch` (the EMA's frame rows at the winner, frame_w apart) its rows x tw
// bytes into pbuf, each row as the aligned 4-byte words that hold it: all as
// asynchronous copies, so the block waits for L2 once, in cp_wait.
__device__ void fetch_issue(float* s_tc, const float* src, int rows, int tw4,
                            const uint8_t* patch, int tw, uint32_t* pbuf, int frame_w) {
  if (src != nullptr) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // no earlier copy lands over these
    fetch_async(s_tc, src, rows * tw4);
  }
  if (patch != nullptr) {
    const int pw = patch_words(tw);
    for (int idx = threadIdx.x; idx < rows * pw; idx += blockDim.x) {
      const int i = idx / pw, c = idx - i * pw;
      const uint8_t* row = patch + static_cast<size_t>(i) * frame_w;
      const uint8_t* word = row - (reinterpret_cast<uintptr_t>(row) & 3) + 4 * c;
      if (word < row + tw) cp_async4(pbuf + idx, word);
    }
  }
}

// The block's asynchronous copies have landed and every thread sees them.
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The EMA of the template fetched into s_tc with the patch bytes in pbuf
// (fetch_issue), in place; 0 in the padding columns.
__device__ void ema_in_place(float* s_tc, const uint32_t* pbuf, const uint8_t* patch, int rows,
                             int tw, int tw4, const Params& p) {
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(pbuf);
  const int pw4 = 4 * patch_words(tw);
  for (int idx = threadIdx.x; idx < rows * tw4 / 4; idx += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(s_tc)[idx];
    const int e = 4 * idx, i = e / tw4, j = e - i * tw4;
    const int off = static_cast<int>(
        reinterpret_cast<uintptr_t>(patch + static_cast<size_t>(i) * p.frame_w) & 3);
    const uint8_t* px = bytes + i * pw4 + off + j;
    float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) x[c] = j + c < tw ? ema_px(x[c], px[c], p) : 0.0f;
    reinterpret_cast<float4*>(s_tc)[idx] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

// ema_stats_whole's stats for a template too large to stage whole (staged in
// row chunks): each pass computes the EMA values again from src, the
// template before it, and patch, the frame at the winner (rows frame_w
// apart), in the same order; the first also writes them to `dst` when given
// (the owner's copy for the next step).  A thread takes 4 pixels of each of
// its two virtual threads at once, their loads all issued before the first
// is used (these kernels have the registers for it).
constexpr int kEmaBatch = 4;

__device__ __forceinline__ void ema_values(float (&v)[2 * kEmaBatch], int (&pos)[2 * kEmaBatch],
                                           const float* src, const uint8_t* patch, int base,
                                           int n_px, int tw, int tw4, const Params& p) {
#pragma unroll
  for (int q = 0; q < 2 * kEmaBatch; ++q) {  // virtual thread q & 1, its pixel q >> 1
    const int idx = base + (q >> 1) * kVirtual + (q & 1) * kThreads + static_cast<int>(threadIdx.x);
    const int i = idx / tw, j = idx - i * tw;
    pos[q] = idx < n_px ? i * tw4 + j : -1;
    v[q] = idx < n_px ? ema_px(__ldcg(src + pos[q]), patch[i * p.frame_w + j], p) : 0.0f;
  }
}

__device__ Stats ema_stats(const float* src, const uint8_t* patch, float* dst, int th, int tw,
                           int tw4, const Params& p, float2* scratch) {
  const int n_px = th * tw;
  float2 acc[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  for (int base = 0; base < n_px; base += kEmaBatch * kVirtual) {
    float v[2 * kEmaBatch];
    int pos[2 * kEmaBatch];
    ema_values(v, pos, src, patch, base, n_px, tw, tw4, p);
#pragma unroll
    for (int q = 0; q < 2 * kEmaBatch; ++q) {
      if (pos[q] < 0) continue;
      if (dst != nullptr) dst[pos[q]] = v[q];
      acc[q & 1].x += v[q];
      acc[q & 1].y = fmaf(v[q], v[q], acc[q & 1].y);
    }
  }
  const float2 tot = block_sum2_virtual(acc[0], acc[1], scratch);
  const float n = static_cast<float>(n_px);
  Stats s;
  s.mean = __fdiv_rn(tot.x, n);
  const float var = __fsub_rn(__fdiv_rn(tot.y, n), __fmul_rn(s.mean, s.mean));
  s.std = __fadd_rn(__fsqrt_rn(fmaxf(var, 0.0f)), kEps);
  float c[2] = {0.0f, 0.0f};
  for (int base = 0; base < n_px; base += kEmaBatch * kVirtual) {
    float v[2 * kEmaBatch];
    int pos[2 * kEmaBatch];
    ema_values(v, pos, src, patch, base, n_px, tw, tw4, p);
#pragma unroll
    for (int q = 0; q < 2 * kEmaBatch; ++q) {
      if (pos[q] >= 0) c[q & 1] += __fsub_rn(v[q], s.mean);
    }
  }
  s.sum_tc = block_sum2_virtual(make_float2(c[0], 0.0f), make_float2(c[1], 0.0f), scratch).x;
  return s;
}

// One staged slot of a centered template value, v - t_mean: the float
// itself or, for the tiers (tiers.cuh), its hi/lo slot in the same bytes; 0
// outside the lane's columns.
template <int kPasses>
__device__ __forceinline__ float staged_slot(float v, float t_mean, bool inside) {
  if (!inside) return 0.0f;
  const float c = __fsub_rn(v, t_mean);
  if constexpr (kPasses == 0) {
    return c;
  } else {
    return __uint_as_float(split_pack(c));
  }
}

// A whole lane's template in s_tc (rows x tw4), centered in place: tpl -
// t_mean, 0 in the padding columns (so they add exactly 0 to the
// correlation).
template <int kPasses>
__device__ void center_in_place(float* s_tc, float t_mean, int rows, int tw, int tw4) {
  for (int idx = threadIdx.x; idx < rows * tw4 / 4; idx += blockDim.x) {
    const float4 v = reinterpret_cast<const float4*>(s_tc)[idx];
    const int j = 4 * idx - ((4 * idx) / tw4) * tw4;
    reinterpret_cast<float4*>(s_tc)[idx] = make_float4(
        staged_slot<kPasses>(v.x, t_mean, j < tw), staged_slot<kPasses>(v.y, t_mean, j + 1 < tw),
        staged_slot<kPasses>(v.z, t_mean, j + 2 < tw),
        staged_slot<kPasses>(v.w, t_mean, j + 3 < tw));
  }
}

// A chunk of a lane's template rows into s_tc, centered as center_in_place
// does: from `src` (global memory, read through L2), after the EMA with
// `patch` when given (rows frame_w apart).  A thread loads 4 float4s (and
// their patch bytes) at once, their loads all issued before the first is
// used (the template in row chunks: these kernels have the registers).
template <int kPasses>
__device__ void stage_rows_of(float* s_tc, const float* src, const uint8_t* patch,
                              const Params& p, float t_mean, int rows, int tw, int tw4) {
  constexpr int kB = 4;
  const int n4 = rows * tw4 / 4;
  for (int base = threadIdx.x; base < n4; base += kB * kThreads) {
    float x[kB][4];
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int idx = base + q * kThreads;
      if (idx >= n4) continue;
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src) + idx);
      const int e = 4 * idx, i = e / tw4, j = e - i * tw4;
      x[q][0] = v.x; x[q][1] = v.y; x[q][2] = v.z; x[q][3] = v.w;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (patch != nullptr && j + c < tw) {
          x[q][c] = ema_px(x[q][c], patch[i * p.frame_w + j + c], p);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kB; ++q) {
      const int idx = base + q * kThreads;
      if (idx >= n4) continue;
      const int j = 4 * idx - ((4 * idx) / tw4) * tw4;
#pragma unroll
      for (int c = 0; c < 4; ++c) x[q][c] = staged_slot<kPasses>(x[q][c], t_mean, j + c < tw);
      reinterpret_cast<float4*>(s_tc)[idx] = make_float4(x[q][0], x[q][1], x[q][2], x[q][3]);
    }
  }
}

// One unit's input rows, frame rows gy0 .. gy0 + in_rows - 1 by columns ox0
// .. ox0 + in_wl - 1, as u8 * float32(1/255) (0 past the frame) into s_in
// (rows in_w apart; in_wl and in_w are multiples of 4).  A thread takes 16
// columns of a row: the aligned 16-byte vector that holds their first byte
// and, when the row is not aligned, the next one, realigned in registers and
// converted in the same pass, then stored as 4 float4s; the index math runs
// once per 16 columns.  kStore false (the ladder's kDma) loads and returns
// the sum of the bytes inside the frame without storing; else returns 0.
template <bool kStore>
__device__ uint32_t load_window(float* s_in, const uint8_t* frame, const Params& p, int gy0,
                                int ox0, int in_rows, int in_wl, int in_w) {
  const int nv = (in_wl + 15) >> 4;  // 16-column groups a row
  const int w_lim = min(p.frame_w - ox0, in_wl);
  uint32_t chk = 0;
  for (int idx = threadIdx.x; idx < in_rows * nv; idx += blockDim.x) {
    const int r = idx / nv, c0 = 16 * (idx - r * nv);  // the group's first column
    const int gy = gy0 + r;
    const int lim = gy < p.frame_h ? w_lim : 0;  // columns taken from the frame
    uint32_t w[4] = {0u, 0u, 0u, 0u};            // the group's 16 bytes
    if (c0 < lim) {
      const uint8_t* at = frame + static_cast<size_t>(gy) * p.frame_w + ox0 + c0;
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 15);
      const uint4* vp = reinterpret_cast<const uint4*>(at - mis);
      const uint4 a = __ldg(vp);
      const uint4 b = (mis != 0 && c0 + 16 - mis < lim) ? __ldg(vp + 1) : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t q[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      const int m = mis >> 2, sh = 8 * (mis & 3);
#pragma unroll
      for (int k = 0; k < 4; ++k) {  // words k + m and k + m + 1 of q, by selects
        const uint32_t lo = m == 0 ? q[k] : m == 1 ? q[k + 1] : m == 2 ? q[k + 2] : q[k + 3];
        const uint32_t hi = m == 0 ? q[k + 1] : m == 1 ? q[k + 2] : m == 2 ? q[k + 3] : q[k + 4];
        w[k] = __funnelshift_r(lo, hi, sh);
      }
    }
    float* dst = s_in + r * in_w + c0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + 4 * k >= in_wl) break;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t byte = c0 + 4 * k + e < lim ? (w[k] >> (8 * e)) & 0xffu : 0u;
        chk += byte;
        f[e] = __fmul_rn(static_cast<float>(byte), kU8Scale);
      }
      if constexpr (kStore) reinterpret_cast<float4*>(dst)[k] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
  return kStore ? 0u : chk;
}

// The resident plan's window loads, cut in two so that the next half's
// bytes travel while the current half is scored: res_fetch loads this
// thread's 16-column groups of load_window's rows and columns (at most
// kPreSlots of them; plan_of sees to it) into registers, and res_store
// converts and stores them as load_window does.
struct Pending {
  uint4 a[kPreSlots], b[kPreSlots];
};

__device__ __forceinline__ void res_fetch(Pending& q, const uint8_t* frame, const Params& p,
                                          int gy0, int ox0, int in_rows, int in_wl) {
  const int nv = (in_wl + 15) >> 4;
  const int w_lim = min(p.frame_w - ox0, in_wl);
#pragma unroll
  for (int s = 0; s < kPreSlots; ++s) {
    const int idx = static_cast<int>(threadIdx.x) + s * kThreads;
    q.a[s] = make_uint4(0u, 0u, 0u, 0u);
    q.b[s] = make_uint4(0u, 0u, 0u, 0u);
    if (idx >= in_rows * nv) continue;
    const int r = idx / nv, c0 = 16 * (idx - r * nv);
    const int gy = gy0 + r;
    const int lim = gy < p.frame_h ? w_lim : 0;
    if (c0 < lim) {
      const uint8_t* at = frame + static_cast<size_t>(gy) * p.frame_w + ox0 + c0;
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 15);
      const uint4* vp = reinterpret_cast<const uint4*>(at - mis);
      q.a[s] = __ldg(vp);
      if (mis != 0 && c0 + 16 - mis < lim) q.b[s] = __ldg(vp + 1);
    }
  }
}

__device__ __forceinline__ void res_store(const Pending& q, float* s_in, const uint8_t* frame,
                                          const Params& p, int gy0, int ox0, int in_rows,
                                          int in_wl, int in_w) {
  const int nv = (in_wl + 15) >> 4;
  const int w_lim = min(p.frame_w - ox0, in_wl);
#pragma unroll
  for (int s = 0; s < kPreSlots; ++s) {
    const int idx = static_cast<int>(threadIdx.x) + s * kThreads;
    if (idx >= in_rows * nv) continue;
    const int r = idx / nv, c0 = 16 * (idx - r * nv);
    const int gy = gy0 + r;
    const int lim = gy < p.frame_h ? w_lim : 0;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (c0 < lim) {
      const uint8_t* at = frame + static_cast<size_t>(gy) * p.frame_w + ox0 + c0;
      const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(at) & 15);
      const uint32_t v[8] = {q.a[s].x, q.a[s].y, q.a[s].z, q.a[s].w,
                             q.b[s].x, q.b[s].y, q.b[s].z, q.b[s].w};
      const int m = mis >> 2, sh = 8 * (mis & 3);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = m == 0 ? v[k] : m == 1 ? v[k + 1] : m == 2 ? v[k + 2] : v[k + 3];
        const uint32_t hi = m == 0 ? v[k + 1] : m == 1 ? v[k + 2] : m == 2 ? v[k + 3] : v[k + 4];
        w[k] = __funnelshift_r(lo, hi, sh);
      }
    }
    float* dst = s_in + r * in_w + c0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + 4 * k >= in_wl) break;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t byte = c0 + 4 * k + e < lim ? (w[k] >> (8 * e)) & 0xffu : 0u;
        f[e] = __fmul_rn(static_cast<float>(byte), kU8Scale);
      }
      reinterpret_cast<float4*>(dst)[k] = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

// Four taps of a tile row's kTileW outputs: acc[x] gains window column x +
// k times tap k, k = 0 .. 3 in order, from the 20 window columns a .. e.
__device__ __forceinline__ void res_step(float (&acc)[kTileW], const float4& a, const float4& b,
                                         const float4& c, const float4& d, const float4& e,
                                         const float4& t) {
  const float w[20] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y,
                       c.z, c.w, d.x, d.y, d.z, d.w, e.x, e.y, e.z, e.w};
#pragma unroll
  for (int x = 0; x < kTileW; ++x) {
    acc[x] = fmaf(w[x], t.x, acc[x]);
    acc[x] = fmaf(w[x + 1], t.y, acc[x]);
    acc[x] = fmaf(w[x + 2], t.z, acc[x]);
    acc[x] = fmaf(w[x + 3], t.w, acc[x]);
  }
}

// One share's correlation for a tile row's kTileW outputs: over `rows`
// template rows (t_row, tw4 apart) and their window rows (in_row, in_w
// apart), n4 groups of 4 taps a row, each output's sum one chain in row and
// tap order, as the chunked plan adds it.  A group of 4 taps is 64 FMAs for
// one window float4 and one template float4 (a broadcast), so the loads
// take half the shared-memory cycles the FMAs take.  The window columns
// rotate through five float4s, so the loop moves no register; it reads at
// most 15 columns past the last tap's window.
__device__ __forceinline__ void res_corr(float (&acc)[kTileW], const float* in_row,
                                         const float* t_row, int rows, int in_w, int tw4,
                                         int n4) {
  for (int i = 0; i < rows; ++i, in_row += in_w, t_row += tw4) {
    const float4* wp = reinterpret_cast<const float4*>(in_row);
    const float4* tp = reinterpret_cast<const float4*>(t_row);
    float4 r0 = wp[0], r1 = wp[1], r2 = wp[2], r3 = wp[3], r4;
    int q = 0;
    for (; q + 5 <= n4; q += 5) {
      r4 = wp[q + 4];
      res_step(acc, r0, r1, r2, r3, r4, tp[q]);
      r0 = wp[q + 5];
      res_step(acc, r1, r2, r3, r4, r0, tp[q + 1]);
      r1 = wp[q + 6];
      res_step(acc, r2, r3, r4, r0, r1, tp[q + 2]);
      r2 = wp[q + 7];
      res_step(acc, r3, r4, r0, r1, r2, tp[q + 3]);
      r3 = wp[q + 8];
      res_step(acc, r4, r0, r1, r2, r3, tp[q + 4]);
    }
    if (q < n4) {
      r4 = wp[q + 4];
      res_step(acc, r0, r1, r2, r3, r4, tp[q]);
      if (q + 1 < n4) {
        r0 = wp[q + 5];
        res_step(acc, r1, r2, r3, r4, r0, tp[q + 1]);
        if (q + 2 < n4) {
          r1 = wp[q + 6];
          res_step(acc, r2, r3, r4, r0, r1, tp[q + 2]);
          if (q + 3 < n4) {
            r2 = wp[q + 7];
            res_step(acc, r3, r4, r0, r1, r2, tp[q + 3]);
          }
        }
      }
    }
  }
}

// sum + v[0] + v[1] + ..., in that order, over n values `stride` apart: the
// loads of 8 values issued before their additions.
__device__ __forceinline__ float res_column(float sum, const float* v, int n, int stride) {
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = v[(i + k) * stride];
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += x[k];
  }
  for (; i < n; ++i) sum += v[i * stride];
  return sum;
}

// Four columns' sums over tw window columns from each (row at the first),
// and their sums of squares, each in column order from 0, as the chunked
// plan's row sums.
__device__ __forceinline__ void res_row_sums(const float* row, int tw, float (&rs)[4],
                                             float (&rq)[4]) {
  auto group = [&](const float4& a, const float4& b) {
    const float w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        rs[c] += w[c + k];
        rq[c] = fmaf(w[c + k], w[c + k], rq[c]);
      }
    }
  };
  const float4* vp = reinterpret_cast<const float4*>(row);
  float4 a = vp[0], b;
  int j = 0;
  for (; j + 8 <= tw; j += 8) {
    b = vp[j / 4 + 1];
    group(a, b);
    a = vp[j / 4 + 2];
    group(b, a);
  }
  if (j + 4 <= tw) {
    group(a, vp[j / 4 + 1]);
    j += 4;
  }
  for (; j < tw; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      rs[c] += row[c + j];
      rq[c] = fmaf(row[c + j], row[c + j], rq[c]);
    }
  }
}

// L2 prefetch of frame rows y0 .. y1 by columns x0 .. x1 (clamped into the
// frame), a 128-byte line a thread.
__device__ void prefetch_rect(const uint8_t* frame, const Params& p, int y0, int y1, int x0,
                              int x1) {
  y0 = max(y0, 0); x0 = max(x0, 0);
  y1 = min(y1, p.frame_h - 1); x1 = min(x1, p.frame_w - 1);
  if (y1 < y0 || x1 < x0) return;
  const int lines = (x1 - x0) / 128 + 2;  // lines a row, at any alignment
  for (int i = threadIdx.x; i < (y1 - y0 + 1) * lines; i += blockDim.x) {
    const int r = i / lines, c = x0 + 128 * (i - r * lines);
    if (c > x1 + 127) continue;
    const uint8_t* at = frame + static_cast<size_t>(y0 + r) * p.frame_w + min(c, x1);
    asm volatile("prefetch.global.L2 [%0];" ::"l"(at));
  }
}

// K1's winner of step k: every block folds the partials of the `serving`
// blocks that scored the step (slots 0 .. serving - 1 of part_*[k & 1]), the
// lexicographic best (a total order: every block gets the same winner), or
// for a ladder rung before kArgmax the checksum's sum in a fixed order.
// Every thread gets the result; no item: no_winner.
template <int kStage>
__device__ Best fold_slots(const Buffers& b, int k, int serving, Best* s_best, float2* s_red) {
  const float* val = sel(b.part_val, k & 1);
  const int32_t* yx = sel(b.part_yx, k & 1);
  if constexpr (kStage < kScoreBox) {
    uint32_t v = 0;
    for (int j = threadIdx.x; j < serving; j += blockDim.x) {
      v += static_cast<uint32_t>(__ldcg(yx + 2 * j));
    }
    return Best{static_cast<float>(block_sum_u32(v, reinterpret_cast<uint32_t*>(s_red)) &
                                   kChecksumMask), 0, 0};
  } else if constexpr (kStage < kArgmax) {
    float v = 0.0f;
    for (int j = threadIdx.x; j < serving; j += blockDim.x) v += __ldcg(val + j);
    return Best{block_sum2(make_float2(v, 0.0f), s_red).x, 0, 0};
  } else {
    Best win = empty_best();
    for (int j = threadIdx.x; j < serving; j += blockDim.x) {
      const Best c{__ldcg(val + j), __ldcg(yx + 2 * j), __ldcg(yx + 2 * j + 1)};
      if (lex_better(c, win)) win = c;
    }
    return block_best(win, s_best);
  }
}

// One lane's work in frame t from its state and extent, in tiles of tile_h
// x kTileW outputs, unsplit and without stats; the table build decides the
// split and fills the rest.
__device__ LaneWork lane_work(const Ints& s, const Params& p, int t, const Extent& e,
                              int tile_h) {
  const Mode m = frame_mode(s, p, t, e);
  LaneWork w;
  w.th = e.th; w.tw = e.tw;
  w.ry0 = m.ry0; w.rx0 = m.rx0; w.ry1 = m.ry1; w.rx1 = m.rx1;
  const int reg_h = m.ry1 - m.ry0 + 1, reg_w = m.rx1 - m.rx0 + 1;
  w.tiles_x = reg_w > 0 ? (reg_w + kTileW - 1) / kTileW : 0;
  w.n_tiles = reg_h > 0 ? ((reg_h + tile_h - 1) / tile_h) * w.tiles_x : 0;
  w.do_global = m.do_global;
  w.split = 1; w.begin = 0; w.n_items = 0;
  return w;
}

// The persistent chunk kernel's body: one launch walks the chunk's scored
// frame steps t = k * batch + batch - 1, k = 0 .. n_steps - 1, and the blocks
// meet at one grid barrier a step.  Step k:
//   (1) the table: every block derives each lane's state for frame t (the
//       deferred commit of the previous scored frame from its state and
//       winner), its mode, window and tiles, and lays the lanes' items end to
//       end.  K1's one lane lives in static shared memory: its state stays
//       there from step to step, every block computes its template stats,
//       and every block folds its winner here from the previous step's
//       partials (its whole template already on its way to s_tc);
//   (2) the owners: block l % gridDim owns lane l; it writes the previous
//       frame's record, the batch's look-ahead records, the template after
//       the commit's EMA (or a copy) and, but for K1 before the end, the
//       state with its stats into buffer [k & 1], and prefetches the next
//       window into L2;
//   (3) the items: the block grid-strides over the union of the lanes'
//       8 x 16 output tiles (two blocks a tile, one half of the template
//       rows each, when there are blocks to spare; 32 x 16 tiles, one run
//       a block, in the resident plan); at its first item of a lane whose
//       template the commit updated, it applies the EMA itself and computes
//       the stats, in the order of the owner's;
//   (4) the partials: a block publishes its best for each lane it scored;
//       for K2 and K3 the last of them to arrive (a counter a lane) folds the
//       lane's partials into its winner;
//   (5) the grid barrier.
// After the last step, a step k = n_steps runs (1) and (2) only: the last
// frame's commit and the records after the last scored frame.
//
// kWhole: the whole template is staged at once (stage_rows == th).
// kResident (float32, not kWhole): the resident plan's items, else the
// chunked plan's.  kOne:
// the launch has one lane (K1): its table entry is in static shared memory
// and the item loop never changes lanes.  kExt: the lanes have extents of
// their own (K3's bucketed mode; never with kOne); without it every lane has
// the launch's.  kPasses: the score tier, 0 for float32 FMAs, else the bf16
// passes of row_mma (the template rows and, after the box sums, the window
// rows held as hi/lo slots in the float32 rows' bytes: one shared-memory
// plan for every tier).  kStage: the ladder's stage (the header comment).
template <bool kWhole, bool kOne, bool kExt, int kPasses, int kStage = kFull,
          bool kResident = false>
__device__ __forceinline__ void chunk_body(const Buffers& b, const Params& p) {
  static_assert(!kResident || (!kWhole && kPasses == 0), "the resident plan is float32 rows");
  static_assert(kStage == kFull || (kOne && !kExt && (kWhole || kPasses == 0)),
                "the ladder has K1's main-path and float32 row-chunk cases only");
  extern __shared__ __align__(16) float smem[];
  __shared__ LaneWork s_one;
  __shared__ Best s_best[kWarps];
  __shared__ float2 s_red[2 * kWarps];
  __shared__ int s_last, s_n_items;
  // Output thread o's best of the current lane over its items (o < kOut),
  // kept here, not in registers held across the correlation.
  __shared__ Best s_mine[kOut];
  // Strides and shared-memory plan come from the template buffer (the
  // bucket); a lane's extent (th, tw in the item loop) may be smaller.
  const int tw4 = round_up4(p.tw);               // template row stride, zero-padded
  const int mid1 = p.th / 2;                     // the launch extent's halves
  const int in_wl1 = kTileW + tw4;               // and input columns
  const int in_w = in_stride(tw4);               // input row stride (multiple of 4)
  const int in_h = p.stage_rows + kTileH - 1;
  const int nl = p.n_lanes;
  const int grid = static_cast<int>(gridDim.x);
  const size_t tpl_lane = static_cast<size_t>(p.th) * tw4;

  LaneWork* lanes = kOne ? &s_one : reinterpret_cast<LaneWork*>(smem);
  float* s_tc = smem + lane_table_bytes(kOne ? 1 : nl) / 4;  // staged rows x tw4, centered
  float* s_in = s_tc + p.stage_rows * tw4;        // in_h x in_w input rows
  float* s_rs = s_in + in_h * in_w;               // in_h x kTileW row sums
  float* s_rq = s_rs + in_h * kTileW;             // in_h x kTileW row sums of squares
  float* s_red2 = s_rq + in_h * kTileW;           // 2 halves x kSplit x kOut partials
  float* s_col = s_red2 + 2 * kSplit * kOut;      // 2 halves x (sum, sum sq) x kOut

  const int group = threadIdx.x / kGroupThreads;
  const int lt = threadIdx.x % kGroupThreads;
  const int ty = lt / (kTileW / kRx), tx = lt % (kTileW / kRx);
  const int o = threadIdx.x, y = o / kTileW, x = o % kTileW;  // output of threads < kOut

  int prev_serving = 0;      // K1: the blocks that scored the previous step
  bool tpl_on_way = false;   // K1: this step's whole template is on its way to s_tc
  for (int k = 0;; ++k) {
    const int t = k * p.batch + p.batch - 1;     // this step's frame
    const int tc = t - p.batch;                  // the frame the table commits (k >= 1)
    const int sb = k == 0 ? 0 : (k - 1) & 1;     // the state and template scored with
    const int db = k & 1;                        // the owners write the next ones here

    // (1) The table, by warp 0: each lane's commit, mode, window and tiles;
    // two blocks share each local tile only if every item still gets a block
    // of its own; then the lanes' items end to end (exclusive prefix sum).
    // Thread `lane` owns entries lane, lane + 32, ...  K1's winner is folded
    // here, by every block from the previous step's partials; K2's and K3's
    // lanes' winners were folded by the last block that scored each.
    const Best win1 = kOne && k > 0 ? fold_slots<kStage>(b, k - 1, prev_serving, s_best, s_red)
                                    : empty_best();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int want = 0;
      for (int base = 0; base < nl; base += 32) {
        const int l = base + lane;
        int v = 0;
        if (l < nl) {
          const Extent e = kExt ? lane_extent(p, l) : launch_extent(p);
          // K1 keeps its state in this block's table entry from step to step;
          // K2 and K3 read it from the owners' state buffers.
          const bool carried = kOne && k > 0;
          const LaneWork& was = lanes[l];
          const float* sf = sel(b.state_f, sb) + l * kStateF;
          Ints s = carried ? Ints{was.bx, was.by, was.bw, was.bh, was.lost, was.useg, was.n_valid,
                                  was.pad}
                           : load_ints(sel(b.state_i, sb) + l * kStateI);
          const float st_mean = carried ? was.t_mean : __ldcg(sf);
          const float st_std = carried ? was.t_std : __ldcg(sf + 1);
          const float st_sum = carried ? was.sum_tc : __ldcg(sf + 2);
          const float st_pad = carried ? was.sf_pad : __ldcg(sf + 3);
          Commit c{};
          Best best = empty_best();
          if (k > 0) {
            if (kOne) {
              best = win1;
            } else {
              best = Best{__ldcg(sel(b.win_val, sb) + l), __ldcg(sel(b.win_yx, sb) + 2 * l),
                          __ldcg(sel(b.win_yx, sb) + 2 * l + 1)};
            }
            c = commit_of<kStage>(s, best, p, tc, e);
            s = c.s;
          }
          LaneWork w = lane_work(s, p, t, e, kResident ? kResTileH : kTileH);
          w.t_mean = st_mean;
          w.t_std = st_std;
          w.t_den = __fadd_rn(w.t_std, kEps);
          w.sum_tc = st_sum;
          w.sf_pad = st_pad;
          w.ema = c.strong;
          w.ready = !c.strong;
          w.wy = best.y;
          w.wx = best.x;
          w.bx = s.bx; w.by = s.by; w.bw = s.bw; w.bh = s.bh;
          w.lost = s.lost; w.useg = s.useg; w.n_valid = s.n_valid; w.pad = s.pad;
          w.score = c.score;
          w.accept = c.accept;
          w.gused = c.do_global;
          w.next_done = 0;
          lanes[l] = w;
          v = w.n_tiles * (w.do_global ? 1 : 2);
        }
        want += warp_sum(v);
      }
      const bool split = want <= grid && !kResident;
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
    // The blocks grid-stride over runs of `run` consecutive items (a run
    // changes lanes only at a lane's end), so that a block meets few lanes
    // (each new lane of a step costs it a staging, and with the commit's
    // EMA the stats) while a lane's items still spread over the card: as
    // many items a run as there are items a block, up to kRun; one where
    // the lanes' extents, and so their items' costs, differ (kExt), so that
    // a large template's items do not gather on a few blocks.  Lane l's runs
    // begin / run .. (begin + n_items - 1) / run go to blocks first_run(l) +
    // j mod gridDim, j < serving_of(l).
    // The resident plan takes all of a block's items in one run: a block
    // then meets at most a lane or two a step, and each staging of a lane
    // serves all of its items there.
    const int run =
        kExt ? 1 : max(1, min(kResident ? kBig : kRun, (s_n_items + grid - 1) / grid));
    auto first_run = [&](int l) { return lanes[l].begin / run; };
    auto serving_of = [&](int l) {
      return lanes[l].n_items > 0
                 ? min(grid, (lanes[l].begin + lanes[l].n_items - 1) / run - first_run(l) + 1)
                 : 0;
    };
    if (kOne) prev_serving = serving_of(0);

    // What s_tc holds (lane, first row).
    int tc_lane = -1, tc_row = -1;
    const uint8_t* frame_tc = b.frames + tc * p.frame_px;  // the committed frame (k >= 1)
    // The EMA's patch words go beside the window rows, in the room of the row
    // sums and partials, when they fit (the template's copies then wait for
    // L2 with the window's loads), else into the window rows' room.
    uint32_t* pbuf_in = reinterpret_cast<uint32_t*>(s_in);
    uint32_t* pbuf_beside = reinterpret_cast<uint32_t*>(s_rs);
    const bool beside =
        p.th * patch_words(p.tw) <= in_h * 2 * kTileW + 2 * kSplit * kOut + 4 * kOut;

    auto patch_of = [&](int l) -> const uint8_t* {
      return frame_tc + l * p.frame_stride + static_cast<size_t>(lanes[l].wy) * p.frame_w +
             lanes[l].wx;
    };
    // The owner's template for the next step, or null.
    auto owned_next = [&](int l) -> float* {
      return k > 0 && l % grid == static_cast<int>(blockIdx.x) ? sel(b.tpl, db) + l * tpl_lane
                                                               : nullptr;
    };
    // K1's owner has written the next step's template: the other blocks may
    // start copying it before the barrier (release; they acquire).
    auto next_written = [&]() {
      __syncthreads();
      if (kOne && threadIdx.x == 0) {
        asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(b.tpl_step), "r"(k + 1)
                     : "memory");
      }
    };
    // The stats into lane l's entry.  The block reductions that computed
    // them come after every thread's last read of the entry, and the next
    // reads come after a barrier of the block.
    auto set_stats = [&](int l, const Stats& st) {
      if (threadIdx.x == 0) {
        lanes[l].t_mean = st.mean;
        lanes[l].t_std = st.std;
        lanes[l].t_den = __fadd_rn(st.std, kEps);
        lanes[l].sum_tc = st.sum_tc;
        lanes[l].ready = 1;
      }
    };
    // Lane l's whole template: the copies (the template unless on its way,
    // the patch when the commit's EMA runs), then, once landed, the EMA in
    // place with the stats when pending (and the owner's next template),
    // and the centering: s_tc holds the lane staged.
    auto issue_whole = [&](int l, uint32_t* pbuf) {
      fetch_issue(s_tc, tpl_on_way ? nullptr : sel(b.tpl, sb) + l * tpl_lane, lanes[l].th, tw4,
                  lanes[l].ema ? patch_of(l) : nullptr, lanes[l].tw, pbuf, p.frame_w);
      tpl_on_way = false;
    };
    auto finish_whole = [&](int l, const uint32_t* pbuf) {
      const LaneWork& w = lanes[l];
      float t_mean = w.t_mean;
      float* next = w.next_done ? nullptr : owned_next(l);
      if (w.ema && !w.ready) {
        const Stats st = ema_stats_whole(s_tc, pbuf, patch_of(l), w.th, w.tw, tw4, p, s_red,
                                         next);
        set_stats(l, st);
        t_mean = st.mean;
      } else if (w.ema) {
        ema_in_place(s_tc, pbuf, patch_of(l), w.th, w.tw, tw4, p);
        next = nullptr;  // written when the stats were
      } else if (next != nullptr) {  // the template as it is, from here
        for (int i = threadIdx.x; i < w.th * tw4 / 4; i += blockDim.x) {
          reinterpret_cast<float4*>(next)[i] = reinterpret_cast<const float4*>(s_tc)[i];
        }
      }
      if (next != nullptr) {
        next_written();  // a block barrier: every thread has read the entry
        if (threadIdx.x == 0) lanes[l].next_done = 1;
      }
      center_in_place<kPasses>(s_tc, t_mean, w.th, w.tw, tw4);
      tc_lane = l;
      tc_row = 0;
    };
    // Lane l's stats when its EMA is still pending outside the items (an
    // owner's lane it did not score, K1's blocks without items, the last
    // commit), and the owner's template for the next step (the EMA's values,
    // or a copy).
    auto lane_stats = [&](int l) {
      const LaneWork& w = lanes[l];
      float* next = owned_next(l);
      if (w.ema && !w.ready) {
        if constexpr (kWhole) {
          issue_whole(l, pbuf_in);
          cp_wait();
          finish_whole(l, pbuf_in);
        } else {
          set_stats(l, ema_stats(sel(b.tpl, sb) + l * tpl_lane, patch_of(l), next, w.th, w.tw,
                                 tw4, p, s_red));
          __syncthreads();  // the staging reads the stats next
        }
      } else if (next != nullptr && !w.ema && !w.next_done) {
        const float* prev = sel(b.tpl, sb) + l * tpl_lane;
        for (size_t i = threadIdx.x; i < tpl_lane / 4; i += blockDim.x) {
          reinterpret_cast<float4*>(next)[i] = __ldcg(reinterpret_cast<const float4*>(prev) + i);
        }
        next_written();
      }
    };

    // The next scored frame's window of each owned lane lies within this
    // step's region of positions widened by the radius, plus the template:
    // into L2 while this step runs.
    for (int l = blockIdx.x; k + 1 < p.n_steps && l < nl; l += grid) {
      const LaneWork& w = lanes[l];
      if (!w.do_global && w.n_tiles > 0) {
        prefetch_rect(b.frames + l * p.frame_stride + (t + p.batch) * p.frame_px, p,
                      w.ry0 - p.radius_y - 1, w.ry1 + p.radius_y + w.th + 1,
                      w.rx0 - p.radius_x - 1, w.rx1 + p.radius_x + w.tw + 1);
      }
    }

    // (2) The owners' lanes, at the end of the step: the committed frame's
    // record and the state for the next step (k >= 1; K1's only at the end),
    // the template for the next step if the items did not write it, the
    // look-ahead records of this step's batch (at k = n_steps, of the frames
    // after the last scored one), and for K2 and K3 an empty winner for a
    // lane with no item.  K1's stats are every block's: the blocks without
    // its items compute them here.
    auto owner_duties = [&]() {
      if (kOne && k > 0 && k < p.n_steps && blockIdx.x != 0) lane_stats(0);
      for (int l = blockIdx.x; l < nl; l += grid) {
        const LaneWork& w = lanes[l];
        const Ints s{w.bx, w.by, w.bw, w.bh, w.lost, w.useg, w.n_valid, w.pad};
        if (k > 0) {
          lane_stats(l);
          if (threadIdx.x == 0) {
            float* row = b.rows + (static_cast<size_t>(l) * p.n_frames + tc) * kRecord;
            if constexpr (kStage < kArgmax) {
              for (int f = 0; f < kRecord; ++f) row[f] = 0.0f;
              row[4] = w.score;
            } else {
              row[0] = static_cast<float>(s.bx);
              row[1] = static_cast<float>(s.by);
              row[2] = static_cast<float>(s.bw);
              row[3] = static_cast<float>(s.bh);
              row[4] = w.score;
              row[5] = w.accept ? 1.0f : 0.0f;
              row[6] = 0.0f;  // O_POISON: this kernel never poisons
              row[7] = static_cast<float>(s.lost);
              row[8] = static_cast<float>(s.useg);
              row[9] = w.gused ? 1.0f : 0.0f;
            }
            if (!kOne || k == p.n_steps) {  // K1's state leaves the table at the end
              int32_t* si = sel(b.state_i, db) + l * kStateI;
              si[0] = s.bx; si[1] = s.by; si[2] = s.bw; si[3] = s.bh;
              si[4] = s.lost; si[5] = s.useg; si[6] = s.n_valid; si[7] = s.pad;
              float* sf = sel(b.state_f, db) + l * kStateF;
              sf[0] = w.t_mean;
              sf[1] = w.t_std;
              sf[2] = w.sum_tc;
              sf[3] = w.sf_pad;
            }
          }
        }
        for (int u = t - p.batch + 1 + static_cast<int>(threadIdx.x); u < min(t, p.n_frames);
             u += blockDim.x) {
          lookahead_row(b.rows + (static_cast<size_t>(l) * p.n_frames + u) * kRecord, s);
        }
        if (!kOne && k < p.n_steps && threadIdx.x == 0 && w.n_items == 0) {
          const Best none = no_winner<kStage>();
          sel(b.win_val, db)[l] = none.val;
          sel(b.win_yx, db)[2 * l] = none.y;
          sel(b.win_yx, db)[2 * l + 1] = none.x;
        }
      }
    };
    if (k == p.n_steps) {
      owner_duties();
      break;
    }

    // (3) The items.
    const int n_items = s_n_items;
    if (o < kOut) s_mine[o] = empty_best();
    int cur = -1;                   // the lane of the last item
    bool fresh = true;              // no unit has used shared memory yet
    uint32_t ichk = 0;              // the ladder's checksums (kStage < kArgmax)
    float fchk = 0.0f;

    // (4) The block's part for lane l, and for K2 and K3 the fold by the last
    // block to arrive: slots of the blocks that scored the lane, the
    // lexicographic best (a total order: the winner does not depend on who
    // folds) or the checksum's sum.  K1's blocks fold after the barrier.
    auto publish = [&](int l, const Best& mine) {
      float* part_val = sel(b.part_val, db);
      int32_t* part_yx = sel(b.part_yx, db);
      const int slot = l * p.n_slots + blockIdx.x;
      if constexpr (kStage < kScoreBox) {
        const uint32_t v = block_sum_u32(ichk, reinterpret_cast<uint32_t*>(s_red));
        if (threadIdx.x == 0) part_yx[2 * slot] = static_cast<int32_t>(v);
      } else if constexpr (kStage < kArgmax) {
        const float v = block_sum2(make_float2(fchk, 0.0f), s_red).x;
        if (threadIdx.x == 0) part_val[slot] = v;
      } else {
        const Best v = block_best(mine, s_best);
        if (threadIdx.x == 0) {
          part_val[slot] = v.val;
          part_yx[2 * slot] = v.y;
          part_yx[2 * slot + 1] = v.x;
        }
      }
      if (kOne) return;  // the barrier publishes it
      const int serving = serving_of(l);
      const int first = first_run(l);
      if (threadIdx.x == 0) {
        __threadfence();
        s_last = atomicAdd(b.lane_count + l, 1) == serving - 1;
      }
      __syncthreads();
      if (!s_last) return;  // uniform per block
      __threadfence();
      Best win = empty_best();
      if constexpr (kStage < kScoreBox) {
        uint32_t v = 0;
        for (int j = threadIdx.x; j < serving; j += blockDim.x) {
          v += static_cast<uint32_t>(
              __ldcg(part_yx + 2 * (l * p.n_slots + (first + j) % grid)));
        }
        win.val = static_cast<float>(block_sum_u32(v, reinterpret_cast<uint32_t*>(s_red)) &
                                     kChecksumMask);
      } else if constexpr (kStage < kArgmax) {
        float v = 0.0f;
        for (int j = threadIdx.x; j < serving; j += blockDim.x) {
          v += __ldcg(part_val + l * p.n_slots + (first + j) % grid);
        }
        win.val = block_sum2(make_float2(v, 0.0f), s_red).x;
      } else {
        for (int j = threadIdx.x; j < serving; j += blockDim.x) {
          const int sl = l * p.n_slots + (first + j) % grid;
          const Best c{__ldcg(part_val + sl), __ldcg(part_yx + 2 * sl),
                       __ldcg(part_yx + 2 * sl + 1)};
          if (lex_better(c, win)) win = c;
        }
        win = block_best(win, s_best);
      }
      if (threadIdx.x == 0) {
        sel(b.win_val, db)[l] = win.val;
        sel(b.win_yx, db)[2 * l] = kStage < kArgmax ? 0 : win.y;
        sel(b.win_yx, db)[2 * l + 1] = kStage < kArgmax ? 0 : win.x;
        b.lane_count[l] = 0;  // ready for the next step
      }
    };

    // The resident plan's items (the other plans' loop below then has none).
    Best res_mine = empty_best();  // thread o's best of the current lane
    if constexpr (kResident) {
      // Lane l's items, 32 x 16 tiles, each in two units, one template
      // half each: the half's window rows (r_in) and their row sums, each
      // warp one share of the half's rows for all 512 outputs (lane: a tile
      // row's 16 outputs in registers), then each thread one output: the
      // shares' partials added in the chunked plan's order, two rounds of
      // 8, and the column sums.  The next unit's bytes load into registers
      // while those sums are added (not across lanes: a new lane's staging
      // takes the room).
      const int r_in_w = res_in_stride(tw4);
      float* r_in = s_tc + p.th * tw4;                    // a half's window rows
      float* r_rs = r_in + res_in_rows(p.th) * r_in_w;    // their row sums, kTileW a row
      float* r_rq = r_rs + res_in_rows(p.th) * kTileW;    // and sums of squares
      float* r_part = r_rq + res_in_rows(p.th) * kTileW;  // 8 shares' partials
      const int warp = threadIdx.x >> 5, row = threadIdx.x & 31;
      const int ry = o / kTileW, rx = o % kTileW;          // thread o's output
      float a_o = 0.0f, bs_o = 0.0f, bq_o = 0.0f;  // its sums over the halves so far
      Pending pend;
      bool have = false;  // r_in holds the unit about to be scored
      auto next_item = [&](int it) {
        return (it + 1) % run == 0 ? it + (grid - 1) * run + 1 : it + 1;
      };
      for (int item = blockIdx.x * run; item < n_items; item = next_item(item)) {
        int l = cur < 0 ? 0 : cur;
        if (!kOne) {
          while (item >= lanes[l].begin + lanes[l].n_items) ++l;
        }
        if (l != cur) {
          if (cur >= 0) {
            publish(cur, res_mine);
            res_mine = empty_best();
          }
          cur = l;
        }
        const LaneWork& w = lanes[l];
        const int th = kExt ? w.th : p.th, tw = kExt ? w.tw : p.tw;
        const int tw4e = kExt ? round_up4(tw) : tw4;
        const int mid = th / 2;
        const int in_wl = kTileW + tw4e;
        auto origin_y = [&](int it) { return w.ry0 + ((it - w.begin) / w.tiles_x) * kResTileH; };
        auto origin_x = [&](int it) { return w.rx0 + ((it - w.begin) % w.tiles_x) * kTileW; };
        const int oy0 = origin_y(item), ox0 = origin_x(item);
        if constexpr (kStage == kEmpty) {
          if (threadIdx.x == 0) ichk += static_cast<uint32_t>(oy0 + ox0);
          continue;
        }
        const uint8_t* frame = b.frames + l * p.frame_stride + t * p.frame_px;
        if (kStage >= kScoreBox && tc_lane != l) {
          __syncthreads();  // the last item's readers are done with the room
          issue_whole(l, reinterpret_cast<uint32_t*>(r_in));
          cp_wait();
          finish_whole(l, reinterpret_cast<const uint32_t*>(r_in));
        }
        for (int h = 0; h < 2; ++h) {
          const int hs = h == 0 ? 0 : mid, he = h == 0 ? mid : th;
          const int in_rows = he - hs + kResTileH - 1;
          if constexpr (kStage == kDma) {
            ichk += load_window<false>(r_in, frame, p, oy0 + hs, ox0, in_rows, in_wl, r_in_w);
            continue;
          }
          if constexpr (kStage == kConvert) {  // each thread reads back what it stored
            __syncthreads();
            load_window<true>(r_in, frame, p, oy0 + hs, ox0, in_rows, in_wl, r_in_w);
            __syncthreads();
            for (int idx = threadIdx.x; idx < in_rows * in_wl; idx += blockDim.x) {
              ichk += __float_as_uint(r_in[(idx / in_wl) * r_in_w + idx % in_wl]);
            }
            continue;
          }
          if (!have) {
            __syncthreads();  // the room is free (the staging's readers too)
            load_window<true>(r_in, frame, p, oy0 + hs, ox0, in_rows, in_wl, r_in_w);
            __syncthreads();
          }
          // The next unit: this item's second half, or the first half of
          // the block's next item when it is the lane's.
          int ny0 = oy0 + mid, nx0 = ox0, n_rows = th - mid + kResTileH - 1;
          have = h == 0;
          if (h == 1) {
            const int ni = next_item(item);
            have = ni < n_items && ni < w.begin + w.n_items;
            if (have) {
              ny0 = origin_y(ni);
              nx0 = origin_x(ni);
              n_rows = mid + kResTileH - 1;
            }
          }

          // Row sums of the half's window rows, 4 columns a thread (8
          // consecutive rows a quarter warp: no bank twice).
          for (int task = threadIdx.x; task < 4 * in_rows; task += kThreads) {
            const int xg = task / in_rows, r = task - xg * in_rows;
            float rs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, rq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            res_row_sums(r_in + r * r_in_w + 4 * xg, tw, rs, rq);
            reinterpret_cast<float4*>(r_rs + r * kTileW)[xg] =
                make_float4(rs[0], rs[1], rs[2], rs[3]);
            reinterpret_cast<float4*>(r_rq + r * kTileW)[xg] =
                make_float4(rq[0], rq[1], rq[2], rq[3]);
          }
          // The correlation: warp g takes share g of the half's rows (the
          // chunked plan's shares) for every output of the tile.
          float acc[kTileW];
#pragma unroll
          for (int x = 0; x < kTileW; ++x) acc[x] = 0.0f;
          if constexpr (kStage >= kScore) {
            const int i_begin = hs + warp * (he - hs) / kSplit;
            const int i_end = hs + (warp + 1) * (he - hs) / kSplit;
            res_corr(acc, r_in + (row + i_begin - hs) * r_in_w, s_tc + i_begin * tw4,
                     i_end - i_begin, r_in_w, tw4, tw4e / 4);
          }
          __syncthreads();
          // The next unit's bytes, on their way while the sums below run.
          if (have) res_fetch(pend, frame, p, ny0, nx0, n_rows, in_wl);
          // The half's sums of each output, in the chunked plan's order:
          // the column of row sums, and the shares' partials in two rounds
          // of 8 (half 1's in reverse, as its row groups take them).
          const int first = h == 0 ? 0 : kSplit / 2;  // the warps of the first round
          auto store_partials = [&]() {
            float4* part = reinterpret_cast<float4*>(r_part + (warp % (kSplit / 2)) * kResPart +
                                                     row * kResPartStride);
#pragma unroll
            for (int k = 0; k < kTileW / 4; ++k) {
              part[k] = make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
            }
          };
          auto add_partials = [&](float a) {  // one round, in its order
#pragma unroll
            for (int g = 0; g < kSplit / 2; ++g) {
              a = __fadd_rn(a, r_part[(h == 0 ? g : kSplit / 2 - 1 - g) * kResPart +
                                      ry * kResPartStride + rx]);
            }
            return a;
          };
          if (kStage >= kScore && warp >= first && warp < first + kSplit / 2) store_partials();
          const float bs_h = res_column(0.0f, r_rs + o, he - hs, kTileW);
          const float bq_h = res_column(0.0f, r_rq + o, he - hs, kTileW);
          float a_h = 0.0f;
          if constexpr (kStage >= kScore) {
            __syncthreads();
            a_h = add_partials(a_h);
            __syncthreads();
            if (warp < first || warp >= first + kSplit / 2) store_partials();
            __syncthreads();
            a_h = add_partials(a_h);
          }
          if (have) res_store(pend, r_in, frame, p, ny0, nx0, n_rows, in_wl, r_in_w);
          __syncthreads();  // the next unit's window rows are in; its row sums may start
          a_o = __fadd_rn(a_o, a_h);
          bs_o = __fadd_rn(bs_o, bs_h);
          bq_o = __fadd_rn(bq_o, bq_h);
        }
        if constexpr (kStage >= kScoreBox) {
          const int oy = oy0 + ry, ox = ox0 + rx;
          if (oy <= w.ry1 && ox <= w.rx1) {
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
            } else if (lex_better(cand, res_mine)) {
              res_mine = cand;
            }
          }
        }
        a_o = 0.0f;
        bs_o = 0.0f;
        bq_o = 0.0f;
      }
    }

    for (int item = kResident ? n_items : blockIdx.x * run; item < n_items;
         item += (item + 1) % run == 0 ? (grid - 1) * run + 1 : 1) {
      int l = 0;
      if (!kOne) {
        l = cur < 0 ? 0 : cur;
        while (item >= lanes[l].begin + lanes[l].n_items) ++l;  // items run lane by lane
      }
      if (l != cur) {
        if (cur >= 0) {
          publish(cur, o < kOut ? s_mine[o] : empty_best());
          if (o < kOut) s_mine[o] = empty_best();
        }
        cur = l;
        if (!kWhole && kStage >= kScoreBox && !lanes[l].ready) lane_stats(l);
      }
      const LaneWork& w = lanes[l];
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
      for (int kk = 0; kk < kRx; ++kk) acc[kk] = 0.0f;
      if (!kWhole && o < kOut) {  // thread o's column sums of each half, carried across units
#pragma unroll
        for (int c = 0; c < 4; ++c) s_col[c * kOut + o] = 0.0f;
      }
      const uint8_t* frame = b.frames + l * p.frame_stride + t * p.frame_px;
      // Stage units: the item's rows at once when the whole template is
      // staged, else one chunk of one half at a time (chunks start at the
      // half's first row).
      const int row_hi = h_hi == 1 ? mid : th;
      for (int u0 = h_lo == 0 ? 0 : mid; u0 < row_hi;) {
        const int u1 = kWhole ? row_hi : min(u0 + p.stage_rows, u0 < mid ? mid : th);
        const int t_row = kWhole ? 0 : u0;
        if (!fresh) __syncthreads();  // the previous unit's readers are done with it
        fresh = false;
        bool landing = false;  // the whole template's copies wait beside the window's loads
        if (kStage >= kScoreBox && (tc_lane != l || tc_row != t_row)) {
          if constexpr (kWhole) {
            if (beside) {
              issue_whole(l, pbuf_beside);
              landing = true;
            } else {
              issue_whole(l, pbuf_in);
              cp_wait();
              finish_whole(l, pbuf_in);
            }
          } else {
            const float* src = sel(b.tpl, sb) + l * tpl_lane + static_cast<size_t>(t_row) * tw4;
            const uint8_t* patch = w.ema ? frame_tc + l * p.frame_stride +
                                               static_cast<size_t>(w.wy + t_row) * p.frame_w +
                                               w.wx
                                         : nullptr;
            stage_rows_of<kPasses>(s_tc, src, patch, p, w.t_mean, u1 - u0, tw, tw4);
            tc_lane = l;
            tc_row = t_row;
          }
        }
        const int in_rows = u1 - u0 + kTileH - 1;  // input rows u0 .. u1 + kTileH - 2
        if constexpr (kStage == kDma) {
          ichk += load_window<false>(s_in, frame, p, oy0 + u0, ox0, in_rows, in_wl, in_w);
          u0 = u1;
          continue;
        }
        load_window<true>(s_in, frame, p, oy0 + u0, ox0, in_rows, in_wl, in_w);
        if (landing) {
          cp_wait();
          finish_whole(l, pbuf_beside);
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
                const float4 bq = *reinterpret_cast<const float4*>(in_row + j0 + 4);
                const float4 tv = *reinterpret_cast<const float4*>(t_rowp + j0);
                const float wv[8] = {a.x, a.y, a.z, a.w, bq.x, bq.y, bq.z, bq.w};
#pragma unroll
                for (int kk = 0; kk < kRx; ++kk) {
                  acc[kk] = fmaf(wv[kk], tv.x, acc[kk]);
                  acc[kk] = fmaf(wv[kk + 1], tv.y, acc[kk]);
                  acc[kk] = fmaf(wv[kk + 2], tv.z, acc[kk]);
                  acc[kk] = fmaf(wv[kk + 3], tv.w, acc[kk]);
                }
                a = bq;
              }
            } else {
              float c[4];
              row_mma<kPasses>(c, reinterpret_cast<const uint32_t*>(s_in) + (i - u0) * in_w,
                               reinterpret_cast<const uint32_t*>(s_tc) + (i - t_row) * tw4,
                               in_w, in_wl, tw);
#pragma unroll
              for (int kk = 0; kk < kRx; ++kk) acc[kk] = __fadd_rn(acc[kk], c[kk]);
            }
          }
          if (kWhole || (u0 < he && u1 >= he)) {
#pragma unroll
            for (int kk = 0; kk < kRx; ++kk) {
              const int out = kPasses == 0 ? lt * kRx + kk : tile_output(lt, kk);
              s_red2[(h * kSplit + group) * kOut + out] = acc[kk];
              acc[kk] = 0.0f;
            }
          }
        }
        __syncthreads();  // row sums and partial correlations are in shared memory

        // The column of row sums over each half's rows in this unit.
        if (!kWhole && o < kOut) {
          for (int h = h_lo; h < h_hi; ++h) {
            const int c0 = max(u0, h == 0 ? 0 : mid), c1 = min(u1, h == 0 ? mid : th);
            float bs = s_col[(2 * h) * kOut + o], bqs = s_col[(2 * h + 1) * kOut + o];
            for (int i = c0; i < c1; ++i) {
              bs += s_rs[(y + i - u0) * kTileW + x];
              bqs += s_rq[(y + i - u0) * kTileW + x];
            }
            s_col[(2 * h) * kOut + o] = bs;
            s_col[(2 * h + 1) * kOut + o] = bqs;
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
            for (int g = 0; g < kSplit; ++g) a_h = __fadd_rn(a_h, s_red2[(h * kSplit + g) * kOut + o]);
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
        float* mine = b.split_part + (cell * 2 + half) * 3 * kOut;
        if (o < kOut) {
          mine[o] = a_o;
          mine[kOut + o] = bs_o;
          mine[2 * kOut + o] = bq_o;
        }
        __threadfence();
        __syncthreads();
        if (threadIdx.x == 0) s_last = atomicAdd(&b.split_count[cell], 1) == 1;
        __syncthreads();
        if (!s_last) continue;  // uniform per block
        const float* other = b.split_part + (cell * 2 + 1 - half) * 3 * kOut;
        if (o < kOut) {
          a_o = __fadd_rn(a_o, __ldcg(other + o));
          bs_o = __fadd_rn(bs_o, __ldcg(other + kOut + o));
          bq_o = __fadd_rn(bq_o, __ldcg(other + 2 * kOut + o));
        }
        if (threadIdx.x == 0) b.split_count[cell] = 0;  // ready for the next step
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
        } else if (lex_better(cand, s_mine[o])) {
          s_mine[o] = cand;
        }
      }
    }
    if (cur >= 0) {
      publish(cur, kResident ? res_mine : (o < kOut ? s_mine[o] : empty_best()));
    }
    owner_duties();
    // K1: the next step's whole template into s_tc while the blocks wait at
    // the barrier, once its owner has written it (step 0's is the caller's).
    tpl_on_way = false;
    if (kOne && kWhole && kStage >= kScoreBox && k + 1 < p.n_steps) {
      if (threadIdx.x == 0 && k > 0) {
        for (;;) {
          unsigned int seen;
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(b.tpl_step)
                       : "memory");
          if (seen >= static_cast<unsigned int>(k + 1)) break;
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");  // s_tc's earlier copies have landed
      __syncthreads();
      fetch_async(s_tc, sel(b.tpl, db), p.th * tw4);
      tpl_on_way = true;
    }

    // (5)
    grid_barrier(b.barrier, static_cast<unsigned int>(k));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The float32 tier, the whole template staged: two blocks an SM at 80 x 80
// (at most 64 registers a thread).
template <bool kOne, bool kExt, int kStage = kFull>
__global__ void __launch_bounds__(kThreads, 2) chunk_kernel(const Buffers b, const Params p) {
  chunk_body<true, kOne, kExt, 0, kStage>(b, p);
}

// The float32 tier, the template staged in chunks (one block an SM: the
// shared memory holds one), its registers left to ptxas.
template <bool kOne, bool kExt>
__global__ void __launch_bounds__(kThreads) chunk_kernel_rows(const Buffers b, const Params p) {
  chunk_body<false, kOne, kExt, 0>(b, p);
}

// The float32 tier where the template does not stage whole but the resident
// plan fits (plan_of): one block an SM, its registers left to ptxas.
template <bool kOne, bool kExt, int kStage = kFull>
__global__ void __launch_bounds__(kThreads) chunk_kernel_resident(const Buffers b,
                                                                  const Params p) {
  chunk_body<false, kOne, kExt, 0, kStage, true>(b, p);
}

// The bf16 tiers: two blocks an SM with the whole template staged (left
// free, ptxas gave the 2- and 3-pass kernels 90 registers, one block an SM,
// and a local frame's items half the card in a second wave); one with the
// template in row chunks, where the shared memory holds one anyway.
template <bool kWhole, bool kOne, bool kExt, int kPasses, int kStage = kFull>
__global__ void __launch_bounds__(kThreads, kWhole ? 2 : 1)
chunk_kernel_tier(const Buffers b, const Params p) {
  chunk_body<kWhole, kOne, kExt, kPasses, kStage>(b, p);
}

using ChunkKernel = void (*)(const Buffers, const Params);

// A launch's parameters: n_lanes lanes (frame_stride apart, ext their
// extents or null), n_blocks blocks, n_frames frames at the cadence batch,
// the tracker's configuration.
Params make_params(long long frame_stride, int n_lanes, int n_frames, int batch, int frame_h,
                   int frame_w, int th, int tw, const int32_t* ext, int n_blocks, int radius_x,
                   int radius_y, int lost_threshold, int enable_global, float min_conf,
                   float global_conf, float strong_conf, float lr, float one_minus_lr) {
  Params p{};
  p.frame_h = frame_h; p.frame_w = frame_w; p.th = th; p.tw = tw;
  p.out_h = frame_h - th + 1; p.out_w = frame_w - tw + 1;
  p.radius_x = radius_x; p.radius_y = radius_y;
  p.lost_threshold = lost_threshold; p.enable_global = enable_global;
  p.n_lanes = n_lanes;
  p.n_slots = n_blocks;
  p.max_split_tiles = n_blocks / 2;
  p.stage_rows = stage_rows(th, tw, n_lanes);
  p.n_frames = n_frames;
  p.batch = batch;
  p.n_steps = batch > 0 ? n_frames / batch : 0;
  p.frame_stride = frame_stride;
  p.frame_px = static_cast<long long>(frame_h) * frame_w;
  p.ext = ext;
  p.min_conf = min_conf; p.global_conf = global_conf; p.strong_conf = strong_conf;
  p.lr = lr; p.one_minus_lr = one_minus_lr;
  return p;
}

// The workspace of a launch, in 16-byte-aligned regions: first the counters
// the launch zeroes (lane arrivals, the barrier, K1's template flag,
// split-tile arrivals), then
// the winners and the partials by parity, and the split-tile partials.
struct Workspace {
  size_t counters, win_val, win_yx, part_val, part_yx, split_part, total;
};

__host__ __device__ constexpr size_t align16(size_t v) { return (v + 15) / 16 * 16; }

Workspace workspace_layout(int n_lanes, int n_blocks) {
  const size_t nl = n_lanes, nb = n_blocks, split = nl * (nb / 2);
  Workspace w{};
  w.counters = align16(4 * (nl + 2 + split));
  w.win_val = w.counters;
  w.win_yx = w.win_val + align16(4 * 2 * nl);
  w.part_val = w.win_yx + align16(4 * 2 * 2 * nl);
  w.part_yx = w.part_val + align16(4 * 2 * nl * nb);
  w.split_part = w.part_yx + align16(4 * 2 * 2 * nl * nb);
  w.total = w.split_part + align16(4 * split * 2 * 3 * kOut);
  return w;
}

// Lets a block use `smem` bytes of dynamic shared memory, and asks for the
// largest shared-memory carveout: two 94 KB blocks (the 80 x 80 geometry) fit
// an SM only there; the default carveout left room for one.
cudaError_t set_smem(ChunkKernel kernel, int smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Blocks of `kernel` resident on one SM with the shared memory of `p`, or -1
// on a CUDA error.
int blocks_per_sm(ChunkKernel kernel, int smem) {
  int n = 0;
  if (kernel == nullptr || set_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem) != cudaSuccess) {
    return -1;
  }
  return n;
}

// One chunk: the counters zeroed, then one cooperative launch of n_blocks
// blocks of `kernel` with `smem` bytes of dynamic shared memory (its plan's,
// plan_smem_bytes) on `stream` (every block resident, or the launch is
// refused: cudaErrorCooperativeLaunchTooLarge).  `work` holds
// workspace_layout(n_lanes, n_blocks).total bytes; state_i2, state_f2 and
// tpl2 are the second buffers of the state and the template.  Returns the
// first CUDA error, or 0.
int launch_chunk_kernel(ChunkKernel kernel, const Params& p, int smem, int n_blocks,
                        const uint8_t* frames, int32_t* state_i, float* state_f, float* tpl,
                        int32_t* state_i2, float* state_f2, float* tpl2, void* work,
                        float* rows, cudaStream_t stream) {
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Workspace ws = workspace_layout(p.n_lanes, n_blocks);
  char* base = static_cast<char*>(work);
  Buffers b{};
  b.frames = frames;
  b.rows = rows;
  b.state_i[0] = state_i; b.state_i[1] = state_i2;
  b.state_f[0] = state_f; b.state_f[1] = state_f2;
  b.tpl[0] = tpl; b.tpl[1] = tpl2;
  b.lane_count = reinterpret_cast<int32_t*>(base);
  b.barrier = reinterpret_cast<unsigned int*>(base) + p.n_lanes;
  b.tpl_step = reinterpret_cast<unsigned int*>(base) + p.n_lanes + 1;
  b.split_count = reinterpret_cast<int32_t*>(base) + p.n_lanes + 2;
  b.win_val[0] = reinterpret_cast<float*>(base + ws.win_val);
  b.win_val[1] = b.win_val[0] + p.n_lanes;
  b.win_yx[0] = reinterpret_cast<int32_t*>(base + ws.win_yx);
  b.win_yx[1] = b.win_yx[0] + 2 * p.n_lanes;
  b.part_val[0] = reinterpret_cast<float*>(base + ws.part_val);
  b.part_val[1] = b.part_val[0] + p.n_lanes * n_blocks;
  b.part_yx[0] = reinterpret_cast<int32_t*>(base + ws.part_yx);
  b.part_yx[1] = b.part_yx[0] + 2 * p.n_lanes * n_blocks;
  b.split_part = reinterpret_cast<float*>(base + ws.split_part);
  err = cudaMemsetAsync(base, 0, ws.counters, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&b, const_cast<Params*>(&p)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(n_blocks),
                                    dim3(kThreads), args, smem, stream);
  return static_cast<int>(err);
}

}  // namespace
