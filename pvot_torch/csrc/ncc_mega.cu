// Tracking chunks on Hopper, one stream, many streams or many objects: the
// port of pvot/ops/ncc_mega.py `_mega_kernel` (:170) with `_scored_frame_body`
// (:496), `_shear_score_tiles` (:318) and `_lex_better` (:487), entries
// `mega_track_chunk` (:818, K1), `mega_track_chunk_multi` (:966, K2) and
// `mega_track_chunk_objects` (:1115, K3), with inkernel_global=True, at
// every score tier (highest=True, or highest=False with score_passes 1, 2,
// 3) and every look-ahead batch cadence (batch >= 1).
//
// Lanes.  The device code is written for S independent lanes (streams or
// objects): lane s has its own frames (at s * frame_stride), template, state
// slot, partials and records; K1 is S = 1, K3 is frame_stride 0 (every object
// reads the one shared clip).  A lane's template extent (th, tw) is the
// launch's unless a per-lane extent table is given (K3's bucketed mode): the
// templates then sit zero-padded in a shared th x tw bucket, and each lane
// scores, commits and updates only its own top-left th_k x tw_k.
//
// One persistent launch a chunk (mega_body.cuh chunk_body).  The TPU kernel
// is one pallas_call a chunk whose grid walks the frames, with the template
// resident in VMEM and the state in SMEM (pvot/ops/ncc_mega.py:922-950).
// Here one cooperative launch puts every block on the card at once (its
// grid: the blocks an SM can hold, times the SMs), and the blocks walk the
// chunk's scored frame steps together, meeting at one grid barrier a step.
// A step t, for every lane at once:
//   (1) the deferred commit: every block takes each lane's state and the
//       winner of the previous scored frame and derives, identically, the
//       gate (0.4 local / 0.6 when use_global), the bbox, the lost counter
//       and the use_global reset (K1 keeps its one lane's state in every
//       block's shared memory for the whole chunk, as the TPU kernel keeps
//       it in SMEM; K2 and K3 read their lanes' states from the owners'
//       buffers); then the lane's mode and window for frame
//       t (frame_mode, pvot/ops/ncc_mega.py:541-561), its region (the
//       clamped local window, or on a global frame the whole (H-th+1) x
//       (W-tw+1) map) cut into 8 x 16 output tiles, and the lanes' tiles laid
//       end to end in a table in shared memory;
//   (2) the owners: block l % grid owns lane l and writes the previous
//       frame's 10-field record, the batch's look-ahead records, and the
//       template and state for the next step into the buffers of this step's
//       parity (two of each; no block reads a buffer in the step in which it
//       is written);
//   (3) the score: each block grid-strides over the union of the lanes'
//       tiles, so a lane in re-acquisition spreads over the whole card next
//       to the local lanes; when the card has blocks to spare, two blocks
//       share each local tile, one half of the template rows each, and the
//       later of the two (an atomic count per tile) adds the other's partial
//       sums.  A block stages the centered template and its u8 input rows,
//       converted as v * float32(1/255), in shared memory: the whole template
//       when it fits beside its tile, else chunks of rows within each half
//       (templates up to 256 x 256; two instantiations, kWhole).  At float32
//       a template too large for that (160 x 160) is staged whole once a
//       step for a block's run of a lane's 32 x 16 tiles where it fits with
//       one half's window rows (the resident plan, mega_body.cuh plan_of),
//       each warp one share of the half's rows, a thread a tile row's 16
//       outputs in registers; the sums keep the chunked plan's order.  When the
//       commit's template EMA runs (score >= 0.7), the block that stages the
//       lane applies it itself while staging, from the previous template and
//       the frame's u8 patch at the winner, and computes the new mean, std
//       (+1e-6) and sum_tc (pvot/ops/ncc_mega.py:766-787) in the order of a
//       1,024-thread block, so every block and the owner get the same bits.
//       Box sums run separably (row sums over tw columns, then a column of
//       row sums over each half, carried across chunks in the same order as
//       the whole template adds them).  For the correlation sum(w * (tpl -
//       t_mean)), 16 warps split each half's rows (half 1's shares in
//       reverse, so a warp's two shares even out; a chunk runs each warp's
//       share as far as it holds it, so the sums do not depend on the
//       chunking); each thread keeps four neighbouring outputs in registers
//       and reads 4 taps per step as float4; the warps' partials add in a
//       fixed order, half 0 then half 1, whether or not two blocks shared the
//       tile.  The score is (acc - mean * sum_tc) / ((sqrt(max(var, 1e-6)) +
//       1e-6) * (t_std + 1e-6) * N);
//   (4) the fold: each block publishes, for each lane it scored, its best
//       (value, y, x) under the lexicographic order (value desc, y asc, x
//       asc); for K2 and K3 the last block to arrive (an atomic count per
//       lane) folds the lane's partials into its winner; K1's blocks each
//       fold its one lane's partials after the barrier, which saves the
//       count's and the winner's round trips.  The order is total, so the
//       winner is the row-major first-occurrence argmax whoever folds; no
//       atomics touch the values;
//   (5) the grid barrier (an arrive-and-spin counter, release and acquire).
// After the last step the owners commit the last scored frame and write the
// records of the frames after it.  Frames t >= n_valid commit nothing
// (:563-573).  The window rows load as aligned 16-byte vectors; the whole
// template and the EMA's patch come into shared memory as asynchronous
// copies (K1's template issued before the fold), so a block waits for L2
// once for them; and each owner prefetches its lane's next window into L2
// (the next window lies within this step's positions widened by the radius,
// plus the template).
//
// What bounds it on the H100 at 720p / 80x80 / r=60.  A local frame scores
// 121 x 121 positions, about 94 M FMA: at the FP32 peak that is 2.8
// microseconds, so one stream's local frames are latency-bound: inside a
// step a chain of dependent phases (table, stage, load, sum, correlate,
// combine, publish, fold, barrier), each a round trip to L2 or a barrier.
// The persistent launch takes the launches and the commit block of earlier
// versions (two launches a frame, the commit's EMA on one block) off that
// chain; the split-tile combine's round trip through L2 and the correlation
// stage are the largest parts left.  S streams share each step, so S local
// frames fill the card that one leaves idle.  A global frame scores 641 x
// 1201 positions, about 4.9 G FMA, and is bound by FP32 issue and
// shared-memory loads on all SMs.  Measured times are in PERF.md.  Later
// work (ROADMAP B8): the two halves of a tile in a cluster of two with
// distributed shared memory in place of the L2 combine, and wgmma for the
// tiers.
//
// Score tiers.  highest=False replaces the bf16 hi/lo split of
// `_shear_score_tiles` (pvot/ops/ncc_mega.py:384-440), which the TPU kernel
// runs on local frames (:676) and in the in-kernel global strips (:633)
// alike, and so does this kernel: chunk_kernel_tier<..., kPasses> runs the
// correlation on the tensor cores, with warp-level
// mma.sync.m16n8k16.bf16 (tiers.cuh row_mma), corr(hi w, hi t) for 1 pass,
// + corr(hi w, lo t) for 2, + corr(lo w, hi t) for 3.  Per template row a
// warp computes its whole 8 x 16 tile as window rows x the row's Toeplitz
// band; the template rows are staged as hi/lo slots when staged, the window
// rows after their float32 box sums, both in the bytes of the float32 rows
// (one shared-memory plan for every tier: stage_rows and score_smem_bytes do
// not see the tier).  Box sums, the epilogue, the EMA and the stats stay
// float32.  chunk_kernel, the float32 tier, is the float32 FMA code; the
// kernels share chunk_body.  Bound: the bf16 passes at 989 TFLOP/s, 0.19 /
// 0.38 / 0.57 us for 1 / 2 / 3 passes of a local 720p/80/r60 frame (93.7 M
// MAC), far below the chain of dependent phases that bounds a local frame;
// a global frame (4.93 G MAC) is where the tensor cores can show.
// Accumulation: the tensor core's float32 sums are not round-to-nearest, so
// the fragment restarts from 0 for every template row (ceil((tw + 7) / 16)
// steps a pass) and each row's sum joins the thread's float32 sums with one
// round-to-nearest addition; the rows, row shares, halves and chunks add in
// the float32 kernel's fixed order, so a lane's records are K1's on it alone
// at every tier, whoever shares the launch.
//
// Batch cadence (pvot/ops/ncc_mega.py:262-311).  With batch > 1 only frames
// t with t % batch == batch - 1 are scored: n_frames / batch steps.  The
// owner writes each batch's look-ahead records (the state before its scored
// frame, score -1, no update) and, after the last step, those of the frames
// after the last scored one; the state's n_valid field holds n_full =
// (n_valid // batch) * batch, so a cadence frame past it commits nothing and
// records score -1.  One launch a chunk at every batch.
//
// Numerics.  The epilogue, the u8 conversion and the EMA use explicit
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs that
// the plain PyTorch version (pvot_torch/ops/ncc_mega.py) does not do; only the
// sums themselves run in another order, the same order for every lane count.
// Build without --use_fast_math.
//
// Layout.  The persistent kernel and its helpers are in mega_body.cuh, which
// the rung ladder (mega_breakdown.cu) shares; this file instantiates their
// production stage (kFull) for K1-K3 and holds the C entries.

#include "mega_body.cuh"

namespace {

template <int kPasses>
ChunkKernel chunk_kernel_of(bool whole, bool one, bool ext) {
  if constexpr (kPasses == 0) {
    if (one) return whole ? chunk_kernel<true, false> : chunk_kernel_rows<true, false>;
    if (ext) return whole ? chunk_kernel<false, true> : chunk_kernel_rows<false, true>;
    return whole ? chunk_kernel<false, false> : chunk_kernel_rows<false, false>;
  } else {
    if (one) {
      return whole ? chunk_kernel_tier<true, true, false, kPasses>
                   : chunk_kernel_tier<false, true, false, kPasses>;
    }
    if (ext) {
      return whole ? chunk_kernel_tier<true, false, true, kPasses>
                   : chunk_kernel_tier<false, false, true, kPasses>;
    }
    return whole ? chunk_kernel_tier<true, false, false, kPasses>
                 : chunk_kernel_tier<false, false, false, kPasses>;
  }
}

// The chunk kernel's instantiation for the plan (plan_of), for one lane or
// many, for lanes with extents of their own, and for the score tier (0:
// float32; 1, 2, 3: bf16 passes); null for another tier.
ChunkKernel chunk_kernel_for(int plan, bool one, bool ext, int passes) {
  if (plan == kPlanResident) {
    if (one) return chunk_kernel_resident<true, false>;
    return ext ? chunk_kernel_resident<false, true> : chunk_kernel_resident<false, false>;
  }
  const bool whole = plan == kPlanWhole;
  switch (passes) {
    case 0: return chunk_kernel_of<0>(whole, one, ext);
    case 1: return chunk_kernel_of<1>(whole, one, ext);
    case 2: return chunk_kernel_of<2>(whole, one, ext);
    case 3: return chunk_kernel_of<3>(whole, one, ext);
    default: return nullptr;
  }
}

// One chunk of n_frames over n_lanes lanes on `stream`, at the score tier
// `passes` (0: float32) and the cadence `batch`: one cooperative launch of
// n_blocks blocks, whatever the batch.  ext: per-lane (th_k, tw_k) inside
// the th x tw template buffer, or null.
int launch_chunk(const uint8_t* frames, long long frame_stride, int n_lanes, int n_frames,
                 int frame_h, int frame_w, int th, int tw, const int32_t* ext,
                 int32_t* state_i, float* state_f, float* tpl, int32_t* state_i2,
                 float* state_f2, float* tpl2, void* work, int n_blocks, float* rows,
                 int radius_x, int radius_y, int lost_threshold, int enable_global,
                 float min_conf, float global_conf, float strong_conf, float lr,
                 float one_minus_lr, int passes, int batch, cudaStream_t stream) {
  const Params p = make_params(frame_stride, n_lanes, n_frames, batch, frame_h, frame_w, th, tw,
                               ext, n_blocks, radius_x, radius_y, lost_threshold, enable_global,
                               min_conf, global_conf, strong_conf, lr, one_minus_lr);
  const int plan = plan_of(th, tw, n_lanes, passes);
  // A one-lane launch runs the kOne instantiation, which takes the launch's
  // extent: an extent table needs two lanes or more.
  const ChunkKernel kernel = chunk_kernel_for(plan, n_lanes == 1, ext != nullptr, passes);
  if (plan < 0 || p.out_h < 1 || p.out_w < 1 || n_lanes < 1 || n_blocks < 1 || n_frames < 0 ||
      (ext != nullptr && n_lanes < 2) || kernel == nullptr || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_chunk_kernel(kernel, p, plan_smem_bytes(plan, th, tw, n_lanes), n_blocks, frames,
                             state_i, state_f, tpl, state_i2, state_f2, tpl2, work, rows, stream);
}

}  // namespace

extern "C" {

// K1: one stream's chunk at the score tier `passes` (0: float32; 1, 2, 3
// bf16 passes) and the cadence `batch`: one cooperative launch of n_blocks
// blocks on `stream` (every block resident at once: at most
// pvot_mega_score_blocks_per_sm times the SMs), no synchronisation.
// state_i = [bx, by, bw, bh, lost, use_global, n_valid, _], state_f =
// [t_mean, t_std, sum_tc, _] and tpl (th x round_up4(tw), zero-padded
// columns) are the state and template the chunk starts from; state_i2,
// state_f2 and tpl2 (the same sizes, tpl2 zeroed) are their second buffers.
// After the chunk the state and template are in the first buffers when
// n_frames / batch is even, else in the second.  rows is (n_frames, 10).
// work holds pvot_mega_work_bytes(1, n_blocks) bytes of scratch.  Returns
// the first CUDA error, or 0.
int pvot_mega_track_chunk(const uint8_t* frames, int n_frames, int frame_h, int frame_w,
                          int th, int tw, int32_t* state_i, float* state_f, float* tpl,
                          int32_t* state_i2, float* state_f2, float* tpl2, void* work,
                          int n_blocks, float* rows, int radius_x, int radius_y,
                          int lost_threshold, int enable_global, float min_conf,
                          float global_conf, float strong_conf, float lr, float one_minus_lr,
                          int passes, int batch, void* stream) {
  return launch_chunk(frames, 0, 1, n_frames, frame_h, frame_w, th, tw, nullptr, state_i,
                      state_f, tpl, state_i2, state_f2, tpl2, work, n_blocks, rows, radius_x,
                      radius_y, lost_threshold, enable_global, min_conf, global_conf,
                      strong_conf, lr, one_minus_lr, passes, batch,
                      static_cast<cudaStream_t>(stream));
}

// K2: n_lanes streams' chunks, tier, cadence and launch as K1's.  Lane s
// reads frames + s * frame_stride (n_frames x frame_h x frame_w u8), state
// slot s of the state buffers (8 ints, 4 floats) and template s (th x
// round_up4(tw)), and writes rows + 10 * s * n_frames.  The blocks share the
// union of all lanes' tiles.  work holds pvot_mega_work_bytes(n_lanes,
// n_blocks) bytes.
int pvot_mega_track_chunk_multi(const uint8_t* frames, long long frame_stride, int n_lanes,
                                int n_frames, int frame_h, int frame_w, int th, int tw,
                                int32_t* state_i, float* state_f, float* tpl,
                                int32_t* state_i2, float* state_f2, float* tpl2, void* work,
                                int n_blocks, float* rows, int radius_x, int radius_y,
                                int lost_threshold, int enable_global, float min_conf,
                                float global_conf, float strong_conf, float lr,
                                float one_minus_lr, int passes, int batch, void* stream) {
  return launch_chunk(frames, frame_stride, n_lanes, n_frames, frame_h, frame_w, th, tw,
                      nullptr, state_i, state_f, tpl, state_i2, state_f2, tpl2, work, n_blocks,
                      rows, radius_x, radius_y, lost_threshold, enable_global, min_conf,
                      global_conf, strong_conf, lr, one_minus_lr, passes, batch,
                      static_cast<cudaStream_t>(stream));
}

// K3: n_objects trackers over ONE clip (frames: n_frames x frame_h x frame_w
// u8, read by every object), tier, cadence and launch as K1's; replaces
// pvot/ops/ncc_mega.py:1246 (`mega_track_chunk_objects`, :1115).  Object k
// has state slot k and template k, and writes rows + 10 * k * n_frames, as a
// K2 lane does.  ext (n_objects x 2 int32 on the device, or null when every
// template is th x tw) gives each object's true extent (th_k, tw_k) inside
// its zero-padded th x tw bucket (the bucketed mode): the object scores its
// own (frame_h - th_k + 1) x (frame_w - tw_k + 1) map, commits a th_k x tw_k
// box and updates only that corner of its template.
//
// What bounds it: FP32 FMA issue, about 93.7 M FMA per 80 x 80 / r60 object
// on a local frame (4.9 G on a global one), against a frame of 0.9 MB read
// once per step.  The design answers with one step for all objects (the
// union balance, so an object in global search spreads over the whole card
// beside the local ones) and the shared frame, which every object's blocks
// read from L2 after the first.
int pvot_mega_track_chunk_objects(const uint8_t* frames, int n_objects, int n_frames,
                                  int frame_h, int frame_w, int th, int tw, const int32_t* ext,
                                  int32_t* state_i, float* state_f, float* tpl,
                                  int32_t* state_i2, float* state_f2, float* tpl2, void* work,
                                  int n_blocks, float* rows, int radius_x, int radius_y,
                                  int lost_threshold, int enable_global, float min_conf,
                                  float global_conf, float strong_conf, float lr,
                                  float one_minus_lr, int passes, int batch, void* stream) {
  return launch_chunk(frames, 0, n_objects, n_frames, frame_h, frame_w, th, tw, ext, state_i,
                      state_f, tpl, state_i2, state_f2, tpl2, work, n_blocks, rows, radius_x,
                      radius_y, lost_threshold, enable_global, min_conf, global_conf,
                      strong_conf, lr, one_minus_lr, passes, batch,
                      static_cast<cudaStream_t>(stream));
}

// Bytes of scratch a launch of n_blocks blocks over n_lanes lanes needs.
long long pvot_mega_work_bytes(int n_lanes, int n_blocks) {
  return static_cast<long long>(workspace_layout(n_lanes, n_blocks).total);
}

// Template rows a block stages at once (see stage_rows), for the wrapper's
// envelope check to be held against.
int pvot_mega_stage_rows(int th, int tw, int n_lanes) {
  return stage_rows(th, tw, n_lanes);
}

// The shared-memory plan of a launch (plan_of: 0 whole, 1 resident, 2
// chunked; -1 none fits) and its dynamic shared memory in bytes into *smem,
// for the wrapper's plan mirror and its launch counters to be held against.
int pvot_mega_plan(int th, int tw, int n_lanes, int passes, int* smem) {
  const int plan = plan_of(th, tw, n_lanes, passes);
  *smem = plan < 0 ? 0 : plan_smem_bytes(plan, th, tw, n_lanes);
  return plan;
}

// Chunk-kernel blocks resident on one SM of the current device at the given
// geometry, lanes, extent table (ext != 0) and tier, or -1 on a CUDA error
// or an unsupported geometry: the grid of a launch is at most this times the
// SMs.
int pvot_mega_score_blocks_per_sm(int th, int tw, int n_lanes, int ext, int passes) {
  const int plan = plan_of(th, tw, n_lanes, passes);
  if (plan < 0 || n_lanes < 1) return -1;
  return blocks_per_sm(chunk_kernel_for(plan, n_lanes == 1, ext != 0 && n_lanes > 1, passes),
                       plan_smem_bytes(plan, th, tw, n_lanes));
}

const char* pvot_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
