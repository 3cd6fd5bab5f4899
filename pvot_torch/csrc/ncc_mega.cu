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
// scores, commits and updates only its own top-left th_k x tw_k.  Per frame
// step t of a chunk, in stream order and with every lane's tracker state
// resident in device memory (the host never waits inside a chunk):
//
//   (a) score_kernel — one launch for all lanes.  Each block derives every
//       lane's mode and window from its state (frame_mode below,
//       pvot/ops/ncc_mega.py:541-561), cuts each lane's region (the clamped
//       local window, or on a global frame the whole (H-th+1) x (W-tw+1) map)
//       into 8 x 16 output tiles, lays the lanes' tiles end to end (an
//       exclusive prefix sum in shared memory, built by warp 0) and
//       grid-strides over the union, so a lane in re-acquisition spreads
//       over the whole card next to the local lanes.  A one-lane launch
//       (K1) is its own instantiation (kOne): every thread derives the
//       lane's work into registers, with no table and no scan.
//       When the card has blocks to spare, two blocks share each local tile,
//       one half of the template rows each; the later of the two (an atomic
//       count per tile) adds the other's partial sums.  A block stages the
//       centered template (tpl - t_mean; the template lives in device memory
//       with its rows zero-padded to a multiple of 4 columns) and its u8 input
//       rows, converted as v * float32(1/255), in shared memory: the whole
//       template when it fits beside its tile, else chunks of rows within
//       each half (templates up to 256 x 256); the two cases are two
//       instantiations of the kernel (kWhole), so a template that fits pays
//       nothing for the chunk loop.  Box sums run separably (row sums over
//       tw columns, then a column of row sums over each half, carried across
//       chunks in the same order as the whole template adds them).  For the
//       correlation sum(w * (tpl - t_mean)), 16 warps split each half's rows
//       (half 1's shares in reverse, so a warp's two shares even out; a
//       chunk runs each warp's share as far as it holds it, so the sums do
//       not depend on the chunking, which the lane table's size moves);
//       each thread keeps four neighbouring outputs in registers and reads 4
//       taps per step as float4; the warps' partials add in a fixed order,
//       half 0 then half 1, whether or not two blocks shared the tile.  The
//       score is (acc - mean * sum_tc) / ((sqrt(max(var, 1e-6)) + 1e-6) *
//       (t_std + 1e-6) * N).  The block writes, for each lane it serves, its
//       best (value, y, x) under the lexicographic order (value desc, y asc,
//       x asc) to that lane's partials, or -inf if it scored nothing of the
//       lane.  The order is total, so partials fold in any order to the
//       row-major first-occurrence argmax; no atomics touch the values.
//   (b) commit_kernel — one block per lane folds the lane's partials, applies
//       the gate (0.4 local / 0.6 when use_global), the bbox commit, the lost
//       counter and the use_global reset, runs the 0.7-gated template EMA from
//       the u8 frame at the new bbox, recomputes mean, std (+1e-6) and sum_tc
//       with block reductions (pvot/ops/ncc_mega.py:769-787), and writes the
//       frame's 10-field record and the lane's next state.  Frames t >=
//       n_valid commit nothing (:563-573).  A template of up to 1024 x 20
//       pixels stays in registers between the EMA and the stats; a larger one
//       is read back from device memory in the second pass.
//
// What bounds it on the H100 at 720p / 80x80 / r=60.  A local frame scores
// 121 x 121 positions, about 94 M FMA: at the FP32 peak that is a few
// microseconds, so one stream's local frames are latency- and launch-bound:
// two launches a frame, and inside each a chain of dependent phases (copy,
// stage, sum, publish, reduce), each a round trip to L2 or a barrier.  S
// streams share each launch, so S local frames fill the card that one leaves
// idle.  A global frame scores 641 x 1201 positions, about 4.9 G FMA, and is
// bound by FP32 issue and shared-memory loads on all SMs.  Measured times are
// in PERF.md.  Later work: wgmma and TMA for the tiers, one persistent
// launch per chunk in place of 2F launches, and CUDA graphs.
//
// Score tiers.  highest=False replaces the bf16 hi/lo split of
// `_shear_score_tiles` (pvot/ops/ncc_mega.py:384-440), which the TPU kernel
// runs on local frames (:676) and in the in-kernel global strips (:633)
// alike, and so does this kernel: score_kernel_tier<..., kPasses> runs the
// correlation on the tensor cores, with warp-level
// mma.sync.m16n8k16.bf16 (tiers.cuh row_mma), corr(hi w, hi t) for 1 pass,
// + corr(hi w, lo t) for 2, + corr(lo w, hi t) for 3.  Per template row a
// warp computes its whole 8 x 16 tile as window rows x the row's Toeplitz
// band; the template rows are staged as hi/lo slots when staged, the window
// rows after their float32 box sums, both in the bytes of the float32 rows
// (one shared-memory plan for every tier: stage_rows and score_smem_bytes do
// not see the tier).  Box sums, the epilogue, the EMA and the stats stay
// float32.  score_kernel, the float32 tier, is the float32 FMA code with
// its launch bounds as before; the two share score_body.
// Bound: the bf16 passes at 989 TFLOP/s, 0.19 / 0.38 / 0.57 us for 1 / 2 /
// 3 passes of a local 720p/80/r60 frame (93.7 M MAC), far below the chain
// of dependent phases that bounds a local frame today; a global frame
// (4.93 G MAC) is where the tensor cores can show.  Accumulation: the
// tensor core's float32 sums are not round-to-nearest, so the fragment
// restarts from 0 for every template row (ceil((tw + 7) / 16) steps a pass)
// and each row's sum joins the thread's float32 sums with one
// round-to-nearest addition; the rows, row shares, halves and chunks add in
// the float32 kernel's fixed order, so a lane's records are K1's on it
// alone at every tier, whoever shares the launch.
//
// Batch cadence (pvot/ops/ncc_mega.py:262-311).  With batch > 1 only frames
// t with t % batch == batch - 1 are scored, and a score and a commit launch
// are made only for them: 2 launches a batch.  The commit also writes the
// look-ahead records of the batch's earlier frames (the state before it,
// score -1, no update), and the state's n_valid field holds n_full =
// (n_valid // batch) * batch, so a cadence frame past it commits nothing and
// records score -1.  When batch does not divide the chunk, one
// lookahead_kernel launch writes the records after the last cadence frame:
// 2 * (F / batch) + (F % batch != 0) launches a chunk.
//
// Numerics.  The epilogue, the u8 conversion and the EMA use explicit
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs that
// the plain PyTorch version (pvot_torch/ops/ncc_mega.py) does not do; only the
// sums themselves run in another order, the same order for every lane count.
// Build without --use_fast_math.
//
// Layout.  The score and commit kernels and their helpers are in
// mega_body.cuh, which the rung ladder (mega_breakdown.cu) shares; this file
// instantiates their production stage (kFull) for K1-K3 and holds the launch
// loop and the C entries.

#include "mega_body.cuh"

namespace {

// The look-ahead records of frames [t0, n_frames) of every lane (a block
// per lane): the chunk's frames after its last scored one.
__global__ void lookahead_kernel(const int32_t* __restrict__ si, float* __restrict__ rows,
                                 int t0, int n_frames) {
  const int s = blockIdx.x;
  for (int t = t0 + static_cast<int>(threadIdx.x); t < n_frames; t += blockDim.x) {
    lookahead_row(rows + (static_cast<size_t>(s) * n_frames + t) * kRecord, si + s * kStateI);
  }
}

template <int kPasses>
ScoreKernel score_kernel_of(bool whole, bool one, bool ext) {
  if constexpr (kPasses == 0) {
    if (one) return whole ? score_kernel<true, true, false> : score_kernel<false, true, false>;
    if (ext) return whole ? score_kernel<true, false, true> : score_kernel<false, false, true>;
    return whole ? score_kernel<true, false, false> : score_kernel<false, false, false>;
  } else {
    if (one) {
      return whole ? score_kernel_tier<true, true, false, kPasses>
                   : score_kernel_tier<false, true, false, kPasses>;
    }
    if (ext) {
      return whole ? score_kernel_tier<true, false, true, kPasses>
                   : score_kernel_tier<false, false, true, kPasses>;
    }
    return whole ? score_kernel_tier<true, false, false, kPasses>
                 : score_kernel_tier<false, false, false, kPasses>;
  }
}

// The score kernel's instantiation for a template staged whole or in
// chunks, for one lane or many, for lanes with extents of their own, and
// for the score tier (0: float32; 1, 2, 3: bf16 passes); null for another
// tier.
ScoreKernel score_kernel_for(bool whole, bool one, bool ext, int passes) {
  switch (passes) {
    case 0: return score_kernel_of<0>(whole, one, ext);
    case 1: return score_kernel_of<1>(whole, one, ext);
    case 2: return score_kernel_of<2>(whole, one, ext);
    case 3: return score_kernel_of<3>(whole, one, ext);
    default: return nullptr;
  }
}

CommitKernel commit_kernel_for(bool ext, bool batch) {
  if (ext) return batch ? commit_kernel<true, true> : commit_kernel<true, false>;
  return batch ? commit_kernel<false, true> : commit_kernel<false, false>;
}

// One chunk of n_frames over n_lanes lanes on `stream`, at the score tier
// `passes` (0: float32) and the cadence `batch`: a score and a commit launch
// for each frame t with t % batch == batch - 1 (every frame at batch 1),
// then, when batch does not divide n_frames, one lookahead_kernel launch for
// the frames after the last of them: 2 * (n_frames / batch) + (n_frames %
// batch != 0) launches.  Frames that are not scored cost no score launch.
// ext: per-lane (th_k, tw_k) inside the th x tw template buffer, or null.
int launch_chunk(const uint8_t* frames, long long frame_stride, int n_lanes, int n_frames,
                 int frame_h, int frame_w, int th, int tw, const int32_t* ext,
                 int32_t* state_i, float* state_f,
                 float* tpl, float* part_val, int32_t* part_yx, int n_blocks,
                 float* split_part, int32_t* split_count, float* rows, int radius_x,
                 int radius_y, int lost_threshold, int enable_global, float min_conf,
                 float global_conf, float strong_conf, float lr, float one_minus_lr,
                 int passes, int batch, cudaStream_t stream) {
  const Params p = make_params(frame_stride, n_lanes, frame_h, frame_w, th, tw, ext, n_blocks,
                               radius_x, radius_y, lost_threshold, enable_global, min_conf,
                               global_conf, strong_conf, lr, one_minus_lr);
  // A one-lane launch runs the kOne instantiation, which has no lane table
  // and takes the launch's extent: an extent table needs two lanes or more.
  const ScoreKernel score =
      score_kernel_for(p.stage_rows == th, n_lanes == 1, ext != nullptr, passes);
  if (p.stage_rows < 1 || p.out_h < 1 || p.out_w < 1 || n_lanes < 1 || n_blocks < 1 ||
      (ext != nullptr && n_lanes < 2) || score == nullptr || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = launch_steps(score, commit_kernel_for(ext != nullptr, batch > 1), p,
                               n_blocks, n_frames, batch, frames, tpl, state_i, state_f,
                               part_val, part_yx, split_part, split_count, rows, stream);
  if (err != 0) return err;
  if (n_frames % batch != 0) {
    lookahead_kernel<<<n_lanes, 32, 0, stream>>>(state_i, rows, n_frames / batch * batch,
                                                 n_frames);
    return static_cast<int>(cudaGetLastError());
  }
  return 0;
}

}  // namespace

extern "C" {

// K1: one stream's chunk at the score tier `passes` (0: float32; 1, 2, 3
// bf16 passes) and the cadence `batch`: 2 * (n_frames / batch) + (n_frames %
// batch != 0) launches on `stream` (2 * n_frames at batch 1), no
// synchronisation.  state_i = [bx, by, bw, bh, lost, use_global, n_valid, _],
// state_f = [t_mean, t_std, sum_tc, _] and tpl (th x round_up4(tw),
// zero-padded columns) are read and updated in place; rows is (n_frames, 10).
// part_val / part_yx hold n_blocks per-block winners; split_part
// (n_blocks / 2 x 2 x 3 x 128 floats) and split_count (n_blocks / 2 ints,
// zero) serve local frames whose tiles two blocks share.  Returns the first
// CUDA error, or 0.
int pvot_mega_track_chunk(const uint8_t* frames, int n_frames, int frame_h, int frame_w,
                          int th, int tw, int32_t* state_i, float* state_f, float* tpl,
                          float* part_val, int32_t* part_yx, int n_blocks,
                          float* split_part, int32_t* split_count, float* rows,
                          int radius_x, int radius_y, int lost_threshold, int enable_global,
                          float min_conf, float global_conf, float strong_conf, float lr,
                          float one_minus_lr, int passes, int batch, void* stream) {
  return launch_chunk(frames, 0, 1, n_frames, frame_h, frame_w, th, tw, nullptr, state_i,
                      state_f, tpl, part_val, part_yx, n_blocks, split_part, split_count, rows,
                      radius_x, radius_y, lost_threshold, enable_global, min_conf,
                      global_conf, strong_conf, lr, one_minus_lr, passes, batch,
                      static_cast<cudaStream_t>(stream));
}

// K2: n_lanes streams' chunks, tier and cadence as K1's and as many launches
// in all.  Lane s reads
// frames + s * frame_stride (n_frames x frame_h x frame_w u8), state_i + 8s,
// state_f + 4s, tpl + s * th * round_up4(tw), and writes rows + 10 * s *
// n_frames.  The n_blocks score blocks share the union of all lanes' tiles.
// The partials hold n_blocks per lane; split_part and split_count n_blocks /
// 2 tiles per lane.
int pvot_mega_track_chunk_multi(const uint8_t* frames, long long frame_stride, int n_lanes,
                                int n_frames, int frame_h, int frame_w, int th, int tw,
                                int32_t* state_i, float* state_f, float* tpl,
                                float* part_val, int32_t* part_yx, int n_blocks,
                                float* split_part, int32_t* split_count, float* rows,
                                int radius_x, int radius_y, int lost_threshold,
                                int enable_global, float min_conf, float global_conf,
                                float strong_conf, float lr, float one_minus_lr, int passes,
                                int batch, void* stream) {
  return launch_chunk(frames, frame_stride, n_lanes, n_frames, frame_h, frame_w, th, tw,
                      nullptr, state_i, state_f, tpl, part_val, part_yx, n_blocks, split_part,
                      split_count, rows, radius_x, radius_y, lost_threshold, enable_global,
                      min_conf, global_conf, strong_conf, lr, one_minus_lr, passes, batch,
                      static_cast<cudaStream_t>(stream));
}

// K3: n_objects trackers over ONE clip (frames: n_frames x frame_h x frame_w
// u8, read by every object), tier, cadence and launches as K1's; replaces
// pvot/ops/ncc_mega.py:1246 (`mega_track_chunk_objects`, :1115).  Object k
// reads and updates state_i + 8k, state_f + 4k and its template at tpl + k *
// th * round_up4(tw), and writes rows + 10 * k * n_frames, as a K2 lane does.
// ext (n_objects x 2 int32 on the device, or null when every template is th
// x tw) gives each object's true extent (th_k, tw_k) inside its zero-padded
// th x tw bucket (the bucketed mode): the object scores its own
// (frame_h - th_k + 1) x (frame_w - tw_k + 1) map, commits a th_k x tw_k box
// and updates only that corner of its template.
//
// What bounds it: FP32 FMA issue, about 93.7 M FMA per 80 x 80 / r60 object
// on a local frame (4.9 G on a global one), against a frame of 0.9 MB read
// once per step.  The design answers with one score launch a step for all
// objects (the union balance, so an object in global search spreads over
// the whole card beside the local ones) and the shared frame, which every
// object's blocks read from L2 after the first.
int pvot_mega_track_chunk_objects(const uint8_t* frames, int n_objects, int n_frames,
                                  int frame_h, int frame_w, int th, int tw, const int32_t* ext,
                                  int32_t* state_i, float* state_f, float* tpl,
                                  float* part_val, int32_t* part_yx, int n_blocks,
                                  float* split_part, int32_t* split_count, float* rows,
                                  int radius_x, int radius_y, int lost_threshold,
                                  int enable_global, float min_conf, float global_conf,
                                  float strong_conf, float lr, float one_minus_lr, int passes,
                                  int batch, void* stream) {
  return launch_chunk(frames, 0, n_objects, n_frames, frame_h, frame_w, th, tw, ext, state_i,
                      state_f, tpl, part_val, part_yx, n_blocks, split_part, split_count, rows,
                      radius_x, radius_y, lost_threshold, enable_global, min_conf,
                      global_conf, strong_conf, lr, one_minus_lr, passes, batch,
                      static_cast<cudaStream_t>(stream));
}

// Template rows a score block stages at once (see stage_rows), for the
// wrapper's envelope check to be held against.
int pvot_mega_stage_rows(int th, int tw, int n_lanes) {
  return stage_rows(th, tw, n_lanes);
}

// Score blocks resident on one SM at the given geometry and tier (for the
// build report), or -1 on a CUDA error.
int pvot_mega_score_blocks_per_sm(int th, int tw, int n_lanes, int passes) {
  const int rows = stage_rows(th, tw, n_lanes);
  if (rows < 1) return -1;
  const int smem = score_smem_bytes(rows, tw, n_lanes);
  const ScoreKernel score = score_kernel_for(rows == th, n_lanes == 1, false, passes);
  int n = 0;
  if (score == nullptr || set_score_smem(score, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, score, kScoreThreads, smem) !=
          cudaSuccess) {
    return -1;
  }
  return n;
}

const char* pvot_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
