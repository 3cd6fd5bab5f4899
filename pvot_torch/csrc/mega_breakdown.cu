// K1's rung ladder on Hopper: the port of tools/mega_breakdown.py
// `build_rung` (:76; its pallas_call at :409), which timed copies of the TPU
// mega kernel with stages switched off at compile time.  Here a rung is K1's
// own two launches a frame (mega_body.cuh's score and commit kernels) cut off
// after one stage, compiled from the production source: the kFull rung is
// K1's code, so the ladder measures the production kernel and needs no copy
// kept in sync by hand.  The stages and the checksums that keep each cut
// rung's work observable are described at the top of mega_body.cuh.
//
// Only the main path's case is instantiated: one lane, the whole template
// staged beside its tile (kWhole), no extent table, batch 1; at float32
// (score_kernel) and at 1, 2 and 3 bf16 passes (score_kernel_tier), so each
// rung runs under its tier's launch bounds.
//
// What bounds it: a rung is a measurement, not a product path.  Its full
// rung is K1, bound at 720p / 80 x 80 / r60 by its correlation's operations
// (0.00280 ms a local frame at the FP32 peak; PERF.md); the differences
// between consecutive rungs attribute a frame's time to the stages.

#include "mega_body.cuh"

namespace {

template <int kPasses, int kStage>
ScoreKernel rung_score() {
  if constexpr (kPasses == 0) {
    return score_kernel<true, true, false, kStage>;
  } else {
    return score_kernel_tier<true, true, false, kPasses, kStage>;
  }
}

template <int kPasses>
ScoreKernel rung_score_of(int rung) {
  switch (rung) {
    case kEmpty: return rung_score<kPasses, kEmpty>();
    case kDma: return rung_score<kPasses, kDma>();
    case kConvert: return rung_score<kPasses, kConvert>();
    case kScoreBox: return rung_score<kPasses, kScoreBox>();
    case kScore: return rung_score<kPasses, kScore>();
    case kArgmax: return rung_score<kPasses, kArgmax>();
    case kFull: return rung_score<kPasses, kFull>();
    default: return nullptr;
  }
}

// The rung's score kernel at the tier `passes` (0: float32), or null.
ScoreKernel rung_score_kernel(int rung, int passes) {
  switch (passes) {
    case 0: return rung_score_of<0>(rung);
    case 1: return rung_score_of<1>(rung);
    case 2: return rung_score_of<2>(rung);
    case 3: return rung_score_of<3>(rung);
    default: return nullptr;
  }
}

// The rung's commit kernel (the tier does not reach it), or null.
CommitKernel rung_commit_kernel(int rung) {
  switch (rung) {
    case kEmpty: return commit_kernel<false, false, kEmpty>;
    case kDma: return commit_kernel<false, false, kDma>;
    case kConvert: return commit_kernel<false, false, kConvert>;
    case kScoreBox: return commit_kernel<false, false, kScoreBox>;
    case kScore: return commit_kernel<false, false, kScore>;
    case kArgmax: return commit_kernel<false, false, kArgmax>;
    case kFull: return commit_kernel<false, false, kFull>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// One stream's chunk through the rung `rung` (0 empty, 1 dma, 2 convert, 3
// score_box, 4 score, 5 argmax, 6 full: mega_body.cuh's stages) at the score
// tier `passes`; the arguments and launches are pvot_mega_track_chunk's (2 *
// n_frames launches on `stream`, no synchronisation), with batch 1 and a
// template that a score block stages whole.  Rung 6 is K1.  A rung before 5
// walks the state (bx + 1, by + (t & 1)) and writes records of zeros with
// its checksum in field 4.  Returns the first CUDA error, or 0.
int pvot_mega_breakdown_chunk(int rung, const uint8_t* frames, int n_frames, int frame_h,
                              int frame_w, int th, int tw, int32_t* state_i, float* state_f,
                              float* tpl, float* part_val, int32_t* part_yx, int n_blocks,
                              float* split_part, int32_t* split_count, float* rows,
                              int radius_x, int radius_y, int lost_threshold,
                              int enable_global, float min_conf, float global_conf,
                              float strong_conf, float lr, float one_minus_lr, int passes,
                              int batch, void* stream) {
  const Params p = make_params(0, 1, frame_h, frame_w, th, tw, nullptr, n_blocks, radius_x,
                               radius_y, lost_threshold, enable_global, min_conf, global_conf,
                               strong_conf, lr, one_minus_lr);
  const ScoreKernel score = rung_score_kernel(rung, passes);
  const CommitKernel commit = rung_commit_kernel(rung);
  if (score == nullptr || commit == nullptr || batch != 1 || p.stage_rows != th ||
      p.out_h < 1 || p.out_w < 1 || n_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_steps(score, commit, p, n_blocks, n_frames, 1, frames, tpl, state_i, state_f,
                      part_val, part_yx, split_part, split_count, rows,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
