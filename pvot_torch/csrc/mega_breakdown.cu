// K1's rung ladder on Hopper: the port of tools/mega_breakdown.py
// `build_rung` (:76; its pallas_call at :409), which timed copies of the TPU
// mega kernel with stages switched off at compile time.  Here a rung is K1's
// own persistent launch (mega_body.cuh's chunk kernel) cut off after one
// stage, compiled from the production source: the kFull rung is K1's code,
// so the ladder measures the production kernel and needs no copy kept in
// sync by hand.  The stages and the checksums that keep each cut rung's work
// observable are described at the top of mega_body.cuh.
//
// Two cases are instantiated, one lane, no extent table, batch 1 each: the
// main path's, the whole template staged beside its tile (kWhole), at
// float32 (chunk_kernel) and at 1, 2 and 3 bf16 passes (chunk_kernel_tier),
// so each rung runs under its tier's launch bounds; and the float32
// row-chunk case in the resident plan (chunk_kernel_resident: a template
// too large to stage whole, as 160 x 160 at 1080p; mega_body.cuh plan_of).
//
// What bounds it: a rung is a measurement, not a product path.  Its full
// rung is K1, bound at 720p / 80 x 80 / r60 by its correlation's operations
// (0.00280 ms a local frame at the FP32 peak; PERF.md); the differences
// between consecutive rungs attribute a frame's time to the stages, and the
// `empty` rung is the floor of the steps' table, fold and grid barrier.

#include "mega_body.cuh"

namespace {

template <int kPasses, int kStage>
ChunkKernel rung_kernel() {
  if constexpr (kPasses == 0) {
    return chunk_kernel<true, false, kStage>;
  } else {
    return chunk_kernel_tier<true, true, false, kPasses, kStage>;
  }
}

template <int kPasses>
ChunkKernel rung_kernel_of(int rung) {
  switch (rung) {
    case kEmpty: return rung_kernel<kPasses, kEmpty>();
    case kDma: return rung_kernel<kPasses, kDma>();
    case kConvert: return rung_kernel<kPasses, kConvert>();
    case kScoreBox: return rung_kernel<kPasses, kScoreBox>();
    case kScore: return rung_kernel<kPasses, kScore>();
    case kArgmax: return rung_kernel<kPasses, kArgmax>();
    case kFull: return rung_kernel<kPasses, kFull>();
    default: return nullptr;
  }
}

// K1's float32 row-chunk case (a template too large to stage whole) in the
// resident plan, cut after a stage; the kFull rung is the production kernel.
ChunkKernel rows_rung_for(int rung) {
  switch (rung) {
    case kEmpty: return chunk_kernel_resident<true, false, kEmpty>;
    case kDma: return chunk_kernel_resident<true, false, kDma>;
    case kConvert: return chunk_kernel_resident<true, false, kConvert>;
    case kScoreBox: return chunk_kernel_resident<true, false, kScoreBox>;
    case kScore: return chunk_kernel_resident<true, false, kScore>;
    case kArgmax: return chunk_kernel_resident<true, false, kArgmax>;
    case kFull: return chunk_kernel_resident<true, false>;
    default: return nullptr;
  }
}

// The rung's kernel at the tier `passes` (0: float32), or null.
ChunkKernel rung_kernel_for(int rung, int passes) {
  switch (passes) {
    case 0: return rung_kernel_of<0>(rung);
    case 1: return rung_kernel_of<1>(rung);
    case 2: return rung_kernel_of<2>(rung);
    case 3: return rung_kernel_of<3>(rung);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// One stream's chunk through the rung `rung` (0 empty, 1 dma, 2 convert, 3
// score_box, 4 score, 5 argmax, 6 full: mega_body.cuh's stages) at the score
// tier `passes`; the arguments and the launch are pvot_mega_track_chunk's
// (one cooperative launch on `stream`, no synchronisation), with batch 1.  A
// template that a block stages whole runs the main-path case at any tier;
// a larger one the row-chunk case, float32 and in the resident plan only.
// Rung 6 is K1.  A rung before 5 walks the state (bx + 1, by + (t & 1)) and
// writes records of zeros with its checksum in field 4.  Returns the first
// CUDA error, or 0.
int pvot_mega_breakdown_chunk(int rung, const uint8_t* frames, int n_frames, int frame_h,
                              int frame_w, int th, int tw, int32_t* state_i, float* state_f,
                              float* tpl, int32_t* state_i2, float* state_f2, float* tpl2,
                              void* work, int n_blocks, float* rows, int radius_x,
                              int radius_y, int lost_threshold, int enable_global,
                              float min_conf, float global_conf, float strong_conf, float lr,
                              float one_minus_lr, int passes, int batch, void* stream) {
  const Params p = make_params(0, 1, n_frames, batch, frame_h, frame_w, th, tw, nullptr,
                               n_blocks, radius_x, radius_y, lost_threshold, enable_global,
                               min_conf, global_conf, strong_conf, lr, one_minus_lr);
  const int plan = plan_of(th, tw, 1, passes);
  const ChunkKernel kernel = plan == kPlanWhole      ? rung_kernel_for(rung, passes)
                             : plan == kPlanResident ? rows_rung_for(rung)
                                                     : nullptr;
  if (kernel == nullptr || batch != 1 || p.out_h < 1 || p.out_w < 1 || n_blocks < 1 ||
      n_frames < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_chunk_kernel(kernel, p, plan_smem_bytes(plan, th, tw, 1), n_blocks, frames,
                             state_i, state_f, tpl, state_i2, state_f2, tpl2, work, rows,
                             static_cast<cudaStream_t>(stream));
}

// Blocks of the rung's kernel resident on one SM of the current device at a
// th x tw template and the tier `passes`, or -1: its grid is at most this
// times the SMs.
int pvot_mega_breakdown_blocks_per_sm(int rung, int th, int tw, int passes) {
  const int plan = plan_of(th, tw, 1, passes);
  const ChunkKernel kernel = plan == kPlanWhole      ? rung_kernel_for(rung, passes)
                             : plan == kPlanResident ? rows_rung_for(rung)
                                                     : nullptr;
  return kernel == nullptr ? -1 : blocks_per_sm(kernel, plan_smem_bytes(plan, th, tw, 1));
}

}  // extern "C"
