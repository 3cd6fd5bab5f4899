// K2's chunk kernels with the step clock compiled in (mega_body.cuh
// chunk_kernel_clocked), one a plan and score tier of the many-lane kernels,
// in a source of their own so that they build beside ncc_mega.cu's kernels
// and not after them.  ncc_mega.cu's multi-stream entry launches one where
// its caller passes the clock's slots.

#include "mega_body.cuh"

namespace {

template <int kPasses>
ChunkKernel clocked_of(bool whole) {
  return whole ? chunk_kernel_clocked<true, false, kPasses>
               : chunk_kernel_clocked<false, false, kPasses>;
}

}  // namespace

// The clocked twin of K2's many-lane kernel for `plan` (plan_of) and the
// score tier `passes` (0: float32; 1, 2, 3: bf16 passes), or null for another
// tier.  An untyped pointer: each source's kernel types live in its own
// anonymous namespace.
extern "C" void* pvot_mega_clocked_kernel(int plan, int passes) {
  ChunkKernel kernel = nullptr;
  if (plan == kPlanResident) {
    kernel = chunk_kernel_clocked<false, true, 0>;
  } else {
    const bool whole = plan == kPlanWhole;
    switch (passes) {
      case 0: kernel = clocked_of<0>(whole); break;
      case 1: kernel = clocked_of<1>(whole); break;
      case 2: kernel = clocked_of<2>(whole); break;
      case 3: kernel = clocked_of<3>(whole); break;
      default: break;
    }
  }
  return reinterpret_cast<void*>(kernel);
}
