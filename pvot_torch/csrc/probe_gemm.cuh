// Float32 dot products for the Mosaic probe catalogues' kernels
// (argmax_probe.cu, pallas_probe.cu): the counterpart of a probe's
// `lax.dot_general(..., precision=HIGHEST)` on the TPU, which is a float32
// product.  A dot of n terms runs as float32 FMAs in chunks of kChunk terms,
// each chunk's sum joining the total with one round-to-nearest addition, so
// the rounding error grows with n / kChunk + kChunk rather than with n, and
// a kernel stays within 1e-6 (relative) of the exact product that its plain
// version rounds once (pvot_torch/tools/fused_argmax_probe.py).

#pragma once

#include <cuda_runtime.h>

namespace pvot_probe {

constexpr int kChunk = 16;

// sum_{i < n} a(i) * b(i) in float32, chunk by chunk.
template <typename A, typename B>
__device__ __forceinline__ float blocked_dot(int n, A a, B b) {
  float total = 0.0f;
  for (int i0 = 0; i0 < n; i0 += kChunk) {
    const int i1 = min(n, i0 + kChunk);
    float part = 0.0f;
    for (int i = i0; i < i1; ++i) part = fmaf(a(i), b(i), part);
    total = __fadd_rn(total, part);
  }
  return total;
}

// v mod m in [0, m) for m > 0, as np.roll and jnp.roll take it.
__device__ __forceinline__ int pmod(int v, int m) {
  const int r = v % m;
  return r < 0 ? r + m : r;
}

}  // namespace pvot_probe
