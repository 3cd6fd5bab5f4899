// The aligned-window NCC of tools/pallas_probe.py `probe_new_ncc_mini`
// (:478, pallas_call :560) on Hopper: the one function of T5's catalogue
// that the T4 kernels (argmax_probe.cu) do not already compute.  It consumes
// the probe's own operands: the zero-padded image, the Toeplitz operator
// toep (n_k L x 8 tx: toep[k L + l, p tx + dx] = tc[8 k + p, l - dx] for the
// centered template tc), the box matrix (L x tx), and the scalars (t_mean,
// t_std, sum tc, n).  Output tile (i, j), 8 x tx at rows 8 i and columns tx
// j, with w_k the 16 x L window at rows 8 (i + k) and columns tx j:
//
//   acc[r, dx]  = sum_k sum_p sum_l w_k[p + r, l] toep[k L + l, p tx + dx]
//   bsum[r, l]  = sum_k sum_p w_k[p + r, l]      (bsq: of the squares)
//   wsum, wssq  = bsum box, bsq box
//   mean = wsum / n, var = wssq / n - mean^2, std = sqrt(max(var, 1e-6))
//   out = (acc - mean sum_tc) / ((std + 1e-6) (t_std + 1e-6) n)
//
// in float32 (the probe's HIGHEST dots; pvot_torch/csrc/probe_gemm.cuh
// blocked_dot), the sums in the probe's order (k outer, p inner).
//   Design: a block per 8 x 32 outputs (a thread each) stages the 8 n_k + 8
//   image rows its windows cover and the tile's box partial sums in shared
//   memory and reads toep and box from device memory, its 32 lanes on
//   neighbouring columns.
//   Bound: operations, 2 n_k 8 L + 2 L FMAs an output at the FP32 peak
//   (about 0.2 us for the probe's 56 x 256 outputs), far below one launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "probe_gemm.cuh"

namespace {

using pvot_probe::blocked_dot;

constexpr int kRows = 8;   // output rows a tile
constexpr int kCols = 32;  // output columns a block
constexpr int kThreads = kRows * kCols;

__global__ void __launch_bounds__(kThreads)
toeplitz_ncc_kernel(const float* __restrict__ img, int img_rows, int img_w,
                    const float* __restrict__ toep, int n_k, int L, int tx,
                    const float* __restrict__ box, const float* __restrict__ scal,
                    float* __restrict__ out, int out_w) {
  extern __shared__ float s_mem[];
  const int rows_in = 8 * n_k + 8;
  float* s_img = s_mem;                // rows_in x L
  float* s_bsum = s_img + rows_in * L; // kRows x L
  float* s_bsq = s_bsum + kRows * L;   // kRows x L
  const int quarters = tx / kCols;
  const int j = blockIdx.x / quarters, dx0 = blockIdx.x % quarters * kCols;
  const int y0 = kRows * blockIdx.y, x0 = tx * j;
  for (int e = threadIdx.x; e < rows_in * L; e += kThreads) {
    const int y = y0 + e / L, x = x0 + e % L;
    s_img[e] = y < img_rows && x < img_w ? img[static_cast<long long>(y) * img_w + x] : 0.0f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * L; e += kThreads) {
    const int r = e / L, l = e % L;
    float s = 0.0f, q = 0.0f;
    for (int k = 0; k < n_k; ++k) {
      for (int p = 0; p < 8; ++p) {
        const float v = s_img[(8 * k + p + r) * L + l];
        s = __fadd_rn(s, v);
        q = __fadd_rn(q, __fmul_rn(v, v));
      }
    }
    s_bsum[e] = s;
    s_bsq[e] = q;
  }
  __syncthreads();
  const int r = threadIdx.x / kCols, dx = dx0 + threadIdx.x % kCols;
  const int ld_toep = 8 * tx;
  float acc = 0.0f;
  for (int k = 0; k < n_k; ++k) {
    for (int p = 0; p < 8; ++p) {
      const float* w_row = s_img + (8 * k + p + r) * L;
      const float* t_col = toep + static_cast<long long>(k) * L * ld_toep + p * tx + dx;
      acc = __fadd_rn(acc, blocked_dot(
                               L, [&](int l) { return w_row[l]; },
                               [&](int l) { return t_col[static_cast<long long>(l) * ld_toep]; }));
    }
  }
  const float* b_col = box + dx;
  const float wsum = blocked_dot(
      L, [&](int l) { return s_bsum[r * L + l]; }, [&](int l) { return b_col[l * tx]; });
  const float wssq = blocked_dot(
      L, [&](int l) { return s_bsq[r * L + l]; }, [&](int l) { return b_col[l * tx]; });
  const float t_std = scal[1], sum_tc = scal[2], n = scal[3];
  const float mean = __fdiv_rn(wsum, n);
  const float var = __fsub_rn(__fdiv_rn(wssq, n), __fmul_rn(mean, mean));
  const float sd = __fsqrt_rn(fmaxf(var, 1e-6f));
  const float cov = __fsub_rn(acc, __fmul_rn(mean, sum_tc));
  const float den = __fmul_rn(__fmul_rn(__fadd_rn(sd, 1e-6f), __fadd_rn(t_std, 1e-6f)), n);
  out[static_cast<long long>(y0 + r) * out_w + x0 + dx] = __fdiv_rn(cov, den);
}

}  // namespace

extern "C" {

// img (img_rows x img_w f32), toep (n_k L x 8 tx f32), box (L x tx f32),
// scal (4 f32: t_mean, t_std, sum tc, n) in device memory; out (8 gh x tx
// gw f32).  One launch on `stream`; returns the CUDA error, or 0.
int pvot_probe_toeplitz_ncc(const float* img, int img_rows, int img_w, const float* toep,
                            int n_k, int L, int tx, const float* box, const float* scal,
                            float* out, int gh, int gw, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(8 * n_k + 8 + 2 * kRows) * L;
  if (n_k < 1 || L < 1 || tx < kCols || tx % kCols || gh < 1 || gw < 1 || smem > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  toeplitz_ncc_kernel<<<dim3(gw * (tx / kCols), gh), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(img, img_rows, img_w, toep, n_k, L,
                                                             tx, box, scal, out, gw * tx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
