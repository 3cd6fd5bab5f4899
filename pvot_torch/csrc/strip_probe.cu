// The global-strip probes on Hopper: the port of tools/global_strip_probe.py
// `_kernel_factory` (:114; strip_body :125, kernel :167, pallas_call :227) and
// `probe_when_refetch` (:268; kernel :275, pallas_call :306).  On the TPU they
// probed the constructs of the mega kernel's in-kernel global search; here
// they compute the same functions, each beside a plain PyTorch version
// (pvot_torch/tools/global_strip_probe.py).  Frames are (n_frames, 256, 512)
// u8, the probes' shape.
//
// strip_best: for frame t, the strips (sy, sx) of a 3 x 2 grid on odd frames
// and strip (0, 0) on even ones.  Strip (sy, sx) scores the 8 x 8 box sums of
// v * float32(1/255) at rows y0 + dy, y0 = 64 sy + (sy & 7), dy < 48, and
// columns 256 sx + dx, dx < 128 (the JAX kernel's aligned 64 x 256 slab after
// its roll by the residual sy & 7), and keeps its first best in row-major
// order.  The strips fold in the lexicographic order (value desc, y asc, x
// asc) of strip_body (:160-165).  The JAX kernel's two variants (pl.when with
// static trip counts, traced trip counts) compute this one function.
//   Design: a block per (strip, frame) stages the 55 x 135 pixels its box sums
//   need, sums each column's 8 rows, then each output's 8 column sums, each
//   sum in a fixed order (the plain version's), and reduces (value, y, x)
//   lexicographically; a second launch, a block per frame, folds the strips'
//   bests in strip order.  No float atomics: the result does not depend on
//   the order the blocks run in.
//   Bound: bytes, 55 x 135 u8 a strip read once, and 48 x 128 x 15 additions
//   a strip; a few microseconds of launch latency hold it on the card.
//
// slab_refetch: for frame t, s0 = the sum of the u8 slab at (0, 0), 64 x 256,
// and s1 = the sum of the slab at (64, 256) when byte (0, 0) is odd, else s0.
// (The TPU probe failed to compile for an incidental reason, an i8 scalar
// extract; in interpret mode it computes this function.)  Integer sums, exact
// in float32 (below 2^24).
//   Design: a block per frame, 16-byte loads, an integer block reduction.
//   Bound: bytes, one or two 16 KB slabs a frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPadH = 256, kPadW = 512;      // the probes' frame shape
constexpr int kSlabH = 64, kSlabW = 256;     // the aligned slab of a strip
constexpr int kNy = 3, kNx = 2;              // the strip grid of an odd frame
constexpr int kDyMax = kSlabH - 16;          // 48 scored rows a strip
constexpr int kTx = 128;                     // scored columns a strip
constexpr int kBox = 8;
constexpr int kInRows = kDyMax + kBox - 1;   // 55
constexpr int kInCols = kTx + kBox - 1;      // 135
constexpr int kThreads = 256;
constexpr int kBig = 1 << 30;
constexpr float kU8Scale = static_cast<float>(1.0 / 255.0);

struct Best {
  float val;
  int y, x;
};

__device__ __forceinline__ bool lex_better(const Best& a, const Best& b) {
  return a.val > b.val || (a.val == b.val && (a.y < b.y || (a.y == b.y && a.x < b.x)));
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

// Block (kThreads) best; thread 0 gets it.
__device__ Best block_best(Best b) {
  __shared__ Best s_best[kThreads / 32];
  b = warp_best(b);
  if ((threadIdx.x & 31) == 0) s_best[threadIdx.x >> 5] = b;
  __syncthreads();
  if (threadIdx.x < 32) {
    b = threadIdx.x < kThreads / 32 ? s_best[threadIdx.x] : Best{-INFINITY, kBig, kBig};
    b = warp_best(b);
  }
  return b;
}

__device__ __forceinline__ int strips_of(int t) { return (t & 1) ? kNy * kNx : 1; }

__global__ void __launch_bounds__(kThreads)
strip_best_kernel(const uint8_t* __restrict__ frames, float* __restrict__ part_val,
                  int32_t* __restrict__ part_yx) {
  __shared__ float s_col[kDyMax][kInCols + 1];  // each column's 8-row sums
  const int s = blockIdx.x, t = blockIdx.y;
  if (s >= strips_of(t)) return;  // uniform per block: an even frame has one strip
  const int sy = s / kNx, sx = s % kNx;
  const int y0 = sy * kSlabH + (sy & 7), x0 = sx * kSlabW;
  const uint8_t* frame = frames + static_cast<size_t>(t) * kPadH * kPadW;
  // Column j's 55 pixels, converted, then its 48 sums of 8 rows in order.
  for (int j = threadIdx.x; j < kInCols; j += kThreads) {
    float v[kInRows];
#pragma unroll
    for (int r = 0; r < kInRows; ++r) {
      v[r] = __fmul_rn(static_cast<float>(frame[(y0 + r) * kPadW + x0 + j]), kU8Scale);
    }
#pragma unroll
    for (int dy = 0; dy < kDyMax; ++dy) {
      float a = v[dy];
#pragma unroll
      for (int p = 1; p < kBox; ++p) a = __fadd_rn(a, v[dy + p]);
      s_col[dy][j] = a;
    }
  }
  __syncthreads();
  // Each output's 8 column sums in order; the first best in row-major order.
  Best best{-INFINITY, kBig, kBig};
  for (int o = threadIdx.x; o < kDyMax * kTx; o += kThreads) {
    const int dy = o / kTx, dx = o % kTx;
    float a = s_col[dy][dx];
#pragma unroll
    for (int q = 1; q < kBox; ++q) a = __fadd_rn(a, s_col[dy][dx + q]);
    const Best c{a, y0 + dy, x0 + dx};
    if (lex_better(c, best)) best = c;
  }
  best = block_best(best);
  if (threadIdx.x == 0) {
    const int slot = t * kNy * kNx + s;
    part_val[slot] = best.val;
    part_yx[2 * slot] = best.y;
    part_yx[2 * slot + 1] = best.x;
  }
}

// Frame t's strips folded in strip order: out[t] = (value, y, x).
__global__ void strip_fold_kernel(const float* __restrict__ part_val,
                                  const int32_t* __restrict__ part_yx, float* __restrict__ out) {
  const int t = blockIdx.x;
  if (threadIdx.x != 0) return;
  Best best{-INFINITY, kBig, kBig};
  for (int s = 0; s < strips_of(t); ++s) {
    const int slot = t * kNy * kNx + s;
    const Best c{part_val[slot], part_yx[2 * slot], part_yx[2 * slot + 1]};
    if (lex_better(c, best)) best = c;
  }
  out[3 * t] = best.val;
  out[3 * t + 1] = static_cast<float>(best.y);
  out[3 * t + 2] = static_cast<float>(best.x);
}

// The sum of the slab at (ya, xa) of `frame`, on every thread of the block.
__device__ int slab_sum(const uint8_t* frame, int ya, int xa, int* scratch) {
  int v = 0;
  for (int i = threadIdx.x; i < kSlabH * kSlabW / 16; i += kThreads) {
    const int r = i / (kSlabW / 16), c = (i % (kSlabW / 16)) * 16;
    const uint4 q = *reinterpret_cast<const uint4*>(frame + (ya + r) * kPadW + xa + c);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v += static_cast<int>((w[k] & 0xff) + ((w[k] >> 8) & 0xff) + ((w[k] >> 16) & 0xff) +
                            (w[k] >> 24));
    }
  }
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();  // scratch may still be read from an earlier call
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
  for (int w = 0; w < kThreads / 32; ++w) v += scratch[w];
  return v;
}

__global__ void __launch_bounds__(kThreads)
slab_refetch_kernel(const uint8_t* __restrict__ frames, float* __restrict__ out) {
  __shared__ int s_sum[kThreads / 32];
  const int t = blockIdx.x;
  const uint8_t* frame = frames + static_cast<size_t>(t) * kPadH * kPadW;
  const int s0 = slab_sum(frame, 0, 0, s_sum);
  const bool cond = (frame[0] & 1) != 0;  // uniform per block
  const int s1 = cond ? slab_sum(frame, kSlabH, kSlabW, s_sum) : s0;
  if (threadIdx.x == 0) {
    out[2 * t] = static_cast<float>(s0);
    out[2 * t + 1] = static_cast<float>(s1);
  }
}

}  // namespace

extern "C" {

// strip_best over frames (n_frames x 256 x 512 u8) on `stream`: two launches,
// no synchronisation.  part_val (n_frames x 6 floats) and part_yx (n_frames x
// 12 ints) are scratch; out is n_frames x 3 floats (value, y, x).  Returns
// the first CUDA error, or 0.
int pvot_strip_best(const uint8_t* frames, int n_frames, float* part_val, int32_t* part_yx,
                    float* out, void* stream) {
  if (n_frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  strip_best_kernel<<<dim3(kNy * kNx, n_frames), kThreads, 0, st>>>(frames, part_val, part_yx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  strip_fold_kernel<<<n_frames, 32, 0, st>>>(part_val, part_yx, out);
  return static_cast<int>(cudaGetLastError());
}

// slab_refetch over frames (n_frames x 256 x 512 u8) on `stream`: one
// launch; out is n_frames x 2 floats (s0, s1).  Returns the CUDA error, or 0.
int pvot_slab_refetch(const uint8_t* frames, int n_frames, float* out, void* stream) {
  if (n_frames < 1) return static_cast<int>(cudaErrorInvalidValue);
  slab_refetch_kernel<<<n_frames, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(frames,
                                                                                    out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
