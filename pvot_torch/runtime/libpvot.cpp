// pvot native runtime: host-side data-loader kernels.
//
// TPU-native equivalent of the reference's host-side C++ preprocessing
// (to_gray in tracker_ghc/include/utils.hpp:4-13 — OpenCV's cvtColor +
// convertTo on the decode thread).  The TPU pipeline ships uint8 gray frames
// to the device, so the host hot path is BGR->gray conversion and frame-ring
// management; both live here as a small C library driven from Python via
// ctypes (no pybind11 in this image).
//
// Conversion math matches OpenCV's fixed-point BGR2GRAY exactly
// (15-fraction-bit coefficients; verified bit-exact in tests against cv2),
// so the native path is interchangeable with the cv2/numpy paths.

#include <atomic>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr uint32_t kRCoef = 9798;   // 0.299 * 2^15
constexpr uint32_t kGCoef = 19235;  // 0.587 * 2^15
constexpr uint32_t kBCoef = 3735;   // 0.114 * 2^15
constexpr uint32_t kShift = 15;
constexpr uint32_t kRound = 1u << (kShift - 1);

inline void gray_row(const uint8_t* bgr, uint8_t* gray, int64_t w) {
  for (int64_t x = 0; x < w; ++x) {
    const uint32_t b = bgr[3 * x + 0];
    const uint32_t g = bgr[3 * x + 1];
    const uint32_t r = bgr[3 * x + 2];
    gray[x] = static_cast<uint8_t>(
        (b * kBCoef + g * kGCoef + r * kRCoef + kRound) >> kShift);
  }
}

}  // namespace

extern "C" {

// BGR uint8 (h, w, 3) -> gray uint8 (h, w).  OpenMP over rows.
void pvot_bgr_to_gray_u8(const uint8_t* bgr, uint8_t* gray, int64_t h,
                         int64_t w) {
#pragma omp parallel for schedule(static)
  for (int64_t y = 0; y < h; ++y) {
    gray_row(bgr + y * w * 3, gray + y * w, w);
  }
}

// Batch variant: frames (n, h, w, 3) -> (n, h, w).  Parallel over rows of
// the whole batch so small batches still use every core.
void pvot_bgr_to_gray_u8_batch(const uint8_t* bgr, uint8_t* gray, int64_t n,
                               int64_t h, int64_t w) {
  const int64_t rows = n * h;
#pragma omp parallel for schedule(static)
  for (int64_t y = 0; y < rows; ++y) {
    gray_row(bgr + y * w * 3, gray + y * w, w);
  }
}

// uint8 gray -> float32 in [0, 1] (reference convertTo(CV_32F, 1/255):
// the scale is applied in double then rounded once to float, reproduced via
// a 256-entry lookup computed in double).
void pvot_gray_u8_to_f32(const uint8_t* gray, float* out, int64_t n) {
  float lut[256];
  for (int i = 0; i < 256; ++i) {
    lut[i] = static_cast<float>(static_cast<double>(i) * (1.0 / 255.0));
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    out[i] = lut[gray[i]];
  }
}

// ---------------------------------------------------------------------------
// Host NCC engine: the native analog of the reference's CPU op
// (tracker/src/ncc_cpu.cpp + the kernel math in
// tracker_ghc/src/baseline_kernel.cu:17-46).  Valid-mode NCC map with the
// reference's exact epsilon structure:
//
//   mu_f, var from window sums; sigma_f = sqrt(max(var, 1e-6))
//   cov = sum f * t_c  -  mu_f * sum(t_c)        (t_c = t - mu_t)
//   ncc = cov / ((sigma_f + 1e-6) * (t_std_in + 1e-6) * N)
//
// t_mean / t_std_in arrive host-computed in double precision (the wrapper's
// cv::meanStdDev + 1e-6, baseline_kernel.cu:263-266).  Window sum /
// sum-of-squares use O(1)-per-output integral images (double); the
// covariance dot is the O(N) inner loop, OpenMP over output rows and
// auto-vectorized along x.  This makes pvot usable with no accelerator at
// all (pvot.models.host drives it with the full C5-C8 tracking semantics).
// ---------------------------------------------------------------------------

void pvot_ncc_match_f32(const float* frame, int64_t fh, int64_t fw,
                        const float* templ, int64_t th, int64_t tw,
                        float t_mean, float t_std_in, float* out) {
  const int64_t oh = fh - th + 1;
  const int64_t ow = fw - tw + 1;
  if (oh <= 0 || ow <= 0) return;
  const double n = static_cast<double>(th * tw);

  // Centered template + its residual sum (nonzero in f32, kept for parity).
  float* t_c = new float[th * tw];
  double sum_tc = 0.0;
  for (int64_t i = 0; i < th * tw; ++i) {
    t_c[i] = templ[i] - t_mean;
    sum_tc += t_c[i];
  }

  // Integral images of frame and frame^2, (fh+1) x (fw+1), double.
  const int64_t sw = fw + 1;
  double* sat = new double[(fh + 1) * sw];
  double* satsq = new double[(fh + 1) * sw];
  for (int64_t x = 0; x <= fw; ++x) {
    sat[x] = 0.0;
    satsq[x] = 0.0;
  }
  for (int64_t y = 0; y < fh; ++y) {
    double row = 0.0, rowsq = 0.0;
    double* s = sat + (y + 1) * sw;
    double* ss = satsq + (y + 1) * sw;
    const double* ps = sat + y * sw;
    const double* pss = satsq + y * sw;
    s[0] = 0.0;
    ss[0] = 0.0;
    const float* f = frame + y * fw;
    for (int64_t x = 0; x < fw; ++x) {
      const double v = f[x];
      row += v;
      rowsq += v * v;
      s[x + 1] = ps[x + 1] + row;
      ss[x + 1] = pss[x + 1] + rowsq;
    }
  }

#pragma omp parallel for schedule(static)
  for (int64_t oy = 0; oy < oh; ++oy) {
    const double* s0 = sat + oy * sw;
    const double* s1 = sat + (oy + th) * sw;
    const double* q0 = satsq + oy * sw;
    const double* q1 = satsq + (oy + th) * sw;
    float* orow = out + oy * ow;
    for (int64_t ox = 0; ox < ow; ++ox) {
      const double sum = s1[ox + tw] - s1[ox] - s0[ox + tw] + s0[ox];
      const double ssq = q1[ox + tw] - q1[ox] - q0[ox + tw] + q0[ox];
      const double mu = sum / n;
      double var = ssq / n - mu * mu;
      if (var < 1e-6) var = 1e-6;
      const double sigma = __builtin_sqrt(var);
      double dot = 0.0;
      for (int64_t r = 0; r < th; ++r) {
        const float* fr = frame + (oy + r) * fw + ox;
        const float* tr = t_c + r * tw;
        // Row dots accumulate in float under an omp-simd reduction (the
        // reduction clause licenses the reordering SIMD needs); rows then
        // sum in double.  Error stays under the f32-oracle comparison
        // noise (pinned at 1e-5 in tests) and the inner loop vectorizes.
        float acc = 0.0f;
#pragma omp simd reduction(+ : acc)
        for (int64_t c = 0; c < tw; ++c) {
          acc += fr[c] * tr[c];
        }
        dot += static_cast<double>(acc);
      }
      const double cov = dot - mu * sum_tc;
      // Double-epsilon denominator: t_std_in already holds one host-side
      // +1e-6 (template_stats), the kernel adds another — the reference's
      // exact structure (baseline_kernel.cu:44-46).
      orow[ox] = static_cast<float>(
          cov / ((sigma + 1e-6) * (static_cast<double>(t_std_in) + 1e-6) * n));
    }
  }

  delete[] t_c;
  delete[] sat;
  delete[] satsq;
}

// ---------------------------------------------------------------------------
// Frame ring buffer: fixed-capacity single-producer/single-consumer queue of
// equally-sized gray frames.  The decode thread pushes, the device-feed
// thread pops chunk-sized views — the native analog of the reference's
// implicit "decode then copy" loop, but with decode/compute overlap.
// ---------------------------------------------------------------------------

struct PvotRing {
  uint8_t* data;
  int64_t capacity;    // number of frame slots
  int64_t frame_bytes;
  std::atomic<int64_t> head;  // next slot to write
  std::atomic<int64_t> tail;  // next slot to read
};

void* pvot_ring_create(int64_t capacity, int64_t frame_bytes) {
  PvotRing* ring = new PvotRing();
  ring->data = new uint8_t[capacity * frame_bytes];
  ring->capacity = capacity;
  ring->frame_bytes = frame_bytes;
  ring->head.store(0);
  ring->tail.store(0);
  return ring;
}

void pvot_ring_destroy(void* handle) {
  PvotRing* ring = static_cast<PvotRing*>(handle);
  delete[] ring->data;
  delete ring;
}

int64_t pvot_ring_size(void* handle) {
  PvotRing* ring = static_cast<PvotRing*>(handle);
  return ring->head.load() - ring->tail.load();
}

// Push one frame; returns 1 on success, 0 if the ring is full.
int32_t pvot_ring_push(void* handle, const uint8_t* frame) {
  PvotRing* ring = static_cast<PvotRing*>(handle);
  const int64_t head = ring->head.load(std::memory_order_relaxed);
  if (head - ring->tail.load(std::memory_order_acquire) >= ring->capacity) {
    return 0;
  }
  std::memcpy(ring->data + (head % ring->capacity) * ring->frame_bytes, frame,
              ring->frame_bytes);
  ring->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Pop up to `max_frames` into `out` (contiguous); returns the count popped.
int64_t pvot_ring_pop(void* handle, uint8_t* out, int64_t max_frames) {
  PvotRing* ring = static_cast<PvotRing*>(handle);
  const int64_t tail = ring->tail.load(std::memory_order_relaxed);
  const int64_t avail = ring->head.load(std::memory_order_acquire) - tail;
  const int64_t n = avail < max_frames ? avail : max_frames;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(out + i * ring->frame_bytes,
                ring->data + ((tail + i) % ring->capacity) * ring->frame_bytes,
                ring->frame_bytes);
  }
  ring->tail.store(tail + n, std::memory_order_release);
  return n;
}

}  // extern "C"
