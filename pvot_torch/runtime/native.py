"""ctypes bindings for the native host runtime (libpvot.so): a copy of
pvot/runtime/native.py.

Copied, not imported (importing `pvot` imports JAX).  The C++ source is
pvot/runtime/libpvot.cpp, byte for byte; the library builds with make/g++ on
first use into build/pvot_torch/ at the root of the checkout, not into the
source tree.  Every entry point has a pure-numpy fallback, so the port works
without a toolchain; `build_info()` says which build, if any, loaded.
tests/test_torch_serving.py and tests/test_torch_host.py hold the copies
equal to the originals.

The build.  `make` first builds libpvot.so with the Makefile's flags
(-fopenmp).  A compiler without OpenMP's runtime (no libgomp.spec) refuses
those; make then runs once more, with -fopenmp-simd in place of -fopenmp,
into libpvot_simd.so: libpvot.cpp calls no omp_ function, so its `omp
parallel for` loops run on one thread there and its `omp simd` loops stay
vectorised.  That build searches simd_include/ (an empty omp.h) after the
system's headers, for a compiler that has no omp.h either.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "pvot_torch")
_SO = os.path.join(_OUT, "libpvot.so")
# The retry's flags: the Makefile's, with -fopenmp-simd for -fopenmp.
SIMD_CXXFLAGS = ("-O3 -march=native -fPIC -fopenmp-simd -std=c++17 -Wall -idirafter "
                 + os.path.join(_DIR, "simd_include"))
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_openmp: Optional[str] = None


def _make(out: str, *overrides: str) -> None:
    subprocess.run(["make", "-s", "-C", _DIR, f"OUT={out}", *overrides], check=True,
                   capture_output=True, timeout=120)


def _build(out: str = _OUT) -> Tuple[Optional[str], Optional[str]]:
    """Run make into `out` (the Makefile's flags, then once more with
    SIMD_CXXFLAGS into libpvot_simd.so if that fails); (path of the
    library, "fopenmp" or "fopenmp-simd"), or (None, None) when neither
    build ran and no library of either kind is there.  make is a timestamp
    no-op when a library is fresh and a rebuild when libpvot.cpp changed (a
    stale binary must never shadow source changes); a library already built
    still loads when the toolchain is missing."""
    so, simd_so = os.path.join(out, "libpvot.so"), os.path.join(out, "libpvot_simd.so")
    try:
        _make(out)
        return so, "fopenmp"
    except (OSError, subprocess.SubprocessError):
        pass
    try:
        _make(out, f"TARGET={simd_so}", f"CXXFLAGS={SIMD_CXXFLAGS}")
        return simd_so, "fopenmp-simd"
    except (OSError, subprocess.SubprocessError):
        pass
    for path, kind in ((so, "fopenmp"), (simd_so, "fopenmp-simd")):
        if os.path.exists(path):
            return path, kind
    return None, None


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed, _openmp
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path, kind = _build()
        try:
            lib = ctypes.CDLL(path) if path else None
        except OSError:
            lib = None
        if lib is None:
            _build_failed = True
            return None
        _openmp = kind
        lib.pvot_bgr_to_gray_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.pvot_bgr_to_gray_u8_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.pvot_gray_u8_to_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.pvot_ncc_match_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
        ]
        lib.pvot_ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.pvot_ring_create.restype = ctypes.c_void_p
        lib.pvot_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.pvot_ring_size.argtypes = [ctypes.c_void_p]
        lib.pvot_ring_size.restype = ctypes.c_int64
        lib.pvot_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.pvot_ring_push.restype = ctypes.c_int32
        lib.pvot_ring_pop.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.pvot_ring_pop.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def build_info() -> dict:
    """{"built": whether the library loaded, "openmp": "fopenmp" or
    "fopenmp-simd" (the build that loaded), or None}."""
    built = available()
    return {"built": built, "openmp": _openmp if built else None}


def bgr_to_gray_u8(bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) or (N, H, W, 3) uint8 BGR -> uint8 gray; native when built,
    else the numpy fixed-point fallback from pvot_torch.io.gray."""
    lib = load()
    bgr = np.ascontiguousarray(bgr, np.uint8)
    if lib is None:
        from pvot_torch.io import gray as gray_mod

        if bgr.ndim == 3:
            return gray_mod.bgr_to_gray_u8(bgr)
        return np.stack([gray_mod.bgr_to_gray_u8(f) for f in bgr])
    if bgr.ndim == 3:
        h, w, _ = bgr.shape
        out = np.empty((h, w), np.uint8)
        lib.pvot_bgr_to_gray_u8(
            bgr.ctypes.data, out.ctypes.data, h, w
        )
        return out
    n, h, w, _ = bgr.shape
    out = np.empty((n, h, w), np.uint8)
    lib.pvot_bgr_to_gray_u8_batch(bgr.ctypes.data, out.ctypes.data, n, h, w)
    return out


def gray_u8_to_f32(gray: np.ndarray) -> np.ndarray:
    lib = load()
    gray = np.ascontiguousarray(gray, np.uint8)
    if lib is None:
        from pvot_torch.io.gray import gray_u8_to_f32 as fallback

        return fallback(gray)
    out = np.empty(gray.shape, np.float32)
    lib.pvot_gray_u8_to_f32(gray.ctypes.data, out.ctypes.data, gray.size)
    return out


def template_stats_host(templ: np.ndarray):
    """(mean, population std + 1e-6) in double — the reference host wrapper's
    cv::meanStdDev semantics (baseline_kernel.cu:263-266)."""
    t = np.asarray(templ, np.float64)
    mean = float(t.mean())
    std = float(np.sqrt(max(t.var(), 0.0))) + 1e-6
    return mean, std


def _ncc_numpy(frame, templ, t_mean, t_std_in):
    """Pure-numpy fallback for pvot_ncc_match_f32 (same math, same double
    accumulation; strip-wise to bound the sliding-window buffer)."""
    fh, fw = frame.shape
    th, tw = templ.shape
    oh, ow = fh - th + 1, fw - tw + 1
    n = float(th * tw)
    f64 = frame.astype(np.float64)
    t_c = (templ - np.float32(t_mean)).astype(np.float64)
    sum_tc = t_c.sum()
    sat = np.zeros((fh + 1, fw + 1))
    satsq = np.zeros((fh + 1, fw + 1))
    np.cumsum(np.cumsum(f64, 0), 1, out=sat[1:, 1:])
    np.cumsum(np.cumsum(f64 * f64, 0), 1, out=satsq[1:, 1:])
    sums = sat[th:, tw:] - sat[th:, :-tw] - sat[:-th, tw:] + sat[:-th, :-tw]
    ssq = (
        satsq[th:, tw:] - satsq[th:, :-tw] - satsq[:-th, tw:] + satsq[:-th, :-tw]
    )
    mu = sums / n
    sigma = np.sqrt(np.maximum(ssq / n - mu * mu, 1e-6))
    out = np.empty((oh, ow), np.float64)
    strip = max(1, (4 << 20) // max(1, ow * th * tw * 8))
    win = np.lib.stride_tricks.sliding_window_view(f64, (th, tw))
    for y0 in range(0, oh, strip):
        y1 = min(oh, y0 + strip)
        out[y0:y1] = np.einsum(
            "ywrc,rc->yw", win[y0:y1, :ow], t_c, optimize=True
        )
    cov = out - mu * sum_tc
    return (cov / ((sigma + 1e-6) * (float(t_std_in) + 1e-6) * n)).astype(
        np.float32
    )


def ncc_match(frame: np.ndarray, templ: np.ndarray,
              t_mean: Optional[float] = None,
              t_std: Optional[float] = None) -> np.ndarray:
    """Host NCC map with the reference's exact epsilon structure — the
    native analog of the reference CPU op (tracker/src/ncc_cpu.cpp; kernel
    math baseline_kernel.cu:17-46).

    frame (H, W) f32 in [0,1], templ (th, tw) f32 -> valid-mode map
    (H-th+1, W-tw+1) f32.  t_std, when given, must already include the
    host-side +1e-6 (template_stats semantics).  Runs the C++ engine when
    built (OpenMP + integral images), else the numpy fallback: the host
    engine's own two implementations, never a stand-in for a device kernel.
    """
    frame = np.ascontiguousarray(frame, np.float32)
    templ = np.ascontiguousarray(templ, np.float32)
    if t_mean is None or t_std is None:
        t_mean, t_std = template_stats_host(templ)
    fh, fw = frame.shape
    th, tw = templ.shape
    if th > fh or tw > fw:
        raise ValueError(f"template {templ.shape} larger than frame {frame.shape}")
    lib = load()
    if lib is None:
        return _ncc_numpy(frame, templ, t_mean, t_std)
    out = np.empty((fh - th + 1, fw - tw + 1), np.float32)
    lib.pvot_ncc_match_f32(
        frame.ctypes.data, fh, fw, templ.ctypes.data, th, tw,
        ctypes.c_float(t_mean), ctypes.c_float(t_std), out.ctypes.data,
    )
    return out


class FrameRing:
    """Native SPSC frame ring (decode thread -> device-feed thread)."""

    def __init__(self, capacity: int, frame_shape):
        self._shape = tuple(frame_shape)
        self._frame_bytes = int(np.prod(self._shape))
        lib = load()
        if lib is None:
            raise RuntimeError("native runtime unavailable (no toolchain?)")
        self._lib = lib
        self._handle = lib.pvot_ring_create(capacity, self._frame_bytes)
        self.capacity = capacity

    def push(self, frame: np.ndarray) -> bool:
        if self._handle is None:
            raise RuntimeError("push on a closed FrameRing")
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.shape != self._shape:
            raise ValueError(f"frame shape {frame.shape} != ring {self._shape}")
        return bool(self._lib.pvot_ring_push(self._handle, frame.ctypes.data))

    def pop(self, max_frames: int) -> np.ndarray:
        out = np.empty((max_frames, *self._shape), np.uint8)
        return out[: self.pop_into(out)]

    def pop_into(self, out: np.ndarray) -> int:
        """Pop up to len(out) frames into `out`, a C-contiguous uint8 array
        of whole frames (the port's addition: the serving loop pops straight
        into its staging buffers); returns how many."""
        if self._handle is None:
            raise RuntimeError("pop on a closed FrameRing")
        if out.dtype != np.uint8 or out.shape[1:] != self._shape or not out.flags.c_contiguous:
            raise ValueError(f"pop_into needs C-contiguous uint8 (n, {self._shape}) frames")
        return int(self._lib.pvot_ring_pop(self._handle, out.ctypes.data, len(out)))

    def __len__(self) -> int:
        if self._handle is None:
            return 0
        return int(self._lib.pvot_ring_size(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.pvot_ring_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
