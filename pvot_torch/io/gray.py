"""uint8 gray -> float32 in [0, 1], the two conversions of pvot/io/gray.py.

Two different roundings, and parity needs both:

  * host path (`gray_u8_to_f32`, the template at init): cv::convertTo scales
    by a double alpha and casts once — an f64 multiply by 1/255, then f32.
  * device path (`ensure_gray_f32`, every frame the NCC reads): an f32
    multiply by float32(1/255), as pvot/io/gray.py:90 and the mega kernel
    (pvot/ops/ncc_mega.py:608-611) do.  The CUDA kernel uses the same
    constant (pvot_torch/csrc/ncc_mega.cu, kU8Scale).

`bgr_to_gray_u8` is a copy of pvot/io/gray.py:33: OpenCV's fixed-point
BGR2GRAY, through cv2 where it is installed (imported at first use: the
card's machine has no OpenCV) and the same 15-bit formula in numpy
otherwise; `to_gray` chains it with the host scale.  `device_gray_scale` and
`device_bgr_to_gray_f32` are JAX's on-device conversions, on the tensor's own
device or the one named (numpy input: the current CUDA device unless the
caller names another, as every entry point of the port).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# float32(1/255) as a Python float: exactly representable in f32, so every
# conversion of it (torch scalar promotion, the C++ literal) is exact.
U8_SCALE = float(np.float32(1.0 / 255.0))

# OpenCV's fixed-point BGR2GRAY coefficients: R=0.299, G=0.587, B=0.114
# quantized to 15 fractional bits (pvot/io/gray.py:26-30).
_R_COEF, _G_COEF, _B_COEF, _SHIFT = 9798, 19235, 3735, 15
_ROUND = 1 << (_SHIFT - 1)


@functools.lru_cache(maxsize=None)
def _cv2():
    """OpenCV, or None where it is not installed."""
    try:
        import cv2  # type: ignore
    except ImportError:
        return None
    return cv2


def bgr_to_gray_u8(frame_bgr: np.ndarray) -> np.ndarray:
    """uint8 BGR (H, W, 3) -> uint8 gray (H, W), bit-exact with cv2.cvtColor."""
    if frame_bgr.dtype != np.uint8 or frame_bgr.ndim != 3 or frame_bgr.shape[2] != 3:
        raise ValueError(f"expected uint8 HxWx3 BGR, got {frame_bgr.dtype} {frame_bgr.shape}")
    cv2 = _cv2()
    if cv2 is None:
        b = frame_bgr[..., 0].astype(np.uint32)
        g = frame_bgr[..., 1].astype(np.uint32)
        r = frame_bgr[..., 2].astype(np.uint32)
        y = (b * _B_COEF + g * _G_COEF + r * _R_COEF + _ROUND) >> _SHIFT
        return y.astype(np.uint8)
    return cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)


def gray_u8_to_f32(gray_u8: np.ndarray) -> np.ndarray:
    """uint8 gray -> float32 in [0, 1], scaled in f64 and rounded once
    (the reference's convertTo(CV_32F, 1/255))."""
    return (gray_u8.astype(np.float64) * (1.0 / 255.0)).astype(np.float32)


def ensure_gray_f32(img: torch.Tensor) -> torch.Tensor:
    """uint8 -> f32 * float32(1/255) on the tensor's device; floats pass
    through as f32.  Elementwise, so it commutes exactly with slicing."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * U8_SCALE
    return img.to(torch.float32)


def to_gray(frame_bgr: np.ndarray) -> np.ndarray:
    """The reference's `to_gray` (tracker_ghc/include/utils.hpp:4-13): uint8
    BGR -> float32 gray in [0, 1], the fixed-point gray then the 1/255 scale
    (pvot/io/gray.py:55)."""
    return gray_u8_to_f32(bgr_to_gray_u8(frame_bgr))


def _on_device(x, device) -> torch.Tensor:
    """x as a tensor on `device`; by default a tensor stays where it is and
    numpy goes to the current CUDA device (tracker.state.default_device)."""
    if device is None and isinstance(x, torch.Tensor):
        return x
    from pvot_torch.tracker.state import default_device

    return torch.as_tensor(x, device=default_device(device))


def device_gray_scale(gray_u8, device=None) -> torch.Tensor:
    """uint8 gray -> float32 * float32(1/255) on the device
    (pvot/io/gray.py:71)."""
    return _on_device(gray_u8, device).to(torch.float32) * U8_SCALE


def device_bgr_to_gray_f32(frame_bgr_u8, device=None) -> torch.Tensor:
    """uint8 BGR (H, W, 3) -> float32 gray / 255 on the device
    (pvot/io/gray.py:94): the float weights 0.114 B + 0.587 G + 0.299 R as
    one float32 product (no TF32), within 1/255 of the fixed-point host
    path."""
    from pvot_torch.ops.ncc_reference import full_f32

    f = _on_device(frame_bgr_u8, device).to(torch.float32)
    w = torch.tensor([0.114, 0.587, 0.299], dtype=torch.float32, device=f.device)
    with full_f32(f.device):
        return (f @ w) * U8_SCALE
