"""uint8 gray -> float32 in [0, 1], the two conversions of pvot/io/gray.py.

Two different roundings, and parity needs both:

  * host path (`gray_u8_to_f32`, the template at init): cv::convertTo scales
    by a double alpha and casts once — an f64 multiply by 1/255, then f32.
  * device path (`ensure_gray_f32`, every frame the NCC reads): an f32
    multiply by float32(1/255), as pvot/io/gray.py:90 and the mega kernel
    (pvot/ops/ncc_mega.py:608-611) do.  The CUDA kernel uses the same
    constant (pvot_torch/csrc/ncc_mega.cu, kU8Scale).
"""

from __future__ import annotations

import numpy as np
import torch

# float32(1/255) as a Python float: exactly representable in f32, so every
# conversion of it (torch scalar promotion, the C++ literal) is exact.
U8_SCALE = float(np.float32(1.0 / 255.0))


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
