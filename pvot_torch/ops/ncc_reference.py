"""Plain PyTorch NCC: the port's correctness oracle (pvot/ops/ncc_reference.py).

Per output position, with N = th * tw and the reference's epsilons:

    mean  = sum(window) / N
    var   = sum(window^2) / N - mean^2
    std   = sqrt(max(var, 1e-6))
    ncc   = corr(window, templ - t_mean) / ((std + 1e-6) * (t_std + 1e-6) * N)

where t_std already carries one +1e-6 (template_stats).  Window sums are
valid-mode cross-correlations (F.conv2d, which does not flip the kernel).
Every function keeps its input's dtype, so the tests can run the same code
in float64.  On the card, F.conv2d goes through cuDNN, whose float32
default is TF32: a caller that runs this there turns
torch.backends.cudnn.allow_tf32 off first.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pvot_torch.io.gray import ensure_gray_f32


def template_stats(templ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Template mean and (population std + 1e-6), as 0-d tensors."""
    if not templ.is_floating_point():
        templ = templ.to(torch.float32)
    mean = templ.mean()
    var = (templ * templ).mean() - mean * mean
    std = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-6
    return mean, std


def corr2_valid(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2-D cross-correlation: (H, W), (h, w) -> (H-h+1, W-w+1)."""
    return F.conv2d(image[None, None], kernel[None, None])[0, 0]


def window_moments(frame: torch.Tensor, templ_shape: Tuple[int, int]):
    """Per-placement (mean, std) of the frame, with the variance clamp."""
    th, tw = templ_shape
    n = float(th * tw)
    ones = torch.ones((th, tw), dtype=frame.dtype, device=frame.device)
    mean = corr2_valid(frame, ones) / n
    var = corr2_valid(frame * frame, ones) / n - mean * mean
    return mean, torch.sqrt(torch.clamp(var, min=1e-6))


def ncc_map_reference(
    frame: torch.Tensor,
    templ: torch.Tensor,
    t_mean: torch.Tensor | None = None,
    t_std: torch.Tensor | None = None,
) -> torch.Tensor:
    """Full NCC map of `frame` (uint8, or float in [0, 1]) against `templ`.

    float64 inputs stay float64 (the tests' high-precision reference);
    everything else computes in float32."""
    if frame.dtype != torch.float64:
        frame = ensure_gray_f32(frame)
        templ = templ.to(torch.float32)
    else:
        templ = templ.to(torch.float64)
    if t_mean is None or t_std is None:
        t_mean, t_std = template_stats(templ)
    th, tw = templ.shape
    n = float(th * tw)
    _, std = window_moments(frame, (th, tw))
    cov = corr2_valid(frame, templ - t_mean)
    return cov / ((std + 1e-6) * (t_std + 1e-6) * n)
