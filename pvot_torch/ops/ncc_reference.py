"""Plain PyTorch NCC: the port's correctness oracle (pvot/ops/ncc_reference.py),
with its cv::matchTemplate variant (`ncc_map_opencv`, the reference's --cpu
mode) and its batched maps (`ncc_map_batched`).

Per output position, with N = th * tw and the reference's epsilons:

    mean  = sum(window) / N
    var   = sum(window^2) / N - mean^2
    std   = sqrt(max(var, 1e-6))
    ncc   = corr(window, templ - t_mean) / ((std + 1e-6) * (t_std + 1e-6) * N)

where t_std already carries one +1e-6 (template_stats).  Window sums are
valid-mode cross-correlations (F.conv2d, which does not flip the kernel).
Every function keeps its input's dtype, so the tests can run the same code
in float64.  On the card, cuDNN's float32 convolutions and cuBLAS's float32
products may run in TF32 when the global flags allow it; every torch-ops
NCC function of the port runs them inside `full_f32`, which holds them to
full float32 whatever the caller set.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

from pvot_torch.io.gray import ensure_gray_f32


def _precision_knobs():
    """(object, attribute, full-f32 value) of each float32 precision flag of
    cuDNN convolutions and cuBLAS products: the per-operator flags where this
    torch has them (reading the legacy ones after a mix of both APIs
    raises), else the legacy allow_tf32 pair."""
    conv = getattr(torch.backends.cudnn, "conv", None)
    matmul = torch.backends.cuda.matmul
    if conv is not None and hasattr(conv, "fp32_precision") and hasattr(matmul, "fp32_precision"):
        return [(conv, "fp32_precision", "ieee"), (matmul, "fp32_precision", "ieee")]
    return [(torch.backends.cudnn, "allow_tf32", False), (matmul, "allow_tf32", False)]


@contextlib.contextmanager
def full_f32(device: torch.device):
    """Float32 convolutions and products on `device` in full float32 (no
    TF32) inside the block, the caller's flags restored after it; nothing
    changes off the card."""
    if torch.device(device).type != "cuda":
        yield
        return
    knobs = _precision_knobs()
    saved = [getattr(obj, name) for obj, name, _ in knobs]
    for obj, name, value in knobs:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for (obj, name, _), value in zip(knobs, saved):
            setattr(obj, name, value)


def template_stats(templ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Template mean and (population std + 1e-6) over the last two axes:
    0-d tensors for one (th, tw) template, (S,) for a stack of them."""
    if not templ.is_floating_point():
        templ = templ.to(torch.float32)
    mean = templ.mean(dim=(-2, -1))
    var = (templ * templ).mean(dim=(-2, -1)) - mean * mean
    std = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-6
    return mean, std


def template_stats_bucketed(templ_padded: torch.Tensor, n) -> Tuple[torch.Tensor, torch.Tensor]:
    """`template_stats` of the true region of a zero-padded template
    (pvot/ops/ncc_matmul.py:245 template_stats_bucketed): the padding's zeros
    vanish from the sums, and `n` is the true pixel count th_k * tw_k, a
    number or a tensor with the stack's leading shape."""
    if not templ_padded.is_floating_point():
        templ_padded = templ_padded.to(torch.float32)
    n = torch.as_tensor(n, device=templ_padded.device).to(templ_padded.dtype)
    mean = templ_padded.sum(dim=(-2, -1)) / n
    var = (templ_padded * templ_padded).sum(dim=(-2, -1)) / n - mean * mean
    std = torch.sqrt(torch.clamp(var, min=0.0)) + 1e-6
    return mean, std


def corr2_valid(image: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2-D cross-correlation: (H, W), (h, w) -> (H-h+1, W-w+1),
    in full float32 on the card."""
    with full_f32(image.device):
        return F.conv2d(image[None, None], kernel[None, None])[0, 0]


def score_tier(highest: bool, score_passes: int) -> int:
    """The correlation's tier as a pass count: 0 for float32 (highest=True,
    where score_passes is ignored), else score_passes, which must be 1, 2 or
    3 either way (pvot/ops/ncc_mega.py:868-869)."""
    if score_passes not in (1, 2, 3):
        raise ValueError(f"score_passes must be 1, 2 or 3, got {score_passes}")
    return 0 if highest else int(score_passes)


def cli_tier(fast: bool, score_passes=None) -> dict:
    """The highest / score_passes keywords of a command line's --fast and
    --score-passes (3 passes unless given)."""
    return dict(highest=not fast, score_passes=3 if score_passes is None else score_passes)


def tier_name(highest: bool = True, score_passes: int = 3) -> str:
    """bench.py's name of a score tier (bench.py:233-238)."""
    if highest:
        return "highest"
    return "fast_1pass_bf16" if score_passes == 1 else f"fast_{score_passes}pass_bf16_hilo"


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of a float32 tensor as float32 values: hi = bf16(x) and lo =
    bf16(x - hi), both rounded to nearest even (pvot/ops/ncc_mega.py:394-416,
    pvot/ops/ncc_pallas.py:77-78)."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def tiered_corr(region: torch.Tensor, tc: torch.Tensor, passes: int = 0) -> torch.Tensor:
    """corr(region, tc) at a score tier (pvot/ops/ncc_mega.py:384-440,
    pvot/ops/ncc_pallas.py:63-87): 0 is float32; with hi/lo the bf16 split,
    3 passes are corr(hi w, hi t) + corr(hi w, lo t) + corr(lo w, hi t), 2
    drop the last term and 1 keeps the first alone.  A product of two bf16
    values is exact in float32, so every tier is exact products summed in
    full float32."""
    if passes == 0:
        return corr2_valid(region, tc)
    wh, wl = split_bf16(region)
    th, tl = split_bf16(tc)
    out = corr2_valid(wh, th)
    if passes >= 2:
        out = out + corr2_valid(wh, tl)
    if passes == 3:
        out = out + corr2_valid(wl, th)
    return out


def ncc_scores(region: torch.Tensor, tc: torch.Tensor, t_std, sum_tc, n: float,
               passes: int = 0) -> torch.Tensor:
    """The kernels' score formula over a float32 region (pvot/ops/ncc_mega.py
    :462-470, pvot/ops/ncc_pallas.py:169-176):

        (corr(region, tc) - mean * sum_tc) / ((std + 1e-6) * (t_std + 1e-6) * n)

    with tc the centered template, sum_tc its sum and std = sqrt(max(var,
    1e-6)); the correlation at the tier `passes` (`tiered_corr`), the rest in
    float32 at every tier.  The window moments are summed in float64 and
    rounded to float32 once: var = E[x^2] - E[x]^2 cancels on flat windows,
    where float32 sums lose up to 3.7e-3 of a score (ROADMAP C, plain-version
    numerics)."""
    ones = torch.ones(tc.shape, dtype=torch.float64, device=region.device)
    r64 = region.to(torch.float64)
    mean64 = corr2_valid(r64, ones) / n
    var = (corr2_valid(r64 * r64, ones) / n - mean64 * mean64).to(torch.float32)
    mean = mean64.to(torch.float32)
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    cov = tiered_corr(region, tc, passes) - mean * sum_tc
    return cov / ((std + 1e-6) * (t_std + 1e-6) * n)


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


def ncc_map_opencv(frame: torch.Tensor, templ: torch.Tensor) -> torch.Tensor:
    """cv::matchTemplate(TM_CCOEFF_NORMED) semantics, the reference's --cpu
    mode (tracker_ghc/src/main.cpp:158; pvot/ops/ncc_reference.py:124):

        R = sum(T' I') / sqrt(sum(T'^2) sum(I'^2)),  T' = T - mean(T),
                                                     I' = I_win - mean(I_win)

    with a plain 1e-12 guard on the denominator, as JAX has it.  Dtypes as
    in `ncc_map_reference`."""
    if frame.dtype != torch.float64:
        frame = ensure_gray_f32(frame)
        templ = templ.to(torch.float32)
    else:
        templ = templ.to(torch.float64)
    n = float(templ.numel())
    t_centered = templ - templ.mean()
    t_ssq = (t_centered * t_centered).sum()
    ones = torch.ones(templ.shape, dtype=frame.dtype, device=frame.device)
    sums = corr2_valid(frame, ones)
    ssq = corr2_valid(frame * frame, ones)
    win_ssq = torch.clamp(ssq - sums * sums / n, min=0.0)
    numer = corr2_valid(frame, t_centered)
    denom = torch.sqrt(t_ssq * win_ssq)
    return numer / torch.clamp(denom, min=1e-12)


def ncc_map_batched(frames: torch.Tensor, templ: torch.Tensor) -> torch.Tensor:
    """NCC maps of frames (B, H, W) against one template snapshot -> (B,
    outH, outW) (pvot/ops/ncc_reference.py:152, the analog of the reference's
    nccKernelNaiveBatched): the template's stats once, then every frame's
    map."""
    t_mean, t_std = template_stats(templ)
    return torch.stack([ncc_map_reference(f, templ, t_mean, t_std) for f in frames])
