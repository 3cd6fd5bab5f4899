"""The NCC engines that the JAX package leaves to XLA, as torch ops: the port
of pvot/ops/ncc_matmul.py.

  cross-correlation   im2col along x, one product with the template rows,
                      then the sum of th shifted slices (`cross_correlate`);
                      or a 1-D convolution along x with the template rows
                      as filters, then the same sum (`cross_correlate_conv1d`)
  window sums         exclusive integral images, four corners a box
                      (`sliding_box_sums`, `_box_sums_traced`)

The sums follow JAX's order, integral images included, so that the scores
land where JAX's land (the tests hold them to pvot.ops.ncc_matmul).  On the
card every product runs in full float32 (`full_f32`), whatever the global
TF32 flags say: the JAX engine runs at HIGHEST (pvot/ops/backends.py:161-167).

Engines: `make_full_fn` / `make_region_fn` (the `xla` backend; with
`passes=3` the region scores of `xla_fast`),
`make_opencv_full_fn` / `make_opencv_region_fn` (the `cpu` parity mode,
cv::matchTemplate(TM_CCOEFF_NORMED)), and `make_bucketed_full_fn` /
`make_bucketed_region_fn` (templates of mixed sizes zero-padded into one
bucket).  Region engines take their origin as host ints and slice the frame
there; frames stay in their wire dtype until sliced.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pvot_torch.io.gray import ensure_gray_f32
from pvot_torch.ops.ncc_reference import full_f32, split_bf16, template_stats


def cross_correlate(img: torch.Tensor, templ: torch.Tensor) -> torch.Tensor:
    """Valid-mode cross-correlation by im2col-x and one product:
    img (Y, W), templ (th, tw) -> (Y - th + 1, W - tw + 1)."""
    th, tw = templ.shape
    y, w = img.shape
    out_h, out_w = y - th + 1, w - tw + 1
    x = img.unfold(1, tw, 1)  # (Y, out_w, tw): x[y, dx, c] = img[y, dx + c]
    with full_f32(img.device):
        r1 = torch.matmul(x, templ.t()).contiguous()  # (Y, out_w, th)
    # cross[dy, dx] = sum_r r1[dy + r, dx, r]: the th shifted slices as one
    # strided view, summed over r.
    shifted = r1.as_strided((th, out_h, out_w), (out_w * th + 1, out_w * th, th))
    return shifted.sum(dim=0)


def cross_correlate_conv1d(img: torch.Tensor, templ: torch.Tensor) -> torch.Tensor:
    """`cross_correlate` by a 1-D valid convolution along the width
    (pvot/ops/ncc_matmul.py:78): the template's rows are th filters over
    every image row, r1[y, r, dx] = sum_c img[y, dx + c] * templ[r, c], then
    cross[dy, dx] = sum_r r1[dy + r, r, dx].  The convolution runs in full
    float32 on the card (`full_f32`: cuDNN would take TF32)."""
    th, tw = templ.shape
    y, w = img.shape
    out_h, out_w = y - th + 1, w - tw + 1
    with full_f32(img.device):
        r1 = F.conv1d(img[:, None, :], templ[:, None, :]).contiguous()  # (Y, th, out_w)
    # The th shifted slices r1[r : r + out_h, r, :] as one strided view.
    shifted = r1.as_strided((th, out_h, out_w), (th * out_w + out_w, th * out_w, 1))
    return shifted.sum(dim=0)


def _strips(frame: torch.Tensor, templ: torch.Tensor, strip_rows: int) -> torch.Tensor:
    """cross_correlate over y-strips of strip_rows output rows (0: one
    strip), which bounds the im2col buffer."""
    th = templ.shape[0]
    out_h = frame.shape[0] - th + 1
    if not strip_rows or strip_rows >= out_h:
        return cross_correlate(frame, templ)
    return torch.cat([
        cross_correlate(frame[dy0 : dy0 + min(strip_rows, out_h - dy0) + th - 1], templ)
        for dy0 in range(0, out_h, strip_rows)
    ])


# XLA lowers cumsum to a two-level scan in blocks of 16 (measured bit-equal
# to jnp.cumsum on the CPU, frames up to 1080x1920); the port's integral
# images sum in that order, on the CPU and on the card.
_SCAN_BLOCK = 16


def _scan(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sequential float32 prefix sums along `dim`."""
    out = [v.select(dim, 0)]
    for i in range(1, v.shape[dim]):
        out.append(out[-1] + v.select(dim, i))
    return torch.stack(out, dim)


def cumsum(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive prefix sums along `dim` in XLA's order: sequential within
    blocks of 16, the blocks' totals summed the same way, and each block's
    exclusive prefix added to its sums."""
    n = v.shape[dim]
    if n <= _SCAN_BLOCK:
        return _scan(v, dim)
    v = v.movedim(dim, 0)
    m = -(-n // _SCAN_BLOCK)
    padded = torch.cat([v, v.new_zeros((m * _SCAN_BLOCK - n, *v.shape[1:]))])
    inner = _scan(padded.reshape(m, _SCAN_BLOCK, *v.shape[1:]), 1)
    outer = cumsum(inner[:, -1], 0)
    before = torch.cat([torch.zeros_like(outer[:1]), outer[:-1]])
    out = (inner + before[:, None]).reshape(m * _SCAN_BLOCK, *v.shape[1:])[:n]
    return out.movedim(0, dim)


def _integral(img: torch.Tensor) -> torch.Tensor:
    """Exclusive 2-D integral image: S[y, x] = sum(img[:y, :x])."""
    return F.pad(cumsum(cumsum(img, 0), 1), (1, 0, 1, 0))


def sliding_box_sums(img: torch.Tensor, th: int, tw: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares) over every valid th x tw window, each box as
    S[y2, x2] - S[y1, x2] - S[y2, x1] + S[y1, x1] of an integral image."""
    out_h, out_w = img.shape[0] - th + 1, img.shape[1] - tw + 1

    def box(values):
        s = _integral(values)
        return (s[th : th + out_h, tw : tw + out_w] - s[:out_h, tw : tw + out_w]
                - s[th : th + out_h, :out_w] + s[:out_h, :out_w])

    return box(img), box(img * img)


def _strips_hl3(frame: torch.Tensor, tc: torch.Tensor, strip_rows: int) -> torch.Tensor:
    """`_strips` at 3 bf16 passes: hi w * hi t + hi w * lo t + lo w * hi t,
    each product exact and summed in float32 (pvot/ops/ncc_pallas.py:63-87;
    XLA's Precision.HIGH on a TPU)."""
    wh, wl = split_bf16(frame)
    th, tl = split_bf16(tc)
    return (_strips(wh, th, strip_rows) + _strips(wh, tl, strip_rows)
            + _strips(wl, th, strip_rows))


def ncc_map_matmul(frame, templ, t_mean=None, t_std=None, strip_rows: int = 0,
                   passes: int = 0) -> torch.Tensor:
    """Full NCC map with the reference's epsilons (pvot/ops/ncc_matmul.py:134);
    passes=3 runs the correlation at 3 bf16 passes, the window sums stay
    float32."""
    frame = ensure_gray_f32(frame)
    templ = templ.to(torch.float32)
    if t_mean is None or t_std is None:
        t_mean, t_std = template_stats(templ)
    th, tw = templ.shape
    n = float(th * tw)
    cov = (_strips_hl3 if passes == 3 else _strips)(frame, templ - t_mean, strip_rows)
    sums, ssq = sliding_box_sums(frame, th, tw)
    mean = sums / n
    var = ssq / n - mean * mean
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    return cov / ((std + 1e-6) * (t_std + 1e-6) * n)


def ncc_map_opencv_matmul(frame, templ, strip_rows: int = 0) -> torch.Tensor:
    """cv::matchTemplate(TM_CCOEFF_NORMED) semantics, the `cpu` parity mode
    (pvot/ops/ncc_matmul.py:180)."""
    frame = ensure_gray_f32(frame)
    templ = templ.to(torch.float32)
    th, tw = templ.shape
    n = float(th * tw)
    t_centered = templ - torch.mean(templ)
    t_ssq = torch.sum(t_centered * t_centered)
    numer = _strips(frame, t_centered, strip_rows)
    sums, ssq = sliding_box_sums(frame, th, tw)
    win_ssq = torch.clamp(ssq - sums * sums / n, min=0.0)
    denom = torch.sqrt(t_ssq * win_ssq)
    return numer / torch.clamp(denom, min=1e-12)


def _region(frame, x0: int, y0: int, h: int, w: int) -> torch.Tensor:
    return frame[y0 : y0 + h, x0 : x0 + w]


def make_full_fn(strip_rows: int = 128):
    """Full-map callable (frame, templ, t_mean, t_std) -> map, strip-wise."""

    def full_fn(frame, templ, t_mean, t_std):
        return ncc_map_matmul(frame, templ, t_mean, t_std, strip_rows=strip_rows)

    return full_fn


def make_region_fn(span_x: int, span_y: int, passes: int = 0):
    """Region scorer (frame, templ, t_mean, t_std, x0, y0) -> (span_y,
    span_x): scores only the (span + t - 1)^2 neighbourhood, the correlation
    in float32 (passes 0) or at 3 bf16 passes (the `xla_fast` engine, JAX's
    make_region_fn(precision=HIGH), pvot/ops/ncc_matmul.py:358-375)."""
    if passes not in (0, 3):
        raise ValueError(f"the region scorer runs 0 or 3 passes, not {passes}")

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        th, tw = templ.shape
        region = _region(frame, x0, y0, span_y + th - 1, span_x + tw - 1)
        return ncc_map_matmul(region, templ, t_mean, t_std, passes=passes)

    return region_fn


def make_opencv_full_fn(strip_rows: int = 128):
    """`cpu` parity full-map callable (frame, templ, t_mean, t_std)."""

    def full_fn(frame, templ, t_mean, t_std):
        del t_mean, t_std  # TM_CCOEFF_NORMED normalizes differently
        return ncc_map_opencv_matmul(frame, templ, strip_rows=strip_rows)

    return full_fn


def make_opencv_region_fn(span_x: int, span_y: int):
    """`cpu` parity region scorer."""

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        del t_mean, t_std
        th, tw = templ.shape
        return ncc_map_opencv_matmul(_region(frame, x0, y0, span_y + th - 1, span_x + tw - 1),
                                     templ)

    return region_fn


# --- Bucketed NCC: templates zero-padded into a (bh, bw) bucket, each with
# its true extent (th, tw) as host ints (pvot/ops/ncc_matmul.py:236-346).


def _box_sums_traced(img: torch.Tensor, th: int, tw: int, out_h: int, out_w: int):
    """Sliding th x tw box sums over (out_h, out_w) positions of `img`."""
    s = _integral(img)
    return (s[th : th + out_h, tw : tw + out_w] - s[:out_h, tw : tw + out_w]
            - s[th : th + out_h, :out_w] + s[:out_h, :out_w])


def ncc_scores_bucketed(img, templ_padded, t_mean, t_std, th: int, tw: int, out_h: int,
                        out_w: int) -> torch.Tensor:
    """NCC scores of a zero-padded template at its true extent (th, tw):
    img (out_h + bh - 1, out_w + bw - 1), templ_padded (bh, bw) raw values.
    Scores whose window hangs past the image's content are garbage; callers
    mask them."""
    img = ensure_gray_f32(img)
    bh, bw = templ_padded.shape
    keep = torch.zeros((bh, bw), dtype=torch.bool, device=templ_padded.device)
    keep[:th, :tw] = True
    t_centered = torch.where(keep, templ_padded.to(torch.float32) - t_mean, 0.0)
    cross = cross_correlate(img, t_centered)
    n = float(th * tw)
    sums = _box_sums_traced(img, th, tw, out_h, out_w)
    ssq = _box_sums_traced(img * img, th, tw, out_h, out_w)
    mean = sums / n
    var = ssq / n - mean * mean
    std = torch.sqrt(torch.clamp(var, min=1e-6))
    cov = cross - mean * torch.sum(t_centered)
    return cov / ((std + 1e-6) * (t_std + 1e-6) * n)


def make_bucketed_region_fn(span_x: int, span_y: int, bucket: Tuple[int, int]):
    """(frame_padded, templ_padded, t_mean, t_std, th, tw, x0, y0) ->
    (span_y, span_x) scores over the region at (x0, y0)."""
    bh, bw = bucket

    def region_fn(frame, templ_padded, t_mean, t_std, th, tw, x0, y0):
        region = _region(frame, x0, y0, span_y + bh - 1, span_x + bw - 1)
        return ncc_scores_bucketed(region, templ_padded, t_mean, t_std, th, tw, span_y, span_x)

    return region_fn


def make_bucketed_full_fn(frame_shape: Tuple[int, int], bucket: Tuple[int, int]):
    """Full-frame scorer at a true extent: the frame zero-padded by (bh - 1,
    bw - 1) so every candidate of any extent in the bucket exists; positions
    past (H - th + 1, W - tw + 1) are garbage and masked by the caller."""
    fh, fw = frame_shape
    bh, bw = bucket

    def full_fn(frame, templ_padded, t_mean, t_std, th, tw):
        img = F.pad(frame, (0, bw - 1, 0, bh - 1))
        return ncc_scores_bucketed(img, templ_padded, t_mean, t_std, th, tw, fh, fw)

    return full_fn
