"""The NCC backend registry (pvot/ops/backends.py): a reference CLI mode name
-> (full_fn, region_fn, region_argmax_fn).

  full_fn(frame, templ, t_mean, t_std) -> full NCC map
  region_fn(frame, templ, t_mean, t_std, x0, y0) -> (span_y, span_x) scores
      of the candidate region at map position (x0, y0)
  region_argmax_fn(frame, templ, t_mean, t_std, x0, y0, bounds) -> (3,) row
      (best value, x, y) in map coordinates, or None: the fused kernel
      (K5), which the step then uses in place of region_fn + the masked
      argmax.

  mode                          backend    engine
  cuda, naive, xla, batch       xla        torch-ops im2col product + integral
                                           images (pvot_torch.ops.ncc_matmul)
  fast, xla_fast                xla_fast   the same, region scores at 3 bf16
                                           passes (JAX's Precision.HIGH)
  cpu                           cpu        the same, cv::matchTemplate
                                           (TM_CCOEFF_NORMED) normalization
  shared, const, const_tiled,   cuda       the hand-written kernels K4 (maps)
  pallas, pallas_shear, shear,             and K5 (fused argmax) of
  auto, mega                               pvot_torch.ops.ncc_pallas
  pallas_fast                   cuda_fast  K4 and K5 with the region scores
                                           at 3 bf16 passes on the tensor
                                           cores (`_dot_hl3`)
  ref_conv                      ref_conv   the conv oracle (tests, debugging)

In both fast engines the global full maps stay float32, as in JAX
(pvot/ops/backends.py:168-177, :212-214).

The JAX package's operator engine, its geometry probes and its fallback
chains (ROADMAP R2, R3) and `prefer_pallas` (R7) have no counterpart: every
name of the Pallas family is the one CUDA engine, which launches or raises.
`mega` reaches here only from a scan-style caller (the chunk drivers take it
first), as in JAX.  The fused argmax keeps JAX's gate, a span of at most 128
a side (pvot/ops/backends.py:129-147), so that the launches are the
reference's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from pvot_torch.config import TrackerConfig

MODE_TO_BACKEND = {
    "cuda": "xla",
    "naive": "xla",
    "xla": "xla",
    "cpu": "cpu",
    "shared": "cuda",
    "const": "cuda",
    "const_tiled": "cuda",
    "pallas": "cuda",
    "batch": "xla",
    "fast": "xla_fast",
    "xla_fast": "xla_fast",
    "pallas_fast": "cuda_fast",
    "pallas_shear": "cuda",
    "shear": "cuda",
    "mega": "cuda",
    "auto": "cuda",
    "ref_conv": "ref_conv",
}

FUSED_ARGMAX_MAX_SPAN = 128


def cuda_region_passes(name: str) -> Optional[int]:
    """The region scores' pass count (0: float32, 3: bf16 hi/lo) when `name`
    resolves to the CUDA engine, else None."""
    return {"cuda": 0, "cuda_fast": 3}.get(MODE_TO_BACKEND.get(name))


def fused_argmax_fn(frame_shape, templ_shape, span_x: int, span_y: int, highest: bool = True):
    """The fused argmax (K5) when the candidate region fits one JAX kernel
    tile, a span of at most 128 a side; else None (region scores by K4 and
    the argmax by torch ops)."""
    from pvot_torch.ops.ncc_pallas import pallas_region_argmax_fn

    if span_x > FUSED_ARGMAX_MAX_SPAN or span_y > FUSED_ARGMAX_MAX_SPAN:
        return None
    return pallas_region_argmax_fn(frame_shape, templ_shape, (span_y, span_x), highest=highest)


def get_backend(
    name: str,
    frame_shape: Tuple[int, int],
    templ_shape: Tuple[int, int],
    config: TrackerConfig,
) -> Tuple[Callable, Callable, Optional[Callable]]:
    """Resolve a mode or backend name to (full_fn, region_fn,
    region_argmax_fn)."""
    span_x = 2 * config.search_radius_x + 1
    span_y = 2 * config.search_radius_y + 1
    if name not in MODE_TO_BACKEND:
        raise ValueError(f"unknown NCC backend: {name!r}")
    backend = MODE_TO_BACKEND[name]
    if backend in ("xla", "xla_fast"):
        from pvot_torch.ops.ncc_matmul import make_full_fn, make_region_fn

        passes = 3 if backend == "xla_fast" else 0
        return make_full_fn(strip_rows=128), make_region_fn(span_x, span_y, passes), None
    if backend == "cpu":
        from pvot_torch.ops.ncc_matmul import make_opencv_full_fn, make_opencv_region_fn

        return make_opencv_full_fn(strip_rows=128), make_opencv_region_fn(span_x, span_y), None
    if backend == "ref_conv":
        from pvot_torch.tracker.step import default_region_fn
        from pvot_torch.ops.ncc_reference import ncc_map_reference

        return ncc_map_reference, default_region_fn(span_x, span_y), None
    from pvot_torch.ops.ncc_pallas import pallas_full_fn, pallas_region_fn

    highest = backend == "cuda"  # else cuda_fast
    return (
        pallas_full_fn(frame_shape, templ_shape),
        pallas_region_fn(frame_shape, templ_shape, (span_y, span_x), highest=highest),
        fused_argmax_fn(frame_shape, templ_shape, span_x, span_y, highest=highest),
    )
