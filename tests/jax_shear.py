"""JAX's shear engine (the K4 and K5 Pallas kernels in interpret mode) as a
step of pvot.tracker.scan.track_video: the oracle of the port's CUDA engine
(`shared` and the other Pallas-family modes) on the CPU, built as
tests/test_ncc_pallas.py:204-244 builds it.  pvot.ops.backends cannot give
it here: its support probe runs the kernels compiled, which the CPU cannot.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax import lax

from pvot.ops.ncc_pallas import ncc_map_pallas, ncc_region_argmax_pallas
from pvot.tracker.scan import _stack_outputs, make_masked_scan_fn, pad_tail
from pvot.tracker.step import make_step


def shear_engine(span_x: int, span_y: int):
    """(full_fn, region_fn, region_argmax_fn) of the shear engine in
    interpret mode; the fused argmax only for spans of at most 128, as
    pvot/ops/backends.py:129-147 gates it."""

    def full_fn(frame, templ, t_mean, t_std):
        return ncc_map_pallas(frame, templ, t_mean, t_std, interpret=True, shear=True)

    def region(frame, templ, x0, y0):
        th, tw = templ.shape
        return lax.dynamic_slice(frame, (y0, x0), (span_y + th - 1, span_x + tw - 1))

    def region_fn(frame, templ, t_mean, t_std, x0, y0):
        return ncc_map_pallas(region(frame, templ, x0, y0), templ, t_mean, t_std,
                              interpret=True, shear=True)

    def argmax_fn(frame, templ, t_mean, t_std, x0, y0, bounds):
        return ncc_region_argmax_pallas(region(frame, templ, x0, y0), templ, bounds, x0, y0,
                                        t_mean, t_std, interpret=True, shear=True)

    fused = argmax_fn if span_x <= 128 and span_y <= 128 else None
    return full_fn, region_fn, fused


def shear_step(frame_shape, templ_shape, config, strategy: str = "fused"):
    full_fn, region_fn, argmax_fn = shear_engine(2 * config.search_radius_x + 1,
                                                 2 * config.search_radius_y + 1)
    return make_step(frame_shape, templ_shape, config, ncc_full_fn=full_fn,
                     ncc_region_fn=region_fn, strategy=strategy, ncc_region_argmax_fn=argmax_fn)


@functools.lru_cache(maxsize=None)
def _scan_fn(frame_shape, templ_shape, config, strategy):
    return make_masked_scan_fn(shear_step(frame_shape, templ_shape, config, strategy))


def track_video_shear(frames, state, config, strategy: str = "fused", chunk_size: int = 32):
    """pvot.tracker.scan.track_video's chunk loop on the shear engine in
    interpret mode; the scan compiles once per geometry, config, strategy
    and chunk length, so clips of one geometry share it."""
    frames = np.asarray(frames)
    scan_fn = _scan_fn(frames.shape[1:], tuple(state.template.shape), config, strategy)
    outs = []
    for start in range(0, frames.shape[0], chunk_size):
        chunk = frames[start : start + chunk_size]
        n_real = chunk.shape[0]
        if n_real < chunk_size:
            chunk = pad_tail(chunk, chunk_size - n_real)
        valid = np.arange(chunk_size) < n_real
        state, out = scan_fn(state, jax.device_put(chunk), jax.device_put(valid))
        outs.append(jax.tree.map(lambda a: a[:n_real], out))
    return state, _stack_outputs(outs)
