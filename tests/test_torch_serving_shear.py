"""Serving over the port's `shared` engine (the plain K4 and K5 on the CPU)
against JAX's shear engine in interpret mode (tests/jax_shear.py), one
stream at a time.  Kept apart from tests/test_torch_serving_scan.py because
the interpret-mode scan compiles for about 16 s: each file then stays short
in the parallel test run.  Streams, tolerances and helpers are that file's.
"""

import jax.numpy as jnp
import pytest
import torch

import pvot_torch
from pvot.config import TrackerConfig as JaxConfig
from pvot_torch.io import serving
from pvot_torch.parallel.multi import unstack_state
from tests.test_torch_serving_scan import (
    GEOMETRY, KW, LENGTHS, _as_np, _assert_outputs, _assert_state, _stream, _torch_stacked,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def streams():
    return [_stream(n, 3 + i) for i, n in enumerate(LENGTHS)]


def test_serve_streams_shared_matches_jax_shear(streams):
    """The `shared` engine (the plain K4 and K5 here) over the three streams,
    stream 1 started in global search: each stream equal to JAX's shear
    engine (interpret mode) on it alone; global frames score as JAX's K4."""
    from tests.jax_shear import track_video_shear

    starts = [st._replace(use_global=jnp.asarray(s == 1)) for s, (_, st) in enumerate(streams)]
    final, outs = serving.serve_streams(
        [iter(f[1:]) for f, _ in streams], _torch_stacked(starts), GEOMETRY,
        pvot_torch.TrackerConfig(**KW), backend="shared", chunk_size=8)
    assert outs[1].used_global[0] and not outs[0].used_global.any()
    for s, ((frames, _), st) in enumerate(zip(streams, starts)):
        jfinal, want = track_video_shear(frames[1:], st, JaxConfig(**KW), chunk_size=8)
        _assert_outputs(outs[s], want)
        _assert_state(unstack_state(final, s), _as_np(jfinal))
