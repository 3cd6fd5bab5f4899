"""The occlusion cell's CPU-size copy through both packages: the port's
multi-stream chunk driver (its plain version on the CPU) against the JAX
package's track_streams_mega on the same occluded clips and start states.
Every stream loses its target, searches the whole frame and finds the
target again inside the multi-stream kernel (inkernel_global)."""

import jax.numpy as jnp
import numpy as np
import torch

from pvbench import harness, port
from pvbench.reference import tracker as ref
from pvbench.traffic import scene
from pvot.config import TrackerConfig as JaxConfig
from pvot.tracker.mega import track_streams_mega as jax_track_streams_mega
from pvot.tracker.state import TrackerState as JaxState
from pvot_torch.config import TrackerConfig
from pvot_torch.convert import state_to_numpy
from pvot_torch.tracker.mega import track_streams_mega

CELL = "streams16-720p-occl100"
CPU = torch.device("cpu")


def test_k2_occluded_streams_match_jax():
    seed = 987_654_321_098
    cell = harness.load_cell(CELL, harness.load_json(harness.ROOT / "BENCHMARK.json"))
    config, mix = harness.load_module("drivers", cell.mix["driver"]).small(cell.config, cell.mix)
    clips, truth = zip(*(scene.make_clip(config, mix, seed, s, s * mix["phase_step"], CPU)
                         for s in range(mix["streams"])))
    clips, truth = torch.stack(clips), np.stack([t[:, 0] for t in truth], axis=1)
    per = clips.shape[1]
    templates = [ref.initial_lane(clips[s, per - 1], truth[per - 1, s]).template
                 for s in range(clips.shape[0])]
    states = port.init_states(torch.stack(templates), truth[per - 1], CPU)
    got_state, got = track_streams_mega(clips, states, TrackerConfig(**config["tracker"]),
                                        chunk_size=mix["segment"])
    jax_states = JaxState(**{k: jnp.asarray(v) for k, v in state_to_numpy(states).items()})
    want_state, want = jax_track_streams_mega(
        clips.numpy(), jax_states, JaxConfig(**config["tracker"]), chunk_size=mix["segment"],
        scan_backend="xla", interpret=True, _probe=True, inkernel_global=True)
    assert got.used_global.any(axis=0).all()  # every stream searched the whole frame
    for field in ("bbox", "updated", "used_global"):
        np.testing.assert_array_equal(getattr(got, field), np.asarray(getattr(want, field)),
                                      err_msg=field)
    # As the port's other JAX comparisons: the accepted frames' scores to
    # 1e-5, all to 2e-3 (a hidden frame's score is a background window's,
    # whose small std magnifies the sums' rounding).
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(got.score[acc], np.asarray(want.score)[acc], atol=1e-5)
    np.testing.assert_allclose(got.score, np.asarray(want.score), atol=2e-3)
    got_np = state_to_numpy(got_state)
    for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h", "lost_count", "use_global"):
        np.testing.assert_array_equal(got_np[k], np.asarray(getattr(want_state, k)), err_msg=k)
    np.testing.assert_allclose(got_np["template"], np.asarray(want_state.template), atol=1e-6)
