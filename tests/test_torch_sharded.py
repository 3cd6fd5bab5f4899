"""Tracking across several devices (pvot_torch.parallel.sharded, serving over
a device list, pvot_torch.tools.dryrun_multichip) on gloo CPU processes, held
to the port's one-device paths and to the JAX package's sharded drivers on
the conftest's virtual devices.

One world of 4 ranks (a 2 x 2 mesh) runs every sharded case once for the
module (tests/torch_sharded_ranks.py); the tests compare what its ranks
returned.  Trajectories (bbox, used_global, updated) must be equal; scores
follow the tracker's equality contract (pvot/tracker/mega.py:321-345):
accepted frames within 1e-5, every frame within 2e-3."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from pvot.io.gray import gray_u8_to_f32 as jax_gray
from pvot.parallel.sharded import (
    make_search_sharded_step as jax_sharded_step, shard_states as jax_shard_states,
    track_video_sharded as jax_track_video_sharded,
)
from pvot.tracker.state import init_state as jax_init_state
from pvot.tracker.step import make_step as jax_make_step
from pvot_torch.io.serving import serve_streams
from pvot_torch.parallel.multi import init_multi_state, make_multi_step, multi_carry_from_state
from pvot_torch.tracker.scan import track_video
from pvot_torch.tracker.state import StepOutput, init_state
from pvot_torch.tracker.step import cached_step, carry_from_state
from pvot_torch.tools.dryrun_multichip import dryrun_multichip, spawn
from tests import torch_sharded_ranks as R


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's small tensors: the tier-1 run's
    workers share the host's cores, and a pool of threads a worker would
    crowd the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """Every rank's results: rank r sits at (data, search) = divmod(r, 2)."""
    return spawn(4, R.run_world, timeout=300)


def _assert_contract(got, want, what=""):
    np.testing.assert_array_equal(got.bbox, np.asarray(want.bbox), err_msg=what)
    np.testing.assert_array_equal(got.used_global, np.asarray(want.used_global), err_msg=what)
    np.testing.assert_array_equal(got.updated, np.asarray(want.updated), err_msg=what)
    acc = np.asarray(want.updated)
    np.testing.assert_allclose(got.score[acc], np.asarray(want.score)[acc], rtol=0, atol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(got.score, np.asarray(want.score), rtol=0, atol=2e-3,
                               err_msg=what)


def _stream(out, s):
    return StepOutput(*(np.asarray(v)[:, s] for v in out))


def _jax_mesh():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "search"))


def _jax_states(pairs):
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[jax_init_state(jnp.asarray(t), r) for t, r in pairs])


def _torch_alone(video, templ, roi, cfg, backend="xla"):
    """The port's unsharded scan of one stream."""
    return track_video(video, init_state(templ, roi, device="cpu"), cfg, backend=backend,
                       chunk_size=8)[1]


def test_world_layout(world):
    assert [r["coords"] for r in world] == [(0, 0, 0, 0), (0, 1, 0, 1), (1, 0, 1, 0),
                                            (1, 1, 1, 1)]


def test_sharded_step_matches_unsharded(world):
    """The step, frame by frame (tests/test_parallel.py:58): every rank of a
    search group gives its stream the unsharded step's records, and JAX's
    sharded step's."""
    clips = [R.setup(9), R.setup(11)]
    h, w = clips[0][1].shape[1:]
    step = cached_step((h, w), (24, 24), R.CFG, "fused", "xla")
    carries = [carry_from_state(init_state(t, r, device="cpu")) for _, _, r, t in clips]
    jstep = jax.jit(jax_sharded_step(_jax_mesh(), (h, w), (24, 24), R.CFG))
    jstates = jax_shard_states(_jax_mesh(), _jax_states([(t, r) for _, _, r, t in clips]),
                               P("data"))
    for i, t in enumerate(range(1, 8)):
        frames = [clips[s][1][t] for s in range(2)]
        jstates, jout = jstep(jstates, jnp.stack([jnp.asarray(jax_gray(f)) for f in frames]))
        for s in range(2):
            carries[s], rec = step(carries[s], torch.from_numpy(jax_gray(frames[s])))
            want = StepOutput(*(np.asarray([v]) for v in rec))
            jwant = StepOutput(*(np.asarray(v)[s : s + 1] for v in jout))
            for r in (2 * s, 2 * s + 1):
                got = StepOutput(*(np.asarray([v]) for v in world[r]["step"][i]))
                _assert_contract(got, want, f"frame {t} stream {s} rank {r}")
                _assert_contract(got, jwant, f"frame {t} stream {s} rank {r} vs JAX")


def test_track_video_sharded_matches_unsharded(world):
    """tests/test_parallel.py:234: chunks of 6, 6 and a masked 3, the full
    (F, S) output on every rank, equal to the unsharded scan of each stream
    and to JAX's track_video_sharded on a (2, 2) mesh."""
    clips = [R.setup(9), R.setup(11)]
    videos = np.stack([v[1:] for _, v, _, _ in clips])
    _, jout = jax_track_video_sharded(videos, _jax_states([(t, r) for _, _, r, t in clips]),
                                      _jax_mesh(), R.CFG, chunk_size=6)
    got = StepOutput(**world[0]["scan"])
    assert got.bbox.shape == (15, 2, 4)
    for r in world[1:]:
        for k, v in r["scan"].items():
            np.testing.assert_array_equal(v, world[0]["scan"][k])
    for s, (_, video, roi, templ) in enumerate(clips):
        _assert_contract(_stream(got, s), _torch_alone(video[1:], templ, roi, R.CFG), f"s{s}")
        _assert_contract(_stream(got, s), _stream(jout, s), f"stream {s} vs JAX")
    for r in world:  # the final state survives the chunk boundaries
        np.testing.assert_array_equal(r["scan_final_x"], got.bbox[-1, :, 0])


def test_sharded_k4_slabs_match_the_unsharded_engine(world):
    """backend="pallas": the CUDA engine's full maps (K4; its plain version
    on the CPU) on every slab and strip, each stream equal to the unsharded
    scan on that engine (K5 on its local frames)."""
    got = StepOutput(**world[0]["scan_pallas"])
    for r in world[1:]:
        np.testing.assert_array_equal(r["scan_pallas"]["bbox"], got.bbox)
    for s, (_, video, roi, templ) in enumerate([R.setup(9), R.setup(11)]):
        _assert_contract(_stream(got, s),
                         _torch_alone(video[1:], templ, roi, R.CFG, backend="pallas"), f"s{s}")


def test_search_sharded_global_reacquisition(world):
    """tests/test_parallel.py:296: lost -> global (strips on every search
    rank, the combine) -> re-acquired, equal to the unsharded scan and to
    JAX's sharded scan."""
    specs, videos, starts = R.reacq_clips()
    _, jout = jax_track_video_sharded(np.stack([v[1:] for v in videos]), _jax_states(starts),
                                      _jax_mesh(), R.CFG_REACQ, chunk_size=8)
    got = StepOutput(**world[0]["reacq"])
    for r in world[1:]:
        np.testing.assert_array_equal(r["reacq"]["bbox"], got.bbox)
    any_global = False
    for s, (video, (templ, roi)) in enumerate(zip(videos, starts)):
        alone = _torch_alone(video[1:], templ, roi, R.CFG_REACQ)
        _assert_contract(_stream(got, s), alone, f"stream {s}")
        _assert_contract(_stream(got, s), _stream(jout, s), f"stream {s} vs JAX")
        any_global = any_global or bool(alone.used_global.any())
    assert any_global, "the fixture never searched globally"
    for s, spec in enumerate(specs):
        gx, gy, _, _ = R.target_bbox(spec, spec.num_frames - 1)
        assert abs(int(got.bbox[-1, s, 0]) - gx) <= 3 and abs(int(got.bbox[-1, s, 1]) - gy) <= 3


def test_search_sharded_global_tie_row_major_across_shards(world):
    """tests/test_parallel.py:356: an exact tie between rows of search rank 0
    (y = 30) and rank 1 (y = 130; strips of 81 rows) lands on the row-major
    first occurrence on every rank, as the unsharded step finds it."""
    frame, pattern = R.tie_frame()
    ts = R.TIE["ts"]
    one = jax_init_state(jnp.asarray(pattern), (*R.TIE["second"], ts, ts))._replace(
        use_global=jnp.bool_(True))
    _, ref = jax.jit(jax_make_step(frame.shape, (ts, ts), R.CFG))(one, jnp.asarray(frame))
    assert bool(ref.used_global)
    np.testing.assert_array_equal(np.asarray(ref.bbox), [*R.TIE["first"], ts, ts])
    for r in world:
        bbox, score, used_global, updated = r["tie"]
        assert used_global and updated
        assert list(bbox) == [*R.TIE["first"], ts, ts]
        assert abs(score - float(ref.score)) <= 1e-6


def test_data_parallel_multi_step(world):
    """tests/test_parallel.py:98: 4 streams x 2 objects on a (data, obj)
    mesh, each rank a block of 2 streams x 1 object; identical frames give
    identical records, those of the one-device multi-object step."""
    spec, video, roi, templ = R.setup(5)
    one = init_multi_state([templ, jax_gray(video[0])[40:64, 40:64]], [roi, (40, 40, 24, 24)],
                           device="cpu")
    mc, recs = make_multi_step(video.shape[1:], (24, 24), R.CFG)(
        multi_carry_from_state(one), torch.from_numpy(jax_gray(video[1])))
    for r in world:
        obj = r["coords"][3]
        got = r["data_parallel"]
        assert got["bbox"].shape == (2, 1, 4)
        for s in range(2):
            bbox, score, used_global, updated = recs[obj]
            np.testing.assert_array_equal(got["bbox"][s, 0], bbox)
            assert got["score"][s, 0] == np.float32(score)
            assert got["used_global"][s, 0] == used_global and got["updated"][s, 0] == updated
    gx, gy, _, _ = R.target_bbox(spec, 1)
    b = world[0]["data_parallel"]["bbox"][0, 0]
    assert abs(int(b[0]) - gx) <= 2 and abs(int(b[1]) - gy) <= 2


def test_serving_across_devices_matches_one_device():
    """serve_streams over ["cpu", "cpu"], unequal lengths: contiguous groups
    [0, 1] and [2, 3], each stream bit-equal to serving on one device, and to
    JAX's serve_streams(devices=jax.devices()[:2]) under the contract."""
    from pvot.io.serving import serve_streams as jax_serve_streams

    from pvot_torch.config import TrackerConfig
    from pvot_torch.parallel.multi import stack_states

    rng = np.random.default_rng(0)
    config = TrackerConfig(search_radius_x=12, search_radius_y=12)
    lengths = [5, 3, 4, 2]
    videos = [rng.integers(0, 255, (n + 1, 96, 128), dtype=np.uint8) for n in lengths]
    pairs = [(rng.random((16, 16), dtype=np.float32), (20 + s, 30 + s, 16, 16))
             for s in range(4)]
    states = stack_states([init_state(t, r, device="cpu") for t, r in pairs], "cpu")
    timings = []
    final1, one = serve_streams([iter(v[1:]) for v in videos], states, (96, 128), config,
                                backend="xla", chunk_size=3)
    final2, two = serve_streams([iter(v[1:]) for v in videos], states, (96, 128), config,
                                backend="xla", chunk_size=3, devices=["cpu", "cpu"],
                                timings=timings)
    assert sum(n for n, _ in timings) == sum(lengths)
    for a, b in zip(final1, final2):
        assert torch.equal(a, b)
    _, jouts = jax_serve_streams([iter(v[1:]) for v in videos], _jax_states(pairs), (96, 128),
                                 config, backend="xla", chunk_size=3, devices=jax.devices()[:2])
    assert [o.bbox.shape[0] for o in two] == lengths
    for s in range(4):
        for a, b in zip(one[s], two[s]):
            np.testing.assert_array_equal(a, b)
        _assert_contract(two[s], jouts[s], f"stream {s} vs JAX")


def test_dryrun_multichip_passes():
    lines = dryrun_multichip(4, device="cpu")
    assert len(lines) == 5 and lines[0].startswith("dryrun_multichip ok: mesh=(1x4)")
