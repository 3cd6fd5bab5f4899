"""The chunk kernel's plain version (pvot_torch.ops.ncc_mega) against the JAX
chunk kernel, and the CUDA kernel against its plain version on the card.

One JAX call, in Pallas interpret mode (the slow part of these tests), at the
tests/test_mega.py geometry: 250x94 frames, 16x16 template, radius 8.  The
chunk starts from a re-acquisition state (bbox centre outside the frame, as
pvot/tracker/mega.py _global_probe_clip builds it): global frames that
reject, one that re-acquires, then local tracking, and a last frame past
n_valid.  Lanes compare under the tracker's equality contract
(pvot/tracker/mega.py _outputs_equal): bbox, updated, used_global, lost and
use_global exactly; accepted scores within 1e-5, all within 2e-3; template
within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pvot.config import TrackerConfig as JaxConfig
from pvot.ops.ncc_mega import mega_track_chunk as jax_chunk
from pvot.tracker.mega import _global_probe_clip
from pvot_torch.config import TrackerConfig
from pvot_torch.convert import state_from_numpy
from pvot_torch.ops.ncc_mega import (
    O_GUSED, O_LOST, O_SCORE, O_UPDATED, O_USEG, mega_track_chunk,
    mega_track_chunk_reference,
)

F, H, W, T = 8, 94, 250, 16
N_VALID = F - 1
RADIUS = dict(search_radius_x=8, search_radius_y=8)
EXACT = {"bbox": slice(0, 4), "updated": O_UPDATED, "lost": O_LOST,
         "use_global": O_USEG, "used_global": O_GUSED}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread each, so that parallel
    test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def probe():
    """(frames (F+1, H, W) u8, start state as numpy, JAX rows, JAX template)."""
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (F + 1, H, W), np.uint8)
    st = _global_probe_clip(frames, (T, T))
    rows, tpl = jax_chunk(
        jnp.asarray(frames[1:]),
        jnp.stack([st.bbox_x, st.bbox_y, st.bbox_w, st.bbox_h]).astype(jnp.int32),
        st.template, st.t_mean, st.t_std, st.lost_count, st.use_global,
        jnp.int32(N_VALID), frame_shape=(H, W), templ_shape=(T, T),
        config=JaxConfig(**RADIUS), interpret=True, highest=True,
        inkernel_global=True,
    )
    state = {k: np.asarray(v) for k, v in st._asdict().items()}
    return frames, state, np.asarray(rows)[:, :10], np.asarray(tpl)


def _args(frames_u8, s, device="cpu"):
    t = state_from_numpy(s, device)
    return (torch.as_tensor(frames_u8, device=device), torch.stack(list(t.bbox)),
            t.template, t.t_mean, t.t_std, t.lost_count, t.use_global)


def _assert_contract(got_rows, got_tpl, want_rows, want_tpl):
    for name, lane in EXACT.items():
        np.testing.assert_array_equal(got_rows[:, lane], want_rows[:, lane], err_msg=name)
    acc = want_rows[:, O_UPDATED] != 0
    np.testing.assert_allclose(got_rows[acc, O_SCORE], want_rows[acc, O_SCORE], atol=1e-5)
    np.testing.assert_allclose(got_rows[:, O_SCORE], want_rows[:, O_SCORE], atol=2e-3)
    np.testing.assert_allclose(got_tpl, want_tpl, atol=1e-6)


def test_probe_covers_the_state_machine(probe):
    _, _, rows, _ = probe
    gused = rows[:N_VALID, O_GUSED] != 0
    upd = rows[:N_VALID, O_UPDATED] != 0
    assert gused.any() and (gused & ~upd).any(), "global frames that reject"
    assert (gused & upd).any(), "a global frame that re-acquires"
    assert (~gused & upd).any(), "local tracking after re-acquisition"
    assert rows[N_VALID, O_UPDATED] == 0 and rows[N_VALID, O_GUSED] == 0


def test_plain_chunk_matches_jax_chunk(probe):
    frames, state, want_rows, want_tpl = probe
    rows, tpl = mega_track_chunk_reference(
        *_args(frames[1:], state), N_VALID, TrackerConfig(**RADIUS)
    )
    assert rows.shape == (F, 10) and rows.dtype == torch.float32
    _assert_contract(rows.numpy(), tpl.numpy(), want_rows, want_tpl)
    # The frame past n_valid commits nothing: it repeats the last committed
    # record's state lanes.
    np.testing.assert_array_equal(rows[N_VALID, [0, 1, 2, 3, O_LOST, O_USEG]].numpy(),
                                  rows[N_VALID - 1, [0, 1, 2, 3, O_LOST, O_USEG]].numpy())


def test_wrapper_on_cpu_is_the_plain_version(probe):
    frames, state, want_rows, want_tpl = probe
    before = mega_track_chunk.launches
    rows, tpl = mega_track_chunk(*_args(frames[1:], state), N_VALID, TrackerConfig(**RADIUS))
    assert mega_track_chunk.launches == before
    _assert_contract(rows.numpy(), tpl.numpy(), want_rows, want_tpl)


def test_n_valid_zero_commits_nothing(probe):
    frames, state, _, _ = probe
    rows, tpl = mega_track_chunk_reference(
        *_args(frames[1:4], state), 0, TrackerConfig(**RADIUS)
    )
    start = [int(state[k]) for k in ("bbox_x", "bbox_y", "bbox_w", "bbox_h")]
    assert rows[:, :4].tolist() == [start] * 3
    assert not rows[:, O_UPDATED].any() and not rows[:, O_GUSED].any()
    # The start bbox lies outside the frame, so its window collapses: a frame
    # past n_valid scores nothing.
    assert torch.isinf(rows[:, O_SCORE]).all()
    np.testing.assert_array_equal(tpl.numpy(), state["template"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version(probe, cuda_device):
    frames, state, _, _ = probe
    config = TrackerConfig(**RADIUS)
    args = _args(frames[1:], state, cuda_device)
    before = mega_track_chunk.launches
    rows, tpl = mega_track_chunk(*args, N_VALID, config)
    assert mega_track_chunk.launches == before + 1  # one launch a chunk
    want_rows, want_tpl = mega_track_chunk_reference(*args, N_VALID, config)
    _assert_contract(rows.cpu().numpy(), tpl.cpu().numpy(),
                     want_rows.cpu().numpy(), want_tpl.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("highest,passes", [(True, 3), (False, 1)])
def test_cuda_chunk_twice_is_bit_equal(probe, cuda_device, highest, passes):
    """The persistent launch's blocks meet at a grid barrier a step and fold
    the winners through counters: the same chunk run twice gives the same
    records and template bit for bit, whichever block arrives last."""
    frames, state, _, _ = probe
    config = TrackerConfig(**RADIUS)
    args = _args(frames[1:], state, cuda_device)
    first = mega_track_chunk(*args, N_VALID, config, highest=highest, score_passes=passes)
    again = mega_track_chunk(*args, N_VALID, config, highest=highest, score_passes=passes)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
