"""The multi-device self-check of the port, the analog of the JAX package's
dryrun_multichip (__graft_entry__.py:107-345): n processes in one gloo
world, a (data x search) mesh over them (search as large as possible up to
4), the sharded scan and serving across devices, each held to its one-device
counterpart.

  python -m pvot_torch.tools.dryrun_multichip [N] [--device cuda|cpu]

N defaults to 4.  Rank r tracks on cuda:(r mod the cards present), so ranks
may share a card (the gloo groups gather from the host,
pvot_torch.parallel.sharded); without a CUDA device the run raises unless
--device cpu asks for the CPU.
Passes, each printed by rank 0:
  1. a tiny clip (96x128, 16x16 templates, radius 12) through
     track_video_sharded: 2 chunks with a masked tail, (F, S) outputs;
  2. the same clip on the CUDA engine's full maps (backend "pallas": K4 on
     the card, its plain version on the CPU), each stream's boxes and flags
     equal to the unsharded track_video on that engine;
  3. 720p, 80x80 templates, radius 60 (the headline geometry), 4 frames of
     moving targets, within 2 px of the ground truth;
  4. 720p re-acquisition (exit and re-enter, lost threshold 2): boxes and
     used_global exactly those of the unsharded scan, global frames present;
  5. serve_streams over min(2, N) devices, unequal stream lengths, bit-equal
     to serving on one device (rank 0 alone: serving has no collectives).

`spawn` starts such a world for any function (tests and chip_smoke.py use
it): each rank joins the process group through a FileStore in a temporary
directory, and every process is stopped before it returns.
"""

from __future__ import annotations

import argparse
import itertools
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, List

import numpy as np


def _rank_main(rank: int, world: int, store: str, out_dir: str, fn: Callable, args) -> None:
    import torch
    import torch.distributed as dist

    # The ranks share the host's cores: without a share each, their
    # intra-op thread pools oversubscribe it many times over.
    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // world)))
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # a rank that failed must not wait for the others' collectives
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, fn: Callable, *args, timeout: float = 600.0) -> List:
    """fn(rank, world, *args) in `world` new processes, one gloo world over
    them; returns each rank's return value, in rank order.  Raises if a rank
    fails or the world outlasts `timeout` seconds; either way every process
    is stopped first.  fn must be importable by name (a module-level
    function) and its return value picklable."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="pvot_torch_world_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(r, world, store, tmp, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.exitcode is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"ranks {failed} of {world} failed (their stderr above)")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"a world of {world} ranks outlasted {timeout:.0f} s")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                raise RuntimeError(f"ranks {failed} of {world} failed (their stderr above)")
        finally:
            for p in procs:
                if p.exitcode is None:
                    p.kill()
                p.join()
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def factor(n: int):
    """(data, search): search the largest of 4, 2, 1 that divides n."""
    search = next(c for c in (4, 2, 1) if n % c == 0)
    return n // search, search


def rank_device(rank: int, kind: str) -> str:
    """The device a rank tracks on: the CPU, or cuda:(rank mod cards)."""
    if kind == "cpu":
        return "cpu"
    import torch

    return f"cuda:{rank % torch.cuda.device_count()}"


def _stack(templates, rois, device):
    from pvot_torch.parallel.multi import stack_states
    from pvot_torch.tracker.state import init_state

    return stack_states([init_state(t, r, device=device) for t, r in zip(templates, rois)],
                        device)


def _clips(specs, n_frames: int) -> np.ndarray:
    from pvot_torch.io.synthetic import generate_gray_frames

    return np.stack([np.stack(list(itertools.islice(generate_gray_frames(sp), n_frames)))
                     for sp in specs])


def _gt_states(specs, clips, device):
    from pvot_torch.io.gray import gray_u8_to_f32
    from pvot_torch.io.synthetic import target_bbox

    rois = [target_bbox(sp, 0) for sp in specs]
    return _stack([gray_u8_to_f32(c[0])[y : y + h, x : x + w]
                   for c, (x, y, w, h) in zip(clips, rois)], rois, device)


def _dryrun_rank(rank: int, world: int, kind: str) -> List[str]:
    """The dryrun's passes on one rank; rank 0's lines come back."""
    import torch

    from pvot_torch.config import TrackerConfig
    from pvot_torch.io.synthetic import SyntheticSpec, target_bbox
    from pvot_torch.parallel.multi import unstack_state
    from pvot_torch.parallel.sharded import make_mesh, track_video_sharded
    from pvot_torch.tracker.scan import track_video

    device = rank_device(rank, kind)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    data, search = factor(world)
    mesh = make_mesh((data, search))
    lines = []
    frame_shape, templ_shape = (96, 128), (16, 16)
    config = TrackerConfig(search_radius_x=12, search_radius_y=12)
    rng = np.random.default_rng(0)
    rois = [(20 + 3 * s, 30 + 2 * s, 16, 16) for s in range(data)]
    states = _stack([rng.random(templ_shape, dtype=np.float32) for _ in rois], rois, device)
    videos = rng.integers(0, 255, (data, 5, *frame_shape), dtype=np.uint8)

    # 1. Two chunks, the second a masked tail.
    _, out = track_video_sharded(videos, states, mesh, config, chunk_size=3, device=device)
    assert out.bbox.shape == (5, data, 4), out.bbox.shape
    lines.append(f"dryrun_multichip ok: mesh=({data}x{search}) data x search, scanned "
                 f"{out.bbox.shape[0]} frames x {data} streams, bbox sample="
                 f"{out.bbox[-1, 0].tolist()}")

    # 2. The CUDA engine's full maps on the slabs and strips.
    _, k4 = track_video_sharded(videos, states, mesh, config, chunk_size=3, backend="pallas",
                                device=device)
    if rank == 0:
        for s in range(data):
            _, alone = track_video(videos[s], unstack_state(states, s), config,
                                   backend="pallas", device=device)
            np.testing.assert_array_equal(k4.bbox[:, s], alone.bbox)
            np.testing.assert_array_equal(k4.used_global[:, s], alone.used_global)
    lines.append("dryrun_multichip backend=pallas ok: every stream equal to the unsharded "
                 "track_video(backend=\"pallas\")")

    # 3. The headline geometry, moving targets, against the ground truth.
    n_frames = 4
    specs = [SyntheticSpec(width=1280, height=720, num_frames=200, target_w=80, target_h=80,
                           seed=100 + s) for s in range(data)]
    clips = _clips(specs, n_frames + 1)
    _, out720 = track_video_sharded(clips[:, 1:], _gt_states(specs, clips, device), mesh,
                                    TrackerConfig(), chunk_size=2, device=device)
    want = np.stack([np.stack([target_bbox(sp, i + 1) for i in range(n_frames)])
                     for sp in specs], axis=1)
    err = int(np.abs(out720.bbox - want).max())
    assert err <= 2, f"720p sharded trajectory off the ground truth by {err} px"
    lines.append(f"dryrun_multichip 720p ok: mesh=({data}x{search}), 80x80 template r60, "
                 f"{n_frames} frames x {data} streams, max_l1_err_px={err}, bbox sample="
                 f"{out720.bbox[-1, 0].tolist()}")

    # 4. Re-acquisition at 720p against the unsharded scan.
    n_occ = 12
    cfg_occ = TrackerConfig(lost_frame_threshold=2)
    specs_occ = [SyntheticSpec(width=1280, height=720, num_frames=n_occ + 1, target_w=80,
                               target_h=80, seed=200 + s, amplitude=0.1, exit_and_reenter=True)
                 for s in range(data)]
    clips_occ = _clips(specs_occ, n_occ + 1)
    states_occ = _gt_states(specs_occ, clips_occ, device)
    _, out_occ = track_video_sharded(clips_occ[:, 1:], states_occ, mesh, cfg_occ, chunk_size=4,
                                     device=device)
    if rank == 0:
        n_global = 0
        for s in range(data):
            _, single = track_video(clips_occ[s, 1:], unstack_state(states_occ, s), cfg_occ,
                                    chunk_size=4, device=device)
            np.testing.assert_array_equal(out_occ.bbox[:, s], single.bbox)
            np.testing.assert_array_equal(out_occ.used_global[:, s], single.used_global)
            n_global += int(single.used_global.sum())
        assert n_global > 0, "the re-acquisition clip never searched globally"
        lines.append(f"dryrun_multichip 720p re-acquisition ok: mesh=({data}x{search}), "
                     f"{n_global} global-search frames across {data} streams, bbox/used_global "
                     "exactly equal to the unsharded scan")

    # 5. Serving across devices (no collectives: rank 0 alone).
    if rank == 0:
        from pvot_torch.io.serving import serve_streams

        serve_devices = [rank_device(r, kind) for r in range(min(2, world))]
        lengths = [5, 3, 4, 2][: max(2, min(4, data))]
        svideos = [rng.integers(0, 255, (n + 1, *frame_shape), dtype=np.uint8) for n in lengths]
        sstates = _stack([rng.random(templ_shape, dtype=np.float32) for _ in lengths],
                         [(20 + s, 30 + s, 16, 16) for s in range(len(lengths))], device)
        _, want_outs = serve_streams([iter(v[1:]) for v in svideos], sstates, frame_shape,
                                     config, backend="xla", chunk_size=3)
        _, got_outs = serve_streams([iter(v[1:]) for v in svideos], sstates, frame_shape,
                                    config, backend="xla", chunk_size=3, devices=serve_devices)
        assert [o.bbox.shape[0] for o in got_outs] == lengths
        for w_, g_ in zip(want_outs, got_outs):
            np.testing.assert_array_equal(w_.bbox, g_.bbox)
            np.testing.assert_array_equal(w_.score, g_.score)
        lines.append(f"dryrun_multichip serving ok: {len(lengths)} live streams over "
                     f"{len(serve_devices)} devices, unequal lengths {lengths}, bit-identical "
                     "to single-device")
    return lines


def dryrun_multichip(n_devices: int = 4, device: str = "cuda") -> List[str]:
    """Run the dryrun over n_devices gloo processes tracking on `device`
    ("cuda" or "cpu"); print and return rank 0's lines.  Raises if any pass
    fails, and on "cuda" without a CUDA device."""
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device: pass device="cpu" to run the dryrun on the CPU')
    lines = spawn(n_devices, _dryrun_rank, device)[0]
    for line in lines:
        print(line)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=4, help="processes (devices), default 4")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    opts = ap.parse_args(argv)
    dryrun_multichip(opts.n, opts.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
