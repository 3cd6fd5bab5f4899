"""The global-strip probes on the card: the port of tools/global_strip_probe.py.

On the TPU the probes tried the constructs of the mega kernel's in-kernel
global search, one kernel each (`_kernel_factory` :114 with its two variants
`when_fori_dma` and `dyn_fori_dma`, pallas_call :227; `probe_when_refetch`
:268, pallas_call :306).  Here the functions they compute are two CUDA
kernels (pvot_torch/csrc/strip_probe.cu) with a plain PyTorch version each:

- `strip_best`: for frame t of (F, 256, 512) u8 frames, the 8 x 8 box sums
  of v / 255 of each strip's 48 x 128 map (strip (sy, sx) at rows 64 sy +
  (sy & 7) + dy, columns 256 sx + dx), the strip's first best in row-major
  order, and the strips folded in the lexicographic order (value desc, y
  asc, x asc); odd frames fold over the 3 x 2 strip grid, even frames score
  strip (0, 0) alone.  Output (F, 3) float32: (value, y, x).  The JAX
  kernel's two variants compute this one function.
- `slab_refetch`: for frame t, s0 the sum of the u8 slab at (0, 0), 64 x 256,
  and s1 the sum of the slab at (64, 256) when byte (0, 0) is odd, else s0.
  Output (F, 2) float32.  (The TPU probe failed for an incidental Mosaic
  reason, an i8 scalar extract; in interpret mode it computes this.)

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU tensor
they run the plain versions.  `strip_best.launches` and
`slab_refetch.launches` count the kernel launches (2 and 1 a call).

The entry point runs the probes on their own inputs (`default_rng(7)` for
the strips, `default_rng(8)` for the refetch, (2, 256, 512) u8) and on a
seeded border clip, holds each result to the numpy oracle (a copy of the
JAX tool's `_oracle_best`, or its exact integer form for the border clip's
ties: value within 1e-5 relative, (y, x) exactly; the refetch sums exactly)
and to the plain version, prints PASS or FAIL per probe and exits nonzero on
any FAIL:

    python -m pvot_torch.tools.global_strip_probe [--device cpu]

On the card it also prints each kernel's device microseconds a call, on
its probe's input.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import numpy as np
import torch

TX = 128
SLAB_H, SLAB_W = 64, 256
PAD_H, PAD_W = 256, 512  # 3x2 strip grid + roll-residual slack rows
NY, NX = 3, 2
DY_MAX = SLAB_H - 16  # scored rows per strip (keeps roll wraparound out)
BIG = 2**30
BOX = 8
VALUE_RTOL = 1e-5  # tools/global_strip_probe.py:253: the probe's own bound


def _scores_np(fr, sy, sx):
    """Host oracle for one strip: the kernel's 8x8 box-sum scores.

    The kernel DMAs the aligned slab at (sy*SLAB_H, sx*SLAB_W) and rolls
    rows so row 0 is logical origin y0 = sy*SLAB_H + (sy & 7); scores are
    score(dy, dx) = sum of the 8x8 box at (y0+dy, x0+dx), dy < DY_MAX.
    """
    y0 = sy * SLAB_H + (sy & 7)
    x0 = sx * SLAB_W
    win = fr[y0 : y0 + DY_MAX + 7, x0 : x0 + SLAB_W].astype(np.float64)
    win = win / 255.0
    out = np.zeros((DY_MAX, TX), np.float64)
    c = win.cumsum(axis=0).cumsum(axis=1)
    cp = np.zeros((win.shape[0] + 1, win.shape[1] + 1))
    cp[1:, 1:] = c
    for dy in range(DY_MAX):
        for dx in range(TX):
            out[dy, dx] = (
                cp[dy + 8, dx + 8] - cp[dy, dx + 8] - cp[dy + 8, dx] + cp[dy, dx]
            )
    return out


def _oracle_best(fr, strips):
    best = None
    for sy, sx in strips:
        sc = _scores_np(fr, sy, sx)
        v = sc.max()
        pos = np.argwhere(sc == v)[0]
        ay = sy * SLAB_H + (sy & 7) + pos[0]
        ax = sx * SLAB_W + pos[1]
        cand = (-v, ay, ax)
        if best is None or cand < best:
            best = cand
    return (-best[0], best[1], best[2])


def _oracle_best_exact(fr, strips):
    """`_oracle_best` on integer box sums, exact: the value is S / 255 for the
    box's byte sum S, so equal boxes tie exactly.  `_oracle_best`'s float64
    integral image of v / 255 rounds two equal boxes differently and cannot
    decide a tie; the border clip is held to this one."""
    best = None
    for sy, sx in strips:
        y0, x0 = sy * SLAB_H + (sy & 7), sx * SLAB_W
        win = fr[y0 : y0 + DY_MAX + 7, x0 : x0 + TX + 7].astype(np.int64)
        cp = np.zeros((win.shape[0] + 1, win.shape[1] + 1), np.int64)
        cp[1:, 1:] = win.cumsum(axis=0).cumsum(axis=1)
        sc = cp[8:, 8:] - cp[:-8, 8:] - cp[8:, :-8] + cp[:-8, :-8]
        dy, dx = np.argwhere(sc == sc.max())[0]
        cand = (-int(sc[dy, dx]), y0 + int(dy), x0 + int(dx))
        best = cand if best is None else min(best, cand)
    return (-best[0] / 255.0, best[1], best[2])


def strips_of(t: int) -> list:
    """The strips frame t scores: the 3 x 2 grid on odd frames, (0, 0) else."""
    return [(sy, sx) for sy in range(NY) for sx in range(NX)] if t % 2 == 1 else [(0, 0)]


def _check_frames(frames_u8: torch.Tensor) -> None:
    if frames_u8.dtype != torch.uint8 or frames_u8.ndim != 3 or frames_u8.shape[1:] != (
            PAD_H, PAD_W) or frames_u8.shape[0] < 1:
        raise ValueError(f"expected (F, {PAD_H}, {PAD_W}) uint8 frames, got "
                         f"{frames_u8.dtype} {tuple(frames_u8.shape)}")


def strip_best_reference(frames_u8: torch.Tensor) -> torch.Tensor:
    """Plain version of `strip_best`: each strip's box sums in the kernel's
    order (v * float32(1/255); 8 rows summed in order, then 8 columns of those
    sums), its first best in row-major order, the strips folded
    lexicographically."""
    _check_frames(frames_u8)
    scale = torch.tensor(1.0 / 255.0, dtype=torch.float32)
    out = torch.empty((frames_u8.shape[0], 3), dtype=torch.float32)
    for t in range(frames_u8.shape[0]):
        best = None
        for sy, sx in strips_of(t):
            y0, x0 = sy * SLAB_H + (sy & 7), sx * SLAB_W
            v = frames_u8[t, y0 : y0 + DY_MAX + BOX - 1, x0 : x0 + TX + BOX - 1].cpu()
            v = v.to(torch.float32) * scale
            col = v[:DY_MAX]
            for p in range(1, BOX):
                col = col + v[p : p + DY_MAX]
            box = col[:, :TX]
            for q in range(1, BOX):
                box = box + col[:, q : q + TX]
            idx = int(torch.argmax(box))  # the first maximal index, row-major
            cand = (-float(box.reshape(-1)[idx]), y0 + idx // TX, x0 + idx % TX)
            best = cand if best is None else min(best, cand)
        out[t] = torch.tensor([-best[0], best[1], best[2]], dtype=torch.float32)
    return out.to(frames_u8.device)


def slab_refetch_reference(frames_u8: torch.Tensor) -> torch.Tensor:
    """Plain version of `slab_refetch`: integer sums, exact in float32."""
    _check_frames(frames_u8)
    f = frames_u8.cpu().to(torch.int64)
    s0 = f[:, :SLAB_H, :SLAB_W].sum(dim=(1, 2))
    s1 = f[:, SLAB_H : 2 * SLAB_H, SLAB_W : 2 * SLAB_W].sum(dim=(1, 2))
    odd = (f[:, 0, 0] & 1) == 1
    out = torch.stack([s0, torch.where(odd, s1, s0)], dim=1).to(torch.float32)
    return out.to(frames_u8.device)


def _cuda_frames(frames_u8: torch.Tensor) -> torch.Tensor:
    """Contiguous frames whose base is 16-byte aligned (the refetch's loads)."""
    frames_u8 = frames_u8.contiguous()
    return frames_u8.clone() if frames_u8.data_ptr() % 16 else frames_u8


def strip_best(frames_u8: torch.Tensor) -> torch.Tensor:
    """(F, 3) float32 (value, y, x) of each frame's strip search: the kernels
    of csrc/strip_probe.cu on a CUDA tensor (two launches, no host
    synchronisation; `strip_best.launches` grows by 2), the plain version
    on a CPU tensor."""
    _check_frames(frames_u8)
    if frames_u8.device.type == "cpu":
        return strip_best_reference(frames_u8)
    from pvot_torch.ops import _build

    lib = _build.load_library()
    frames_u8 = _cuda_frames(frames_u8)
    f, dev = frames_u8.shape[0], frames_u8.device
    part_val = torch.empty(f * NY * NX, dtype=torch.float32, device=dev)
    part_yx = torch.empty(2 * f * NY * NX, dtype=torch.int32, device=dev)
    out = torch.empty((f, 3), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pvot_strip_best(frames_u8.data_ptr(), f, part_val.data_ptr(),
                                  part_yx.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "strip_best")
    strip_best.launches += 2
    return out


def slab_refetch(frames_u8: torch.Tensor) -> torch.Tensor:
    """(F, 2) float32 (s0, s1) of each frame: the kernel of csrc/strip_probe.cu
    on a CUDA tensor (one launch; `slab_refetch.launches` grows by 1), the
    plain version on a CPU tensor."""
    _check_frames(frames_u8)
    if frames_u8.device.type == "cpu":
        return slab_refetch_reference(frames_u8)
    from pvot_torch.ops import _build

    lib = _build.load_library()
    frames_u8 = _cuda_frames(frames_u8)
    out = torch.empty((frames_u8.shape[0], 2), dtype=torch.float32, device=frames_u8.device)
    with torch.cuda.device(frames_u8.device):
        err = lib.pvot_slab_refetch(frames_u8.data_ptr(), frames_u8.shape[0], out.data_ptr(),
                                    torch.cuda.current_stream(frames_u8.device).cuda_stream)
        _build.check(err, "slab_refetch")
    slab_refetch.launches += 1
    return out


strip_best.launches = 0
slab_refetch.launches = 0


def probe_frames(seed: int) -> np.ndarray:
    """A probe's input: (2, 256, 512) u8 from default_rng(seed), as the JAX
    probes make it (seed 7 for the strips, 8 for the refetch)."""
    return np.random.default_rng(seed).integers(0, 256, (2, PAD_H, PAD_W), np.uint8)


def border_clip(seed: int = 9) -> np.ndarray:
    """(2, 256, 512) u8, seeded, whose best matches lie on strip borders.

    The background is noise below 32.  Frame 0 (strip (0, 0) alone) holds
    one bright 8 x 8 box at the last row and column its strip scores, (47,
    127).  Frame 1 (the 3 x 2 grid) holds the frame's single brightest 8 x 8
    box across the border between strip rows 0 and 1 (rows 60-67, columns
    20-27: row 64 is the second strip row's slab, whose first scored row is
    65), so strip (1, 0) scores its lower part best at its first row, (65,
    20); that box's 8 x 8 pixels are copied to (65, 276) in strip (1, 1) and
    to (100, 300) later in the same strip: an exact tie between two strips,
    which the fold must give to the smaller (y, x), (65, 20), and a tie
    inside strip (1, 1), which its block must give to its first position.
    Byte (0, 0) is odd in frame 0 and even in frame 1, so the refetch takes
    both of its branches (the probe's own input takes only the second)."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 32, (2, PAD_H, PAD_W), np.uint8)
    frames[0, 47:55, 127:135] = 255
    frames[1, 60:68, 20:28] = 255
    patch = frames[1, 65:73, 20:28].copy()
    frames[1, 65:73, 276:284] = patch
    frames[1, 100:108, 300:308] = patch
    frames[:, 0, 0] = (1, 2)
    return frames


def _oracle_strips(frames: np.ndarray, exact: bool = False) -> np.ndarray:
    oracle = _oracle_best_exact if exact else _oracle_best
    return np.array([oracle(frames[t], strips_of(t)) for t in range(len(frames))],
                    dtype=np.float64)


def _oracle_refetch(frames: np.ndarray) -> np.ndarray:
    out = []
    for fr in frames.astype(np.int64):
        a = fr[:SLAB_H, :SLAB_W].sum()
        b = fr[SLAB_H : 2 * SLAB_H, SLAB_W : 2 * SLAB_W].sum() if fr[0, 0] % 2 == 1 else a
        out.append((a, b))
    return np.array(out, dtype=np.float64)


def check_strips(name: str, got: np.ndarray, want: np.ndarray) -> float:
    """(value, y, x) rows against a reference: value within VALUE_RTOL
    relative, (y, x) exactly.  Returns the largest relative value difference;
    raises AssertionError on a mismatch."""
    rel = float(np.max(np.abs(got[:, 0] - want[:, 0]) / np.abs(want[:, 0])))
    if not (rel <= VALUE_RTOL and np.array_equal(got[:, 1:], want[:, 1:])):
        raise AssertionError(f"{name}: {got.tolist()} vs {want.tolist()}")
    return rel


def check_refetch(name: str, got: np.ndarray, want: np.ndarray) -> float:
    """(s0, s1) rows against a reference, exactly.  Returns 0.0."""
    if not np.array_equal(got, want):
        raise AssertionError(f"{name}: {got.tolist()} vs {want.tolist()}")
    return 0.0


def run_probe(name: str, frames: np.ndarray, device) -> dict:
    """One probe on `device`: the strip search of `frames` (not for
    `when_refetch`) and the refetch (for `when_refetch` and the border clip),
    each against the numpy oracle and the plain version.  The border clip's
    ties are held to the exact oracle, `_oracle_best_exact`.  Returns
    {"probe", "got": {kernel: output}, "max_rel_err", "max_abs_err": {kernel:
    largest difference from the plain version}}; raises on a mismatch."""
    x = torch.from_numpy(frames).to(device)
    cases = []
    if name != "when_refetch":
        cases.append((strip_best, strip_best_reference, check_strips,
                      _oracle_strips(frames, exact=name == "border_clip")))
    if name in ("when_refetch", "border_clip"):
        cases.append((slab_refetch, slab_refetch_reference, check_refetch,
                      _oracle_refetch(frames)))
    got, err, abs_err = {}, 0.0, {}
    for fn, plain, check, want in cases:
        out = fn(x).cpu().numpy().astype(np.float64)
        ref = plain(x.cpu()).numpy().astype(np.float64)
        err = max(err, check(f"{name}, {fn.__name__} vs the numpy oracle", out, want),
                  check(f"{name}, {fn.__name__} vs the plain version", out, ref))
        got[fn.__name__] = out.tolist()
        abs_err[fn.__name__] = float(np.abs(out - ref).max())
    return {"probe": name, "got": got, "max_rel_err": err, "max_abs_err": abs_err}


PROBES = (("when_fori_dma", 7), ("dyn_fori_dma", 7), ("when_refetch", 8), ("border_clip", None))


def probe_inputs() -> list:
    """(probe name, frames) for every probe the entry point runs."""
    return [(name, border_clip() if seed is None else probe_frames(seed))
            for name, seed in PROBES]


def device_us(fn, frames: torch.Tensor, repeats: int = 200) -> float:
    """Device microseconds a call between CUDA events, after one warm call."""
    fn(frames)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn(frames)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / repeats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions, no time)")
    args = ap.parse_args(argv)
    device = torch.device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("global_strip_probe: no CUDA device (pass --device cpu for the plain versions)",
              file=sys.stderr)
        return 1
    ok = True
    for name, frames in probe_inputs():
        print(f"--- probe: {name}", flush=True)
        try:
            res = run_probe(name, frames, device)
            print(f"PASS {name}: {res['got']} (max relative value error {res['max_rel_err']:.3g})",
                  flush=True)
        except Exception as e:  # report every probe, then fail
            ok = False
            print(f"FAIL {name}: {type(e).__name__}: {str(e)[:2000]}")
            print("\n".join(traceback.format_exc(limit=10).splitlines()[-10:]), flush=True)
    if device.type == "cuda":
        print(json.dumps({
            "strip_best_us": device_us(strip_best, torch.from_numpy(probe_frames(7)).to(device)),
            "slab_refetch_us": device_us(slab_refetch,
                                         torch.from_numpy(probe_frames(8)).to(device)),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
