"""How `correct` is decided: the program's records and final state against
the plain reference (pvbench/reference) and the boxes the scene expects.

A run's records are checked in three ways, after the window has closed:

* every tracker-frame's box against the box a correct tracker reports
  (`off_truth`), and every tracker-frame handed to the program has a record
  (`missing`).  That box is the scene's (pvbench/traffic/scene.py,
  `expected`): the target's box on a frame where it is visible; on a frame
  where the mix's `occlusion` hides it, the box of the last frame where it
  was visible, which the tracker holds since nothing in a hidden frame
  passes its gates (NCC of order 1/sqrt(th * tw) against min_confidence and
  global_confidence); the first visible frame after a hidden interval,
  longer than the lost threshold, is searched globally and lands on the
  target exactly;
* sampled units (calls or chunks, drawn from the seed, always with the first
  unit, the first timed unit and the last) are replayed by the reference,
  frame by frame with its own searches, gates and template updates, from the
  state it reaches at the unit's start; the records are compared field by
  field (`records_differ`: boxes, `updated`, `used_global`) and by score
  (`score_gap`, the widest gap);
* the state at a unit's start is the reference's own for the first unit (its
  template cut from the frame before), and for a later one the reference's
  template update (the float32 EMA) applied along the program's records,
  with the lost count and the global flag worked out the same way.  That
  follow also runs to the end, and the program's final carried state must
  equal it bit for bit (`state_differ`: boxes, lost counts, global flags
  and template pixels).

Limits come from the cell's file (`limits`), never from here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from pvbench.reference import tracker as ref

_FOLLOW_BLOCK = 256  # frames whose patches are gathered at once


def sample_units(units: Sequence[Tuple[int, int]], first_timed: int, n: int,
                 seed: int) -> List[int]:
    """Indices of the units to replay: the first, the first timed one, the
    last, and others drawn from the seed, n in all (or every unit)."""
    keep = {0, min(first_timed, len(units) - 1), len(units) - 1}
    rest = [i for i in range(len(units)) if i not in keep]
    rng = np.random.default_rng([int(seed) % (2**63), 0x5EED])
    extra = max(0, min(n - len(keep), len(rest)))
    if extra:
        keep.update(int(i) for i in rng.choice(rest, size=extra, replace=False))
    return sorted(keep)


def _outside(b: np.ndarray, frame_w: int, frame_h: int) -> np.ndarray:
    """is_outside over boxes (..., 4)."""
    bx, by, bw, bh = (b[..., i] for i in range(4))
    cx, cy = bx + bw // 2, by + bh // 2
    return ((cx < 0) | (cx >= frame_w) | (cy < 0) | (cy >= frame_h)
            | (bx + bw < 0) | (bx >= frame_w) | (by + bh < 0) | (by >= frame_h))


def follow(p: ref.Params, patches: Callable, init: List[ref.Lane], records: np.ndarray,
           starts: Sequence[int]) -> Tuple[Dict[int, List[ref.Lane]], List[ref.Lane]]:
    """The reference's state along the program's records (T, L, 7): the EMA of
    each frame whose record says updated with a score at the strong gate,
    with the patch at the record's box, and the lost count and global flag of
    the records' accepts.  patches(ts, xy) gives the uint8 patches (n, L, th,
    tw) at boxes' corners xy (n, L, 2) of frames ts.  Returns the lanes' state
    at each frame in `starts` (before it) and at the end."""
    n_t, n_l = records.shape[:2]
    bbox = np.rint(records[..., :4]).astype(np.int64)
    updated = records[..., 5] != 0
    strong = updated & (records[..., 4].astype(np.float32) >= np.float32(p.strong_confidence))
    prev = np.concatenate([np.array([ln.bbox for ln in init], np.int64)[None], bbox[:-1]])
    lost = np.zeros((n_t + 1, n_l), np.int64)
    useg = np.zeros((n_t + 1, n_l), bool)
    lost[0] = [ln.lost for ln in init]
    useg[0] = [ln.use_global for ln in init]
    if not (updated.all() and lost[0].max(initial=0) == 0 and not useg[0].any()
            and not _outside(bbox, p.frame_w, p.frame_h).any()
            and not _outside(prev[:1], p.frame_w, p.frame_h).any()):
        out_prev = _outside(prev, p.frame_w, p.frame_h)
        out_now = _outside(bbox, p.frame_w, p.frame_h)
        for t in range(n_t):
            ug = p.enable_global_search & (useg[t] | out_prev[t]
                                           | (lost[t] >= p.lost_frame_threshold))
            lost[t + 1] = np.where(updated[t], 0, lost[t] + 1)
            useg[t + 1] = ug & ~(updated[t] & ~out_now[t])
    tpl = torch.stack([ln.template for ln in init]).clone()
    a, b = ref.f32(1.0 - p.template_update_lr), ref.f32(p.template_update_lr)
    want = set(starts)
    at: Dict[int, List[ref.Lane]] = {}

    def snapshot(t):
        return [ref.Lane([int(v) for v in prev[t, l]], tpl[l].clone(), int(lost[t, l]),
                         bool(useg[t, l])) for l in range(n_l)]

    for t0 in range(0, n_t, _FOLLOW_BLOCK):
        ts = np.arange(t0, min(n_t, t0 + _FOLLOW_BLOCK))
        part = (patches(ts, bbox[ts, :, :2]).to(torch.float32) * ref.U8_SCALE) * b
        mask = torch.as_tensor(strong[ts], device=tpl.device)
        for i, t in enumerate(ts.tolist()):
            if t in want:
                at[t] = snapshot(t)
            if strong[t].any():
                new = tpl * a + part[i]
                tpl = new if strong[t].all() else torch.where(mask[i][:, None, None], new, tpl)
    end = [ref.Lane([int(v) for v in (bbox[-1, l] if n_t else prev[0, l])], tpl[l].clone(),
                    int(lost[n_t, l]), bool(useg[n_t, l])) for l in range(n_l)]
    return at, end


def judge(p: ref.Params, frames_at: Callable, patches: Callable, truth: np.ndarray,
          init: List[ref.Lane], records: np.ndarray, units: Sequence[Tuple[int, int]],
          first_timed: int, final, n_units: int, seed: int, missing: int) -> dict:
    """The numbers compared.  frames_at(t) gives frame t's (L, H, W) uint8 on
    the reference's device; truth (T, L, 4) the boxes the scene expects of the
    recorded frames; records (T, L, 7); units the program's (first frame,
    frames) in order; final the program's final (bbox (L, 4), template (L,
    th, tw), lost (L,), use_global (L,))."""
    bbox = np.rint(records[..., :4]).astype(np.int64)
    nums = {"missing": int(missing),
            "off_truth": int((bbox != truth).any(axis=-1).sum())}
    picked = sample_units(units, first_timed, n_units, seed)
    starts = [units[i][0] for i in picked]
    at, end = follow(p, patches, init, records, starts)
    differ, gap, ref_off = 0, 0.0, 0
    for i in picked:
        t0, n = units[i]
        lanes = [ln.copy() for ln in at[t0]]
        mine = ref.track(lambda k: frames_at(t0 + k), n, lanes, p)
        theirs = records[t0 : t0 + n]
        same = ((np.rint(mine[..., :4]) == np.rint(theirs[..., :4])).all(axis=-1)
                & (mine[..., 5] == theirs[..., 5]) & (mine[..., 6] == theirs[..., 6]))
        differ += int((~same).sum())
        gap = max(gap, float(np.abs(mine[..., 4].astype(np.float32)
                                    - theirs[..., 4].astype(np.float32)).max(initial=0.0)))
        ref_off += int((np.rint(mine[..., :4]) != truth[t0 : t0 + n]).any(axis=-1).sum())
    nums["records_differ"] = differ
    nums["score_gap"] = gap
    f_box, f_tpl, f_lost, f_useg = final
    want_tpl = torch.stack([ln.template for ln in end]).to(f_tpl.device)
    nums["state_differ"] = int(
        (np.asarray(f_box) != np.array([ln.bbox for ln in end])).sum()
        + (np.asarray(f_lost) != np.array([ln.lost for ln in end])).sum()
        + (np.asarray(f_useg) != np.array([ln.use_global for ln in end])).sum()
        + int((f_tpl.to(torch.float32) != want_tpl).sum()))
    info = {"units_replayed": len(picked), "frames_replayed": sum(units[i][1] for i in picked),
            "reference_off_truth": ref_off, "records": int(records.shape[0] * records.shape[1]),
            "used_global": int((records[..., 6] != 0).sum())}
    return {"numbers": nums, "info": info}


def verdict(numbers: dict, limits: dict) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number within its limit;
    a number without a limit, or a limit without a number, is not correct."""
    checks = {k: {"value": numbers.get(k), "limit": limits.get(k)}
              for k in sorted(set(numbers) | set(limits))}
    ok = all(c["value"] is not None and c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
