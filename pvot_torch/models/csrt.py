"""CPU black-box baseline: OpenCV TrackerCSRT (baseline B1), a copy of
pvot/models/csrt.py.

Copied, not imported (importing `pvot` imports JAX).  The equivalent of the
reference's baseline_cpu/cpub.cpp: OpenCV's CSRT used as a black box,
wrapped with per-stage timing (track/draw/write totals, cpub.cpp:101-148)
and the raw-frame cache loader (cpub.cpp loadCachedVideo; format in
pvot_torch.io.video.load_cached_video).  A comparison baseline on the host
CPU, no tensor and no card, exactly as in the reference.  OpenCV is
imported only when a function runs: the card's machine has none.

Reference quirk intentionally NOT reproduced: cpub.cpp:192-193 skips
`runTracking` entirely when the frame cache loads (a bug: the timing run
then measures nothing); here tracking always runs.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from pvot_torch.utils.timing import StageTimer


def _create_csrt():
    """CSRT when the OpenCV build has it (contrib), else the closest
    available classical black-box tracker (MIL) with a notice: the
    baseline's role is 'OpenCV black box to compare against', not CSRT
    specifically."""
    import cv2

    if hasattr(cv2, "TrackerCSRT_create"):
        return cv2.TrackerCSRT_create(), "CSRT"
    if hasattr(cv2, "legacy") and hasattr(cv2.legacy, "TrackerCSRT_create"):
        return cv2.legacy.TrackerCSRT_create(), "CSRT"
    if hasattr(cv2, "TrackerMIL_create"):
        import sys

        print(
            "pvot_torch: OpenCV build lacks TrackerCSRT; using TrackerMIL as the "
            "black-box baseline",
            file=sys.stderr,
        )
        return cv2.TrackerMIL_create(), "MIL"
    raise RuntimeError("OpenCV build lacks TrackerCSRT and TrackerMIL")


def track_video_csrt(
    frames_bgr: np.ndarray,
    roi: Tuple[int, int, int, int],
    writer=None,
    draw: bool = True,
) -> Tuple[np.ndarray, StageTimer]:
    """Track (F, H, W, 3) uint8 BGR frames with CSRT from `roi` on frame 0.

    Returns (bboxes (F-1, 4) int32, stage timer with the track/draw/write
    breakdown).  Mirrors cpub.cpp runTracking: update per frame; on failure
    the previous box is kept.
    """
    import cv2

    tracker, _kind = _create_csrt()
    tracker.init(frames_bgr[0], tuple(int(v) for v in roi))
    timer = StageTimer()
    bboxes: List[Tuple[int, int, int, int]] = []
    bbox = tuple(int(v) for v in roi)
    for i in range(1, len(frames_bgr)):
        frame = frames_bgr[i]
        with timer.stage("track"):
            ok, new_bbox = tracker.update(frame)
            if ok:
                bbox = tuple(int(v) for v in new_bbox)
        bboxes.append(bbox)
        if draw and (writer is not None):
            with timer.stage("draw"):
                x, y, w, h = bbox
                cv2.rectangle(frame, (x, y), (x + w, y + h), (255, 0, 0), 2)
            with timer.stage("write"):
                writer.write(frame)
    return np.asarray(bboxes, np.int32), timer


def load_or_decode(video_path: str, cache_path: Optional[str] = None):
    """cpub.cpp's load flow: try the raw-frame cache, else decode the video
    (and optionally populate the cache)."""
    from pvot_torch.io.video import VideoReader, load_cached_video, save_cached_video

    if cache_path:
        cached = load_cached_video(cache_path)
        if cached is not None:
            return cached
    with VideoReader(video_path) as r:
        frames = np.stack(list(r))
    if cache_path:
        save_cached_video(cache_path, frames)
    return frames
