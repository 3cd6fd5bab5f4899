"""Host-side video decode and encode: copies of pvot/io/video.py
`VideoReader`, `VideoWriter` and the raw-frame cache (`load_cached_video`,
`save_cached_video`, numpy only).

OpenCV is imported when a reader or writer opens, not when this module is
imported: the card's machine has no OpenCV, so it serves synthetic streams
only.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from pvot_torch.io.gray import bgr_to_gray_u8


class VideoReader:
    """Sequential frame reader yielding uint8 BGR frames (H, W, 3)."""

    def __init__(self, path: str):
        try:
            import cv2  # type: ignore
        except ImportError as e:
            raise RuntimeError("OpenCV is required for video decode") from e
        self._cv2 = cv2
        self._cap = cv2.VideoCapture(path)
        if not self._cap.isOpened():
            raise IOError(f"Cannot open video: {path}")
        self.path = path

    @property
    def fps(self) -> float:
        fps = self._cap.get(self._cv2.CAP_PROP_FPS)
        # Reference falls back to 30 fps when the container reports none
        # (tracker_ghc/src/main.cpp:327-328).
        return fps if fps and fps > 0 else 30.0

    @property
    def size(self) -> Tuple[int, int]:
        """(width, height)."""
        return (
            int(self._cap.get(self._cv2.CAP_PROP_FRAME_WIDTH)),
            int(self._cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT)),
        )

    def read(self) -> Optional[np.ndarray]:
        ok, frame = self._cap.read()
        return frame if ok else None

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def gray_frames(self) -> Iterator[np.ndarray]:
        """Yield uint8 grayscale frames."""
        for frame in self:
            yield bgr_to_gray_u8(frame)

    def close(self) -> None:
        self._cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VideoWriter:
    """Annotated-video writer with the reference's avc1 -> MJPG fallback
    (tracker_ghc/src/main.cpp:330-339)."""

    def __init__(self, path: str, fps: float, size: Tuple[int, int]):
        try:
            import cv2  # type: ignore
        except ImportError as e:
            raise RuntimeError("OpenCV is required for video encode") from e
        w, h = size
        self.path = path
        self._writer = None
        for fourcc_str in ("avc1", "MJPG", "mp4v"):
            writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc_str), fps, (w, h))
            if writer.isOpened():
                self._writer = writer
                self.fourcc = fourcc_str
                break
        if self._writer is None:
            raise IOError(f"Failed to open output video for writing: {path}")

    def write(self, frame_bgr: np.ndarray) -> None:
        self._writer.write(frame_bgr)

    def close(self) -> None:
        self._writer.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_cached_video(cache_path: str) -> Optional[np.ndarray]:
    """Raw-frame cache loader in the reference CPU baseline's format
    (baseline_cpu/cpub.cpp loadCachedVideo: an int32 width, height, type
    header, then raw frames).  Returns uint8 (N, H, W, C), or None when the
    file is absent or corrupt (pvot/io/video.py:113)."""
    import os
    import struct

    if not os.path.exists(cache_path):
        return None
    try:
        with open(cache_path, "rb") as f:
            header = f.read(12)
            if len(header) < 12:
                return None
            w, h, cv_type = struct.unpack("<iii", header)
            channels = (cv_type >> 3) + 1  # CV_MAKETYPE channel encoding
            frame_bytes = w * h * channels
            frames = []
            while True:
                buf = f.read(frame_bytes)
                if len(buf) < frame_bytes:
                    break
                frames.append(np.frombuffer(buf, np.uint8).reshape(h, w, channels).copy())
        return np.stack(frames) if frames else None
    except Exception:
        return None


def save_cached_video(cache_path: str, frames: np.ndarray) -> None:
    """Writer of the raw-frame cache format (load_cached_video;
    pvot/io/video.py:143)."""
    import struct

    if frames.ndim == 3:
        frames = frames[..., None]
    n, h, w, c = frames.shape
    cv_type = (c - 1) << 3  # CV_8UC{c}
    with open(cache_path, "wb") as f:
        f.write(struct.pack("<iii", w, h, cv_type))
        for i in range(n):
            f.write(frames[i].astype(np.uint8).tobytes())
