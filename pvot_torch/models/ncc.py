"""High-level NCC tracker (pvot/models/ncc.py `NccTracker`): construct from the
first frame and a ROI, call `update(frame)` per frame or `track(frames)` for
a clip; `save` / `load` checkpoint the state in the JAX package's format.

A new tracker's state goes to `device` (default: the current CUDA device;
the CPU only as `device="cpu"`); a given state stays on its device unless
`device` names another.  The tracker runs the backend and strategy it was
built with, for both `update` and `track`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pvot_torch.config import TrackerConfig
from pvot_torch.tracker.state import StepOutput, TrackerState


def _gray(frame) -> np.ndarray:
    frame = np.asarray(frame)
    if frame.ndim == 3:
        from pvot_torch.io.gray import bgr_to_gray_u8

        frame = bgr_to_gray_u8(frame)
    return frame


class NccTracker:
    """Single-object NCC template tracker.

    >>> tracker = NccTracker(first_frame_gray_u8, roi=(x, y, w, h))
    >>> for frame in frames:
    ...     bbox, score = tracker.update(frame)
    """

    def __init__(
        self,
        first_frame,
        roi: Tuple[int, int, int, int],
        config: TrackerConfig = TrackerConfig(),
        strategy: str = "fused",
        backend: str = "xla",
        state: Optional[TrackerState] = None,
        device=None,
    ):
        from pvot_torch.io.gray import gray_u8_to_f32
        from pvot_torch.tracker.state import init_state
        from pvot_torch.tracker.step import cached_step, carry_from_state

        first_frame = _gray(first_frame)
        self.frame_shape = tuple(first_frame.shape)
        self.config = config.validate()
        self.strategy, self.backend = strategy, backend
        if state is None:
            x, y, w, h = (int(v) for v in roi)
            templ = gray_u8_to_f32(first_frame)[y : y + h, x : x + w]
            state = init_state(templ, (x, y, w, h), device=device)
        elif device is not None:
            state = state.to(torch.device(device))
        self.device = state.template.device
        self._carry = carry_from_state(state)
        self._step = cached_step(self.frame_shape, tuple(state.template.shape), self.config,
                                 strategy, backend)

    @property
    def state(self) -> TrackerState:
        from pvot_torch.tracker.step import state_from_carry

        return state_from_carry(self._carry)

    @property
    def bbox(self) -> Tuple[int, int, int, int]:
        return tuple(self._carry.bbox)

    def update(self, frame) -> Tuple[Tuple[int, int, int, int], float]:
        """Advance one frame: gray u8/f32 or BGR u8 (converted).  Returns
        (bbox, score)."""
        frame = torch.as_tensor(_gray(frame)).to(self.device)
        self._carry, (bbox, score, _, _) = self._step(self._carry, frame)
        return tuple(bbox), float(score)

    def track(self, frames, chunk_size: int = 32) -> StepOutput:
        """Track a whole clip (F, H, W) from the current state."""
        from pvot_torch.tracker.scan import track_video
        from pvot_torch.tracker.step import carry_from_state

        state, out = track_video(frames, self.state, self.config, self.strategy, self.backend,
                                 chunk_size=chunk_size)
        self._carry = carry_from_state(state)
        return out

    def save(self, path: str) -> str:
        from pvot_torch.utils.checkpoint import save_state

        return save_state(path, self.state)

    @classmethod
    def load(cls, path: str, frame_shape: Tuple[int, int],
             config: TrackerConfig = TrackerConfig(), device=None, **kwargs) -> "NccTracker":
        """A tracker resumed from a checkpoint of either package, on `device`."""
        from pvot_torch.utils.checkpoint import load_state

        state = load_state(path, device=device)
        th, tw = state.template.shape
        return cls(np.zeros(frame_shape, np.uint8), roi=(0, 0, tw, th), config=config,
                   state=state, device=device, **kwargs)
