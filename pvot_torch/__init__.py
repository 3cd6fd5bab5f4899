"""pvot_torch — the PyTorch / CUDA (Hopper) port of pvot.

Imports torch and never JAX or the `pvot` package.  Importing it builds and
loads no kernel: the CUDA sources in pvot_torch/csrc build at their first
launch (pvot_torch.ops._build).
"""

from pvot_torch.config import TrackerConfig
from pvot_torch.tracker.mega import track_video_mega
from pvot_torch.tracker.scan import track_video
from pvot_torch.tracker.state import StepOutput, TrackerState, init_state

__all__ = [
    "TrackerConfig",
    "TrackerState",
    "StepOutput",
    "init_state",
    "track_video",
    "track_video_mega",
]
