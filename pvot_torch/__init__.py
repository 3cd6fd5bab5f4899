"""pvot_torch — the PyTorch / CUDA (Hopper) port of pvot.

Imports torch and never JAX or the `pvot` package.  Importing it builds and
loads no kernel: the CUDA sources in pvot_torch/csrc build at their first
launch (pvot_torch.ops._build).  The serving entry points load lazily, as
pvot/__init__.py:31-64 does.
"""

from pvot_torch.config import DEFAULT_CONFIG, WINDOWS_TREE_CONFIG, TrackerConfig
from pvot_torch.tracker.mega import track_video_mega
from pvot_torch.tracker.scan import track_video, track_video_batched
from pvot_torch.tracker.state import StepOutput, TrackerState, init_state
from pvot_torch.tracker.step import make_step

__version__ = "0.1.0"

__all__ = [
    "TrackerConfig",
    "DEFAULT_CONFIG",
    "WINDOWS_TREE_CONFIG",
    "TrackerState",
    "StepOutput",
    "init_state",
    "make_step",
    "track_video",
    "track_video_batched",
    "track_video_mega",
    "track_streams_mega",
    "track_objects_mega",
    "serve_streams",
    "serve_streams_grouped",
    "serve_objects",
    "track_video_multi",
    "track_stream",
    "NccTracker",
]


def __getattr__(name):  # lazy heavyweight entry points
    if name == "track_streams_mega":
        from pvot_torch.tracker.mega import track_streams_mega

        return track_streams_mega
    if name == "track_objects_mega":
        from pvot_torch.tracker.mega import track_objects_mega

        return track_objects_mega
    if name == "serve_streams":
        from pvot_torch.io.serving import serve_streams

        return serve_streams
    if name == "serve_streams_grouped":
        from pvot_torch.io.serving import serve_streams_grouped

        return serve_streams_grouped
    if name == "serve_objects":
        from pvot_torch.io.serving import serve_objects

        return serve_objects
    if name == "track_video_multi":
        from pvot_torch.parallel.multi import track_video_multi

        return track_video_multi
    if name == "track_stream":
        from pvot_torch.io.pipeline import track_stream

        return track_stream
    if name == "NccTracker":
        from pvot_torch.models.ncc import NccTracker

        return NccTracker
    raise AttributeError(f"module 'pvot_torch' has no attribute {name!r}")
