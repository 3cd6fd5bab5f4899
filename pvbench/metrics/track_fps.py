"""track_fps: tracker-frames completed in the window over the window's
seconds (one a tracker a frame: S streams x F frames count S * F, K objects x
F frames K * F).  The window runs from the first timed frame handed to the
program to the last record readable on the host."""

UNIT = "frames/s"


def read(run):
    return run.tracker_frames / run.window_s
