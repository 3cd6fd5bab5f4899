"""chunk_kernel_us_per_step: the chunk kernel's device time in the traced
span over its frame steps (one step is one frame of all lanes)."""

UNIT = "us"
LAYER = "chunk kernel: csrc/mega_body.cuh via ops/ncc_mega.py"
MOVES = "track_fps"


def read(run):
    t = run.trace
    if not t or not t["steps"]:
        return None
    return t["kernel_us"] / t["steps"]
