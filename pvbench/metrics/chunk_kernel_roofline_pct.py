"""chunk_kernel_roofline_pct: the least time the card could take for the
traced span's frame steps (pvbench/roofline.py: operations at the FP32 peak
or bytes at HBM's rate, whichever is larger) over the chunk kernel's device
time in torch.profiler's records of them."""

UNIT = "%"
LAYER = "chunk kernel: csrc/mega_body.cuh via ops/ncc_mega.py"
MOVES = "track_fps"


def read(run):
    t = run.trace
    if not t or t["kernel_us"] <= 0:
        return None
    return 100.0 * t["bound_ms"] * 1e3 / t["kernel_us"]
