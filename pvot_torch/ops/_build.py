"""Build the port's CUDA sources at first use and bind them with ctypes.

`nvcc` compiles every pvot_torch/csrc/*.cu for sm_90a, one process per
source, all started together, and links the objects into one shared library
with a plain C interface under build/pvot_torch/ at the root of the checkout
(listed in .gitignore).  The file name carries a hash of the
sources and flags, so an edited source builds anew and an unchanged one
loads the existing library.  Nothing builds when a module is imported; the
first call of `load_library()` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pvot_torch"
# No --use_fast_math: it changes division and sqrt, and the kernels are held
# to their plain versions on near-ties.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_info: dict = {}  # seconds, path and compiler output of this process's load

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# radii .. one_minus_lr, passes, batch, stream
_CONFIG = [_I, _I, _I, _I, _F, _F, _F, _F, _F, _I, _I, _P]
SIGNATURES = {
    # frames, n_frames, frame_h, frame_w, th, tw, state_i, state_f, tpl, state_i2,
    # state_f2, tpl2, work, n_blocks, rows, then the configuration
    "pvot_mega_track_chunk": (
        [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, *_CONFIG],
        ctypes.c_int,
    ),
    # frames, frame_stride, n_lanes, then as pvot_mega_track_chunk from n_frames
    # to the configuration, then the step clock (or null)
    "pvot_mega_track_chunk_multi": (
        [_P, _L, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, *_CONFIG, _P],
        ctypes.c_int,
    ),
    "pvot_mega_track_chunk_objects": (
        [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, *_CONFIG],
        ctypes.c_int,
    ),
    # rung, then pvot_mega_track_chunk's arguments
    "pvot_mega_breakdown_chunk": (
        [_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, *_CONFIG],
        ctypes.c_int,
    ),
    "pvot_mega_work_bytes": ([_I, _I], ctypes.c_longlong),
    "pvot_mega_stage_rows": ([_I, _I, _I], ctypes.c_int),
    # th, tw, n_lanes, passes, smem (int out) -> plan
    "pvot_mega_plan": ([_I, _I, _I, _I, _P], ctypes.c_int),
    # th, tw, n_lanes, ext, passes
    "pvot_mega_score_blocks_per_sm": ([_I, _I, _I, _I, _I], ctypes.c_int),
    # rung, th, tw, passes
    "pvot_mega_breakdown_blocks_per_sm": ([_I, _I, _I, _I], ctypes.c_int),
    # img, img_u8, img_h, img_w, row_stride, lane_stride, lanes, n_lanes, out_h,
    # out_w, tpl, tpl_stride, th, tw, t_mean, t_std, stat_stride, out, passes, stream
    "pvot_ncc_map": (
        [_P, _I, _I, _I, _L, _L, _P, _I, _I, _I, _P, _L, _I, _I, _P, _P, _I, _P, _I, _P],
        ctypes.c_int,
    ),
    # ... as pvot_ncc_map to out, then part_val, part_yx, done, passes, stream
    "pvot_ncc_region_argmax": (
        [_P, _I, _I, _I, _L, _L, _P, _I, _I, _I, _P, _L, _I, _I, _P, _P, _I, _P, _P, _P, _P,
         _I, _P],
        ctypes.c_int,
    ),
    "pvot_ncc_chunk_rows": ([_I, _I], ctypes.c_int),
    # th, tw, argmax, passes, smem (int out) -> tile height
    "pvot_ncc_plan": ([_I, _I, _I, _I, _P], ctypes.c_int),
    # frames, n_frames, part_val, part_yx, out, stream
    "pvot_strip_best": ([_P, _I, _P, _P, _P, _P], ctypes.c_int),
    # frames, n_frames, out, stream
    "pvot_slab_refetch": ([_P, _I, _P, _P], ctypes.c_int),
    # The probe catalogues' kernels (csrc/argmax_probe.cu, csrc/pallas_probe.cu).
    # x, n, mode, val, idx, fill, out_n, stream
    "pvot_probe_tile_reduce": ([_P, _I, _I, _P, _P, _I, _I, _P], ctypes.c_int),
    # op, x, scal, si, out, n, w, stream
    "pvot_probe_ew": ([_I, _P, _P, _I, _P, _I, _I, _P], ctypes.c_int),
    # a, lda, b, b_lo, b_kind, ldb, c, m, n, k, passes, tile_m, tile_n, groups, stage_k,
    # splits, k_split, ws, ws_floats, tickets, n_tickets, stream
    "pvot_probe_gemm": ([_P, _L, _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                         _L, _P, _I, _P], ctypes.c_int),
    # x, x_u8, fs, ld, src_h, src_w, off, ru, cu, nb, bstep, nk, kstep, rows, cols, band,
    # out, stream
    "pvot_probe_window": ([_P, _I, _L, _I, _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                           _P], ctypes.c_int),
    # x, steps, tile, inc, out, stream
    "pvot_probe_carry_sum": ([_P, _I, _I, _I, _P, _P], ctypes.c_int),
    # x, h, w, steps, rows, unit, out, stream
    "pvot_probe_offset_chain": ([_P, _I, _I, _I, _I, _I, _P, _P], ctypes.c_int),
    # a, b, n, steps, out, stream
    "pvot_probe_gated_gemm": ([_P, _P, _I, _I, _P, _P], ctypes.c_int),
    # x, h, w, y0, x0, rows, cols, steps, out, stream
    "pvot_probe_gated_copy": ([_P, _I, _I, _I, _I, _I, _I, _I, _P, _P], ctypes.c_int),
    # x, h, w, shifts, stride, out_h, bcast, out, stream
    "pvot_probe_roll": ([_P, _I, _I, _P, _I, _I, _I, _P, _P], ctypes.c_int),
    # w, w_rows, L, t, M, P, ty, tx, out, stream
    "pvot_probe_shear": ([_P, _I, _I, _P, _I, _I, _I, _I, _P, _P], ctypes.c_int),
    # img, img_rows, img_w, toep, n_k, L, tx, box, scal, out, gh, gw, stream
    "pvot_probe_toeplitz_ncc": ([_P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _I, _I, _P],
                                ctypes.c_int),
    "pvot_cuda_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpvot_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists: one
    nvcc per source, all at once, then one link.  `build_info["units"]`
    holds each source's compile seconds."""
    out = library_path()
    if out.exists():
        build_info.update(seconds=0.0, path=str(out), log="(cached)", units={})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        text = BUILD_DIR / f"{tag}.{src.stem}.txt"  # a file, so no pipe can fill
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        with open(text, "w") as sink:
            proc = subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT)
        jobs.append((src, cmd, obj, text, proc))
    units = {}
    while len(units) < len(jobs):
        for src, _, _, _, proc in jobs:
            if src.name not in units and proc.poll() is not None:
                units[src.name] = time.perf_counter() - t0
        time.sleep(0.05)
    log = ""
    failed = None
    for src, cmd, _, text, proc in jobs:
        out_text = text.read_text()
        text.unlink()
        log += f"== {src.name}\n{out_text}"  # the compiler's output, source by source
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out_text}"
    objs = [str(obj) for _, _, obj, _, _ in jobs]
    try:
        if failed:
            raise RuntimeError(failed)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-shared", "-o", str(tmp), *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    out.with_suffix(".log").write_text(log)
    build_info.update(seconds=seconds, path=str(out), log=log, units=units)
    return out


def load_library() -> ctypes.CDLL:
    """The bound library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a C entry point."""
    if err:
        msg = load_library().pvot_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
