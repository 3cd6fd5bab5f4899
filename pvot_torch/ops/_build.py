"""Build the port's CUDA sources at first use and bind them with ctypes.

`nvcc` compiles every pvot_torch/csrc/*.cu into one shared library with a
plain C interface, for sm_90a, under build/pvot_torch/ at the root of the
checkout (listed in .gitignore).  The file name carries a hash of the
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
build_info: dict = {}  # seconds, path and compiler output of this process's load

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "pvot_mega_track_chunk": (
        [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I,
         _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
        ctypes.c_int,
    ),
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
    """Compile the sources unless the library for their hash exists."""
    out = library_path()
    if out.exists():
        build_info.update(seconds=0.0, path=str(out), log="(cached)")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources() if s.suffix == ".cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    build_info.update(seconds=seconds, path=str(out), log=log)
    return out


def load_library() -> ctypes.CDLL:
    """The bound library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
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
