"""The native host library's build (pvot_torch/runtime/native.py): where the
compiler refuses -fopenmp (no libgomp.spec), make runs once more with
-fopenmp-simd, and the library it builds exports every entry point."""

import ctypes
import shutil
import stat

import pytest

from pvot_torch.runtime import native

ENTRY_POINTS = ["pvot_bgr_to_gray_u8", "pvot_bgr_to_gray_u8_batch", "pvot_gray_u8_to_f32",
                "pvot_ncc_match_f32", "pvot_ring_create", "pvot_ring_destroy",
                "pvot_ring_size", "pvot_ring_push", "pvot_ring_pop"]


def _no_libgomp_cxx(tmp_path):
    """A compiler that fails on -fopenmp as g++ does without libgomp.spec."""
    path = tmp_path / "cxx"
    path.write_text(
        "#!/bin/sh\n"
        "for a in \"$@\"; do\n"
        "  if [ \"$a\" = -fopenmp ]; then\n"
        "    echo \"g++: fatal error: cannot read spec file 'libgomp.spec'\" >&2; exit 1\n"
        "  fi\n"
        "done\n"
        f"exec {shutil.which('g++')} \"$@\"\n")
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.mark.skipif(shutil.which("g++") is None or shutil.which("make") is None,
                    reason="no g++ or make on this machine")
def test_build_retries_with_openmp_simd(tmp_path, monkeypatch):
    out = tmp_path / "out"
    monkeypatch.setenv("CXX", _no_libgomp_cxx(tmp_path))
    path, kind = native._build(str(out))
    assert (path, kind) == (str(out / "libpvot_simd.so"), "fopenmp-simd")
    assert not (out / "libpvot.so").exists()
    lib = ctypes.CDLL(path)
    assert [name for name in ENTRY_POINTS if not hasattr(lib, name)] == []
    # The next build finds the simd library fresh; the repo's build/ is untouched.
    assert native._build(str(out)) == (path, kind)
    monkeypatch.delenv("CXX")
    assert native._build(str(out)) == (str(out / "libpvot.so"), "fopenmp")


def test_build_info_names_the_build():
    info = native.build_info()
    assert set(info) == {"built", "openmp"}
    if info["built"]:
        assert info["openmp"] in ("fopenmp", "fopenmp-simd")
    else:
        assert info["openmp"] is None


def test_frame_pipeline_names_its_ring():
    import numpy as np

    from pvot_torch.io.pipeline import FramePipeline

    frames = [np.full((4, 6), i, np.uint8) for i in range(3)]
    native_pipe = FramePipeline(iter(frames), (4, 6), chunk_size=2)
    python_pipe = FramePipeline(iter(frames), (4, 6), chunk_size=2, use_native=False)
    try:
        assert native_pipe.ring == ("native" if native.available() else "python")
        assert python_pipe.ring == "python"
        for pipe in (native_pipe, python_pipe):
            assert [n for _, n in pipe.chunks()] == [2, 1]
    finally:
        native_pipe.close()
        python_pipe.close()
