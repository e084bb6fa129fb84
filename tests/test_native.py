"""The native library loader builds the library from source when it is
missing, and again when the source is newer."""

import ctypes
import os
import shutil

import pytest

from cmfem_tpu import native


@pytest.fixture
def native_copy(tmp_path):
    for f in ("Makefile", "cmfem_native.cpp"):
        shutil.copy(os.path.join(native._NATIVE_DIR, f), tmp_path)
    return tmp_path


@pytest.mark.parametrize("state", ["missing", "stale", "makefile-newer"])
def test_loader_rebuilds(native_copy, state):
    lib = native_copy / "libcmfem_native.so"
    src = native_copy / "cmfem_native.cpp"
    mk = native_copy / "Makefile"
    if state != "missing":
        lib.write_bytes(b"not a library")
        t = os.path.getmtime(src)
        os.utime(lib, (t - 60, t - 60))
        if state == "makefile-newer":
            os.utime(src, (t - 120, t - 120))
            assert os.path.getmtime(mk) > os.path.getmtime(lib)
    assert native.is_stale(str(native_copy))
    path = native.build_native(str(native_copy))
    assert path == str(lib)
    assert not native.is_stale(str(native_copy))
    assert hasattr(ctypes.CDLL(path), "gmsh_open")
    assert not [f for f in os.listdir(native_copy) if f.endswith(".tmp")]
