"""Host C++ of the PyTorch port, built at first use and bound through ctypes.

Counterpart of ``presto_tpu/native/__init__.py``. ``libpcol`` is the PCOL
file format's data plane (mmap, write-time statistics and the range
pre-filters of the file connector's scan),
compiled from this package's own ``pcol.cpp`` with ``g++`` into the
git-ignored ``build/`` beside it; the reference's ``libpcol.so`` is never
loaded. It is host code, not a device kernel. The build goes to a temporary
name and is renamed into place, so processes that build at once never load
a half-written library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pcol.cpp")
_BUILD_DIR = os.path.join(_HERE, "build")
_SO = os.path.join(_BUILD_DIR, "libpcol.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# the first build or load failure, kept so later calls raise it at once
# instead of starting g++ again
_failure: Optional[BaseException] = None


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
    return _SO


def libpcol() -> ctypes.CDLL:
    """Load the native library, building it first if needed; raises when
    the toolchain fails (the PCOL reader then takes its numpy path). A
    failure is remembered: later calls raise it without a second build."""
    global _lib, _failure
    with _lock:
        if _failure is not None:
            raise _failure
        if _lib is None:
            try:
                lib = ctypes.CDLL(_build())
            except Exception as e:  # noqa: BLE001 - remembered, then raised
                _failure = e
                raise
            lib.pcol_open.restype = ctypes.c_void_p
            lib.pcol_open.argtypes = [ctypes.c_char_p]
            lib.pcol_length.restype = ctypes.c_uint64
            lib.pcol_length.argtypes = [ctypes.c_void_p]
            lib.pcol_data.restype = ctypes.POINTER(ctypes.c_uint8)
            lib.pcol_data.argtypes = [ctypes.c_void_p]
            lib.pcol_close.restype = None
            lib.pcol_close.argtypes = [ctypes.c_void_p]
            lib.pcol_stats_i64.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
            lib.pcol_stats_i32.argtypes = lib.pcol_stats_i64.argtypes
            lib.pcol_stats_i64.restype = lib.pcol_stats_i32.restype = None
            lib.pcol_stats_f64.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
            lib.pcol_stats_f64.restype = None
            lib.pcol_filter_range_i64.restype = ctypes.c_uint64
            lib.pcol_filter_range_i64.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p]
            lib.pcol_filter_range_i32.restype = ctypes.c_uint64
            lib.pcol_filter_range_i32.argtypes = lib.pcol_filter_range_i64.argtypes
            _lib = lib
    return _lib


def native_available() -> bool:
    try:
        libpcol()
        return True
    except Exception:  # noqa: BLE001 - any build or load failure means "no"
        return False
