"""Build and load the port's hand-written CUDA kernels.

The sources in this directory are compiled with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface (``kernels/build/``, git-ignored),
at first use, and loaded with ``ctypes``. The library's name carries a hash
of its source, so an edited source is rebuilt and a built one is reused.
Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR / "build"
SOURCE = "hash_table.cu"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # ht_insert(comps, mask, ncomps, n, slots, trips, slot_comps, slot_rows,
    #           gid, stats, claims, work, counts, stream)
    "ht_insert": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    # ht_insert_config(&grid_blocks, &block_threads, &tail_rows)
    "ht_insert_config": [_P, _P, _P],
    # ht_probe(slot_keys, slot_rows, slots, keys, mask, n, trips, out, stream)
    "ht_probe": [_P, _P, _I, _P, _P, _I, _I, _P, _P],
}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(source: str) -> Path:
    """Compile one source into BUILD_DIR (skipped when already built);
    returns the library path."""
    src = _DIR / source
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot make the kernel build directory {BUILD_DIR}: {e}") from e
    if not os.access(BUILD_DIR, os.W_OK):
        raise RuntimeError(f"the kernel build directory {BUILD_DIR} is not writable")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    (BUILD_DIR / f"{src.stem}.ptxas.txt").write_text(proc.stderr)
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded hash-table library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build(SOURCE)))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ht_error_string.argtypes = [ctypes.c_int]
            lib.ht_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({lib.ht_error_string(err).decode()})")
