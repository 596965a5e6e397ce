"""Build and load the CUDA kernels (``csrc/genasm_fused.cu``).

At first use the source is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so the build takes seconds) under
``build/repro_torch_kernels/`` at the root of the checkout, named by a hash
of the source and the flags, so an edited source rebuilds.  The library is
loaded with ``ctypes``; pointers and the stream pass as ``c_void_p``,
integers as ``c_int``.  ``ptxas``'s report (registers, spills per kernel)
is kept beside the library.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "csrc" / "genasm_fused.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: argument types of each C entry point: pointers, then ints, then the
#: block geometry (threads per block; K1: lanes, threads, shared bytes) and
#: the stream; K1's occupancy query: ints, then the results' pointers
_SIGNATURES = {
    "genasm_tb_fused_launch": [_P] * 4 + [_I] * 10 + [_I] * 3 + [_P],
    "genasm_tb_fused_occupancy": [_I] * 5 + [_P] * 2,
    "genasm_tail_banded_launch": [_P] * 7 + [_I] * 10 + [_I, _P],
    "genasm_tail_full_launch": [_P] * 7 + [_I] * 10 + [_I, _P],
    "genasm_dc_band_launch": [_P] * 5 + [_I] * 7 + [_I, _P],
}

_library: ctypes.CDLL | None = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels are built from source at first "
                           "use")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS)
                            .encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgenasm_fused_{digest}.so"


def build() -> Path:
    """Compile the library unless this source's build exists; return it."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    ptxas_report(lib).write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)        # atomic: a concurrent build sees all or none
    return lib


def ptxas_report(lib: Path | None = None) -> Path:
    """Where ``-Xptxas -v``'s output of the build of ``lib`` is kept."""
    return (lib or library_path()).with_suffix(".ptxas.txt")


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.genasm_error_string.argtypes = [ctypes.c_int]
        lib.genasm_error_string.restype = ctypes.c_char_p
        _library = lib
    return _library
