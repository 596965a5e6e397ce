"""Build and load the CUDA kernels (``csrc/*.cu``).

At first use each source (``tb_fused.cu``: K1, ``tail_fused.cu``: K2 and
K4, ``dc_band.cu``: K3; all include ``genasm_common.cuh``) is compiled by
its own ``nvcc``, all started together, and the objects are linked into one
shared library with a plain C interface (no PyTorch headers, so the build
takes seconds to a minute) under ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of the sources and the flags, so an edited
source rebuilds.  The library is loaded with ``ctypes``; pointers and the
stream pass as ``c_void_p``, integers as ``c_int``.  ``ptxas``'s report
(registers, spills per kernel) is kept beside the library, with the
seconds each source took.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(CSRC / f"{name}.cu"
                for name in ("tb_fused", "tail_fused", "dc_band"))
HEADERS = (CSRC / "genasm_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))

_P, _I = ctypes.c_void_p, ctypes.c_int
#: argument types of each C entry point: pointers, then ints, then the
#: block geometry (K1: lanes, threads, shared bytes; K2/K4: lanes,
#: threads, placement, shared bytes; K3: lanes, threads, placement, chunk,
#: shared bytes) and the stream; the occupancy
#: queries: ints, then the results' pointers
_SIGNATURES = {
    "genasm_tb_fused_launch": [_P] * 4 + [_I] * 10 + [_I] * 3 + [_P],
    "genasm_tb_fused_occupancy": [_I] * 5 + [_P] * 2,
    "genasm_tail_banded_launch": [_P] * 7 + [_I] * 10 + [_I] * 4 + [_P],
    "genasm_tail_full_launch": [_P] * 7 + [_I] * 10 + [_I] * 4 + [_P],
    "genasm_tail_occupancy": [_I] * 6 + [_P] * 2,
    "genasm_dc_band_launch": [_P] * 5 + [_I] * 7 + [_I] * 5 + [_P],
    "genasm_dc_band_occupancy": [_I] * 6 + [_P] * 2,
}

_library: ctypes.CDLL | None = None
#: one build and load per process, however many threads ask at once
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the CUDA kernels are built from source at first "
                           "use")
    return nvcc


def library_path() -> Path:
    blob = b"".join(p.read_bytes() for p in (*SOURCES, *HEADERS))
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"libgenasm_{digest}.so"


def compile_sources(sources, out_dir: Path, flags=NVCC_FLAGS) -> dict:
    """Compile each source into an object in `out_dir`, one ``nvcc`` each,
    all started together.  Returns {source name: (object, nvcc's output,
    seconds)}; raises if any fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        obj = out_dir / f"{Path(src).stem}.{os.getpid()}.o"
        procs[Path(src).name] = (obj, time.perf_counter(), subprocess.Popen(
            [_nvcc(), *flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    done, failed = {}, []
    for name, (obj, start, proc) in procs.items():
        log = proc.communicate()[0]
        done[name] = (obj, log, time.perf_counter() - start)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} ({proc.returncode}):\n"
                          f"{log}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def link(objects, lib: Path) -> None:
    """Link `objects` into the shared library `lib` (atomically: a
    concurrent build sees all of it or none)."""
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                           *map(str, objects)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)


def build() -> Path:
    """Compile the library unless this source's build exists; return it."""
    lib = library_path()
    if lib.exists():
        return lib
    built = compile_sources(SOURCES, BUILD_DIR)
    report = "".join(f"== {name}: {sec:.2f} s\n{log}"
                     for name, (_, log, sec) in built.items())
    ptxas_report(lib).write_text(report)
    link([obj for obj, _, _ in built.values()], lib)
    for obj, _, _ in built.values():
        obj.unlink()
    return lib


def ptxas_report(lib: Path | None = None) -> Path:
    """Where ``-Xptxas -v``'s output of the build of ``lib`` is kept, each
    unit's part headed ``== name: seconds``."""
    return (lib or library_path()).with_suffix(".ptxas.txt")


def _open(path: Path) -> ctypes.CDLL:
    """Load the library at `path` and declare its entry points' types."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.genasm_error_string.argtypes = [ctypes.c_int]
    lib.genasm_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed.  Thread-safe: the
    first caller builds and loads under a lock, the others wait for it (a
    session's dispatch and retire threads may both get here first)."""
    global _library
    with _LOAD_LOCK:
        if _library is None:
            _library = _open(build())
    return _library
