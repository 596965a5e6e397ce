"""Build and load the CUDA kernels (``csrc/*.cu``).

At first use each source is compiled by its own ``nvcc``, all started
together: ``tb_fused.cu`` (K1), ``tail_fused.cu`` (K2 and K4) and
``dc_band.cu`` (K3), each with the C entry points and the kernel's
instantiations at NW = 1..4 (W <= 128); ``tb_fused_wide.cu``,
``tail_fused_wide.cu`` and ``dc_band_wide.cu``, the instantiations at NW =
5..8 (W = 129..256), which the entry points reach through
``k1_kernel_wide`` / ``tail_kernel_wide`` / ``k3_kernel_wide``; each pair
includes its kernel's body (``tb_fused.cuh``, ``tail_fused.cuh``,
``dc_band.cuh``, all three ``genasm_common.cuh``); ``tb_fused_xwide.cu``,
``tail_fused_xwide.cu`` and ``dc_band_xwide.cu``, the wide family at NW >=
9 (one kernel each, with entry points of their own, over
``genasm_xwide_reg.cuh``); ``ladder_graph.cu``, the rescue ladder's gate
kernel and its conditional graph.  The objects
are linked into one shared library with a plain C interface (no
PyTorch headers, so the build takes seconds to a minute) under ``build/repro_torch_kernels/`` at the root
of the checkout, named by a hash of the sources and the flags, so an edited
source rebuilds.  The library is loaded with ``ctypes``; pointers and the
stream pass as ``c_void_p``, integers as ``c_int``.  ``ptxas``'s report
(registers, spills per kernel) is kept beside the library, with the
seconds each source took.

Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import concurrent.futures
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
                for name in ("tb_fused", "tail_fused", "dc_band",
                             "tb_fused_wide", "tail_fused_wide",
                             "dc_band_wide", "tb_fused_xwide",
                             "tail_fused_xwide", "dc_band_xwide",
                             "ladder_graph"))
HEADERS = tuple(CSRC / f"{name}.cuh"
                for name in ("genasm_common", "tb_fused", "tail_fused",
                             "dc_band", "genasm_xwide_reg"))
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC))

_P, _I = ctypes.c_void_p, ctypes.c_int
_U64, _L = ctypes.c_ulonglong, ctypes.c_longlong
#: the wide family's block: K1's and K2/K4's lanes, threads, shared bytes,
#: store words and scratch words a lane; K3's lanes, threads, shared bytes,
#: steps a flush and scratch words a lane (then the grid's blocks and the
#: stream)
_XR_BLOCK = [_I] * 3 + [_L] * 2
_XR_K3_BLOCK = [_I] * 4 + [_L]
#: argument types of each C entry point: pointers, then ints, then the
#: block geometry (K1, K2/K4: lanes, threads, placement, shared bytes; K3:
#: lanes, threads, placement, chunk, shared bytes; the wide family's
#: ``_XR_BLOCK`` / ``_XR_K3_BLOCK``) and the stream; the
#: occupancy queries: ints, then the results' pointers; the ladder graph's
#: (``ladder_graph``): graphs, nodes, tensors and results as pointers, a
#: conditional handle as an unsigned 64-bit integer
_SIGNATURES = {
    "genasm_tb_fused_launch": [_P] * 5 + [_I] * 10 + [_I] * 4 + [_P],
    "genasm_tb_window_launch": [_P] * 11 + [_I] * 13 + [_I] * 4 + [_P],
    "genasm_tb_fused_occupancy": [_I] * 6 + [_P] * 2,
    "genasm_tail_banded_launch": [_P] * 7 + [_I] * 10 + [_I] * 4 + [_P],
    "genasm_tail_full_launch": [_P] * 7 + [_I] * 10 + [_I] * 4 + [_P],
    "genasm_tail_occupancy": [_I] * 6 + [_P] * 2,
    "genasm_dc_band_launch": [_P] * 5 + [_I] * 7 + [_I] * 5 + [_P],
    "genasm_dc_band_occupancy": [_I] * 6 + [_P] * 2,
    "genasm_tb_fused_xwide_launch": [_P] * 5 + [_I] * 10 + _XR_BLOCK
    + [_I, _P],
    "genasm_tb_window_xwide_launch": [_P] * 11 + [_I] * 13 + _XR_BLOCK
    + [_I, _P],
    "genasm_tail_banded_xwide_launch": [_P] * 7 + [_I] * 10 + _XR_BLOCK
    + [_I, _P],
    "genasm_tail_full_xwide_launch": [_P] * 7 + [_I] * 10 + _XR_BLOCK
    + [_I, _P],
    "genasm_dc_band_xwide_launch": [_P] * 6 + [_I] * 7 + _XR_K3_BLOCK
    + [_I, _P],
    "genasm_tb_fused_xwide_occupancy": [_I] * 2 + [_P] * 2,
    "genasm_tail_xwide_occupancy": [_I] * 2 + [_P] * 2,
    "genasm_dc_band_xwide_occupancy": [_I] * 2 + [_P] * 2,
    "genasm_ladder_gate_launch": [_P, _I, _P, _P],
    "genasm_graph_create": [_P],
    "genasm_graph_destroy": [_P],
    "genasm_graph_add_child": [_P, _P, _P, _P],
    "genasm_graph_conditional": [_P, _P],
    "genasm_graph_add_gate": [_P, _P, _P, _I, _P, _U64, _P],
    "genasm_graph_add_if": [_P, _P, _U64, _P, _P],
    "genasm_graph_instantiate": [_P, _P],
    "genasm_graph_upload": [_P, _P],
    "genasm_graph_launch": [_P, _P],
    "genasm_graph_exec_destroy": [_P],
    "genasm_mem_free": [_P],
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
    seconds until that nvcc ended)}; raises if any fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    start = time.perf_counter()
    procs = {}
    for src in sources:
        obj = out_dir / f"{Path(src).stem}.{os.getpid()}.o"
        procs[Path(src).name] = (obj, subprocess.Popen(
            [_nvcc(), *flags, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def wait(proc):         # one thread a process: each nvcc's own end
        log = proc.communicate()[0]
        return log, time.perf_counter() - start
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        ended = {name: pool.submit(wait, proc)
                 for name, (_, proc) in procs.items()}
    done, failed = {}, []
    for name, (obj, proc) in procs.items():
        log, seconds = ended[name].result()
        done[name] = (obj, log, seconds)
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
