"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card (K1 also
over a grid of its instantiations and block geometries, with its
occupancy; K2 and K4 over every tail instantiation in both store
placements; K3 over every instantiation in both band placements, with
its occupancy), drives the aligner's main path (``GenASMAligner.align``) on
PBSIM2-like long reads through the fused backend (K1, K2, K4) and the
split backend (K3 and the PyTorch traceback), holds the two results
equal, and checks the kernel path against the CPU plain path end to end:
on both backends, through all three rungs of the rescue ladder, and with
the reference's ``lane_tile='auto'`` of 2,816.
Every phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result, where CUDA is not available.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.api import CompileCache, plan                 # noqa: E402
from repro_torch.core import transfer                          # noqa: E402
from repro_torch.core.aligner import GenASMAligner             # noqa: E402
from repro_torch.core.config import AlignerConfig              # noqa: E402
from repro_torch.core.windowing import (H100_SMS,              # noqa: E402
                                        n_main_windows, plan_lane_tile)
from repro_torch.core.oracle import validate_cigar             # noqa: E402
from repro_torch.data.genome import (ReadSimConfig, simulate_reads,  # noqa: E402
                                     synth_genome)
from repro_torch.kernels import build, genasm_dc               # noqa: E402
from repro_torch.kernels.genasm_dc import (K3_PLACEMENTS,      # noqa: E402
                                           PLACEMENTS)
from repro_torch.kernels.ops import _to_kernel_layout          # noqa: E402
from repro_torch.serve.align_step import launch_plan           # noqa: E402

# H100 SXM peaks for the bound: HBM3 bandwidth (NVIDIA data sheet) and the
# INT32 rate, 132 SMs x 64 INT32 lanes x 1.98 GHz boost (Hopper whitepaper)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations the DP needs per (column, level, word): three shifts,
# three carry inserts, one PM OR, three ANDs; per traceback step: four bit
# tests (shift, AND, compare) and the cursor bookkeeping
OPS_PER_CELL_WORD = 10
OPS_PER_WALK_STEP = 20

KERNELS = {      # name -> (wrapper, plain version, TPU kernel it replaces)
    "tb_fused": (genasm_dc.genasm_tb_fused, genasm_dc.tb_fused_plain,
                 "src/repro/kernels/genasm_dc.py:414 _kernel_fused"),
    "tail_banded": (genasm_dc.genasm_tail_banded, genasm_dc.tail_banded_plain,
                    "src/repro/kernels/genasm_dc.py:734 _kernel_tail_banded"),
    "tail_full": (genasm_dc.genasm_tail_full, genasm_dc.tail_full_plain,
                  "src/repro/kernels/genasm_dc.py:588 _kernel_tail_fused"),
    "dc_band": (genasm_dc.genasm_dc, genasm_dc.dc_band_plain,
                "src/repro/kernels/genasm_dc.py:324 _kernel"),
}
#: the kernels each backend's main path launches, and no other
PATH_KERNELS = {"fused": ("tb_fused", "tail_banded", "tail_full"),
                "split": ("dc_band",)}
_CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"tb_fused": _CSRC + "tb_fused.cu",
           "tail_banded": _CSRC + "tail_fused.cu",
           "tail_full": _CSRC + "tail_fused.cu",
           "dc_band": _CSRC + "dc_band.cu"}
#: each kernel template's display name and template parameters
TEMPLATES = {"tb_fused_kernel": ("tb_fused", ("NW", "KP", "NWB")),
             "tail_fused_kernel": ("tail_fused", ("NW", "KP", "NWB", "PLACE")),
             "dc_band_kernel": ("dc_band", ("NW", "KP", "NWB", "PLACE"))}
#: K1's ms per launch at 4,096 lanes in its first design (one thread per
#: lane, band in global scratch), by k: PERF.md section 6, measured by this
#: script on an NVIDIA H100 80GB HBM3 at 700.00 W
K1_ONE_THREAD_MS = {12: 0.1435, 24: 0.4426, 48: 1.805}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts(device: torch.device):
    """(counts of the path `device` should take, counts of the other):
    kernel launches on the card, plain-version calls on the CPU (the CPU
    only ever serves a rehearsal of this script at a small size)."""
    if device.type == "cuda":
        return genasm_dc.LAUNCHES, genasm_dc.PLAIN_CALLS
    return genasm_dc.PLAIN_CALLS, genasm_dc.LAUNCHES


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return smi


def phase_build() -> dict:
    """Build and load the library (one nvcc per source, all started
    together); returns ptxas's usage per kernel instantiation."""
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    seconds = time.perf_counter() - t0
    report = build.ptxas_report(lib).read_text()
    usage = _ptxas_usage(report)
    per_source = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^== (\S+): ([\d.]+) s$", report, re.M)}
    emit("build", seconds=seconds, nvcc_seconds=per_source,
         library=lib.name, instantiations=len(usage), ptxas=usage)
    return usage


def _kernel_name(template: str, args) -> str:
    """name<NW=..,KP=..,NWB=..[,PLACE=..]> of an instantiation."""
    name, params = TEMPLATES[template]
    places = K3_PLACEMENTS if template == "dc_band_kernel" else PLACEMENTS
    args = [places[int(a)] if p == "PLACE" else a
            for p, a in zip(params, args)]
    return f"{name}<" + ",".join(f"{p}={a}" for p, a in zip(params, args)) \
        + ">"


def _instantiation(name: str, cfg: AlignerConfig, placement=None) -> str:
    """The usage key of the instantiation kernel `name` runs for `cfg`."""
    kp = genasm_dc.levels_bucket(cfg.k)
    if name == "tb_fused":
        return _kernel_name("tb_fused_kernel", (cfg.nw, kp, cfg.nwb))
    if name == "dc_band":
        return _kernel_name("dc_band_kernel", (cfg.nw, kp, cfg.nwb,
                                               K3_PLACEMENTS.index(placement)))
    nwb = cfg.nwb if name == "tail_banded" else cfg.nw
    return _kernel_name("tail_fused_kernel", (cfg.nw, kp, nwb,
                                              PLACEMENTS.index(placement)))


def _ptxas_usage(report: str) -> dict:
    """{kernel<NW,KP,NWB[,PLACE]>: "registers, spill stores, spill
    loads, stack frame"} from ptxas -v output (a thread-local array that
    does not fit registers lives in the stack frame, in local memory)."""
    usage, name, spill = {}, None, ""
    for line in report.splitlines():
        if "Function properties for" in line:
            mangled = line.split()[-1]
            template = next((t for t in TEMPLATES if t in mangled), None)
            name = None
            if template is not None:
                args = re.search(r"_kernelI((?:Li\d+E)+)E", mangled).group(1)
                name = _kernel_name(template, re.findall(r"Li(\d+)E", args))
        elif "spill stores" in line:
            nums = re.findall(r"(\d+) bytes", line)
            spill = (f"spill stores {nums[1]} B, spill loads {nums[2]} B, "
                     f"stack frame {nums[0]} B")
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            usage[name] = f"{regs} registers, {spill}"
    return usage


# ---- phase 3: every kernel against its plain version on the card ----

def _mutated(rng, m_len, n: int, k: int):
    """Random patterns of lengths m_len (sentinel-padded to max(m_len))
    and texts (B, n) within ~k+2 edits of them, plus the texts' true
    lengths (<= n)."""
    n_pairs = len(m_len)
    pats = rng.integers(0, 4, (n_pairs, int(m_len.max()))).astype(np.uint8)
    txts = np.full((n_pairs, n), 9, np.uint8)
    lens = np.zeros(n_pairs, np.int32)
    for b in range(n_pairs):
        pats[b, m_len[b]:] = 255
        t = list(pats[b, :m_len[b]])
        for _ in range(int(rng.integers(0, k + 3))):
            pos = int(rng.integers(0, max(1, len(t))))
            r = rng.random()
            if r < 0.4 and t:
                t[pos] = int(rng.integers(0, 4))
            elif r < 0.7:
                t.insert(pos, int(rng.integers(0, 4)))
            elif len(t) > 1:
                del t[pos]
        t = t[:n]
        txts[b, :len(t)] = t
        lens[b] = len(t)
    return pats, txts, lens


def _case(name: str, cfg: AlignerConfig, n_pairs: int, rng, dev):
    """Inputs (on `dev`) and keyword arguments of one kernel at the shapes
    the main path gives it, and the columns each lane fills."""
    if name in ("tb_fused", "dc_band"):
        pats, txts, _ = _mutated(rng, np.full(n_pairs, cfg.W), cfg.W, cfg.k)
        txts = np.where(txts == 9, rng.integers(0, 4, txts.shape), txts)
        pm, text = _to_kernel_layout(torch.from_numpy(pats).to(dev),
                                     torch.from_numpy(txts).to(dev), cfg)
        kw = dict(cfg=cfg)
        if name == "tb_fused":
            kw.update(commit_limit=cfg.stride, max_ops=cfg.tb_max_ops,
                      max_steps=cfg.tb_max_steps)
        return (pm, text), kw, np.full(n_pairs, cfg.W)
    n_text = cfg.W + 4 * cfg.k
    m_len = rng.integers(cfg.O + 1, cfg.W + 1, n_pairs).astype(np.int32)
    pats, txts, n_len = _mutated(rng, m_len, n_text, cfg.k)
    pm, text = _to_kernel_layout(torch.from_numpy(pats).to(dev),
                                 torch.from_numpy(txts).to(dev), cfg)
    lens = [torch.from_numpy(x)[None].to(dev).contiguous()
            for x in (m_len, n_len)]
    kw = dict(cfg=cfg, n_text=n_text, commit_limit=2 * (cfg.W + n_text),
              max_ops=cfg.W + n_text, max_steps=cfg.W + n_text + 4)
    return (pm, text, *lens), kw, np.minimum(n_len, n_text)


def _dist_and_steps(name: str, out):
    """Per-lane dist and the walk steps taken, from a kernel's outputs (K3
    walks no step)."""
    if name == "dc_band":
        return out[0].long().cpu(), 0
    meta = out[1].long().cpu()
    return meta[genasm_dc.META_DIST], int(meta[genasm_dc.META_NOPS].sum())


def _bound(cfg, inputs, outputs, cols, dist, walk_steps: int):
    """Least time on an H100 for this call's work, and what bounds it:
    bytes (each input read once, each output written once) over HBM
    bandwidth vs the integer operations these inputs need (the levels up
    to each lane's dist in each column it fills, and the walk steps it
    takes) over the INT32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    levels = torch.clamp(dist, max=cfg.k) + 1
    cols = torch.as_tensor(cols, dtype=torch.long)
    fill_ops = int((cols * levels).sum()) * cfg.nw * OPS_PER_CELL_WORD
    walk_ops = walk_steps * OPS_PER_WALK_STEP
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (fill_ops + walk_ops) / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _time_ms(fn, reps: int, device: torch.device) -> float:
    """Mean ms of `reps` calls: CUDA events on the card."""
    if device.type != "cuda":
        start = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - start) * 1e3 / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def _device_ms(fn, reps: int, device: torch.device):
    """Mean device ms per call of `fn`: `reps` calls captured in one CUDA
    graph and replayed between two CUDA events, so no host time falls
    between the launches; None off the card."""
    if device.type != "cuda":
        return None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    return _time_ms(graph.replay, 1, device) / reps


def _max_abs_err(name: str, got, ref, what: str) -> int:
    """Max abs difference of a kernel's outputs and its plain version's;
    raises unless it is 0."""
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, ref))
    if err != 0:
        raise AssertionError(f"{name} {what}: kernel and plain version "
                             f"differ (max abs err {err})")
    return err


def _plain(name: str, inputs, kw, device):
    """The plain version's outputs and its ms on the same inputs."""
    _sync(device)
    start = time.perf_counter()
    ref = KERNELS[name][1](*inputs, **kw)
    _sync(device)
    return ref, (time.perf_counter() - start) * 1e3


def _timing(name: str, cfg, call, inputs, got, cols, reps: int,
            device) -> dict:
    """Times of `call` (device ms from a CUDA graph, event ms of
    back-to-back calls) and the bound of its work."""
    for _ in range(2):
        call()
    event_ms = _time_ms(call, reps, device)
    device_ms = _device_ms(call, reps, device)
    dist, steps = _dist_and_steps(name, got)
    bound_ms, bound_by = _bound(cfg, inputs, got, cols, dist, steps)
    return dict(ms=event_ms if device_ms is None else device_ms,
                event_ms=event_ms, bound_ms=bound_ms, bound_by=bound_by)


def _check_case(name: str, cfg: AlignerConfig, n_pairs: int, rng, device,
                reps: int, what: str) -> dict:
    """One kernel call against its plain version on the same inputs (max
    abs err 0 or raise); with reps > 0 also its times and bound."""
    wrapper = KERNELS[name][0]
    inputs, kw, cols = _case(name, cfg, n_pairs, rng, device)
    call = lambda: wrapper(*inputs, **kw)               # noqa: E731
    got = call()
    ref, plain_ms = _plain(name, inputs, kw, device)
    err = _max_abs_err(name, got, ref, what)
    dist, _ = _dist_and_steps(name, got)
    row = dict(name=name, W=cfg.W, k=cfg.k, lanes=n_pairs, max_abs_err=err,
               plain_ms=plain_ms, solved=int((dist <= cfg.k).sum()))
    if reps:
        row.update(_timing(name, cfg, call, inputs, got, cols, reps, device))
    return row


def tail_launcher(name: str, cfg: AlignerConfig, geo, inputs, kw):
    """A call of the tail kernel `name` (K2 ``tail_banded`` or K4
    ``tail_full``) at block `geo` (any ``genasm_dc.tail_geometry``, in
    either placement) on CUDA `inputs`, through its C entry point, and its
    (ops, meta); the wrapper launches only the geometry's default.  On
    CPU inputs: the plain version."""
    pm, text, m_len, n_len = inputs
    if pm.device.type != "cuda":
        return lambda: KERNELS[name][1](*inputs, **kw)
    lanes, dev = pm.shape[-1], pm.device
    ops = torch.empty((kw["max_ops"], lanes), dtype=torch.int32, device=dev)
    meta = torch.empty((genasm_dc.META_ROWS, lanes), dtype=torch.int32,
                       device=dev)
    store = torch.empty((lanes, geo.store_words) if geo.store_words else 0,
                        dtype=torch.int32, device=dev)
    fn = getattr(build.load_library(), f"genasm_{name}_launch")
    nwb = cfg.nwb if name == "tail_banded" else cfg.nw

    def call():
        rc = fn(pm.data_ptr(), text.data_ptr(), m_len.data_ptr(),
                n_len.data_ptr(), ops.data_ptr(), meta.data_ptr(),
                store.data_ptr(), lanes, kw["n_text"], cfg.W, cfg.nw, cfg.k,
                nwb, int(cfg.early_term), kw["commit_limit"], kw["max_ops"],
                kw["max_steps"], geo.lanes, geo.threads,
                PLACEMENTS.index(geo.placement), geo.shared_bytes,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} at {geo}: CUDA error {rc}")
        return ops, meta
    return call


def _tail_geometry(name: str, cfg: AlignerConfig, placement=None,
                   usage=None):
    """The geometry of the tail kernel `name` for `cfg` at its main-path
    shapes, in `placement` (default: the geometry's own choice), and a row
    of its block, store and (with ``usage``, on the card) occupancy and
    ptxas report."""
    n_text = cfg.W + 4 * cfg.k
    banded = name == "tail_banded"
    geo = genasm_dc.tail_geometry(cfg, n_text, cfg.W + n_text, banded=banded,
                                  placement=placement)
    nwb = cfg.nwb if banded else cfg.nw
    row = dict(NW=cfg.nw, KP=genasm_dc.levels_bucket(cfg.k), NWB=nwb,
               G=geo.group, L=geo.levels_per_thread, lanes_per_block=geo.lanes,
               threads=geo.threads, placement=geo.placement,
               shared_bytes=geo.shared_bytes,
               store_bytes_per_lane=4 * ((cfg.k + 1) * n_text * nwb
                                         if geo.placement == "shared"
                                         else geo.store_words))
    if usage is not None:
        blocks, limit = genasm_dc.tail_occupancy(cfg, geo, banded)
        if limit < geo.shared_bytes:
            raise AssertionError(f"{name} W={cfg.W} k={cfg.k}: the card "
                                 f"allows {limit} B of dynamic shared "
                                 f"memory, a block asks for "
                                 f"{geo.shared_bytes}")
        row.update(blocks_per_sm=blocks, card_shared_bytes=limit,
                   ptxas=usage.get(_instantiation(name, cfg,
                                                  geo.placement)))
    return geo, row


def k3_launcher(cfg: AlignerConfig, geo, inputs):
    """A call of K3 at block `geo` (any ``genasm_dc.dc_band_geometry``, in
    either placement) on CUDA `inputs`, through its C entry point, and its
    (dist, band, levels); the wrapper launches only the geometry's
    default.  On CPU inputs: the plain version."""
    pm, text = inputs
    if pm.device.type != "cuda":
        return lambda: genasm_dc.dc_band_plain(pm, text, cfg=cfg)
    lanes, dev = pm.shape[-1], pm.device
    dist, levels = (torch.empty(lanes, dtype=torch.int32, device=dev)
                    for _ in range(2))
    band = torch.empty((cfg.k + 1, cfg.ncols_band, cfg.nwb, lanes),
                       dtype=torch.int32, device=dev)
    fn = build.load_library().genasm_dc_band_launch

    def call():
        rc = fn(pm.data_ptr(), text.data_ptr(), band.data_ptr(),
                dist.data_ptr(), levels.data_ptr(), lanes, cfg.W, cfg.nw,
                cfg.k, cfg.nwb, cfg.ncols_band, int(cfg.early_term),
                geo.lanes, geo.threads, K3_PLACEMENTS.index(geo.placement),
                geo.chunk, geo.shared_bytes,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"dc_band at {geo}: CUDA error {rc}")
        return dist, band, levels
    return call


def _k3_geometry(cfg: AlignerConfig, placement=None, usage=None,
                 threads=None):
    """K3's geometry for `cfg` in `placement` (default: the geometry's
    own), and a row of its block and (with ``usage``, on the card) the
    shared bytes the card allows, blocks per SM and ptxas's report."""
    geo = genasm_dc.dc_band_geometry(cfg, threads, placement=placement)
    row = dict(NW=cfg.nw, KP=genasm_dc.levels_bucket(cfg.k), NWB=cfg.nwb,
               G=geo.group, L=geo.levels_per_thread, lanes_per_block=geo.lanes,
               threads=geo.threads, placement=geo.placement, chunk=geo.chunk,
               shared_bytes=geo.shared_bytes)
    if usage is not None:
        blocks, limit = genasm_dc.dc_band_occupancy(cfg, geo)
        if limit < geo.shared_bytes:
            raise AssertionError(f"K3 W={cfg.W} k={cfg.k}: the card allows "
                                 f"{limit} B of dynamic shared memory, a "
                                 f"block asks for {geo.shared_bytes}")
        row.update(blocks_per_sm=blocks, card_shared_bytes=limit,
                   ptxas=usage.get(_instantiation("dc_band", cfg,
                                                  geo.placement)))
    return geo, row


#: K3 on the card at W > 64 (NW = 3, 4) and where m_pad > W (40, 48):
#: (W, O, k), each at the phase's lanes, timed
K3_WIDE = [(40, 16, 12), (48, 16, 12), (96, 36, 24), (96, 36, 48),
           (128, 48, 24), (128, 48, 48)]


def phase_kernels(device: torch.device, n_pairs: int = 4096,
                  reps: int = 20, usage: dict | None = None) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes
    (W=64), then K3 at the widths of ``K3_WIDE``.  On the card ``ms`` is
    the device time per launch (``_device_ms``); ``event_ms`` the
    CUDA-event time per call of back-to-back wrapper calls, the host's time
    between launches included.  The tail rows carry their block, store
    placement and (with ``usage``, ptxas's) registers, spills and blocks
    per SM; the K3 rows their block, band placement and occupancy."""
    rng = np.random.default_rng(2022)
    cases = [("tb_fused", 12), ("tb_fused", 24), ("tb_fused", 48),
             ("tail_banded", 12), ("tail_full", 24), ("tail_full", 48),
             ("dc_band", 12), ("dc_band", 24), ("dc_band", 48)]
    cases = [(name, AlignerConfig(k=k)) for name, k in cases] + [
        ("dc_band", AlignerConfig(W=W, O=O, k=k)) for W, O, k in K3_WIDE]
    rows = []
    for name, cfg in cases:
        if name.startswith("tail") and (name == "tail_banded") != cfg.tail_banded:
            raise AssertionError(f"k={cfg.k} does not select {name}")
        row = _check_case(name, cfg, n_pairs, rng, device, reps,
                          f"W={cfg.W} k={cfg.k}")
        if name == "tb_fused":
            row["one_thread_ms"] = K1_ONE_THREAD_MS[cfg.k]
        if name.startswith("tail"):
            row.update(_tail_geometry(name, cfg, usage=usage)[1])
        if name == "dc_band":
            row.update(_k3_geometry(cfg, usage=usage)[1])
        emit("kernel", **row)
        rows.append(row)
    return rows


#: K1's geometry grid: (W, O, k, early_term, lanes); every (NW, KP, NWB)
#: instantiation, W = 40 and 48 (m_pad > W), idle levels above k (k=40),
#: no early termination, lane counts that are no multiple of a block's
#: lanes, blocks of fewer lanes (W = 96 and 128 at k = 48), and the main
#: path's own batch width (2,048, timed)
K1_GRID = [(16, 6, 4, True, 37), (32, 12, 5, True, 37),
           (32, 12, 20, True, 37), (40, 16, 12, True, 37),
           (48, 16, 12, True, 37), (64, 24, 12, True, 37),
           (64, 24, 15, True, 37), (64, 24, 24, True, 37),
           (64, 24, 40, True, 37),
           (64, 24, 48, True, 37), (64, 24, 12, False, 37),
           (64, 24, 48, False, 37), (64, 24, 12, True, 1),
           (64, 24, 24, True, 1), (64, 24, 48, True, 1),
           (96, 36, 12, True, 37), (96, 36, 15, True, 37),
           (96, 36, 24, True, 37), (96, 36, 31, True, 37),
           (96, 36, 48, True, 37), (96, 36, 48, True, 1),
           (128, 48, 12, True, 37), (128, 48, 15, True, 37),
           (128, 48, 24, True, 37), (128, 48, 31, True, 37),
           (128, 48, 40, True, 37), (128, 48, 48, True, 37),
           (128, 48, 48, True, 1),
           (64, 24, 12, True, 2048), (64, 24, 24, True, 2048),
           (64, 24, 48, True, 2048)]


def _k1_geometry(cfg: AlignerConfig) -> dict:
    geo = genasm_dc.tb_fused_geometry(cfg)
    return dict(W=cfg.W, k=cfg.k, NW=cfg.nw,
                KP=genasm_dc.levels_bucket(cfg.k), NWB=cfg.nwb,
                G=geo.group, L=geo.levels_per_thread, lanes_per_block=geo.lanes,
                threads=geo.threads, shared_bytes=geo.shared_bytes)


def phase_k1_grid(device: torch.device, reps: int = 20) -> list[dict]:
    """K1 over its geometry grid, each case held against tb_fused_plain
    with max abs err 0; the 2,048-lane cases timed."""
    rng = np.random.default_rng(15)
    rows = []
    for W, O, k, early_term, lanes in K1_GRID:
        cfg = AlignerConfig(W=W, O=O, k=k, early_term=early_term)
        row = _check_case("tb_fused", cfg, lanes, rng, device,
                          reps if lanes >= 2048 else 0,
                          f"W={W} k={k} early_term={early_term} "
                          f"lanes={lanes}")
        row.update(_k1_geometry(cfg), early_term=early_term)
        emit("k1_grid", **row)
        rows.append(row)
    return rows


def phase_k1_occupancy(usage: dict) -> dict:
    """Per K1 instantiation of the default ladder and of W = 96 and 128 at
    k = 48 (fewer lanes a block): its block, the dynamic shared bytes a
    block asks for and the instantiation's limit as the card reports it,
    active blocks per SM on this card, and ptxas's registers and spills.
    Returns the rows of the default ladder's k (12, 24, 48)."""
    out = {}
    for W, O, k in ((32, 12, 5), (32, 12, 20), (64, 24, 12), (64, 24, 15),
                    (64, 24, 24), (64, 24, 48), (96, 36, 48),
                    (128, 48, 48)):
        cfg = AlignerConfig(W=W, O=O, k=k)
        row = _k1_geometry(cfg)
        blocks, limit = genasm_dc.tb_fused_occupancy(
            cfg, genasm_dc.tb_fused_geometry(cfg))
        if limit < row["shared_bytes"]:
            raise AssertionError(f"K1 W={W} k={k}: the card allows {limit} "
                                 f"B of dynamic shared memory, a block asks "
                                 f"for {row['shared_bytes']}")
        row.update(blocks_per_sm=blocks, card_shared_bytes=limit,
                   ptxas=usage.get(_instantiation("tb_fused", cfg)))
        emit("k1_occupancy", **row)
        if W == 64 and k in K1_ONE_THREAD_MS:
            out[k] = row
    return out


#: K3's grid: K1's (K3 has K1's (NW, KP, NWB) instantiations), each in
#: both band placements, at 37 and 1 lanes
K3_GRID = [case for case in K1_GRID if case[4] < 2048]


def phase_k3_grid(device: torch.device, reps: int = 20,
                  usage: dict | None = None,
                  timed_lanes=(2048, 4096)) -> list[dict]:
    """K3 over ``K3_GRID``, then the main path's shapes (W=64, k = 12, 24,
    48) at each of `timed_lanes`, timed; each case in both band
    placements, launched through the C entry point at that placement's
    geometry (``k3_launcher``) and held against ``dc_band_plain`` with max
    abs err 0; each row with its block, shared bytes asked and allowed,
    blocks per SM and ptxas's report (with ``usage``), the timed rows with
    their device ms and bound."""
    rng = np.random.default_rng(17)
    rows = []
    timed = [(64, 24, k, True, lanes) for lanes in timed_lanes
             for k in (12, 24, 48)]
    for W, O, k, early_term, lanes in K3_GRID + timed:
        cfg = AlignerConfig(W=W, O=O, k=k, early_term=early_term)
        inputs, kw, cols = _case("dc_band", cfg, lanes, rng, device)
        ref, plain_ms = _plain("dc_band", inputs, kw, device)
        for placement in K3_PLACEMENTS:
            geo, geo_row = _k3_geometry(cfg, placement, usage)
            call = k3_launcher(cfg, geo, inputs)
            got = call()
            row = dict(name="dc_band", W=W, k=k, early_term=early_term,
                       lanes=lanes, max_abs_err=_max_abs_err(
                           "dc_band", got, ref, f"W={W} k={k} early_term="
                           f"{early_term} lanes={lanes} {placement}"),
                       plain_ms=plain_ms, **geo_row)
            if lanes >= 2048:
                row.update(_timing("dc_band", cfg, call, inputs, got, cols,
                                   reps, device))
            emit("k3_grid", **row)
            rows.append(row)
    return rows


#: the tails' grid: (W, O, k, tail_store, kernel), every (NW, KP, NWB)
#: instantiation of tail_fused_kernel: K4 at W <= 32 (nwb == nw at the
#: base k), K2 where the band is the whole vector (tail_store='band'),
#: W = 40 and 48 (m_pad > W), W = 96 and 128; and W=128, k=48, whose lane
#: fits no block's shared memory (global only)
TAIL_GRID = [(16, 6, 4, "auto", "tail_full"), (32, 12, 20, "auto", "tail_full"),
             (32, 12, 5, "band", "tail_banded"),
             (40, 16, 12, "auto", "tail_banded"),
             (48, 16, 12, "auto", "tail_banded"),
             (64, 24, 12, "auto", "tail_banded"),
             (64, 24, 12, "full", "tail_full"),
             (64, 24, 24, "auto", "tail_full"),
             (64, 24, 48, "auto", "tail_full"),
             (96, 36, 12, "auto", "tail_banded"),
             (96, 36, 15, "auto", "tail_banded"),
             (96, 36, 12, "full", "tail_full"),
             (96, 36, 24, "auto", "tail_banded"),
             (96, 36, 31, "auto", "tail_full"),
             (96, 36, 48, "auto", "tail_full"),
             (128, 48, 12, "auto", "tail_banded"),
             (128, 48, 15, "auto", "tail_banded"),
             (128, 48, 12, "full", "tail_full"),
             (128, 48, 24, "auto", "tail_banded"),
             (128, 48, 31, "auto", "tail_banded"),
             (128, 48, 24, "full", "tail_full"),
             (128, 48, 40, "auto", "tail_banded"),
             (128, 48, 32, "full", "tail_full"),
             (128, 48, 48, "auto", "tail_full")]
#: the main path's tails, timed at 2,048 lanes in both placements
TAIL_TIMED = [(64, 24, 12, "auto", "tail_banded"),
              (64, 24, 24, "auto", "tail_full"),
              (64, 24, 48, "auto", "tail_full")]


def phase_tail_grid(device: torch.device, reps: int = 20,
                    usage: dict | None = None,
                    lane_counts=(37, 1, 2048)) -> list[dict]:
    """K2 and K4 over ``TAIL_GRID`` at 37 and 1 lanes and ``TAIL_TIMED``
    at 2,048 (timed), each case in both store placements wherever one
    lane's store fits a block's shared memory (else global only), launched
    through the C entry point at that placement's geometry
    (``tail_launcher``) and held against the plain version with max abs
    err 0."""
    rng = np.random.default_rng(16)
    rows = []
    for lanes in lane_counts:
        for W, O, k, tail_store, name in (TAIL_TIMED if lanes >= 2048
                                          else TAIL_GRID):
            cfg = AlignerConfig(W=W, O=O, k=k, tail_store=tail_store)
            if (name == "tail_banded") != cfg.tail_banded:
                raise AssertionError(f"W={W} k={k} tail_store={tail_store} "
                                     f"does not select {name}")
            inputs, kw, cols = _case(name, cfg, lanes, rng, device)
            ref, plain_ms = _plain(name, inputs, kw, device)
            for placement in PLACEMENTS:
                try:
                    geo, geo_row = _tail_geometry(name, cfg, placement, usage)
                except ValueError as exc:       # the lane fits no block
                    emit("tail_grid", name=name, W=W, k=k, lanes=lanes,
                         placement=placement, skipped=str(exc))
                    continue
                call = tail_launcher(name, cfg, geo, inputs, kw)
                got = call()
                row = dict(name=name, W=W, k=k, tail_store=tail_store,
                           lanes=lanes, max_abs_err=_max_abs_err(
                               name, got, ref, f"W={W} k={k} lanes={lanes} "
                               f"{placement}"),
                           plain_ms=plain_ms, **geo_row)
                if lanes >= 2048:
                    row.update(_timing(name, cfg, call, inputs, got, cols,
                                       reps, device))
                emit("tail_grid", **row)
                rows.append(row)
    return rows


# ---- phase 4: the main path at a real size, fused then split ----

def long_reads(n_pairs: int = 2048, read_len: int = 10_000,
               genome_len: int = 5_000_000):
    """The main path's batch: PBSIM2-like CLR reads at 10 % error."""
    genome = synth_genome(genome_len, seed=2022)
    return simulate_reads(genome, n_pairs, ReadSimConfig(read_len=read_len,
                                                         error_rate=0.10,
                                                         seed=2022))


def _drive(device: torch.device, backend: str, rs,
           cfg: AlignerConfig | None = None):
    """Align `rs` through ``GenASMAligner.align`` on `backend` at `cfg`
    (default: the default geometry, W=64, O=24, k=12, ladder to 48), the
    launch counts set to 0 just before and read just after.  Fails unless
    exactly the backend's kernels ran on the card (or, on the CPU, exactly
    their plain versions).  Returns the aligner, the result, the host
    seconds and the counts."""
    cfg = (cfg or AlignerConfig()).replace(backend=backend)
    aligner = GenASMAligner(cfg, rescue_rounds=2, device=device)
    genasm_dc.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    res = aligner.align(rs.reads, rs.ref_segments)
    _sync(device)
    seconds = time.perf_counter() - t0
    return (aligner, res, seconds,
            *_path_counts(device, backend, f"{backend} path"))


def _path_counts(device: torch.device, backend: str, what: str):
    """The counts since the last reset: (this device's path, the other
    path).  Raises unless exactly the backend's kernels ran (on the CPU:
    exactly their plain versions)."""
    taken, other = (dict(c) for c in _counts(device))
    expected = PATH_KERNELS[backend]
    if (min(taken[n] for n in expected) == 0 or max(other.values()) != 0
            or any(taken[n] for n in KERNELS if n not in expected)):
        raise AssertionError(f"{what} did not run on the {device} path "
                             f"alone: {taken}, other path {other}")
    return taken, other


def phase_main_path(device: torch.device, rs, sample: int = 64):
    """The fused backend on the main path's batch.  Returns the phase's
    numbers and the AlignResult."""
    aligner, res, align_s, taken, other = _drive(device, "fused", rs)
    if aligner.last_run["rounds_run"] < 2:
        raise AssertionError(f"rescue ladder did not run: {aligner.last_run}")
    checked = 0
    for i in range(min(sample, len(rs.reads))):
        if not res.failed[i]:
            validate_cigar(rs.reads[i], rs.ref_segments[i], res.ops[i],
                           expected_dist=int(res.dist[i]))
            checked += 1
    if checked == 0:
        raise AssertionError("no lane of the sample aligned")
    n_pairs = len(rs.reads)
    out = dict(pairs=n_pairs, read_len=len(rs.reads[0]), align_s=align_s,
               pairs_per_s=n_pairs / align_s,
               failed_share=float(res.failed.mean()),
               cigars_validated=checked, **aligner.last_run,
               summary=res.summary(base_k=aligner.cfg.k),
               transfers=vars(aligner.transfers), launches=taken,
               other_path_calls=other)
    emit("main_path", **out)
    if device.type == "cuda":
        emit("main_path_profile", **_device_breakdown(
            lambda: aligner.align(rs.reads, rs.ref_segments)))
    return out, res


def _assert_same_result(a, b, what: str) -> None:
    for field in ("dist", "failed", "k_used", "read_consumed",
                  "ref_consumed"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"{what}: {field} differs")
    if a.cigars != b.cigars or not all(
            np.array_equal(x, y) for x, y in zip(a.ops, b.ops)):
        raise AssertionError(f"{what}: CIGARs / ops differ")


def phase_main_path_split(device: torch.device, rs, fused: dict,
                          fused_res, profile_rs=None) -> dict:
    """The split backend (K3 per main window, the PyTorch traceback, the
    plain tail) on the same batch: K3 launched once per main window of
    every rung run, no plain version called, and every AlignResult field
    and the level count equal to the fused path's (``fused`` and
    ``fused_res``, from ``phase_main_path``).  On the card it profiles one
    more batch, ``profile_rs`` (the main batch when None; ``main()`` gives
    it 1,024 reads of 500 bp, since the profiler takes minutes to sum the
    events of the main batch's millions of launches)."""
    aligner, res, align_s, taken, other = _drive(device, "split", rs)
    cfg = aligner.cfg
    rounds = aligner.last_run["rounds_run"]
    windows = n_main_windows(max(len(r) for r in rs.reads), cfg)
    if taken["dc_band"] != windows * rounds:
        raise AssertionError(f"K3 launched {taken['dc_band']} times, not "
                             f"{windows} windows x {rounds} rungs")
    _assert_same_result(res, fused_res, "split vs fused")
    for key in ("levels_run_total", "rounds_run"):
        if aligner.last_run[key] != fused[key]:
            raise AssertionError(f"split vs fused: {key} "
                                 f"{aligner.last_run[key]} != {fused[key]}")
    n_pairs = len(rs.reads)
    out = dict(pairs=n_pairs, read_len=len(rs.reads[0]), align_s=align_s,
               pairs_per_s=n_pairs / align_s,
               failed_share=float(res.failed.mean()),
               equal_to_fused=True, windows=windows, **aligner.last_run,
               transfers=vars(aligner.transfers), launches=taken,
               other_path_calls=other)
    emit("main_path_split", **out)
    if device.type == "cuda":
        prof = profile_rs if profile_rs is not None else rs
        emit("main_path_split_profile", pairs=len(prof.reads),
             read_len=len(prof.reads[0]), **_device_breakdown(
                 lambda: aligner.align(prof.reads, prof.ref_segments)))
    return out


def _profiled_kernel(key: str) -> str:
    """Which row of the breakdown a profiler key falls in: one of KERNELS
    (K2 and K4 are both tail_fused_kernel<NW, KP, NWB, PLACE>; NWB < NW is
    K2, as on the main path), copies, or PyTorch's own kernels."""
    tail = re.search(r"tail_fused_kernel<(\d+), (\d+), (\d+), (\d+)>", key)
    if tail:
        return ("tail_banded" if int(tail.group(3)) < int(tail.group(1))
                else "tail_full")
    return next((k for k in KERNELS if f"{k}_kernel" in key),
                "memcpy" if "memcpy" in key.lower() else "torch_kernels")


def _device_breakdown(run) -> dict:
    """Device time of one more run of `run` under torch.profiler (CUDA
    activity), by kernel (ours by name, the rest of PyTorch's together,
    copies), beside the run's host-clock time.  Device busy time is the
    union of the intervals in which some kernel or copy ran (a session's
    retire stream may overlap the dispatch stream), the idle share the
    rest of the wall time.  It reads the profiler's raw events rather
    than ``key_averages()``, whose event tree takes minutes to build for
    a few hundred thousand launches; ``profile_s`` is the host time the
    profiler takes to stop and hand them over, and this sum."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    ms = dict.fromkeys([*KERNELS, "torch_kernels", "memcpy"], 0.0)
    launches = dict.fromkeys(ms, 0)
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = _profiled_kernel(ev.name())
        ms[name] += ev.duration_ns() / 1e6
        launches[name] += 1
        spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    busy_ns, reach = 0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy_ns += end - start
            reach = end
        elif end > reach:
            busy_ns += end - reach
            reach = end
    busy = busy_ns / 1e9
    wall = t1 - t0
    return dict(wall_s=wall, device_ms=ms, device_launches=launches,
                device_busy_s=busy,
                idle_share=1 - busy / wall if busy else None,
                profile_s=time.perf_counter() - t1)


# ---- phase 5: kernel path against plain path, end to end ----

def _with_burst(rs, lane: int, n: int, seed: int):
    """`rs` with `n` random bases inserted in the middle of read `lane`:
    at n = 16 its window needs more than k = 24 edits, so only the third
    rung (k = 48) aligns it."""
    reads = list(rs.reads)
    burst = np.random.default_rng(seed).integers(0, 4, n).astype(np.uint8)
    mid = len(reads[lane]) // 2
    reads[lane] = np.concatenate([reads[lane][:mid], burst,
                                  reads[lane][mid:]])
    return reads, list(rs.ref_segments)


def _cuda_equals_cpu(device, backend, reads, refs, cfg=None, what=""):
    """Align on `device` and on the CPU; raise unless every field is
    equal.  Returns (result, aligner's last_run, seconds per device)."""
    results, runs, seconds = {}, {}, {}
    batch = SimpleNamespace(reads=reads, ref_segments=refs)
    for dev in (device, torch.device("cpu")):
        aligner, results[dev.type], seconds[dev.type], _, _ = _drive(
            dev, backend, batch, cfg)
        runs[dev.type] = aligner.last_run
    _assert_same_result(results[device.type], results["cpu"],
                        f"end to end ({backend}{what})")
    if any(runs[device.type][key] != runs["cpu"][key]
           for key in ("rounds_run", "levels_run_total")):
        raise AssertionError(f"end to end ({backend}{what}): ladder counts "
                             f"differ: {runs}")
    return results[device.type], runs[device.type], seconds


def phase_end_to_end(device: torch.device, n_pairs: int = 32,
                     read_len: int = 2_000, tile_pairs: int = 8,
                     tile_read_len: int = 600) -> None:
    """Each backend on `device` against the same backend on the CPU; then
    the fused backend on the same batch with one read that only the third
    rung aligns (``rounds_run == 3``); then the fused backend at
    ``lane_tile=2816`` (what the reference's ``lane_tile='auto'`` gives at
    the default geometry: a pad unit, no block size) on `tile_pairs`
    reads."""
    genome = synth_genome(1_000_000, seed=7)
    rs = simulate_reads(genome, n_pairs, ReadSimConfig(read_len=read_len,
                                                       seed=7))
    for backend in PATH_KERNELS:
        res, _, seconds = _cuda_equals_cpu(device, backend, rs.reads,
                                           rs.ref_segments)
        emit("end_to_end", backend=backend, pairs=n_pairs,
             read_len=read_len, equal=True, seconds=seconds,
             failed_share=float(res.failed.mean()))
    lane = min(5, n_pairs - 1)
    res, run, seconds = _cuda_equals_cpu(
        device, "fused", *_with_burst(rs, lane, 16, seed=3),
        what=", three rungs")
    if run["rounds_run"] != 3 or res.k_used[lane] != 48 or res.failed[lane]:
        raise AssertionError(f"the burst read did not take the k=48 rung: "
                             f"{run}, k_used {res.k_used[lane]}")
    emit("end_to_end", backend="fused", case="three_rungs", pairs=n_pairs,
         read_len=read_len, equal=True, seconds=seconds, **run)
    tile = AlignerConfig(lane_tile=2816)
    rs = simulate_reads(genome, tile_pairs, ReadSimConfig(
        read_len=tile_read_len, seed=8))
    res, run, seconds = _cuda_equals_cpu(device, "fused", rs.reads,
                                         rs.ref_segments, tile,
                                         ", lane_tile=2816")
    emit("end_to_end", backend="fused", case="lane_tile_2816",
         pairs=tile_pairs, read_len=tile_read_len, equal=True,
         seconds=seconds, rounds_run=run["rounds_run"],
         failed_share=float(res.failed.mean()))


# ---- phase 6: the session front door at full width ----

def ragged_pairs(genome, n_pairs: int, lo: int, hi: int, seed: int,
                 n_burst: int = 0):
    """`n_pairs` PBSIM2-like CLR pairs at 10 % error from `genome`, read
    lengths log-uniform over [lo, hi]; `n_burst` of them, chosen by the
    seed, carry a 16-base insertion (``_with_burst``), so no rung below
    k=48 aligns them.  Returns (reads, refs, burst lanes)."""
    rng = np.random.default_rng(seed)
    lengths = np.round(lo * (hi / lo) ** rng.random(n_pairs)).astype(int)
    reads, refs = [], []
    for i, n in enumerate(lengths):
        rs = simulate_reads(genome, 1, ReadSimConfig(
            read_len=int(n), error_rate=0.10, seed=seed + i))
        reads.append(rs.reads[0])
        refs.append(rs.ref_segments[0])
    burst = sorted(int(b) for b in rng.choice(n_pairs, n_burst,
                                              replace=False))
    for lane in burst:
        reads, refs = _with_burst(SimpleNamespace(reads=reads,
                                                  ref_segments=refs),
                                  lane, 16, seed + lane)
    return reads, refs, burst


def _spy_shapes(session) -> set:
    """Record every distinct (k, lanes, read bucket, ref bucket, ladder)
    `session` asks an executable for: the keys its stream needs, counted
    apart from the cache's own counters."""
    asked = set()
    inner = session._executable

    def spy(cfg, lanes, read_bucket, ref_bucket, rescue_rounds):
        asked.add((cfg.k, lanes, read_bucket, ref_bucket, rescue_rounds))
        return inner(cfg, lanes, read_bucket, ref_bucket,
                     rescue_rounds=rescue_rounds)
    session._executable = spy
    return asked


def _session_pass(label: str, session, reads, refs, want, device,
                  profile: bool = False) -> dict:
    """Align (reads, refs) through `session` (submit each pair, flush,
    collect every future), the launch and transfer counts set to 0 just
    before and read just after.  Raises unless every record equals
    `want` (``GenASMAligner.align`` on the same pairs), exactly the
    backend's kernels launched (no plain version), and each dispatch and
    each rescue-rung dispatch made one upload and one download.  With
    `profile`, the pass runs under torch.profiler (``_device_breakdown``),
    and `seconds` is its host time under the profiler, without the
    profiler's start and stop."""
    backend = session.cfg.backend
    asked = _spy_shapes(session)
    genasm_dc.reset_counts()
    transfer.reset()
    got = {}
    _sync(device)
    t0 = time.perf_counter()
    if profile:
        prof = _device_breakdown(
            lambda: got.update(res=session.align(reads, refs)))
    else:
        got["res"] = session.align(reads, refs)
    _sync(device)
    seconds = prof["wall_s"] if profile else time.perf_counter() - t0
    session.close()
    launches, other = _path_counts(device, backend,
                                   f"session pass {label}")
    _assert_same_result(got["res"], want, f"session pass {label}")
    st = session.stats
    cache = session.cache.stats()
    moved = transfer.stats()
    n = st["dispatches"] + st["rescue_dispatches"]
    if (moved.h2d_calls, moved.d2h_calls) != (n, n):
        raise AssertionError(f"session pass {label}: {moved} for {n} "
                             f"dispatches (with rescue rungs)")
    if cache["hits"] + cache["misses"] != n:
        raise AssertionError(f"session pass {label}: {cache} for {n} "
                             f"dispatches")
    out = {"pass": label, "backend": backend,
           "executor": session.spec.executor,
           "rescue_mode": session.spec.rescue_mode, "pairs": len(reads),
           "seconds": seconds, "pairs_per_s": len(reads) / seconds,
           **{k: st[k] for k in ("dispatches", "lanes", "pad_lanes",
                                 "rescue_dispatches", "rescue_lanes",
                                 "wall_s", "retire_wall_s")},
           "builds": cache["lowerings"], "shapes_asked": len(asked),
           "cache_hits": cache["hits"],
           "process_executables": cache["process"]["executables"],
           "uploads": moved.h2d_calls, "downloads": moved.d2h_calls,
           "upload_bytes": moved.h2d_bytes, "download_bytes":
           moved.d2h_bytes, "launches": launches, "other_path_calls": other,
           "failed_share": float(got["res"].failed.mean()),
           "max_k_used": int(got["res"].k_used.max())}
    if profile:
        out["profile"] = prof
    emit("session", **out)
    return out


def phase_session(device: torch.device, n_pairs: int = 2048,
                  lengths=(1_000, 16_000), n_burst: int = 16,
                  n_short: int = 256, short_lengths=(300, 1_000),
                  n_cpu: int = 32) -> dict:
    """``repro_torch.api`` sessions at full width: the default
    ``AlignerConfig()`` (W=64, O=24, k=12, fused), ``rescue_rounds=2``,
    ``batch_lanes=1024``, ``max_inflight=2``, one executable store.  The
    stream: `n_pairs` CLR pairs at 10 % error, reads over `lengths`
    (1-16 kbp), `n_burst` of them with an insertion burst (the k=48
    rung).  Passes over it: (a) sync, bucket rescue, cold; (b) the same
    spec warm, under the profiler, building nothing; (c) the threaded
    executor; (d) device rescue; then (e) the split backend on `n_short`
    pairs over `short_lengths` (300-1,000 bp).  Every record equals
    ``GenASMAligner`` (fused, 2 rescue rounds) on the card, and `n_cpu`
    of the short pairs through the session on the card equal the same
    session on the CPU.  Also holds ``plan_lane_tile``'s blocks per SM
    against the card's occupancy query for K1."""
    genome = synth_genome(5_000_000, seed=2022)
    t0 = time.perf_counter()
    reads, refs, burst = ragged_pairs(genome, n_pairs, *lengths, seed=2026,
                                      n_burst=n_burst)
    short, short_refs, _ = ragged_pairs(genome, n_short, *short_lengths,
                                        seed=4052)
    sim_s = time.perf_counter() - t0
    cfg = AlignerConfig()
    t0 = time.perf_counter()
    want = GenASMAligner(cfg, rescue_rounds=2, device=device).align(
        reads, refs)
    aligner_s = time.perf_counter() - t0
    burst_k = [int(want.k_used[b]) for b in burst]
    if any(k not in (0, 48) for k in burst_k) or 48 not in burst_k:
        raise AssertionError(f"the burst reads did not need the k=48 rung: "
                             f"k_used {burst_k}")
    for b in burst:
        if not want.failed[b]:
            validate_cigar(reads[b], refs[b], want.ops[b],
                           expected_dist=int(want.dist[b]))
    want_short = GenASMAligner(cfg, rescue_rounds=2, device=device).align(
        short, short_refs)
    buckets = {}
    for r in reads:
        rb = 1 << (len(r) - 1).bit_length()
        buckets[rb] = buckets.get(rb, 0) + 1
    emit("session_stream", pairs=n_pairs, read_bp=sum(map(len, reads)),
         read_buckets=buckets, burst_lanes=burst, sim_s=sim_s,
         burst_k_used=burst_k, aligner_s=aligner_s,
         aligner_pairs_per_s=n_pairs / aligner_s, short_pairs=n_short,
         failed_share=float(want.failed.mean()))
    if len(buckets) < 4:
        raise AssertionError(f"the stream fills {buckets}: fewer than four "
                             f"read buckets")
    store = CompileCache()
    kw = dict(rescue_rounds=2, batch_lanes=1024, max_inflight=2,
              cache=store, device=device)
    passes = {}
    passes["a"] = _session_pass("a", plan(cfg, **kw), reads, refs, want,
                                device)
    if passes["a"]["builds"] != passes["a"]["shapes_asked"]:
        raise AssertionError(f"pass a built {passes['a']['builds']} "
                             f"executables for "
                             f"{passes['a']['shapes_asked']} shapes")
    passes["b"] = _session_pass("b", plan(cfg, **kw), reads, refs, want,
                                device, profile=device.type == "cuda")
    passes["c"] = _session_pass("c", plan(cfg, executor="thread", **kw),
                                reads, refs, want, device)
    for label in ("b", "c"):
        if passes[label]["builds"] != 0:
            raise AssertionError(f"warm pass {label} built "
                                 f"{passes[label]['builds']} executables")
    passes["d"] = _session_pass("d", plan(cfg, rescue_mode="device", **kw),
                                reads, refs, want, device)
    if passes["d"]["builds"] != passes["d"]["shapes_asked"]:
        raise AssertionError("pass d built an executable twice")
    passes["e"] = _session_pass("e", plan(cfg, backend="split", **kw),
                                short, short_refs, want_short, device)
    # the card against the CPU, through the same session spec
    results = {}
    for dev in (device, torch.device("cpu")):
        session = plan(cfg, rescue_rounds=2, batch_lanes=1024,
                       cache="private", device=dev)
        results[dev.type] = session.align(short[:n_cpu], short_refs[:n_cpu])
        session.close()
    _assert_same_result(results[device.type], results["cpu"],
                        "session on the card vs on the CPU")
    # the Hopper lane-tile model against the card's occupancy query
    occupancy = {e["k"]: e["blocks_per_sm"]
                 for e in launch_plan(cfg, 16_384, 2, device)
                 if e["kernel"] == "tb_fused"}
    model = {k: plan_lane_tile(cfg.replace(k=k)) // (
        H100_SMS * genasm_dc.tb_fused_geometry(cfg.replace(k=k)).lanes)
        for k in occupancy}
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else None)
    if device.type == "cuda" and (model != occupancy or sms != H100_SMS):
        raise AssertionError(f"plan_lane_tile's K1 blocks per SM {model} "
                             f"vs the card's {occupancy}, {sms} SMs")
    emit("session_checks", cpu_pairs=n_cpu, cuda_equals_cpu=True,
         k1_blocks_per_sm_model=model, k1_blocks_per_sm_card=occupancy,
         sms=sms, lane_tile_auto=plan_lane_tile(cfg),
         store=store.stats()["executables"])
    return passes


def main() -> None:
    t0 = time.perf_counter()
    phase_s = {}

    def timed(phase, fn, *args, **kw):
        start = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[phase] = time.perf_counter() - start
        return out

    smi = phase_device()
    usage = timed("build", phase_build)
    cuda = torch.device("cuda")
    rows = timed("kernel", phase_kernels, cuda, usage=usage)
    timed("k1_grid", phase_k1_grid, cuda)
    occupancy = timed("k1_occupancy", phase_k1_occupancy, usage)
    timed("tail_grid", phase_tail_grid, cuda, usage=usage)
    timed("k3_grid", phase_k3_grid, cuda, usage=usage)
    rs = timed("batch", long_reads)
    emit("batch", pairs=len(rs.reads), read_len=len(rs.reads[0]),
         sim_s=phase_s["batch"])
    fused, fused_res = timed("main_path", phase_main_path, cuda, rs)
    split = timed("main_path_split", phase_main_path_split, cuda, rs, fused,
                  fused_res, profile_rs=long_reads(1024, read_len=500))
    timed("end_to_end", phase_end_to_end, cuda)
    timed("session", phase_session, cuda)
    launches = {**fused["launches"], "dc_band": split["launches"]["dc_band"]}
    kernels = []
    for name, (_, _, replaces) in KERNELS.items():
        own = [r for r in rows if r["name"] == name]
        main_rows = [r for r in own if r["W"] == 64]
        base = main_rows[0]
        by_k = {r["k"]: dict(ms=r["ms"], event_ms=r["event_ms"],
                             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"])
                for r in main_rows}
        for r in main_rows:
            if name == "tb_fused":
                occ = occupancy[r["k"]]
                by_k[r["k"]].update(ptxas=occ["ptxas"],
                                    shared_bytes=occ["card_shared_bytes"],
                                    blocks_per_sm=occ["blocks_per_sm"])
            elif name.startswith("tail"):
                by_k[r["k"]].update({key: r[key] for key in (
                    "ptxas", "placement", "shared_bytes", "blocks_per_sm",
                    "lanes_per_block", "store_bytes_per_lane")})
            else:
                by_k[r["k"]].update({key: r[key] for key in (
                    "ptxas", "placement", "chunk", "shared_bytes",
                    "blocks_per_sm", "lanes_per_block")})
        entry = dict(
            name=name, route="cuda", source=SOURCES[name], replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in own),
            ms=base["ms"], plain_ms=base["plain_ms"],
            bound_ms=base["bound_ms"], bound_by=base["bound_by"],
            library_ms=None, W=base["W"], k=base["k"], lanes=base["lanes"],
            by_k=by_k)
        wide = [r for r in own if r["W"] != 64]
        if wide:
            entry["by_width"] = [dict(W=r["W"], k=r["k"], ms=r["ms"],
                                      bound_ms=r["bound_ms"],
                                      placement=r.get("placement"),
                                      ptxas=r.get("ptxas")) for r in wide]
        kernels.append(entry)
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=phase_s)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
