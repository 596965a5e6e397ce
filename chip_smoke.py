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
the reference's ``lane_tile='auto'`` of 2,816, then shards the pair axis
over a mesh of the card listed four times (phase ``mesh``: the aligner,
the split backend, a session and the engine, each equal to its unsharded
run).  Then the front doors a user calls, each record held against
``GenASMAligner`` on the card: the session (``repro_torch.api.plan``),
the multi-tenant gateway and the serving engine (phase ``gateway``),
and the read mapper with its X-drop pre-filter (phase ``mapper``).  Last the paper's comparison (phase
``paper``): the GenASM variants and the Edlib-like and KSW2-like
baselines on the CPU and on the card, the distance-only row through K3,
the footprint / access model and the near-duplicate operator.  Then the
LM scaffold's serving path (phase ``lm``): every architecture of
``repro_torch.models`` at its tiny size on the card against the CPU, one
layer of Granite-3-2B and of OLMoE at published widths, and Granite-3-2B
served at full width and depth in bfloat16 (prefill, decode, greedy
generation) with its times beside their bounds.  Then its training path
(phase ``train``): every architecture's train steps on the card against
the CPU, a supervised restart from checkpoints, and Llama-3.2-1B trained
at full width and depth through ``python -m repro_torch.launch.train``
(bfloat16 compute, float32 master weights and AdamW state, remat).
Every phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result, where CUDA is not available.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import re
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

# cuBLAS reads its workspace setting when CUDA starts; phase ``train``'s
# restart leg runs under torch.use_deterministic_algorithms, which asks for
# a fixed one (8 buffers of 4 MiB)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.api import (CompileCache, Gateway,             # noqa: E402
                             GatewayPolicy, ShedError, plan)
from repro_torch.api.session import build_executable           # noqa: E402
from repro_torch.baselines.dp import (INF,                      # noqa: E402
                                      affine_traceback,
                                      banded_affine_dist)
from repro_torch.baselines.myers import (banded_traceback,     # noqa: E402
                                         myers_distance)
from repro_torch.core import counting, transfer                # noqa: E402
from repro_torch.core.aligner import (AlignResult,            # noqa: E402
                                      GenASMAligner)
from repro_torch.core.config import AlignerConfig              # noqa: E402
from repro_torch.core.genasm import dc_dmajor                  # noqa: E402
from repro_torch.core.windowing import (H100_SMS,              # noqa: E402
                                        n_main_windows, pad_geometry,
                                        plan_lane_tile)
from repro_torch.core.oracle import validate_cigar             # noqa: E402
from repro_torch.data.dedup import near_duplicates             # noqa: E402
from repro_torch.data.genome import (ReadSimConfig,            # noqa: E402
                                     plant_decoys, simulate_reads,
                                     synth_genome)
from repro_torch.kernels import build, genasm_dc               # noqa: E402
from repro_torch.kernels.genasm_dc import (K3_PLACEMENTS,      # noqa: E402
                                           PLACEMENTS)
from repro_torch.distributed.sharding import pair_shards      # noqa: E402
from repro_torch.launch.mesh import make_test_mesh             # noqa: E402
from repro_torch.kernels.ops import (_to_kernel_layout,        # noqa: E402
                                    genasm_dc_op)
from repro_torch.mapper import (MapperConfig, ReadMapper,      # noqa: E402
                                pipeline, xdrop_extend)
from repro_torch.serve.engine import (AlignmentEngine,         # noqa: E402
                                      AlignRequest)
from repro_torch.serve.align_step import launch_plan           # noqa: E402
from repro_torch.data.tokens import TokenStream, to_device      # noqa: E402
from repro_torch.models.registry import (ARCH_IDS,             # noqa: E402
                                         get_config, get_model,
                                         tiny_config)
from repro_torch.serve.kvcache import (greedy_generate,        # noqa: E402
                                       pad_cache)
from repro_torch.checkpoint.ckpt import (flat_state,           # noqa: E402
                                         restore_checkpoint)
from repro_torch.launch import train as train_launch           # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, global_norm   # noqa: E402
from repro_torch.runtime.ft import FailureInjector, supervise  # noqa: E402
from repro_torch.train.step import (abstract_state,            # noqa: E402
                                    init_state, make_train_step)

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


def _smi() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = _smi()
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
           cfg: AlignerConfig | None = None, mesh=None):
    """Align `rs` through ``GenASMAligner.align`` on `backend` at `cfg`
    (default: the default geometry, W=64, O=24, k=12, ladder to 48), on
    `mesh` if one is given, the launch counts set to 0 just before and
    read just after.  Fails unless exactly the backend's kernels ran on
    the card (or, on the CPU, exactly their plain versions).  Returns the
    aligner, the result, the host seconds and the counts."""
    cfg = (cfg or AlignerConfig()).replace(backend=backend)
    aligner = GenASMAligner(cfg, rescue_rounds=2, device=device, mesh=mesh)
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
               transfers=dict(vars(aligner.transfers)), launches=taken,
               other_path_calls=other)
    emit("main_path", **out)
    if device.type == "cuda":
        _profile_later("main_path_profile",
                       lambda: aligner.align(rs.reads, rs.ref_segments))
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
               transfers=dict(vars(aligner.transfers)), launches=taken,
               other_path_calls=other)
    emit("main_path_split", **out)
    if device.type == "cuda":
        prof = profile_rs if profile_rs is not None else rs
        _profile_later("main_path_split_profile",
                       lambda: aligner.align(prof.reads, prof.ref_segments),
                       pairs=len(prof.reads), read_len=len(prof.reads[0]))
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


#: profiled runs, each deferred to phase ``profiles`` at the end of the
#: script: torch.profiler leaves CUPTI attached to the process, which slows
#: every later launch on the host (a 16 kbp bucket's graph replay took
#: 16.6 ms instead of 0.43 ms after one profile, tools/torch_graph_probe.py),
#: so no other phase runs after a profile
_PROFILES: list = []


def _profile_later(phase: str, run, top: int = 0, **fields) -> None:
    """Profile `run` (``_device_breakdown``, its `top` kernels by name) in
    phase ``profiles`` and emit it there as `phase`, with `fields`."""
    _PROFILES.append((phase, run, top, fields))


def phase_profiles() -> list:
    """Every deferred profile, in the order the phases asked for them."""
    rows = []
    for phase, run, top, fields in _PROFILES:
        rows.append(dict(**fields, **_device_breakdown(run, top)))
        emit(phase, **rows[-1])
    _PROFILES.clear()
    return rows


def _device_breakdown(run, top: int = 0) -> dict:
    """Device time of one more run of `run` under torch.profiler (CUDA
    activity), by kernel (ours by name, the rest of PyTorch's together,
    copies), beside the run's host-clock time.  Device busy time is the
    union of the intervals in which some kernel or copy ran (a session's
    retire stream may overlap the dispatch stream), the idle share the
    rest of the wall time.  It reads the profiler's raw events rather
    than ``key_averages()``, whose event tree takes minutes to build for
    a few hundred thousand launches; ``profile_s`` is the host time the
    profiler takes to stop and hand them over, and this sum.  With `top`,
    also the `top` kernel names with the most device time (ms, launches)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    ms = dict.fromkeys([*KERNELS, "torch_kernels", "memcpy"], 0.0)
    launches = dict.fromkeys(ms, 0)
    by_name = {}
    spans = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = _profiled_kernel(ev.name())
        ms[name] += ev.duration_ns() / 1e6
        launches[name] += 1
        if top:
            row = by_name.setdefault(ev.name()[:120], [0.0, 0])
            row[0] += ev.duration_ns() / 1e6
            row[1] += 1
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
    out = dict(wall_s=wall, device_ms=ms, device_launches=launches,
               device_busy_s=busy,
               idle_share=1 - busy / wall if busy else None,
               profile_s=time.perf_counter() - t1)
    if top:
        out["top_kernels"] = sorted(
            ([n, round(t, 4), c] for n, (t, c) in by_name.items()),
            key=lambda r: -r[1])[:top]
    return out


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


#: the CPU side of a card-against-CPU check pads to this many lanes: the
#: plain path's cost follows the padded lanes, and no record, rung count or
#: level count depends on the pad unit
CPU_LANE_TILE = 8


def _cuda_equals_cpu(device, backend, reads, refs, cfg=None, what=""):
    """Align on `device` (at `cfg`) and on the CPU (at `cfg` padded to
    ``CPU_LANE_TILE`` lanes); raise unless every field is equal.  Returns
    (result, aligner's last_run, seconds per device)."""
    results, runs, seconds = {}, {}, {}
    batch = SimpleNamespace(reads=reads, ref_segments=refs)
    cfg = cfg or AlignerConfig()
    for dev, dev_cfg in ((device, cfg), (torch.device("cpu"), cfg.replace(
            lane_tile=CPU_LANE_TILE))):
        aligner, results[dev.type], seconds[dev.type], _, _ = _drive(
            dev, backend, batch, dev_cfg)
        runs[dev.type] = aligner.last_run
    _assert_same_result(results[device.type], results["cpu"],
                        f"end to end ({backend}{what})")
    if any(runs[device.type][key] != runs["cpu"][key]
           for key in ("rounds_run", "levels_run_total")):
        raise AssertionError(f"end to end ({backend}{what}): ladder counts "
                             f"differ: {runs}")
    return results[device.type], runs[device.type], seconds


def phase_end_to_end(device: torch.device, n_pairs: int = 8,
                     read_len: int = 600, tile_pairs: int = 8,
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


# ---- phase 5b: the pair axis sharded over a mesh ----

def _mesh_align(device, rs, mesh, fused: dict, fused_res, what: str) -> dict:
    """(a) and (e): the fused backend on `mesh` over the main path's batch.
    Every AlignResult field and the level count equal phase main_path's
    unsharded run (``fused``, ``fused_res``), one upload and one download,
    and each kernel launched once a shard that holds a lane (every shard
    of the main batch) for each unsharded launch, no plain version."""
    aligner, res, align_s, taken, other = _drive(device, "fused", rs,
                                                 mesh=mesh)
    n = len(pair_shards(len(rs.reads), aligner.cfg, mesh))
    _assert_same_result(res, fused_res, f"mesh {what} vs main_path")
    for key in ("levels_run_total", "rounds_run"):
        if aligner.last_run[key] != fused[key]:
            raise AssertionError(f"mesh {what}: {key} "
                                 f"{aligner.last_run[key]} != {fused[key]}")
    t = aligner.transfers
    if (t.h2d_calls, t.d2h_calls) != (1, 1) or \
            (t.h2d_bytes, t.d2h_bytes) != (fused["transfers"]["h2d_bytes"],
                                           fused["transfers"]["d2h_bytes"]):
        raise AssertionError(f"mesh {what}: transfers {t} against "
                             f"{fused['transfers']} unsharded")
    want = {k: n * v for k, v in fused["launches"].items()}
    if taken != want:
        raise AssertionError(f"mesh {what}: launches {taken}, not {n} x "
                             f"the unsharded {fused['launches']}")
    n_pairs = len(rs.reads)
    out = dict(leg=what, shards=mesh.size, shards_run=n,
               devices=[str(d) for d in mesh.devices.flat],
               pairs=n_pairs, align_s=align_s, pairs_per_s=n_pairs / align_s,
               equal_to_main_path=True, **aligner.last_run,
               unsharded_ladder_s=fused["ladder_s"],
               unsharded_pairs_per_s=fused["pairs_per_s"],
               transfers=dict(vars(t)), launches=taken,
               other_path_calls=other)
    emit("mesh", **out)
    return out


def phase_mesh(device: torch.device, rs, fused: dict, fused_res,
               shards: int = 4, n_split: int = 256, split_len: int = 600,
               n_session: int = 256, session_lengths=(1_000, 4_000),
               n_burst: int = 2, batch_lanes: int = 1024, n_engine: int = 300,
               engine_lengths=(1_000, 4_000), engine_batch: int = 256,
               timeout_s: float = 600.0) -> dict:
    """The aligner's pair axis sharded over a mesh of `device` listed
    `shards` times (``make_test_mesh((shards,), ("data",))``; one H100 is
    one device, so the shards run one after another on it), the default
    ``AlignerConfig()``, ``rescue_rounds=2``.  (a) ``GenASMAligner(mesh=)``
    on the main path's batch `rs`: equal to phase main_path (``fused``,
    ``fused_res``) field for field, levels included, 1 upload / 1
    download, every kernel launched `shards` x its unsharded count.
    (b) The split backend (K3) on `n_split` reads of `split_len` bp: equal
    to the unsharded split run, K3 launched `shards` x.  (c) A threaded
    session with bucket rescue on the mesh (``batch_lanes``) over
    `n_session` CLR pairs of `session_lengths`, `n_burst` with an
    insertion burst (the k=48 rung): every record equals
    ``GenASMAligner`` on the card, one upload and one download a
    dispatch, every lane class a multiple of lane_tile x `shards`.
    (d) ``AlignmentEngine(batch_size=engine_batch, mesh=)`` on `n_engine`
    pairs: ``pad_multiple`` lane_tile x `shards`, results equal, no pad
    lane in results or stats.  (e) Where the host has more than one
    card, (a) again on a mesh of every card."""
    cfg = AlignerConfig()
    mesh = make_test_mesh((shards,), ("data",), devices=[device] * shards)
    quantum = cfg.lane_tile * shards
    out = {"a": _mesh_align(device, rs, mesh, fused, fused_res,
                            f"{shards} x {device}")}

    # (b) the split backend, sharded and not
    small = long_reads(n_split, read_len=split_len)
    runs = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        aligner, res, seconds, taken, _ = _drive(device, "split", small,
                                                 mesh=m)
        runs[label] = (res, aligner.last_run, seconds, taken)
    (base, base_run, base_s, base_taken), (res, run, seconds, taken) = \
        runs["unsharded"], runs["sharded"]
    _assert_same_result(res, base, "mesh split vs unsharded split")
    running = len(pair_shards(n_split, cfg, mesh))
    if run["levels_run_total"] != base_run["levels_run_total"] or \
            taken["dc_band"] != running * base_taken["dc_band"]:
        raise AssertionError(f"mesh split: levels {run} vs {base_run}, K3 "
                             f"{taken['dc_band']} vs {base_taken['dc_band']}")
    out["b"] = dict(leg="split", shards=shards, shards_run=running,
                    pairs=n_split,
                    read_len=split_len, seconds=seconds,
                    unsharded_seconds=base_s, equal_to_unsharded=True,
                    rounds_run=run["rounds_run"],
                    levels_run_total=run["levels_run_total"],
                    launches=taken)
    emit("mesh", **out["b"])

    # (c) the threaded session with bucket rescue on the mesh
    genome = synth_genome(5_000_000, seed=2022)
    reads, refs, burst = ragged_pairs(genome, n_session, *session_lengths,
                                      seed=8084, n_burst=n_burst)
    want = GenASMAligner(cfg, rescue_rounds=2, device=device).align(reads,
                                                                    refs)
    if int(want.k_used.max()) != 48:
        raise AssertionError("no session pair took the k=48 rung")
    session = plan(cfg, rescue_rounds=2, batch_lanes=batch_lanes,
                   executor="thread", rescue_mode="bucket", mesh=mesh,
                   cache=CompileCache(), device=device)
    ladder = session._ladder
    out["c"] = _session_pass("mesh", session, reads, refs, want, device,
                             phase="mesh_session")
    if any(c % quantum for c in ladder) or out["c"]["lanes"] % quantum or \
            out["c"]["rescue_lanes"] % quantum or \
            session._retire_thread is not None:
        raise AssertionError(f"mesh session: lane classes {ladder}, "
                             f"{out['c']['lanes']} / "
                             f"{out['c']['rescue_lanes']} lanes, not "
                             f"multiples of {quantum}, or the retire thread "
                             f"still runs")

    # (d) the engine on the mesh
    eng_reads, eng_refs, _ = ragged_pairs(genome, n_engine, *engine_lengths,
                                          seed=9095)
    want_e = GenASMAligner(cfg, rescue_rounds=2, device=device).align(
        eng_reads, eng_refs)
    eng = AlignmentEngine(cfg, batch_size=engine_batch, rescue_rounds=2,
                          mesh=mesh, device=device)
    if eng.pad_multiple != quantum:
        raise AssertionError(f"engine pad_multiple {eng.pad_multiple}")
    for i, (r, f) in enumerate(zip(eng_reads, eng_refs)):
        eng.submit(AlignRequest(rid=i, read=r, ref=f))
    genasm_dc.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    stats = eng.serve_until_empty()
    _sync(device)
    eng_s = time.perf_counter() - t0
    e_launches, _ = _path_counts(device, "fused", "mesh engine")
    eng.close()
    if set(eng.results) != set(range(n_engine)) or \
            stats["aligned"] + stats["failed"] != n_engine:
        raise AssertionError(f"mesh engine: a pad lane reached the "
                             f"results or stats: {stats}")
    for i in range(n_engine):
        got = eng.results[i]
        if (got["ok"], got["dist"], got["cigar"], got["k_used"]) != (
                not want_e.failed[i], int(want_e.dist[i]), want_e.cigars[i],
                int(want_e.k_used[i])):
            raise AssertionError(f"mesh engine result {i} differs")
    out["d"] = dict(leg="engine", shards=shards, pairs=n_engine,
                    batch_size=eng.batch_size, pad_multiple=eng.pad_multiple,
                    seconds=eng_s, stats=stats, equal_to_aligner=True,
                    launches=e_launches)
    emit("mesh", **out["d"])

    # (e) every card of the host, where there is more than one
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards > 1:
        out["e"] = _mesh_align(device, rs, make_test_mesh((cards,),
                                                          ("data",)),
                               fused, fused_res, f"{cards} cards")
    else:
        emit("mesh", leg="every card", ran=False,
             reason=f"{max(cards, 1)} device")
    return out


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
                  profile=None, phase: str = "session") -> dict:
    """Align (reads, refs) through `session` (submit each pair, flush,
    collect every future), the launch and transfer counts set to 0 just
    before and read just after.  Raises unless every record equals
    `want` (``GenASMAligner.align`` on the same pairs), exactly the
    backend's kernels launched (no plain version), and each dispatch and
    each rescue-rung dispatch made one upload and one download.
    `profile`, a callable that aligns the pairs once more through a warm
    session, is profiled in phase ``profiles`` (``_profile_later``)."""
    backend = session.cfg.backend
    asked = _spy_shapes(session)
    genasm_dc.reset_counts()
    transfer.reset()
    got = {}
    _sync(device)
    t0 = time.perf_counter()
    got["res"] = session.align(reads, refs)
    _sync(device)
    seconds = time.perf_counter() - t0
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
    if profile is not None:
        _profile_later(f"{phase}_profile", profile, pass_=label)
    emit(phase, **out)
    return out


def phase_session(device: torch.device, n_pairs: int = 1024,
                  lengths=(1_000, 16_000), n_burst: int = 8,
                  n_short: int = 128, short_lengths=(300, 1_000),
                  n_cpu: int = 8) -> dict:
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
    passes["b"] = _session_pass(
        "b", plan(cfg, **kw), reads, refs, want, device,
        profile=(lambda: plan(cfg, **kw).align(reads, refs))
        if device.type == "cuda" else None)
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


# ---- phase graphs: the session's executables as captured CUDA graphs ----

def _same_step_output(got, want, what: str) -> None:
    """Raise unless two align steps' (out, summary) are equal field for
    field (a mesh's per-shard tuples shard for shard)."""
    for part, a, b in (("out", got[0], want[0]), ("summary", got[1],
                                                  want[1])):
        if set(a) != set(b):
            raise AssertionError(f"{what}: {part} keys {set(a)} vs "
                                 f"{set(b)}")
        for key in b:
            x, y = a[key], b[key]
            pairs = zip(x, y) if isinstance(y, tuple) else [(x, y)]
            for u, v in pairs:
                same = (torch.equal(u, v) if isinstance(v, torch.Tensor)
                        else u == v)
                if not same:
                    raise AssertionError(f"{what}: {part}[{key!r}] differs")


def _graph_against_eager(exe, args, device, what: str) -> dict:
    """One captured executable's call against its eager step on the same
    inputs: every output field equal and the same kernel launches.
    Returns the launches, the host time of the call (it returns before
    the device finishes) and to the end of the device's work, the eager
    step's, and the graphs' own figures."""
    if device.type == "cuda" and exe.graphs is None:
        raise AssertionError(f"{what}: the executable was not captured")
    _sync(device)
    genasm_dc.reset_counts()
    t0 = time.perf_counter()
    got = exe(*args)
    call_s = time.perf_counter() - t0
    _sync(device)
    graph_s = time.perf_counter() - t0
    graph_launches = dict(genasm_dc.LAUNCHES)
    genasm_dc.reset_counts()
    t0 = time.perf_counter()
    want = exe.step(*args)
    _sync(device)
    eager_s = time.perf_counter() - t0
    eager_launches = dict(genasm_dc.LAUNCHES)
    _same_step_output(got, want, what)
    if graph_launches != eager_launches:
        raise AssertionError(f"{what}: the graphs launched "
                             f"{graph_launches}, the eager step "
                             f"{eager_launches}")
    row = dict(what=what, equal_to_eager=True, launches=graph_launches,
               call_s=call_s, graph_s=graph_s, eager_s=eager_s)
    if exe.graphs is not None:
        row.update(_graph_figures(exe))
    return row


def _graph_figures(exe) -> dict:
    """What one executable's capture cost: per graph its nodes, capture
    and instantiate seconds and launches; the memory pool's and the static
    inputs' bytes."""
    g = exe.graphs
    return dict(graphs=[{k: st[k] for k in ("rung", "shard", "nodes",
                                            "capture_s", "instantiate_s")}
                        for st in g.stats],
                nodes=sum(st["nodes"] or 0 for st in g.stats),
                pool_bytes=g.pool_bytes, argument_bytes=g.argument_bytes,
                compile_s=g.compile_s)


def _dispatch_parts(session, cfg, lanes: int, bucket, pairs, device,
                    reps: int = 3) -> dict:
    """Host seconds of each part of one warm bucket-mode dispatch, the
    median of `reps`, each from an idle card: the padding, the upload, the
    executable's call (copy-in, replay, clone-out) and the graph's
    replay alone."""
    reads, refs, _ = pairs
    rb, fb = bucket
    Lr, Lf = pad_geometry(cfg, rb, fb, 0)
    exe = session._executable(cfg, lanes, rb, fb, rescue_rounds=None)
    arrays = session._pad_batch(reads, refs, lanes, Lr, Lf)
    args = transfer.to_device(arrays, device)
    parts = {"pad": lambda: session._pad_batch(reads, refs, lanes, Lr, Lf),
             "upload": lambda: transfer.to_device(arrays, device),
             "call": lambda: exe(*args)}
    if exe.graphs is not None:
        parts["replay"] = exe.graphs.rungs[0][0].replay
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(reps):
            _sync(device)
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        out[name] = float(np.median(times))
    _sync(device)
    return out


def phase_graphs(device: torch.device, lanes: int = 1024,
                 short_lengths=(600, 1_000), long_lengths=(9_000, 15_500),
                 n_burst: int = 4, reps: int = 3, n_tenant: int = 32,
                 tenant_short=(1_000, 2_000), tenant_bulk=(8_000, 16_000),
                 gateway_lanes: int = 512, linger_s: float = 0.05,
                 gateway_store=None, timeout_s: float = 600.0) -> list:
    """The session's executables as captured CUDA graphs
    (``serve.graphs``), held against their eager steps on the card; budget
    40 s.  Default ``AlignerConfig()`` (W=64, O=24, k=12, fused),
    ``rescue_rounds=2``, `lanes` a dispatch.  (a) Bucket mode at a 1 kbp
    and a 16 kbp read bucket (`short_lengths`, `long_lengths`): ``exe(*
    args)`` against ``exe.step(*args)`` on the same uploaded batch, every
    output field and the kernel launches equal; each graph's nodes,
    memory pool, capture and instantiate seconds.  (b) Device mode at the
    1 kbp bucket, `n_burst` lanes with an insertion burst so all three
    rung graphs run: the same checks.  (c) ``session.dispatch`` wall
    (the session's ``wall_s``) of each bucket, warm, `reps` times in
    turns, with the upload's host time beside it (a spy on
    ``transfer.to_device``), the executable's call (span
    ``device.execute``) and the batch's submits less the dispatch (the
    padding, staged as pairs arrive); every record equal to
    ``GenASMAligner``; and each part of a dispatch timed alone from an
    idle card (``_dispatch_parts``).
    (d) Two threaded sessions sharing one compile cache, from two client
    threads, on the 1 kbp bucket: records equal.  (f) A 16 kbp capture on
    one thread while another launches, downloads and pins memory in a
    loop: the graphs equal the eager step.  (e) The gateway at the
    reference's 50 ms linger (`linger_s`) on a threaded session
    (`gateway_lanes`): `n_tenant` short and `n_tenant` bulk pairs as in
    phase ``gateway``, records equal; dispatches and mean pairs a
    dispatch.  With `gateway_store` (phase ``gateway``'s executables: the
    same spec and pairs) the pass measures dispatching, not builds."""
    genome = synth_genome(5_000_000, seed=2022)
    cfg = AlignerConfig()
    t0 = time.perf_counter()
    sets = {"1k": ragged_pairs(genome, lanes, *short_lengths, seed=8081,
                               n_burst=n_burst),
            "16k": ragged_pairs(genome, lanes, *long_lengths, seed=9091)}
    sim_s = time.perf_counter() - t0
    want = {name: GenASMAligner(cfg, rescue_rounds=2, device=device).align(
        reads, refs) for name, (reads, refs, _) in sets.items()}
    if int(want["1k"].k_used.max()) != 48:
        raise AssertionError("no burst lane of the 1 kbp set took k=48")
    store = CompileCache()
    session = plan(cfg, rescue_rounds=2, batch_lanes=lanes,
                   max_inflight=2, cache=store, device=device)
    longest = {name: (max(map(len, reads)), max(map(len, refs)))
               for name, (reads, refs, _) in sets.items()}
    buckets = {name: session.bucket_for(*n) for name, n in longest.items()}
    emit("graphs_stream", sim_s=sim_s, buckets=buckets, pairs=lanes,
         threads=[t.name for t in threading.enumerate()],
         main_windows={name: n_main_windows(rb, cfg)
                       for name, (rb, _) in buckets.items()})
    rows = []

    def bucket_args(name, rounds):
        reads, refs, _ = sets[name]
        rb, fb = buckets[name]
        Lr, Lf = pad_geometry(cfg, rb, fb, rounds or 0)
        arrays = session._pad_batch(reads, refs, lanes, Lr, Lf)
        return (rb, fb), transfer.to_device(arrays, device)

    # (a) and (b): captured against eager
    for name, rounds in (("1k", None), ("16k", None), ("1k", 2)):
        (rb, fb), args = bucket_args(name, rounds)
        t0 = time.perf_counter()
        exe = session._executable(cfg, lanes, rb, fb, rescue_rounds=rounds)
        build_s = time.perf_counter() - t0
        row = _graph_against_eager(
            exe, args, device, f"{name} bucket, rescue_rounds={rounds}")
        row.update(bucket=[rb, fb], lanes=lanes, build_s=build_s,
                   main_windows=n_main_windows(rb, cfg),
                   mode="bucket" if rounds is None else "device")
        rows.append(row)
        emit("graphs", **row)

    # (c) the dispatch wall, warm, the buckets in turns
    session.warmup(longest.values())
    uploads = []
    upload = transfer.to_device

    def timed_upload(*a, **kw):
        t = time.perf_counter()
        out = upload(*a, **kw)
        uploads.append(time.perf_counter() - t)
        return out
    walls = {name: [] for name in sets}
    futs = {name: [] for name in sets}
    transfer.to_device = timed_upload
    session.obs.tracer.reset()
    try:
        for _ in range(reps):
            for name, (reads, refs, _) in sets.items():
                w0 = session.stats["wall_s"]
                t0 = time.perf_counter()
                futs[name].append([session.submit(r, f)
                                   for r, f in zip(reads, refs)])
                wall = session.stats["wall_s"] - w0
                walls[name].append(dict(
                    wall_s=wall, upload_s=uploads[-1],
                    staging_s=time.perf_counter() - t0 - wall))
        executes = [r["t1"] - r["t0"] for r in session.obs.tracer.records()
                    if r["name"] == "device.execute"]
        session.flush()
        for name, per_rep in futs.items():
            for fs in per_rep:
                _assert_records([f.result() for f in fs], want[name],
                                f"graphs dispatch pass, {name}")
    finally:
        transfer.to_device = upload
    session.close()
    for i, row in enumerate(w for rep in zip(*walls.values()) for w in rep):
        row["execute_s"] = executes[i]      # the executable's call
    net = {name: float(np.median([w["wall_s"] - w["upload_s"] for w in v]))
           for name, v in walls.items()}
    rows.append(dict(what="dispatch wall", walls_s=walls, net_median_s=net,
        ratio_16k_to_1k=net["16k"] / net["1k"],
        parts_s={name: _dispatch_parts(session, cfg, lanes, buckets[name],
                                       sets[name], device)
                 for name in sets},
        executables=[dict(key=str(k[1:6]), **_graph_figures(e))
                     for k, e in store._exe.items()
                     if getattr(e, "graphs", None) is not None]))
    emit("graphs", **rows[-1])

    # (d) two threaded sessions on one compile cache, one bucket
    reads, refs, _ = sets["1k"]
    pair = [plan(cfg, rescue_rounds=2, batch_lanes=lanes // 4,
                 executor="thread", cache=store, device=device)
            for _ in range(2)]
    got, errors = [None] * len(reads), []

    def client(s, lanes_of):
        try:
            fs = [(i, s.submit(reads[i], refs[i])) for i in lanes_of]
            s.flush()
            for i, f in fs:
                got[i] = f.result(timeout=timeout_s)
        except BaseException as e:               # reported below
            errors.append(e)
    threads = [threading.Thread(target=client, args=(
        s, range(j, len(reads), 2))) for j, s in enumerate(pair)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    shared_s = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"shared-cache sessions failed: {errors}")
    _assert_records(got, want["1k"], "two sessions on one compile cache")
    shared_hits = sum(s.cache.shared_hits for s in pair)
    for s in pair:
        s.close()
    rows.append(dict(what="two threaded sessions, one cache",
                     pairs=len(reads), seconds=shared_s,
                     equal_to_aligner=True, shared_hits=shared_hits,
                     builds=sum(s.cache.lowerings for s in pair)))
    emit("graphs", **rows[-1])

    # (f) a capture while another thread launches, downloads (a stream
    # sync) and pins memory; a device-wide sync is refused while any stream
    # captures (serve.graphs)
    half = lanes // 2
    reads, refs, _ = sets["16k"]
    rb, fb = buckets["16k"]
    Lr, Lf = pad_geometry(cfg, rb, fb, 0)
    args = transfer.to_device(session._pad_batch(
        reads[:half], refs[:half], half, Lr, Lf), device)
    built, errors = [], []

    def build():
        try:
            built.append(build_executable(cfg, half, rb, fb, None, device))
        except BaseException as e:               # reported below
            errors.append(e)
    thread = threading.Thread(target=build)
    thread.start()
    syncs = 0
    probe = torch.zeros(1 << 16, dtype=torch.uint8, device=device)
    while thread.is_alive():
        probe.add_(1).cpu()           # a launch, a download, a stream sync
        torch.empty(1 << 20, dtype=torch.uint8,
                    pin_memory=device.type == "cuda")
        syncs += 1
    thread.join()
    if errors:
        raise AssertionError(f"a capture beside another thread's syncs "
                             f"failed: {errors}")
    rows.append(_graph_against_eager(
        built[0], args, device, "capture beside another thread's syncs"))
    rows[-1].update(other_thread_syncs=syncs, lanes=half)
    emit("graphs", **rows[-1])

    # (e) the gateway at the reference's 50 ms linger, cold
    short, short_refs, _ = ragged_pairs(genome, n_tenant, *tenant_short,
                                        seed=5051)
    bulk, bulk_refs, _ = ragged_pairs(genome, n_tenant, *tenant_bulk,
                                      seed=6062, n_burst=2)
    want_t = GenASMAligner(cfg, rescue_rounds=2, device=device).align(
        short + bulk, short_refs + bulk_refs)
    gw_session = plan(cfg, rescue_rounds=2, batch_lanes=gateway_lanes,
                      executor="thread", cache=gateway_store or CompileCache(),
                      device=device)
    tenants = {"short": (0, 60.0, short, short_refs),
               "bulk": (1, None, bulk, bulk_refs)}
    gw, gfuts, seconds, (launches, _) = _gateway_pass(
        device, gw_session, tenants, 8, linger_s, 0.005, timeout_s)
    for name, rows_of in (("short", range(n_tenant)),
                          ("bulk", range(n_tenant, 2 * n_tenant))):
        _assert_records([f.result() for f in gfuts[name]],
                        _take(want_t, rows_of), f"50 ms gateway, {name}")
    st = gw.gateway_stats()
    n_disp = len(gw.dispatch_log)
    rows.append(dict(what="gateway", linger_s=linger_s,
                     pairs=2 * n_tenant, seconds=seconds,
                     pairs_per_s=2 * n_tenant / seconds,
                     dispatches=n_disp,
                     mean_pairs_per_dispatch=st["dispatched"] / n_disp,
                     partial_dispatches=st["partial_dispatches"],
                     builds=gw_session.cache.stats()["lowerings"],
                     launches=launches, equal_to_aligner=True))
    gw_session.close()
    emit("graphs", **rows[-1])
    if device.type == "cuda" and net["16k"] > 2 * net["1k"]:
        raise AssertionError(f"a 16 kbp dispatch less its upload took "
                             f"{net['16k']:.4f} s, over twice the 1 kbp "
                             f"bucket's {net['1k']:.4f} s")
    return rows


# ---- phase 7: the gateway and the serving engine at full width ----

def _assert_records(recs, want, what: str) -> None:
    """Raise unless the session records `recs` equal `want` (an
    AlignResult of the same pairs) field for field."""
    _assert_same_result(AlignResult.from_records(recs), want, what)


def _gateway_pass(device, session, tenants, n_threads: int, linger_s: float,
                  sweep_s: float, timeout_s: float):
    """Push every tenant's pairs through one Gateway on `session`
    (``GatewayPolicy(linger_s=linger_s)``) from `n_threads` client threads
    (split evenly over the tenants), with the sweeper running.
    `tenants`: {name: (priority, deadline_s, reads, refs)}.  Returns (gateway, {name: futures in input order}, seconds,
    launch counts); the counts are set to 0 just before the first submit
    and read after the last result."""
    gw = Gateway(session, GatewayPolicy(linger_s=linger_s))
    gw.start_sweeper(sweep_s)
    futs = {name: [None] * len(t[2]) for name, t in tenants.items()}
    errors = []
    per_tenant = n_threads // len(tenants)

    def client(name, shard):
        try:
            priority, deadline, reads, refs = tenants[name]
            ten = gw.tenant(name, priority=priority, deadline_s=deadline)
            for j in shard:
                futs[name][j] = ten.submit(reads[j], refs[j])
            for j in shard:
                futs[name][j].result(timeout=timeout_s)
        except BaseException as e:               # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(
        name, range(i, len(t[2]), per_tenant)))
        for name, t in tenants.items() for i in range(per_tenant)]
    genasm_dc.reset_counts()
    transfer.reset()
    _sync(device)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    gw.close()          # drained: nothing builds (captures) any more
    _sync(device)
    seconds = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or errors:
        raise AssertionError(f"gateway clients failed or hung: {errors}")
    counts = _path_counts(device, "fused", "gateway pass")
    return gw, futs, seconds, counts


def phase_gateway(device: torch.device, n_short: int = 64,
                  short_lengths=(1_000, 2_000), n_bulk: int = 64,
                  bulk_lengths=(8_000, 16_000), n_burst: int = 2,
                  short_deadline_s: float = 60.0, batch_lanes: int = 512,
                  n_threads: int = 8, linger_s: float = 1.0,
                  shed_capacity: int = 256, n_shed_bulk: int = 300,
                  n_shed_short: int = 64, n_engine: int = 600,
                  engine_lengths=(1_000, 4_000), engine_batch: int = 256,
                  n_engine_gateway: int = 8,
                  timeout_s: float = 600.0) -> None:
    """``repro_torch.api.Gateway`` and ``serve.engine.AlignmentEngine`` at
    full width: the default ``AlignerConfig()`` (W=64, O=24, k=12, fused,
    ``rescue_rounds=2``).  (a) Two tenants on one threaded session
    (``batch_lanes``), each fed by half of `n_threads` client threads,
    the sweeper at 5 ms, ``GatewayPolicy(linger_s=linger_s)`` (capacity
    from the session).  The default linger of 50 ms sends every bucket
    out in slivers of a few pairs once the first dispatch holds the
    gateway for longer than that (PERF.md section 6), and each dispatch
    runs its bucket's whole window loop; 1 s lets the clients queue their
    pairs first: ``short`` (priority 0, `short_deadline_s`, `n_short`
    pairs over `short_lengths`) and ``bulk`` (priority 1, no deadline,
    `n_bulk` pairs over `bulk_lengths`, `n_burst` with an insertion burst
    so the k=24 and k=48 rungs run); every record equals
    ``GenASMAligner`` on the card, the stats reconcile and K1, K2, K4
    (and no plain version) ran.  (b) A deterministic shed pass: a gateway
    of ``capacity=shed_capacity`` without pumping takes `n_shed_bulk`
    bulk then `n_shed_short` short pairs (a tenant's pairs taken again
    from its first where it has fewer); exactly the bulk beyond 0.75 x
    capacity shed, none dispatched, and the admitted records equal.
    (c) ``AlignmentEngine(batch_size=engine_batch)`` on `n_engine` pairs
    over `engine_lengths` (device left at its default on the card): its
    results equal, its last batch padded; then `n_engine_gateway` pairs
    through ``engine.gateway()``.  Returns the main pass's executable
    store."""
    genome = synth_genome(5_000_000, seed=2022)
    t0 = time.perf_counter()
    short, short_refs, _ = ragged_pairs(genome, n_short, *short_lengths,
                                        seed=5051)
    bulk, bulk_refs, burst = ragged_pairs(genome, n_bulk, *bulk_lengths,
                                          seed=6062, n_burst=n_burst)
    sim_s = time.perf_counter() - t0
    cfg = AlignerConfig()
    t0 = time.perf_counter()
    want = GenASMAligner(cfg, rescue_rounds=2, device=device).align(
        short + bulk, short_refs + bulk_refs)
    aligner_s = time.perf_counter() - t0
    want_short = _take(want, range(n_short))
    want_bulk = _take(want, range(n_short, n_short + n_bulk))
    if int(want_bulk.k_used.max()) != 48:
        raise AssertionError("no bulk pair took the k=48 rung")
    store = CompileCache()
    session = plan(cfg, rescue_rounds=2, batch_lanes=batch_lanes,
                   executor="thread", cache=store, device=device)
    tenants = {"short": (0, short_deadline_s, short, short_refs),
               "bulk": (1, None, bulk, bulk_refs)}
    gw, futs, seconds, (launches, other) = _gateway_pass(
        device, session, tenants, n_threads, linger_s, 0.005, timeout_s)
    for name, w in (("short", want_short), ("bulk", want_bulk)):
        _assert_records([f.result() for f in futs[name]], w,
                        f"gateway tenant {name}")
    n = n_short + n_bulk
    st = gw.gateway_stats()
    if (st["submitted"], st["completed"], st["dispatched"]) != (n, n, n) \
            or any(st[k] for k in ("shed", "expired", "cancelled", "failed",
                                   "deadline_misses", "queued",
                                   "outstanding")) \
            or st["deadline_hits"] != n \
            or st["tenants"]["short"]["deadline_hits"] != n_short:
        raise AssertionError(f"gateway stats do not reconcile: {st}")
    latency = {}
    for name, fs in futs.items():
        p50, p99 = np.percentile([f.latency for f in fs], (50, 99))
        latency[name] = dict(p50_s=float(p50), p99_s=float(p99),
                             max_s=max(f.latency for f in fs))
    moved = transfer.stats()
    emit("gateway", pass_="main", pairs=n, short=n_short, bulk=n_bulk,
         linger_s=linger_s,
         read_bp=sum(map(len, short + bulk)), burst_lanes=burst,
         sim_s=sim_s, aligner_s=aligner_s,
         aligner_pairs_per_s=n / aligner_s, seconds=seconds,
         pairs_per_s=n / seconds, equal_to_aligner=True, latency=latency,
         dispatches=len(gw.dispatch_log),
         partial_dispatches=st["partial_dispatches"], pumps=st["pumps"],
         capacity=st["capacity"], shed=st["shed"],
         session={k: session.stats[k] for k in (
             "dispatches", "lanes", "pad_lanes", "rescue_dispatches",
             "rescue_lanes", "wall_s", "retire_wall_s")},
         builds=session.cache.stats()["lowerings"],
         uploads=moved.h2d_calls, downloads=moved.d2h_calls,
         launches=launches, other_path_calls=other,
         max_k_used=int(want.k_used.max()),
         failed_share=float(want.failed.mean()))

    # (b) deterministic shedding: no pump, so nothing leaves the system
    gw = Gateway(session, GatewayPolicy(capacity=shed_capacity),
                 auto_pump=False)
    before = gw.stats              # the session's registry: cumulative
    sheds = {0: 0, 1: 0}
    admitted = {"short": [], "bulk": []}
    requests_before = session.stats["requests"]
    for name, priority, reads, refs, count in (
            ("bulk", 1, bulk, bulk_refs, n_shed_bulk),
            ("short", 0, short, short_refs, n_shed_short)):
        ten = gw.tenant(name, priority=priority)
        for j in (i % len(reads) for i in range(count)):
            try:
                admitted[name].append((j, ten.submit(reads[j], refs[j])))
            except ShedError:
                sheds[priority] += 1
    bulk_room = math.ceil(0.75 * shed_capacity)    # GatewayPolicy()
    want_shed = {1: max(0, n_shed_bulk - bulk_room),
                 0: max(0, n_shed_short - (shed_capacity
                                           - min(n_shed_bulk, bulk_room)))}
    if sheds != want_shed or session.stats["requests"] != requests_before:
        raise AssertionError(f"shed pass: shed {sheds} (expected "
                             f"{want_shed}), session saw "
                             f"{session.stats['requests'] - requests_before}"
                             f" requests before the flush")
    gw.flush_all()
    for name, w in (("short", want_short), ("bulk", want_bulk)):
        rows = [j for j, _ in admitted[name]]
        _assert_records([f.result(timeout=timeout_s)
                         for _, f in admitted[name]], _take(w, rows),
                        f"shed pass, admitted {name}")
    n_admitted = sum(map(len, admitted.values()))
    st = {k: v - before[k] for k, v in gw.stats.items()}
    gw.close()
    session.close()
    if (session.stats["requests"] - requests_before != n_admitted
            or st["dispatched"] != n_admitted
            or st["shed"] != sum(sheds.values())):
        raise AssertionError(f"shed pass: a shed request was dispatched: "
                             f"{st}")
    emit("gateway", pass_="shed", capacity=shed_capacity,
         submitted_bulk=n_shed_bulk, submitted_short=n_shed_short,
         shed_by_priority=sheds, admitted=n_admitted,
         dispatched=st["dispatched"], equal_to_aligner=True)

    # (c) the engine, its device left at its default on the card
    eng_reads, eng_refs, _ = ragged_pairs(genome, n_engine, *engine_lengths,
                                          seed=7073)
    want_e = GenASMAligner(cfg, rescue_rounds=2, device=device).align(
        eng_reads, eng_refs)
    kw = {} if device.type == "cuda" else {"device": device}
    eng = AlignmentEngine(AlignerConfig(), batch_size=engine_batch,
                          rescue_rounds=2, **kw)
    if eng.aligner.device.type != device.type:
        raise AssertionError(f"engine on {eng.aligner.device}")
    for i, (r, f) in enumerate(zip(eng_reads, eng_refs)):
        eng.submit(AlignRequest(rid=i, read=r, ref=f))
    genasm_dc.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    stats = eng.serve_until_empty()
    _sync(device)
    eng_s = time.perf_counter() - t0
    e_launches, e_other = _path_counts(device, "fused", "engine")
    for i in range(n_engine):
        got = eng.results[i]
        if (got["ok"], got["dist"], got["cigar"], got["k_used"]) != (
                not want_e.failed[i], int(want_e.dist[i]), want_e.cigars[i],
                int(want_e.k_used[i])):
            raise AssertionError(f"engine result {i} differs")
    n_batches = -(-n_engine // engine_batch)
    pad = n_batches * engine_batch - n_engine
    if (stats["batches"], stats["padded_lanes"]) != (n_batches, pad) \
            or stats["aligned"] + stats["failed"] != n_engine:
        raise AssertionError(f"engine stats: {stats}")
    with eng.gateway() as egw:
        ten = egw.tenant("t", priority=0)
        efuts = [ten.submit(eng_reads[i], eng_refs[i])
                 for i in range(n_engine_gateway)]
        _assert_records([f.result(timeout=timeout_s) for f in efuts],
                        _take(want_e, range(n_engine_gateway)),
                        "engine.gateway()")
    eng.close()
    emit("engine", pairs=n_engine, batch_size=engine_batch,
         seconds=eng_s, pairs_per_s=n_engine / eng_s,
         equal_to_aligner=True, stats=stats,
         gateway_pairs=n_engine_gateway, launches=e_launches,
         other_path_calls=e_other)
    return store


def _take(res, rows):
    """The AlignResult of the lanes `rows` of `res`."""
    rows = list(rows)
    return AlignResult(res.dist[rows], [res.cigars[i] for i in rows],
                       [res.ops[i] for i in rows], res.failed[rows],
                       res.k_used[rows], res.read_consumed[rows],
                       res.ref_consumed[rows])


# ---- phase 8: the read mapper at full width ----

def _stage_seconds(mapper) -> dict:
    """Seconds of each funnel stage of the mapper's last batch, from its
    obs spans."""
    recs = mapper.obs.tracer.records()
    batch = [r for r in recs if r["name"] == "mapper.map_batch"][-1]
    out = {"map_batch": batch["t1"] - batch["t0"]}
    for r in recs:
        if r["parent"] == batch["sid"]:
            out[r["name"]] = out.get(r["name"], 0.0) + r["t1"] - r["t0"]
    return out


def phase_mapper(device: torch.device, genome_len: int = 5_000_000,
                 n_reads: int = 1024, read_len: int = 1_000,
                 batch_lanes: int = 1024, n_cpu: int = 16) -> None:
    """``repro_torch.mapper.ReadMapper(genome, MapperConfig(),
    rescue_rounds=2, batch_lanes=...)`` on the default config and device:
    `n_reads` CLR reads of `read_len` at 10 % error from the 5 Mbp genome
    (seed 2022) with 4 planted partial-repeat decoys a read, mapped twice
    (the second batch is the steady one, its counts set to 0 just before
    it).  Holds: every mapped read's CIGAR, dist, k_used and ref_end
    equal to a direct ``GenASMAligner`` of the read against its winning
    candidate's window; the pre-filter's scores on `device` equal to
    ``xdrop_extend`` on the CPU; `n_cpu` reads through a CPU mapper equal
    field for field; ``examples/map_reads.py``'s floors (recall at the
    true locus >= 95 %, no read at a decoy, kill rate > 0.2); K1, K2, K4
    launched, no plain call."""
    genome = synth_genome(genome_len, seed=2022)
    t0 = time.perf_counter()
    rs = simulate_reads(genome, n_reads, ReadSimConfig(
        read_len=read_len, error_rate=0.10, seed=2022))
    g2, decoy_pos = plant_decoys(genome, rs, decoys_per_read=4)
    sim_s = time.perf_counter() - t0
    kw = {} if device.type == "cuda" else {"device": device}
    t0 = time.perf_counter()
    mapper = ReadMapper(g2, MapperConfig(), rescue_rounds=2,
                        batch_lanes=batch_lanes, **kw)
    index_s = time.perf_counter() - t0
    if mapper.session.device.type != device.type:
        raise AssertionError(f"mapper on {mapper.session.device}")
    t0 = time.perf_counter()
    cold = mapper.map_batch(rs.reads)
    cold_s = time.perf_counter() - t0
    seen = []
    inner = pipeline.xdrop_extend

    def spy(reads, refs, **kw):
        scores = inner(reads, refs, **kw)
        seen.append((reads, refs, kw, scores))
        return scores

    pipeline.xdrop_extend = spy
    try:
        genasm_dc.reset_counts()
        transfer.reset()
        _sync(device)
        t0 = time.perf_counter()
        out = mapper.map_batch(rs.reads)
        _sync(device)
        steady_s = time.perf_counter() - t0
    finally:
        pipeline.xdrop_extend = inner
    launches, other = _path_counts(device, "fused", "mapper")
    moved = transfer.stats()
    stages = _stage_seconds(mapper)
    if [dataclasses.astuple(m) for m in out.mapped] != \
            [dataclasses.astuple(m) for m in cold.mapped]:
        raise AssertionError("the two map_batch calls differ")
    # the pre-filter on the card against the CPU, every lane of the batch
    (packed_r, packed_f, xkw, scores), = seen
    if xkw.get("device") != mapper.session.device:
        raise AssertionError(f"pre-filter ran on {xkw.get('device')}")
    cpu_scores = xdrop_extend(packed_r, packed_f, band=xkw["band"],
                              x_drop=xkw["x_drop"], device="cpu")
    if not np.array_equal(scores, cpu_scores):
        raise AssertionError("pre-filter scores on the card differ from "
                             "the CPU's")
    prefilter = dict(lanes=int(packed_r.shape[0]),
                     candidates=out.stats["n_candidates"],
                     steps=int(packed_r.shape[1] + packed_f.shape[1]))
    if device.type == "cuda":
        _profile_later("mapper_prefilter_profile", lambda: xdrop_extend(
            packed_r, packed_f, band=xkw["band"], x_drop=xkw["x_drop"],
            device=device), **prefilter)
    # mapped reads against a direct alignment of their winning windows
    rows, windows = [], []
    for mr in out.mapped:
        if mr.ok:
            c = next(c for c in mr.candidates
                     if c.ok and c.ref_start == mr.ref_start)
            rows.append(mr)
            windows.append((c.ref_start, c.ref_end))
    direct = GenASMAligner(AlignerConfig(), rescue_rounds=2,
                           device=device).align(
        [rs.reads[mr.read_id] for mr in rows],
        [g2[a:b] for a, b in windows])
    for i, mr in enumerate(rows):
        if (mr.cigar, mr.dist, mr.k_used, mr.ref_end) != (
                direct.cigars[i], int(direct.dist[i]),
                int(direct.k_used[i]),
                windows[i][0] + int(direct.ref_consumed[i])) \
                or direct.failed[i]:
            raise AssertionError(f"mapped read {mr.read_id} differs from "
                                 f"its direct alignment")
    # the CPU mapper on the first reads
    with ReadMapper(g2, MapperConfig(), rescue_rounds=2,
                    batch_lanes=batch_lanes, device="cpu") as cpu_mapper:
        t0 = time.perf_counter()
        cpu_out = cpu_mapper.map_batch(rs.reads[:n_cpu])
        cpu_s = time.perf_counter() - t0
    if [dataclasses.astuple(m) for m in cpu_out.mapped] != \
            [dataclasses.astuple(m) for m in out.mapped[:n_cpu]]:
        raise AssertionError("the CPU mapper's reads differ from the "
                             "card's")
    st = out.stats
    hits = sum(1 for mr, tp in zip(out.mapped, rs.true_pos)
               if mr.ok and abs(mr.ref_start - tp) <= 20)
    decoy_hits = sum(1 for mr in out.mapped if mr.ok and any(
        abs(mr.ref_start - dp) <= 50 for dp in decoy_pos[mr.read_id]))
    recall = hits / st["n_reads"]
    mapper.close()
    emit("mapper", reads=n_reads, read_len=read_len, genome_bp=genome_len,
         sim_s=sim_s, index_s=index_s, index=mapper.index.stats(),
         funnel=st, recall=recall, decoy_hits=decoy_hits,
         cold_s=cold_s, steady_s=steady_s, reads_per_s=n_reads / steady_s,
         stage_s=stages, prefilter=prefilter,
         session_both_batches={k: mapper.session.stats[k] for k in (
             "dispatches", "lanes", "pad_lanes", "rescue_dispatches",
             "rescue_lanes")},
         uploads=moved.h2d_calls, downloads=moved.d2h_calls,
         direct_equal=len(rows), cpu_reads=n_cpu, cpu_s=cpu_s,
         cpu_equal=True, launches=launches, other_path_calls=other)
    if recall < 0.95 or decoy_hits or st["kill_rate"] <= 0.2:
        raise AssertionError(f"mapper floors missed: recall {recall:.4f}, "
                             f"{decoy_hits} reads at a decoy, kill rate "
                             f"{st['kill_rate']:.4f}")


# ---- phase 9: the paper's comparison path ----

#: (ratio, its CPU contender, the paper's GPU ratio), as
#: benchmarks/bench_aligners.py:gpu_rows defines them: CPU per-pair time
#: over GPU per-pair time
PAPER_RATIOS = (("gpu_vs_cpu_genasm", "genasm_improved", 4.1),
                ("gpu_vs_ksw2_like", "ksw2_like_affine_dp", 62.0),
                ("gpu_vs_edlib_like", "edlib_like_myers", 7.2))
#: the paper's footprint and memory-access reductions
PAPER_REDUCTIONS = {"footprint": 24.0, "accesses": 12.0}
#: the GenASM variants of the paper's table (bench_aligners.run)
GENASM_VARIANTS = {"genasm_improved": dict(store="band", early_term=True),
                   "genasm_sene_only": dict(store="and", early_term=False),
                   "genasm_unimproved": dict(store="edges4",
                                             early_term=False)}


def _median_s(fn, device: torch.device):
    """(median seconds, timed runs, last result) of `fn`: on the card one
    warm-up run and three timed; on the CPU (nothing to compile) three
    timed runs where the first took under 2 s, else that one."""
    cuda = device.type == "cuda"
    if cuda:
        fn()
    ts, out = [], None
    while len(ts) < 3 and (cuda or not ts or ts[0] < 2.0):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2], len(ts), out


def _paper_reads(n_reads: int, read_len: int = 1_000):
    """bench_aligners.run's corpus: 10 % error reads from a 400 kbp genome
    (seed 0, reads seed 1); a larger batch starts with the same reads."""
    return simulate_reads(synth_genome(400_000, seed=0), n_reads,
                          ReadSimConfig(read_len=read_len, error_rate=0.10,
                                        seed=1))


def _baseline_inputs(rs, m_pad: int, n_pad: int):
    """The baselines' (pat, txt, m_len, n_len) int32 tensors on the CPU:
    reads padded with 255 to m_pad, refs with 9 to n_pad.  Raises where a
    ref does not fit n_pad (the recipe would truncate it, and a truncated
    ref is no longer what GenASM aligned)."""
    n = len(rs.reads)
    pat = np.full((n, m_pad), 255, np.int32)
    txt = np.full((n, n_pad), 9, np.int32)
    ml = np.zeros(n, np.int32)
    nl = np.zeros(n, np.int32)
    for i, (r, s) in enumerate(zip(rs.reads, rs.ref_segments)):
        if len(r) > m_pad or len(s) > n_pad:
            raise AssertionError(f"pair {i}: {len(r)} / {len(s)} bases do "
                                 f"not fit {m_pad} / {n_pad}")
        pat[i, :len(r)], txt[i, :len(s)] = r, s
        ml[i], nl[i] = len(r), len(s)
    return tuple(torch.from_numpy(x) for x in (pat, txt, ml, nl))


def _token_edits(tokens, rate: float, rng):
    """`tokens` with each token substituted, followed by an inserted
    token, or deleted with probability rate / 3 each."""
    out = []
    for t in tokens:
        x = rng.random()
        if x < rate / 3:
            out.append(int(rng.integers(0, 50_000)))
        elif x < 2 * rate / 3:
            out += [int(t), int(rng.integers(0, 50_000))]
        elif x >= rate:
            out.append(int(t))
    return np.array(out, np.int64)


def dedup_corpus(n_seqs: int = 48, n_near: int = 12, length: int = 1_000,
                 rate: float = 0.05, seed: int = 20):
    """`n_seqs` token sequences of `length` tokens: sequences 2i and 2i+1
    (i < n_near) a random sequence and its near-duplicate at `rate` token
    edits, the rest random.  Returns (seqs, planted pairs)."""
    rng = np.random.default_rng(seed)
    seqs, planted = [], []
    while len(seqs) < n_seqs:
        seqs.append(rng.integers(0, 50_000, length))
        if len(planted) < n_near:
            seqs.append(_token_edits(seqs[-1], rate, rng))
            planted.append((len(seqs) - 2, len(seqs) - 1))
    return seqs, planted


def _paper_stores(cfg: AlignerConfig) -> dict:
    """Each kernel's store per lane from ``core.counting``'s GPU model,
    beside what its block asks for (``kernels.genasm_dc``'s geometry) and
    the unpadded words of the reference's model."""
    k1 = genasm_dc.tb_fused_geometry(cfg)
    out = {"tb_fused": dict(
        k=cfg.k, space="shared", words=counting.gpu_store_words(cfg, 1),
        unpadded_words=counting.kernel_scratch_words(cfg, 1),
        lanes_per_block=k1.lanes, block_shared_bytes=k1.shared_bytes)}
    for name, cfg_t, banded in (("tail_banded", cfg, True),
                                ("tail_full", cfg.replace(k=2 * cfg.k),
                                 False)):
        n_text = cfg_t.W + 4 * cfg_t.k
        geo = genasm_dc.tail_geometry(cfg_t, n_text, cfg_t.W + n_text,
                                      banded=banded)
        out[name] = dict(
            k=cfg_t.k, space=geo.placement,
            words=counting.gpu_tail_store_words(cfg_t, 1, banded=banded),
            unpadded_words=counting.tail_scratch_words(cfg_t, 1,
                                                       banded=banded),
            lanes_per_block=geo.lanes, block_shared_bytes=geo.shared_bytes,
            device_bytes=4 * geo.store_words)
    k3 = genasm_dc.dc_band_geometry(cfg)
    out["dc_band"] = dict(
        k=cfg.k, space="device", words=counting.gpu_split_store_words(cfg, 1),
        placement=k3.placement, lanes_per_block=k3.lanes,
        block_shared_bytes=k3.shared_bytes,
        ring_bytes=4 * 2 * k3.chunk * k3.lanes * k3.lane_stride)
    for row in out.values():
        row["bytes"] = 4 * row["words"]
    return out


def phase_paper(device: torch.device, n_pairs: int = 24,
                n_bulk: int = 2048, n_dedup: int = 48, n_dedup_cpu: int = 12,
                n_traceback: int = 4) -> dict:
    """The paper's comparison (benchmarks/bench_aligners.py's run and
    gpu_rows) on the port: `n_pairs` reads of 1 kbp at 10 % error through
    the three GenASM variants, GenASM-DC alone, the Edlib-like Myers
    distance and the KSW2-like banded affine DP, each on the CPU (the
    port's eager PyTorch); then on `device` GenASM (K1, K2, K4) on those
    pairs and on `n_bulk` reads, Myers, the DP, the distance-only row
    through K3, and the near-duplicate operator.  Holds every card result
    equal to its CPU run, GenASM against Myers (a GenASM CIGAR is a
    global alignment: never below the edit distance) and the oracles, the
    unit-cost DP equal to Myers inside its band, both host tracebacks, and
    the launch counts.  Prints per-pair times, the three ratios against
    the paper's, the footprint / access reductions at the measured level
    count, and each kernel's store."""
    cpu = torch.device("cpu")
    cfg = AlignerConfig(W=64, O=24, k=12)
    rs = _paper_reads(n_pairs)
    reads, refs = rs.reads, rs.ref_segments
    m_pad = 1_000
    n_pad = int(m_pad * 1.25) + 32
    nw = -(-m_pad // 32)
    bw = 160
    affine = dict(sub=4, gapo=6, gape=2)
    base_inputs = _baseline_inputs(rs, m_pad, n_pad)
    n_windows = n_pairs * -(-m_pad // cfg.stride)
    wrng = np.random.default_rng(1)
    wpat, wtxt = (torch.from_numpy(wrng.integers(0, 4, (n_windows, cfg.W))
                                   .astype(np.int32)) for _ in range(2))
    rows, res, seconds = [], {}, {}

    def row(name, dev, batch, s, runs, **extra):
        r = dict(name=name, device=dev.type, batch=batch,
                 us_per_pair=s * 1e6 / batch, runs=runs, **extra)
        if dev.type == "cpu":
            r.update(label="torch_eager_cpu",
                     torch_threads=torch.get_num_threads())
        rows.append(r)
        seconds[(name, dev.type, batch)] = s

    # ---- the contenders on the CPU ----
    for name, kw in GENASM_VARIANTS.items():
        al = GenASMAligner(cfg.replace(backend="plain", **kw),
                           rescue_rounds=1, device=cpu)
        s, runs, res[name] = _median_s(lambda al=al: al.align(reads, refs),
                                       cpu)
        row(name, cpu, n_pairs, s, runs)
        if name == "genasm_improved":
            cpu_run = dict(al.last_run)
        else:
            _assert_same_result(res[name], res["genasm_improved"],
                                f"paper: {name} against genasm_improved")
    s, runs, dc = _median_s(lambda: dc_dmajor(wpat, wtxt, cfg=cfg), cpu)
    row("genasm_dc_distance_only", cpu, n_pairs, s, runs, windows=n_windows)
    s, runs, my_cpu = _median_s(lambda: myers_distance(
        *base_inputs, nw=nw, n=n_pad), cpu)
    row("edlib_like_myers", cpu, n_pairs, s, runs)
    s, runs, dp_cpu = _median_s(lambda: banded_affine_dist(
        *base_inputs, bw=bw, m=m_pad, **affine), cpu)
    row("ksw2_like_affine_dp", cpu, n_pairs, s, runs)

    # ---- the contenders on the card, the counts set to 0 just before ----
    bulk = _paper_reads(n_bulk)
    seqs, planted = dedup_corpus(n_dedup)
    dev_inputs = tuple(x.to(device) for x in base_inputs)
    genasm_dc.reset_counts()
    al = GenASMAligner(cfg, rescue_rounds=1, device=device)
    s, runs, gpu24 = _median_s(lambda: al.align(reads, refs), device)
    row("genasm_gpu_improved", device, n_pairs, s, runs)
    dev_run = dict(al.last_run)
    s, runs, gpu_bulk = _median_s(
        lambda: al.align(bulk.reads, bulk.ref_segments), device)
    row("genasm_gpu_improved", device, n_bulk, s, runs,
        failed_share=float(gpu_bulk.failed.mean()))
    s, runs, my_dev = _median_s(lambda: myers_distance(
        *dev_inputs, nw=nw, n=n_pad), device)
    row("edlib_like_myers", device, n_pairs, s, runs)
    s, runs, dp_dev = _median_s(lambda: banded_affine_dist(
        *dev_inputs, bw=bw, m=m_pad, **affine), device)
    row("ksw2_like_affine_dp", device, n_pairs, s, runs)
    wpat_d, wtxt_d = wpat.to(device), wtxt.to(device)
    s, runs, k3 = _median_s(lambda: genasm_dc_op(wpat_d, wtxt_d, cfg=cfg),
                            device)
    row("genasm_dc_distance_only", device, n_pairs, s, runs,
        windows=n_windows)
    dp_unit = banded_affine_dist(*dev_inputs, bw=bw, m=m_pad).cpu()
    found = near_duplicates(seqs, device=device)
    _sync(device)
    taken, other = (dict(c) for c in _counts(device))
    if min(taken.values()) == 0 or max(other.values()) != 0:
        raise AssertionError(f"paper: the card runs did not launch K1, K2, "
                             f"K4 and K3 alone: {taken}, other path {other}")

    # ---- checks ----
    _assert_same_result(gpu24, res["genasm_improved"],
                        "paper: GenASM on the card against the CPU")
    _assert_same_result(_take(gpu_bulk, range(n_pairs)), gpu24,
                        "paper: the bulk batch's first lanes")
    if dev_run["levels_run_total"] != cpu_run["levels_run_total"]:
        raise AssertionError(f"paper: level counts differ: {dev_run}, "
                             f"{cpu_run}")
    for what, got, want in (("myers", my_dev, my_cpu),
                            ("banded affine DP", dp_dev, dp_cpu),
                            ("K3 dist", k3[0], dc.dist)):
        if not np.array_equal(got.cpu().numpy(),
                              want.numpy().astype(got.cpu().numpy().dtype)):
            raise AssertionError(f"paper: {what} on the card differs from "
                                 f"the CPU")
    my = my_cpu.numpy()
    ok = np.flatnonzero(~gpu24.failed)
    for i in ok:
        if my[i] > gpu24.dist[i]:
            raise AssertionError(f"paper: pair {i}: GenASM dist "
                                 f"{gpu24.dist[i]} below the edit distance "
                                 f"{my[i]}")
        validate_cigar(reads[i], refs[i], gpu24.ops[i],
                       expected_dist=int(gpu24.dist[i]))
    in_band = my <= bw
    if not np.array_equal(dp_unit.numpy()[in_band], my[in_band]):
        raise AssertionError("paper: the unit-cost DP differs from Myers "
                             "inside its band")
    sample = np.random.default_rng(7).choice(n_pairs, n_traceback,
                                             replace=False)
    tracebacks = []
    for i in sample:
        d, ops = banded_traceback(reads[i], refs[i], k=int(my[i]))
        if d != my[i]:
            raise AssertionError(f"paper: pair {i}: banded traceback {d}, "
                                 f"Myers {my[i]}")
        validate_cigar(reads[i], refs[i], ops, expected_dist=d)
        # the traceback's DP charges gapo on every gap base (a linear gap
        # cost): equal to the DP's cost at unit costs, an upper bound of
        # its affine cost
        for costs, want in ((affine, int(dp_cpu[i])), ({}, int(dp_unit[i]))):
            cost, ops = affine_traceback(reads[i], refs[i], bw=bw, **costs)
            if cost is None or want >= INF or cost < want or \
                    (not costs and cost != want):
                raise AssertionError(f"paper: pair {i}: affine traceback "
                                     f"{cost} at {costs}, DP {want}")
            validate_cigar(reads[i], refs[i], ops,
                           expected_dist=None if costs else cost)
            tracebacks.append(dict(pair=int(i), costs=costs or "unit",
                                   traceback=cost, dp=want))
    pairs = {(i, j) for i, j, _ in found}
    if not set(planted) <= pairs:
        raise AssertionError(f"paper: near-duplicates missed "
                             f"{sorted(set(planted) - pairs)}")
    t0 = time.perf_counter()
    cpu_found = near_duplicates(seqs[:n_dedup_cpu], device=cpu)
    dedup_cpu_s = time.perf_counter() - t0
    if cpu_found != [r for r in found if r[1] < n_dedup_cpu]:
        raise AssertionError("paper: near-duplicates on the card differ "
                             "from the CPU's")

    # ---- what it prints ----
    ratios = {}
    for batch in (n_pairs, n_bulk):
        gpu = seconds[("genasm_gpu_improved", device.type, batch)] / batch
        ratios[batch] = {"gpu_pairs_per_s": 1.0 / gpu}
        for key, base, paper in PAPER_RATIOS:
            cpu_pair = seconds[(base, "cpu", n_pairs)] / n_pairs
            ratios[batch][key] = dict(ratio=cpu_pair / gpu, paper=paper,
                                      cpu=base + " (torch_eager_cpu)")
    n_windows_main = n_main_windows(max(len(r) for r in reads), cfg)
    avg_levels = cpu_run["levels_run_total"] / (n_windows_main
                                                * cpu_run["rounds_run"])
    out = dict(
        rows=rows, ratios=ratios, cpu_torch_threads=torch.get_num_threads(),
        avg_levels=avg_levels,
        avg_levels_is="upper bound of the per-lane mean: each main window "
                      "adds its batch's maximum level count",
        levels_run_total=cpu_run["levels_run_total"],
        rounds_run=cpu_run["rounds_run"], main_windows=n_windows_main,
        reduction=counting.reduction_report(cfg, avg_levels),
        paper_reductions=PAPER_REDUCTIONS,
        stores=_paper_stores(cfg),
        lane_state_words_per_thread=counting.gpu_lane_state_words(cfg),
        checks=dict(pairs=n_pairs, genasm_ok=len(ok),
                    unit_dp_pairs_in_band=int(in_band.sum()),
                    tracebacks=tracebacks,
                    myers_median=float(np.median(my)),
                    bulk_failed=int(gpu_bulk.failed.sum())),
        dedup=dict(seqs=len(seqs), pairs=len(seqs) * (len(seqs) - 1) // 2,
                   planted=len(planted), found=len(found),
                   cpu_seqs=n_dedup_cpu, cpu_records=len(cpu_found),
                   cpu_s=dedup_cpu_s),
        launches=taken, other_path_calls=other)
    emit("paper", **out)
    return out


# ---- phase lm: the LM scaffold's serving path ----

#: float32 on both sides, TF32 off: the card (cuBLAS) and the CPU port run
#: the same ops and differ only in the order their kernels sum (the CPU
#: port is held to the JAX reference within the same bound in
#: tests/test_torch_lm.py)
LM_F32_TOL = dict(rtol=1e-4, atol=1e-4)
#: one layer period at published widths, float32, the same bound: sums
#: over 2,048-8,192 terms moved the logits by 5.7e-6 at most (PERF.md
#: section 6, this script on an NVIDIA H100 80GB HBM3 at 700 W)
LM_WIDTH_TOL = LM_F32_TOL
#: Granite-3-2B in bfloat16, each decode step and prefill's last logits
#: against one teacher-forced forward over the same tokens: other matmul
#: shapes (a 2,048-slot cache against 1,568 keys in query chunks) round
#: otherwise in bfloat16 through 40 layers.  Measured 0.0098 at most, one
#: bfloat16 step of logits below 1.3 (PERF.md section 6, this script on
#: an NVIDIA H100 80GB HBM3 at 700 W); the tests' bfloat16 bound, under
#: the JAX tests' 0.08
LM_BF16_TOL = dict(rtol=0.02, atol=0.02)
#: H100 SXM dense bfloat16 peak (NVIDIA data sheet), for the prefill bound
BF16_FLOPS_PER_S = 989e12
LM_PROMPT = 12          # part (a)'s prompt steps
LM_STEPS = 4            # decode steps of parts (a) and (b)


def _lm_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _lm_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _lm_leaves(v)]
    return [tree]


def _lm_err(got, want, tol: dict) -> tuple:
    """(max abs err, within `tol`): |got - want| <= atol + rtol |want|
    everywhere, as ``np.testing.assert_allclose``."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    d = (got - want).abs()
    ok = bool((d <= tol["atol"] + tol["rtol"] * want.abs()).all())
    return float(d.max()), ok


def _lm_batches(cfg, batch: int, prompt: int, steps: int, seed: int,
                device):
    """`prompt` steps and `steps` teacher-forced steps after them from
    ``TokenStream``, on `device`: (prefill batch, [decode batch, ...])."""
    b = TokenStream(cfg.vocab, batch, prompt + steps, seed=seed,
                    family=cfg.family, d_model=cfg.d_model,
                    n_codebooks=cfg.n_codebooks).batch_at(0)
    b = to_device({k: v for k, v in b.items() if k != "labels"}, device)
    key = "embeds" if "embeds" in b else "tokens"
    prefill = {key: b[key][:, :prompt]}
    decodes = [{key: b[key][:, t:t + 1], "cache_pos": t}
               for t in range(prompt, prompt + steps)]
    if "positions" in b:
        prefill["positions"] = b["positions"][:, :, :prompt]
        for t, d in zip(range(prompt, prompt + steps), decodes):
            d["positions"] = b["positions"][:, :, t:t + 1]
    return prefill, decodes


def _lm_outputs(model, seed: int, prompt: int, steps: int,
                batch: int = 2, train: bool = True,
                greedy: bool = True) -> dict:
    """Every output of the serving path for one model: the train-mode
    logits, prefill's logits and cache, `steps` decode steps after
    ``pad_cache`` (teacher-forced, so both sides see the same tokens) and
    the last cache, and ``greedy_generate``'s tokens."""
    prefill, decodes = _lm_batches(model.cfg, batch, prompt, steps, seed,
                                   model.device)
    out = {}
    if train:
        with torch.inference_mode():
            out["train"] = model(prefill, mode="train")[0]
    logits, cache = model.prefill(prefill)
    out["prefill"] = logits
    out["prefill_cache"] = [t.clone() for t in _lm_leaves(cache)]
    cache = pad_cache(cache, prompt + steps)
    for i, d in enumerate(decodes):
        out[f"decode_{i}"], cache = model.decode_step(d, cache)
    out["decode_cache"] = _lm_leaves(cache)
    if greedy and not model.cfg.n_codebooks:
        out["greedy"] = greedy_generate(model, prefill["tokens"], steps,
                                        prompt + steps)
    return out


def _lm_compare(got: dict, want: dict, tol: dict) -> dict:
    """Max abs err of each output (caches: over their leaves) and whether
    it is within `tol`; greedy tokens: equal or not."""
    res = {}
    for k, w in want.items():
        if k == "greedy":
            res[k] = (0.0, bool(torch.equal(got[k].cpu(), w.cpu())))
            continue
        pairs = zip(got[k], w) if isinstance(w, list) else [(got[k], w)]
        errs = [_lm_err(g, x, tol) for g, x in pairs]
        res[k] = (max(e for e, _ in errs), all(ok for _, ok in errs))
    return res


def _lm_tiny(device, archs) -> dict:
    """Part (a): every architecture at ``tiny_config`` in float32, one
    seeded CPU init copied to `device`, the card against the CPU port;
    then the card again with TF32 allowed (which must miss the
    tolerance somewhere, else the tolerance could not tell)."""
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("part (a) needs float32 matmuls without TF32")
    cpu = torch.device("cpu")
    rows, models = {}, {}
    for i, arch in enumerate(archs):
        cfg = dataclasses.replace(tiny_config(get_config(arch)),
                                  dtype="float32")
        on_cpu = get_model(cfg, device=cpu,
                           generator=torch.Generator().manual_seed(i))
        on_card = copy.deepcopy(on_cpu).to(device)
        want = _lm_outputs(on_cpu, i, LM_PROMPT, LM_STEPS)
        got = _lm_outputs(on_card, i, LM_PROMPT, LM_STEPS)
        res = _lm_compare(got, want, LM_F32_TOL)
        bad = {k: v for k, v in res.items() if not v[1]}
        if bad:
            raise AssertionError(f"lm (a) {arch}: card != CPU port "
                                 f"beyond {LM_F32_TOL}: {bad}")
        rows[arch] = dict(max_abs_err=max(e for e, _ in res.values()),
                          greedy_equal=res.get("greedy", (0, None))[1])
        models[arch] = (on_card, want)
    if device.type != "cuda":               # a CPU rehearsal has no TF32
        return dict(archs=rows, tol=LM_F32_TOL, tf32_caught=None)
    torch.set_float32_matmul_precision("high")
    try:
        for i, arch in enumerate(archs):
            on_card, want = models[arch]
            res = _lm_compare(_lm_outputs(on_card, i, LM_PROMPT, LM_STEPS),
                              want, LM_F32_TOL)
            rows[arch].update(
                tf32_max_abs_err=max(e for e, _ in res.values()),
                tf32_within_tol=all(ok for k, (_, ok) in res.items()
                                    if k != "greedy"),
                tf32_greedy_equal=res.get("greedy", (0, None))[1])
    finally:
        torch.set_float32_matmul_precision("highest")
    caught = [a for a, r in rows.items() if not r["tf32_within_tol"]]
    if not caught:
        raise AssertionError(f"lm (a): TF32 matmuls stayed within "
                             f"{LM_F32_TOL} on every architecture: the "
                             f"tolerance cannot tell TF32 from float32")
    return dict(archs=rows, tol=LM_F32_TOL, tf32_caught=caught)


def _lm_width(device, archs, prompt: int = 64, steps: int = LM_STEPS,
              batch: int = 2) -> dict:
    """Part (b): one layer of each of `archs` at its published widths in
    float32, drawn on `device` and copied to the CPU: prefill and `steps`
    decode steps, the card against the CPU port."""
    rows = {}
    for i, arch in enumerate(archs):
        cfg = dataclasses.replace(get_config(arch).with_layers(1),
                                  dtype="float32")
        on_card = get_model(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(100 + i))
        on_cpu = copy.deepcopy(on_card).cpu()
        t0 = time.perf_counter()
        want = _lm_outputs(on_cpu, 100 + i, prompt, steps, batch,
                           train=False, greedy=False)
        cpu_s = time.perf_counter() - t0
        got = _lm_outputs(on_card, 100 + i, prompt, steps, batch,
                          train=False, greedy=False)
        res = _lm_compare(got, want, LM_WIDTH_TOL)
        bad = {k: v for k, v in res.items() if not v[1]}
        if bad:
            raise AssertionError(f"lm (b) {arch}: card != CPU port beyond "
                                 f"{LM_WIDTH_TOL}: {bad}")
        rows[arch] = dict(
            d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            d_ff=cfg.d_ff, experts=cfg.n_experts, top_k=cfg.top_k,
            vocab=cfg.vocab, vocab_padded=cfg.vocab_padded,
            params=sum(p.numel() for p in on_card.parameters()),
            max_abs_err=max(e for e, _ in res.values()),
            max_abs_logit=float(want["prefill"].abs().max()),
            errs={k: e for k, (e, _) in res.items()}, cpu_s=cpu_s)
        del on_card, on_cpu
    return dict(archs=rows, prompts=batch, prompt_len=prompt, steps=steps,
                tol=LM_WIDTH_TOL)


def _lm_bounds(cfg, batch: int, prompt: int, serve_len: int,
               n_params: int) -> dict:
    """The least time the card could take: prefill's products (the
    layers' matmuls, the logits, and attention over every query-key pair
    of a prompt, unmasked, as computed) over the bfloat16 peak; a decode
    step's bytes (every weight and the whole padded KV cache read once)
    over HBM bandwidth."""
    D, H, KV, Dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    L, V = cfg.n_layers, cfg.vocab_padded
    layer = D * H * Dh + 2 * D * KV * Dh + H * Dh * D + 3 * D * F
    tokens = batch * prompt
    flops = (2 * L * layer * tokens + 2 * D * V * tokens
             + 4 * L * batch * H * prompt * prompt * Dh)
    cache_bytes = 2 * L * batch * serve_len * KV * Dh * 2
    step_bytes = n_params * 2 + cache_bytes
    return dict(prefill_flops=flops,
                prefill_bound_ms=flops / BF16_FLOPS_PER_S * 1e3,
                decode_step_bytes=step_bytes, cache_bytes=cache_bytes,
                decode_bound_ms=step_bytes / HBM_BYTES_PER_S * 1e3)


def _lm_serve(device, arch: str = "granite-3-2b", n_layers=None,
              batch: int = 4, prompt: int = 1536, serve_len: int = 2048,
              steps: int = 32) -> dict:
    """Part (c): `arch` at full width and depth in bfloat16, random
    weights from a generator on the card.  `batch` prompts of `prompt`
    tokens from ``TokenStream(seed=0)`` (over ``q_chunk``: the chunked
    attention runs), prefill, ``pad_cache`` to `serve_len`, `steps`
    greedy decode steps; ``greedy_generate`` gives the same tokens; one
    teacher-forced train-mode forward over the prompt and the generated
    tokens gives the decode steps' logits and prefill's last."""
    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.with_layers(n_layers)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = get_model(cfg, device=device,
                      generator=torch.Generator(device=device).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    tokens = to_device(TokenStream(cfg.vocab, batch, prompt, seed=0)
                       .batch_at(0), device)["tokens"]
    vocab = cfg.vocab
    prefill_s = []
    for _ in range(2):                       # cold, then warm
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.prefill({"tokens": tokens})
        _sync(device)
        prefill_s.append(time.perf_counter() - t0)
    first = logits[:, -1]
    cache = pad_cache(cache, serve_len)
    tok = first[:, :vocab].argmax(dim=-1)[:, None]
    gen, step_logits = [], []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(steps):
        gen.append(tok)
        logits, cache = model.decode_step(
            {"tokens": tok.to(torch.int32), "cache_pos": prompt + i}, cache)
        step_logits.append(logits[:, -1])
        tok = logits[:, -1, :vocab].argmax(dim=-1)[:, None]
    _sync(device)
    decode_s = time.perf_counter() - t0
    gen = torch.cat(gen, dim=1)
    t0 = time.perf_counter()
    via_api = greedy_generate(model, tokens, steps, serve_len)
    _sync(device)
    greedy_s = time.perf_counter() - t0
    if not torch.equal(via_api, gen):
        raise AssertionError("lm (c): greedy_generate's tokens differ from "
                             "the same loop run step by step")
    full = torch.cat([tokens, gen.to(tokens.dtype)], dim=1)
    with torch.inference_mode():
        train_logits = model({"tokens": full}, mode="train")[0]
    for what, t in (("prefill", first), ("decode", step_logits[0]),
                    ("train", train_logits)):
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"lm (c): {what} logits not finite")
    pre_err, pre_ok = _lm_err(first, train_logits[:, prompt - 1],
                              LM_BF16_TOL)
    dec = [_lm_err(s, train_logits[:, prompt + i], LM_BF16_TOL)
           for i, s in enumerate(step_logits)]
    if not (pre_ok and all(ok for _, ok in dec)):
        raise AssertionError(f"lm (c): logits beyond {LM_BF16_TOL}: "
                             f"prefill {pre_err}, decode "
                             f"{[e for e, _ in dec]}")
    bounds = _lm_bounds(cfg, batch, prompt, serve_len, n_params)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)

    prof_cache = cache

    def decode_four():
        t = tok.to(torch.int32)
        for i in range(4):
            model.decode_step({"tokens": t, "cache_pos": prompt + steps + i},
                              prof_cache)
    _profile_later("lm_prefill_profile",
                   lambda: model.prefill({"tokens": tokens}), top=12,
                   arch=arch, batch=batch, prompt=prompt)
    _profile_later("lm_decode_profile", decode_four, top=12, arch=arch,
                   steps=4, batch=batch, cache_len=serve_len)
    return dict(
        arch=arch, layers=cfg.n_layers, params=n_params,
        weight_bytes=n_params * 2, batch=batch, prompt=prompt,
        serve_len=serve_len, steps=steps,
        prefill_s_cold=prefill_s[0], prefill_s=prefill_s[1],
        prefill_tokens_per_s=batch * prompt / prefill_s[1],
        decode_ms_per_step=decode_s * 1e3 / steps,
        decode_tokens_per_s=batch * steps / decode_s,
        greedy_generate_s=greedy_s,
        prefill_max_abs_err=pre_err,
        decode_max_abs_err=max(e for e, _ in dec),
        max_abs_logit=float(train_logits.float().abs().max()),
        tol=LM_BF16_TOL, peak_memory_bytes=peak,
        card=_smi() if device.type == "cuda" else None, **bounds)


def phase_lm(device: torch.device, archs=None, width_archs=("granite-3-2b",
             "olmoe-1b-7b"), serve_arch="granite-3-2b", serve_layers=None,
             **serve_kw) -> dict:
    """The LM scaffold's serving path (``repro_torch.models``,
    ``serve/kvcache.py``, ``data/tokens.py``) in three parts, one line
    each: (a) every architecture at ``tiny_config`` in float32, the card
    against the CPU port, and again with TF32; (b) one layer period at
    published widths, float32; (c) Granite-3-2B served at full width and
    depth in bfloat16, with its times beside their bounds."""
    archs = ARCH_IDS if archs is None else archs
    out = {}
    out["a"] = _lm_tiny(device, archs)
    emit("lm", part="a", **out["a"])
    out["b"] = _lm_width(device, width_archs)
    emit("lm", part="b", **out["b"])
    out["c"] = _lm_serve(device, serve_arch, serve_layers, **serve_kw)
    emit("lm", part="c", **out["c"])
    return out



# ---- phase train: the LM scaffold's training path ----

#: leg (a): float32, TF32 off, the card against the CPU port over three
#: steps (the CPU port is held to the reference's train step within the
#: same bound in tests/test_torch_train.py)
TRAIN_F32_TOL = dict(rtol=1e-4, atol=1e-4)
#: leg (b): a restarted run against an uninterrupted one on the card
TRAIN_RESTART_RTOL = 1e-6
#: leg (c): Llama-3.2-1B's first bfloat16 step (float32 masters) against
#: the same step in float32 compute, TF32 off: loss within 1 %, gradient
#: norm within 5 % (PERF.md section 6, written before the first run)
TRAIN_BF16_LOSS_RTOL = 0.01
TRAIN_BF16_NORM_RTOL = 0.05
TRAIN_OPT = dict(lr=1e-3, total_steps=50, warmup_steps=2)
#: a training step's state bytes a parameter: float32 weight, gradient,
#: AdamW m and v
TRAIN_STATE_BYTES = 16


def _check_tf32_off() -> None:
    if (torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise AssertionError("float32 legs need float32 matmuls, TF32 off")


def _train_tiny(device, archs, steps: int = 3, batch: int = 2,
                seq: int = 16) -> dict:
    """Leg (a): every architecture at ``tiny_config`` in float32, one
    seeded CPU init copied to `device`, `steps` train steps on each side
    from the same state: the per-step losses and the parameters after the
    last step, the card against the CPU port; then one ``grad_accum=2``
    step against ``grad_accum=1`` on llama, on the card."""
    _check_tf32_off()
    cpu = torch.device("cpu")
    opt = AdamWConfig(**TRAIN_OPT)
    rows = {}

    def run(model, seed, grad_accum=1, n=steps):
        cfg = model.cfg
        stream = TokenStream(cfg.vocab, batch, seq, seed=seed,
                             family=cfg.family, d_model=cfg.d_model,
                             n_codebooks=cfg.n_codebooks)
        step, state = make_train_step(model, opt, grad_accum), \
            init_state(model)
        metrics = [step(state, stream.batch_at(i))[1] for i in range(n)]
        return ([{k: float(v) for k, v in m.items()} for m in metrics],
                {n: p.detach() for n, p in model.named_parameters()})

    for i, arch in enumerate(archs):
        cfg = dataclasses.replace(tiny_config(get_config(arch)),
                                  dtype="float32")
        on_cpu = get_model(cfg, device=cpu, param_dtype="float32",
                           generator=torch.Generator().manual_seed(i))
        on_card = copy.deepcopy(on_cpu).to(device)
        want, want_p = run(on_cpu, i)
        got, got_p = run(on_card, i)
        loss_err, loss_ok = _lm_err(
            torch.tensor([m["loss"] for m in got]),
            torch.tensor([m["loss"] for m in want]), TRAIN_F32_TOL)
        errs = [_lm_err(got_p[k], want_p[k], TRAIN_F32_TOL) for k in want_p]
        if not (loss_ok and all(ok for _, ok in errs)):
            raise AssertionError(f"train (a) {arch}: card != CPU port "
                                 f"beyond {TRAIN_F32_TOL}: loss {loss_err}, "
                                 f"params {max(e for e, _ in errs)}")
        rows[arch] = dict(loss_max_abs_err=loss_err,
                          param_max_abs_err=max(e for e, _ in errs),
                          losses=[m["loss"] for m in got])
    cfg = dataclasses.replace(tiny_config(get_config("llama3.2-1b")),
                              dtype="float32")
    model = get_model(cfg, device=cpu, param_dtype="float32",
                      generator=torch.Generator().manual_seed(99))
    one, one_p = run(copy.deepcopy(model).to(device), 99, n=1)
    two, two_p = run(copy.deepcopy(model).to(device), 99, grad_accum=2, n=1)
    acc = {k: _lm_err(torch.tensor(two[0][k]), torch.tensor(one[0][k]),
                      TRAIN_F32_TOL) for k in one[0]}
    acc_p = [_lm_err(two_p[k], one_p[k], TRAIN_F32_TOL) for k in one_p]
    if not (all(ok for _, ok in acc.values()) and all(ok for _, ok in acc_p)):
        raise AssertionError(f"train (a): grad_accum=2 != 1 beyond "
                             f"{TRAIN_F32_TOL}: {acc}, params "
                             f"{max(e for e, _ in acc_p)}")
    return dict(archs=rows, steps=steps, batch=batch, seq=seq,
                tol=TRAIN_F32_TOL,
                grad_accum_max_abs_err=max(
                    [e for e, _ in acc.values()] + [e for e, _ in acc_p]))


def _train_restart(device, steps: int = 10, fail_at: int = 7) -> dict:
    """Leg (b): tiny llama (bfloat16 compute, float32 masters) supervised
    for `steps` steps with a checkpoint every step, straight and with a
    failure injected at `fail_at`, under deterministic algorithms (the
    embedding's backward accumulates with atomics otherwise): one
    restart, the same parameters; the last checkpoint written on the card
    restores on the CPU bit for bit."""
    import tempfile
    cfg = tiny_config(get_config("llama3.2-1b"))
    stream = TokenStream(cfg.vocab, 4, 64, seed=0)
    opt = AdamWConfig(**TRAIN_OPT)

    def fresh():
        model = get_model(cfg, device=device, param_dtype="float32",
                          generator=torch.Generator().manual_seed(0))
        return make_train_step(model, opt), init_state(model)

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            step, straight = fresh()
            straight, _, _ = supervise(step, straight, stream, steps=steps,
                                       ckpt_dir=f"{tmp}/a", ckpt_every=1)
            step, resumed = fresh()
            resumed, log, restarts = supervise(
                step, resumed, stream, steps=steps, ckpt_dir=f"{tmp}/b",
                ckpt_every=1, injector=FailureInjector([fail_at]))
            on_cpu, at = restore_checkpoint(
                f"{tmp}/b", abstract_state(resumed["model"]))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    if restarts != 1 or at != steps:
        raise AssertionError(f"train (b): {restarts} restarts, latest "
                             f"checkpoint {at}: {log}")
    a, b = flat_state(straight), flat_state(resumed)
    errs = [_lm_err(b[k], a[k], dict(rtol=TRAIN_RESTART_RTOL, atol=0))
            for k in a]
    if not all(ok for _, ok in errs):
        raise AssertionError(f"train (b): the restarted run differs from "
                             f"the straight one: {max(e for e, _ in errs)}")
    cpu_flat = flat_state(on_cpu)
    bitwise = all(torch.equal(cpu_flat[k], b[k].cpu()) for k in b)
    if not bitwise:
        raise AssertionError("train (b): the card's checkpoint does not "
                             "restore on the CPU bit for bit")
    return dict(steps=steps, fail_at=fail_at, restarts=restarts,
                restored_to=log[0].get("restored_to"),
                max_abs_err=max(e for e, _ in errs),
                bit_equal=all(torch.equal(a[k], b[k]) for k in a),
                cpu_restore_bit_equal=bitwise, deterministic=True)


def _train_bounds(cfg, n_params: int, tokens: int, seq: int) -> dict:
    """The least time a step could take: 6 N flops a token (forward and
    backward, no recompute) plus attention's QK^T and PV over every
    query-key pair of a sequence, unmasked, as computed (4 S^2 Dh a head,
    forward, three times for the step), over the bfloat16 peak; AdamW's
    bytes, weight, gradient, m and v read and weight, m, v written in
    float32, over HBM bandwidth."""
    attn = 3 * 4 * cfg.n_layers * (tokens // seq) * cfg.n_heads * seq ** 2 \
        * cfg.head_dim
    flops = 6 * n_params * tokens + attn
    adamw_bytes = 7 * 4 * n_params
    return dict(step_flops=flops, attention_flops=attn,
                compute_bound_ms=flops / BF16_FLOPS_PER_S * 1e3,
                adamw_bytes=adamw_bytes,
                adamw_bound_ms=adamw_bytes / HBM_BYTES_PER_S * 1e3,
                state_bytes=TRAIN_STATE_BYTES * n_params)


def _train_full(device, arch: str = "llama3.2-1b", steps: int = 4,
                batch: int = 4, seq: int = 1024, tiny: bool = False) -> dict:
    """Leg (c): `arch` trained `steps` steps through
    ``repro_torch.launch.train.main`` at full width and depth (bfloat16
    compute, float32 masters and AdamW state, remat on), no checkpoint
    (``--ckpt-every`` past the last step: the float32 state of 19.8 GB
    would take longer to write than the phase's budget).  A spy on the
    entry point's ``make_train_step`` times each step between CUDA
    events and keeps its metrics; every loss and gradient norm finite, every
    parameter moved, and the first step's loss and gradient norm within
    TRAIN_BF16_*_RTOL of the same step in float32 compute (the same
    initial weights, TF32 off)."""
    import tempfile
    seen = {"ms": [], "metrics": []}
    real = train_launch.make_train_step

    def spy(model, opt_cfg, grad_accum=1):
        step = real(model, opt_cfg, grad_accum)

        def timed(state, batch_):
            if device.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = step(state, batch_)
                ev[1].record()
                seen["ms"].append(ev)
            else:
                t0 = time.perf_counter()
                out = step(state, batch_)
                seen["ms"].append((time.perf_counter() - t0) * 1e3)
            seen["metrics"].append(out[1])
            seen.setdefault("batch0", batch_)
            seen.update(state=out[0], step=step, batch=batch_)
            return out
        return timed

    argv = ["--arch", arch, "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--ckpt-every", "1000", "--device",
            str(device)] + (["--tiny"] if tiny else [])
    _sync(device)
    base = None
    if device.type == "cuda":      # earlier phases' profiles hold memory
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    train_launch.make_train_step = spy
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            log = train_launch.main(argv + ["--ckpt-dir", tmp])
            main_s = time.perf_counter() - t0
    finally:
        train_launch.make_train_step = real
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    ms = [ev[0].elapsed_time(ev[1]) if isinstance(ev, list) else ev
          for ev in seen["ms"]]
    metrics = [{k: float(v) for k, v in m.items()} for m in seen["metrics"]]
    if len(metrics) != steps or not all(
            math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
            for m in metrics):
        raise AssertionError(f"train (c): steps' metrics {metrics}")
    model = seen["state"]["model"]
    cfg = model.cfg
    n_params = sum(p.numel() for p in model.parameters())
    # the entry point's initial weights (its build: float32 draws from a
    # generator on the device seeded --seed 0; the compute dtype draws
    # nothing) in float32 compute: every parameter moved from them, and
    # the first step's loss and gradient norm
    _check_tf32_off()
    f32 = get_model(dataclasses.replace(cfg, dtype="float32"), device=device,
                    param_dtype="float32", generator=torch.Generator(
                        device=device).manual_seed(0))
    moved = [float((p - f32.get_parameter(n)).abs().max())
             for n, p in model.named_parameters()]
    if min(moved) <= 0:
        raise AssertionError("train (c): a parameter did not move")
    loss32, _ = f32.loss(seen["batch0"])
    loss32.backward()
    norm32 = float(global_norm({n: p.grad for n, p in f32.named_parameters()
                                if p.grad is not None}))
    loss32 = float(loss32)
    del f32
    loss_rel = abs(metrics[0]["loss"] - loss32) / abs(loss32)
    norm_rel = abs(metrics[0]["grad_norm"] - norm32) / norm32
    if loss_rel > TRAIN_BF16_LOSS_RTOL or norm_rel > TRAIN_BF16_NORM_RTOL:
        raise AssertionError(f"train (c): bfloat16 step 1 vs float32: loss "
                             f"{metrics[0]['loss']} / {loss32}, norm "
                             f"{metrics[0]['grad_norm']} / {norm32}")
    warm = sorted(ms[1:])[len(ms[1:]) // 2] if len(ms) > 1 else ms[0]
    tokens = batch * seq
    bounds = _train_bounds(cfg, n_params, tokens, seq)
    state, step, batch_ = seen["state"], seen["step"], seen["batch"]
    _profile_later("train_step_profile", lambda: step(state, batch_),
                   top=12, arch=arch, batch=batch, seq=seq)
    return dict(
        arch=arch, layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, params=n_params, remat=cfg.remat,
        compute_dtype=str(model.compute_dtype),
        param_dtypes=sorted({str(p.dtype) for p in model.parameters()}),
        batch=batch, seq=seq, steps=steps, step_ms=ms,
        warm_step_ms=warm, tokens_per_s=tokens / warm * 1e3,
        losses=[m["loss"] for m in metrics],
        grad_norms=[m["grad_norm"] for m in metrics],
        lrs=[m["lr"] for m in metrics], main_s=main_s, log=log,
        f32_loss=loss32, f32_grad_norm=norm32, loss_rel_err=loss_rel,
        grad_norm_rel_err=norm_rel,
        tol=dict(loss=TRAIN_BF16_LOSS_RTOL, grad_norm=TRAIN_BF16_NORM_RTOL),
        min_param_change=min(moved), peak_memory_bytes=peak,
        memory_at_start_bytes=base,
        peak_above_start_bytes=None if peak is None else peak - base,
        card=_smi() if device.type == "cuda" else None, **bounds)


def phase_train(device: torch.device, archs=None, **full_kw) -> dict:
    """The LM scaffold's training path (``TransformerLM.loss`` with remat,
    ``optim/adamw.py``, ``train/step.py``, ``checkpoint/ckpt.py``,
    ``runtime/ft.py``, ``launch/train.py``) in three legs, one line each,
    budget 45 s: (a) every architecture at ``tiny_config`` in float32,
    three steps on the card against the CPU port, and ``grad_accum``;
    (b) a supervised restart on the card against a straight run, and the
    card's checkpoint restored on the CPU; (c) Llama-3.2-1B trained at
    full width and depth through ``python -m repro_torch.launch.train``,
    its step time and memory beside their bounds."""
    archs = ARCH_IDS if archs is None else archs
    out = {}
    out["a"] = _train_tiny(device, archs)
    emit("train", leg="a", **out["a"])
    out["b"] = _train_restart(device)
    emit("train", leg="b", **out["b"])
    out["c"] = _train_full(device, **full_kw)
    emit("train", leg="c", **out["c"])
    return out


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
                  fused_res, profile_rs=long_reads(512, read_len=300))
    timed("end_to_end", phase_end_to_end, cuda)
    timed("mesh", phase_mesh, cuda, rs, fused, fused_res)
    timed("session", phase_session, cuda)
    store = timed("gateway", phase_gateway, cuda)
    timed("graphs", phase_graphs, cuda, gateway_store=store)
    timed("mapper", phase_mapper, cuda)
    timed("paper", phase_paper, cuda)
    timed("lm", phase_lm, cuda)
    timed("train", phase_train, cuda)
    timed("profiles", phase_profiles)
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
