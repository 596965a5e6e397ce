"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
(one process a unit, the NW = 5..8 instantiations and the wide family in
units of their own), holds each kernel against its plain PyTorch version
on the card (K1 also over a grid of its instantiations and block
geometries, with its occupancy; K2 and K4 over every tail instantiation
in both store placements; K3 over every instantiation in both band
placements, with its occupancy; at W = 129..256 every (NW, KP, NWB) on
its route, ``genasm_dc.kernel_family``: K1's and the tails' register fill
or the template kept there, K3's instantiations in their one placement;
at W = 288, 320, 512 and 1024 the wide family over every level capacity
to 1,024), times K1, K2 / K4 and
K3 on each rung of the W = 256 and W = 512 ladders at 2,048 lanes (with
the peak of device memory each takes), drives the aligner's main path (``GenASMAligner.align``) on
PBSIM2-like long reads through the fused backend (K1, K2, K4) and the
split backend (K3 and the PyTorch traceback), holds the two results
equal, and checks the kernel path against the CPU plain path end to end:
on both backends, through all three rungs of the rescue ladder, with the
reference's ``lane_tile='auto'`` of 2,816, and on the W = 128, W = 256
and W = 512 ladders to k = 120, 240 and 480 (the latter two also
through sessions), then
shards the pair axis
over a mesh of the card listed four times (phase ``mesh``: the aligner,
the split backend, a session and the engine, each equal to its unsharded
run).  Then the front doors a user calls, each record held against
``GenASMAligner`` on the card: the session (``repro_torch.api.plan``),
the multi-tenant gateway and the serving engine (phase ``gateway``),
the session's executables as CUDA graphs against their eager steps, the
device-mode ladder as one graph whose IF nodes a gate kernel sets on the
card (phase ``graphs``), and the read mapper with its X-drop pre-filter
(phase ``mapper``).  Last the paper's comparison (phase
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
Then data-parallel training (phase ``train_dp``): the same run as the
one rank of a world of one over NCCL, the int8 ring on the card, two
ranks sharing the card over gloo (started by ``python -m
torch.distributed.run``) against one rank, and the LM dry run of
Llama-3.2-1B's ``train_4k`` cell with the measured step against its
bound.
Every phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with
no result, where CUDA is not available.  Imports nothing of JAX or of the
JAX package ``repro``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import json
import re
import math
import multiprocessing
import os
import shutil
import signal
import socket
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
from repro_torch.api.session import (AlignSession,            # noqa: E402
                                     build_executable)
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
                                        plan_lane_tile, total_op_budget)
from repro_torch.core.oracle import validate_cigar             # noqa: E402
from repro_torch.data.dedup import near_duplicates             # noqa: E402
from repro_torch.data.genome import (ReadSimConfig,            # noqa: E402
                                     plant_decoys, simulate_reads,
                                     synth_genome)
from repro_torch.kernels import (build, genasm_dc,             # noqa: E402
                                 ladder_graph, window_step)
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
from repro_torch.serve import graphs as serve_graphs            # noqa: E402
from repro_torch.core.cigar import (decode_batch,              # noqa: E402
                                    records_from_state)
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
                                    init_state, make_train_step,
                                    replica_digest)

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
#: what K1's window form (``window_step.genasm_tb_window``, one launch a
#: main window) also replaces: the reference's scan body around its Pallas
#: call, which XLA fuses on the TPU (no Pallas kernel)
WINDOW_REPLACES = ("src/repro/core/windowing.py:200 append_main: "
                   "_slice_rev, ops._to_kernel_layout, _append_ops and the "
                   "state's jnp.where")
#: the kernels each backend's main path launches, and no other
PATH_KERNELS = {"fused": ("tb_fused", "tail_banded", "tail_full"),
                "split": ("dc_band",)}
_CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"tb_fused": _CSRC + "tb_fused.cu",
           "tail_banded": _CSRC + "tail_fused.cu",
           "tail_full": _CSRC + "tail_fused.cu",
           "dc_band": _CSRC + "dc_band.cu",
           "ladder_gate": _CSRC + "ladder_graph.cu"}
#: each kernel's body, its instantiations at NW = 5..8 and its wide
#: family (with the family's header, the register fill)
WIDE_SOURCES = {name: [SOURCES[name], SOURCES[name].replace(".cu", ".cuh"),
                       SOURCES[name].replace(".cu", "_wide.cu"),
                       SOURCES[name].replace(".cu", "_xwide.cu"),
                       _CSRC + "genasm_xwide_reg.cuh"]
                for name in ("tb_fused", "tail_banded", "tail_full",
                             "dc_band")}
#: the wide family's kernels (``genasm_dc.kernel_family``), each one
#: kernel, by its name in ptxas's report and in ``genasm_dc.REGISTERS``
XWIDE_KERNELS = {"tb_fused_xwide_kernel": ("tb_fused_xwide", "tb_fused"),
                 "tb_window_xwide_kernel": ("tb_window_xwide", "tb_fused"),
                 "tail_fused_xwide_kernel": ("tail_fused_xwide", "tail"),
                 "dc_band_xwide_kernel": ("dc_band_xwide", "dc_band")}
#: what the device-mode ladder's gate kernel replaces (no Pallas kernel:
#: the reference's on-device round gate)
GATE_REPLACES = "src/repro/core/windowing.py:350 lax.cond(any(failed))"
#: each kernel template's display name and template parameters
TEMPLATES = {"tb_fused_kernel": ("tb_fused", ("NW", "KP", "NWB", "PLACE")),
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
    launches, plain = dict(genasm_dc.LAUNCHES), dict(genasm_dc.PLAIN_CALLS)
    return (launches, plain) if device.type == "cuda" else (plain, launches)


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
    over = _registers_over_table(usage)
    unreached = _unreached(usage)
    emit("build", seconds=seconds, nvcc_seconds=per_source,
         library=lib.name, instantiations=len(usage),
         registers_over_table=over, unreached=unreached, ptxas=usage)
    if over:
        raise AssertionError(f"ptxas counts more registers than "
                             f"genasm_dc.REGISTERS, which caps the blocks: "
                             f"{over}")
    if unreached:
        raise AssertionError(f"instantiations no route reaches "
                             f"(genasm_dc.kernel_family): {unreached}")
    return usage


def _unreached(usage: dict) -> list:
    """K1's and the tails' template instantiations at NW = 5..8 whose (NW,
    KP) ``genasm_dc.kernel_family`` routes to the wide family
    (``TEMPLATE_KEPT`` does not name it): built, and never launched."""
    out = []
    for name in usage:
        m = re.match(r"(tb_fused|tail_fused)<NW=(\d+),KP=(\d+),", name)
        if m and int(m.group(2)) > genasm_dc.NARROW_NW and (
                int(m.group(2)), int(m.group(3))) not in \
                genasm_dc.TEMPLATE_KEPT[REGISTER_FAMILY[m.group(1)]]:
            out.append(name)
    return out


#: each kernel template's family in ``genasm_dc.REGISTERS``
REGISTER_FAMILY = {"tb_fused": "tb_fused", "tail_fused": "tail",
                   "dc_band": "dc_band"}


def _registers_over_table(usage: dict) -> dict:
    """{instantiation: (ptxas's registers, the table's)} wherever ptxas
    counts more than ``genasm_dc.REGISTERS`` for its (NW, KP), or for the
    wide family's kernels ("xwide") more or any spill."""
    over = {}
    families = dict(XWIDE_KERNELS.values())
    for name, text in usage.items():
        regs = int(text.split()[0])
        if name in families:
            table = genasm_dc.REGISTERS[families[name]]["xwide"]
            spilled = re.search(r"spill stores (\d+) B", text)
            if regs > table or (spilled and int(spilled.group(1))):
                over[name] = (text, table)
            continue
        m = re.match(r"(\w+)<NW=(\d+),KP=(\d+),", name)
        if m is None:
            continue
        table = genasm_dc.REGISTERS[REGISTER_FAMILY[m.group(1)]][
            (int(m.group(2)), int(m.group(3)))]
        if regs > table:
            over[name] = (regs, table)
    return over


def _kernel_name(template: str, args) -> str:
    """name<NW=..,KP=..,NWB=..[,PLACE=..]> of an instantiation."""
    name, params = TEMPLATES[template]
    places = K3_PLACEMENTS if template == "dc_band_kernel" else PLACEMENTS
    args = [places[int(a)] if p == "PLACE" else a
            for p, a in zip(params, args)]
    return f"{name}<" + ",".join(f"{p}={a}" for p, a in zip(params, args)) \
        + ">"


def _instantiation(name: str, cfg: AlignerConfig, placement=None) -> str:
    """The usage key of the instantiation kernel `name` runs for `cfg`
    (the wide family's one kernel where ``genasm_dc.kernel_family`` names
    it)."""
    if _xwide(cfg, name):
        return {"tb_fused": "tb_fused_xwide", "dc_band": "dc_band_xwide"}.get(
            name, "tail_fused_xwide")
    kp = genasm_dc.levels_bucket(cfg.k)
    if name == "tb_fused":
        return _kernel_name("tb_fused_kernel", (
            cfg.nw, kp, cfg.nwb,
            PLACEMENTS.index(genasm_dc.K1_PLACEMENT[(cfg.nw, kp)])))
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
            name = "ladder_gate" if "ladder_gate_kernel" in mangled \
                else None
            name = next((x for kernel, (x, _) in XWIDE_KERNELS.items()
                         if kernel in mangled), name)
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
    err = max(int((a.long() - b.to(a.device).long()).abs().max())
              for a, b in zip(got, ref))
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


def _reference(name: str, inputs, kw, device, refs, cfg, lanes: int):
    """The plain version's outputs, its ms and where it ran: the next
    entry of `refs` (``_plain_refs``, computed on the CPU in a worker
    process) where it holds this case's outputs, else the plain version
    run on `device`."""
    if refs is not None:
        key, ref, ms = next(refs)
        if key != (name, repr(cfg), lanes):
            raise AssertionError(f"{name} {cfg} lanes={lanes}: the worker's "
                                 f"plain outputs are of {key}")
        if ref is not None:
            return tuple(torch.from_numpy(a) for a in ref), ms, "cpu"
    ref, ms = _plain(name, inputs, kw, device)
    return ref, ms, device.type


def _done(refs) -> None:
    """Raise unless the phase used every entry of `refs`."""
    if refs is not None and next(refs, None) is not None:
        raise AssertionError("the worker's plain outputs outnumber the "
                             "phase's cases")


def _timing(name: str, cfg, call, reps: int, device, inputs=None,
            got=None, cols=None, warm: int = 2) -> dict:
    """Times of `call` (device ms from a CUDA graph, event ms of
    back-to-back calls, after `warm` calls) and, given its outputs `got`,
    the bound of its work."""
    for _ in range(warm):
        call()
    event_ms = _time_ms(call, reps, device)
    device_ms = _device_ms(call, reps, device)
    out = dict(ms=event_ms if device_ms is None else device_ms,
               event_ms=event_ms)
    if got is not None:
        dist, steps = _dist_and_steps(name, got)
        out["bound_ms"], out["bound_by"] = _bound(cfg, inputs, got, cols,
                                                  dist, steps)
    return out


def _check_case(name: str, cfg: AlignerConfig, n_pairs: int, rng, device,
                reps: int, what: str, refs=None, loop: bool = False,
                floor: bool = False) -> dict:
    """One kernel call against its plain version on the same inputs (max
    abs err 0 or raise; the plain outputs from `refs` where they hold
    them, ``_reference``); with reps > 0 also its times and bound; with
    `loop`, a wide case also on a grid of fewer blocks than its lane
    groups (``_loop_check``); with `floor`, its ``_store_floor_ms``."""
    wrapper = KERNELS[name][0]
    inputs, kw, cols = _case(name, cfg, n_pairs, rng, device)
    call = lambda: wrapper(*inputs, **kw)               # noqa: E731
    got = call()
    ref, plain_ms, plain_on = _reference(name, inputs, kw, device, refs, cfg,
                                         n_pairs)
    err = _max_abs_err(name, got, ref, what)
    dist, _ = _dist_and_steps(name, got)
    row = dict(name=name, W=cfg.W, k=cfg.k, lanes=n_pairs, max_abs_err=err,
               plain_ms=plain_ms, plain_on=plain_on,
               solved=int((dist <= cfg.k).sum()))
    if floor:
        row["store_floor_ms"] = _store_floor_ms(name, cfg, cols, dist)
    if loop and _xwide(cfg, name):
        row.update(_loop_check(name, cfg, call, ref, n_pairs,
                               _k1_block(cfg).lanes, device, what))
    if reps:
        row.update(_timing(name, cfg, call, reps, device, inputs, got, cols))
    return row


def _store_floor_ms(name: str, cfg: AlignerConfig, cols, dist):
    """Least ms to write once over HBM the part of K1's band or a tail's
    store that its walk can read: each lane's levels 0..min(dist, k) (a
    fill that stops at a lane's dist stores no level above it, and one
    that fails stores every level before it knows) in each column it
    keeps (K1: the band's ncols_band; a tail: the columns it fills), nwb
    words each (K4: nw), without the layouts' pads, skew rows or levels
    above dist.  Scratch the bound leaves out; None for K3, whose band
    is its output and in its bound."""
    if name == "dc_band":
        return None
    levels = torch.clamp(dist, max=cfg.k) + 1
    kept = (torch.full_like(levels, cfg.ncols_band) if name == "tb_fused"
            else torch.as_tensor(cols, dtype=torch.long))
    nwb = cfg.nw if name == "tail_full" else cfg.nwb
    return int((levels * kept).sum()) * nwb * 4 / HBM_BYTES_PER_S * 1e3


def _xwide(cfg: AlignerConfig, name: str) -> bool:
    """Whether kernel `name` runs the wide family at `cfg`
    (``genasm_dc.kernel_family``)."""
    return genasm_dc.kernel_family(cfg, name) == "xwide"


@contextlib.contextmanager
def _grid_of(blocks: int):
    """Within this context the wide family's persistent grid holds at most
    `blocks` blocks (the resident count ``genasm_dc._xwide_launch``
    reads), so that each block walks several lane groups and reuses its
    scratch and shared memory for each."""
    resident = genasm_dc.xwide_resident
    genasm_dc.xwide_resident = lambda name, geo, device: blocks
    try:
        yield
    finally:
        genasm_dc.xwide_resident = resident


def _loop_check(name: str, cfg: AlignerConfig, call, ref, lanes: int,
                block_lanes: int, device, what: str) -> dict:
    """The wide kernel `call` once more on a grid of ``groups // 8`` blocks
    (at least one), so that each block handles several of the case's lane
    groups in turn, against the plain outputs `ref` (max abs err 0 or
    raise): the persistent grid's loop, which the cases' own grids (fewer
    groups than the card's resident blocks) do not run.  {} where the
    case is not wide or has one group, or off the card."""
    groups = -(-lanes // block_lanes)
    if not _xwide(cfg, name) or groups < 2 or device.type != "cuda":
        return {}
    blocks = max(1, groups // 8)
    with _grid_of(blocks):
        got = call()
    return dict(loop_blocks=blocks, loop_groups=groups,
                loop_max_abs_err=_max_abs_err(
                    name, got, ref, f"{what} on {blocks} block(s)"))


def _block_row(cfg: AlignerConfig, geo) -> dict:
    """A block's fields in a row: a template's G threads a lane and L
    levels a thread, or the wide family's register fill (WT word threads
    and GW level groups a warp; K3's staged rows a buffer, its steps a
    flush x GW x XR_LEVELS); lanes, threads and shared bytes."""
    if isinstance(geo, genasm_dc.XwideGeometry):
        own = dict(family="xwide", WT=geo.words, GW=geo.depth)
        if geo.chunk:
            own.update(staging_rows=geo.chunk * geo.depth * geo.levels)
    else:
        own = dict(G=geo.group, L=geo.levels_per_thread)
    return dict(own, lanes_per_block=geo.lanes, threads=geo.threads,
                shared_bytes=geo.shared_bytes)


def tail_launcher(name: str, cfg: AlignerConfig, geo, inputs, kw):
    """A call of the tail kernel `name` (K2 ``tail_banded`` or K4
    ``tail_full``) at block `geo` (any ``genasm_dc.tail_geometry``, in
    either placement) on CUDA `inputs`, through its C entry point, and its
    (ops, meta); the wrapper launches only the geometry's default.  On
    CPU inputs, and for the wide family (one block, the wrapper's): the
    wrapper."""
    pm, text, m_len, n_len = inputs
    if pm.device.type != "cuda" or _xwide(cfg, name):
        return lambda: KERNELS[name][0](*inputs, **kw)
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
    shapes, in `placement` (default: the geometry's own choice; the wide
    family's block where it runs the tails, placement "xwide"), and a row
    of its
    block, store and (with ``usage``, on the card) occupancy and ptxas
    report."""
    n_text = cfg.W + 4 * cfg.k
    banded = name == "tail_banded"
    nwb = cfg.nwb if banded else cfg.nw
    if _xwide(cfg, name):
        geo = genasm_dc.xwide_geometry(cfg, name, n_text)
        placement = "xwide"
    else:
        geo = genasm_dc.tail_geometry(cfg, n_text, cfg.W + n_text,
                                      banded=banded, placement=placement)
        placement = geo.placement
    row = dict(NW=cfg.nw, KP=genasm_dc.levels_bucket(cfg.k), NWB=nwb,
               **_block_row(cfg, geo), placement=placement,
               store_bytes_per_lane=4 * ((cfg.k + 1) * n_text * nwb
                                         if placement == "shared"
                                         else geo.store_words))
    if usage is not None:
        blocks, limit = (genasm_dc.xwide_occupancy(name, geo)
                         if _xwide(cfg, name)
                         else genasm_dc.tail_occupancy(cfg, geo, banded))
        if limit < geo.shared_bytes:
            raise AssertionError(f"{name} W={cfg.W} k={cfg.k}: the card "
                                 f"allows {limit} B of dynamic shared "
                                 f"memory, a block asks for "
                                 f"{geo.shared_bytes}")
        if blocks == 0:
            raise AssertionError(f"{name} W={cfg.W} k={cfg.k}: no block of "
                                 f"{geo.threads} threads fits an SM")
        row.update(blocks_per_sm=blocks, card_shared_bytes=limit,
                   ptxas=usage.get(_instantiation(name, cfg, placement)))
    return geo, row


def k3_launcher(cfg: AlignerConfig, geo, inputs):
    """A call of K3 at block `geo` (any ``genasm_dc.dc_band_geometry``, in
    either placement) on CUDA `inputs`, through its C entry point, and its
    (dist, band, levels); the wrapper launches only the geometry's
    default.  On CPU inputs, and for the wide family (one block, the
    wrapper's): the wrapper."""
    pm, text = inputs
    if pm.device.type != "cuda" or _xwide(cfg, "dc_band"):
        return lambda: genasm_dc.genasm_dc(pm, text, cfg=cfg)
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
    own; the wide family's block at NW >= 9, placement "xwide", its chunk
    the steps between two flushes of its staging buffer), and a row of its
    block and (with ``usage``, on the card) the shared bytes the card
    allows, blocks per SM and ptxas's report."""
    if _xwide(cfg, "dc_band"):
        geo = genasm_dc.xwide_geometry(cfg, "dc_band")
        placement, chunk = "xwide", geo.chunk
    else:
        geo = genasm_dc.dc_band_geometry(cfg, threads, placement=placement)
        placement, chunk = geo.placement, geo.chunk
    row = dict(NW=cfg.nw, KP=genasm_dc.levels_bucket(cfg.k), NWB=cfg.nwb,
               **_block_row(cfg, geo), placement=placement, chunk=chunk)
    if usage is not None:
        blocks, limit = (genasm_dc.xwide_occupancy("dc_band", geo)
                         if _xwide(cfg, "dc_band")
                         else genasm_dc.dc_band_occupancy(cfg, geo))
        if limit < geo.shared_bytes:
            raise AssertionError(f"K3 W={cfg.W} k={cfg.k}: the card allows "
                                 f"{limit} B of dynamic shared memory, a "
                                 f"block asks for {geo.shared_bytes}")
        if blocks == 0:
            raise AssertionError(f"K3 W={cfg.W} k={cfg.k}: no block of "
                                 f"{geo.threads} threads fits an SM")
        row.update(blocks_per_sm=blocks, card_shared_bytes=limit,
                   ptxas=usage.get(_instantiation("dc_band", cfg,
                                                  placement)))
    return geo, row


#: K3 on the card at W > 64 (NW = 3, 4) and where m_pad > W (40, 48):
#: (W, O, k), each at the phase's lanes, timed; the last also K1 and K4
#: (KP = 128: their band and store in device memory)
K3_WIDE = [(40, 16, 12), (48, 16, 12), (96, 36, 24), (96, 36, 48),
           (128, 48, 24), (128, 48, 48), (128, 48, 96)]
KP128_TIMED = K3_WIDE[-1]
#: the W = 256 ladder's rungs (``W256_CFG``: W = 256, O = 96, k = 30 -> 60
#: -> 120 -> 240, KP = 32, 64, 128, 256, NW = 8), each kernel timed alone
#: at 2,048 lanes: K1, the tail the rung selects (K2 at k = 30, 60; K4 at
#: 120, 240) and K3.  Their equality with the plain versions is held by the
#: grids (``K1_WIDE_GRID``, ``TAIL_WIDE_GRID``) at 37 and 1 lanes: the
#: plain K4 alone at 2,048 lanes, k = 240 would take minutes.
W256_TIMED = (256, 96, (30, 60, 120, 240), 2048)
#: the W = 512 ladder's rungs (``W512_CFG``: k = 60 -> 120 -> 240 -> 480,
#: KP = 64, 128, 256, 512, NW = 16: the wide family), each kernel timed
#: alone at 2,048 lanes as ``W256_TIMED``'s, one call a timing and no
#: warm-up call past the first (a call takes 8-580 ms; K3 at k = 480
#: writes a 32 GB band); held equal to the plain versions by the grids
#: (``XWIDE_GRID``, ``TAIL_XWIDE_GRID``) and a few of their lanes to the
#: kernel on those lanes alone (``_later_lanes``)
W512_TIMED = (512, 192, (60, 120, 240, 480), 2048)
W512_REPS = 1
#: distinct lanes of the W = 512 rows' inputs, repeated to the 2,048 (a
#: lane's work is its own, so the time is the same; drawing 2,048 lanes
#: of ~1 kbp texts with k edits each in Python took ~13 s)
W512_DISTINCT = 256


def phase_kernels(device: torch.device, n_pairs: int = 4096,
                  reps: int = 20, usage: dict | None = None,
                  w256_lanes: int = W256_TIMED[3],
                  w512_lanes: int = W512_TIMED[3]) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes
    (W=64), then K3 at the widths of ``K3_WIDE`` and K1 and K4 at
    ``KP128_TIMED``.  On the card ``ms`` is the device time per launch
    (``_device_ms``); ``event_ms`` the CUDA-event time per call of
    back-to-back wrapper calls, the host's time between launches included.
    The tail rows carry their block, store placement and (with ``usage``,
    ptxas's) registers, spills and blocks per SM; the K3 rows their block,
    band placement and occupancy; the K1 rows at KP = 128 their band's
    placement, bytes a lane and ptxas, and with K4's the least time to
    write the part of the band or store that the walk can read
    (``store_floor_ms``, ``_store_floor_ms``).  Then each rung of the W = 256 and
    W = 512 ladders (``_ladder_rows``), the ladder's gate kernel
    (``_gate_row``), last K1's window form beside its standalone form
    (``_tb_window_rows``)."""
    rng = np.random.default_rng(2022)
    cases = [("tb_fused", 12), ("tb_fused", 24), ("tb_fused", 48),
             ("tail_banded", 12), ("tail_full", 24), ("tail_full", 48),
             ("dc_band", 12), ("dc_band", 24), ("dc_band", 48)]
    wide = AlignerConfig(W=KP128_TIMED[0], O=KP128_TIMED[1],
                         k=KP128_TIMED[2])
    cases = [(name, AlignerConfig(k=k)) for name, k in cases] + [
        ("dc_band", AlignerConfig(W=W, O=O, k=k)) for W, O, k in K3_WIDE] + [
        ("tb_fused", wide), ("tail_full", wide)]
    rows = []
    for name, cfg in cases:
        if name.startswith("tail") and (name == "tail_banded") != cfg.tail_banded:
            raise AssertionError(f"k={cfg.k} does not select {name}")
        row = _check_case(name, cfg, n_pairs, rng, device, reps,
                          f"W={cfg.W} k={cfg.k}", floor=cfg is wide)
        if name == "tb_fused" and cfg.W == 64:
            row["one_thread_ms"] = K1_ONE_THREAD_MS[cfg.k]
        row = {**_geometry_row(name, cfg, usage), **row}
        emit("kernel", **row)
        rows.append(row)
    rows += _ladder_rows(device, reps, usage, W256_TIMED[:3], w256_lanes)
    rows += _ladder_rows(device, W512_REPS, usage, W512_TIMED[:3],
                         w512_lanes, distinct=W512_DISTINCT, warm=0)
    rows.append(_gate_row(device, 1024, reps, usage))
    emit("kernel", **rows[-1])
    rows += _tb_window_rows(device, reps)
    return rows


#: K1's window form (``window_step.genasm_tb_window``) is held to its
#: plain version (``tb_window_plain``) and timed at these (W, O, ks): the
#: main path's rungs, W = 128 at KP = 128, and the first and last rungs of
#: the W = 256 and W = 512 ladders (NW = 8: the template at k = 30, the
#: register fill at 240; NW = 16); checked
#: on ``TB_WINDOW_LANES`` lanes over ``TB_WINDOW_WINDOWS`` windows in a row
#: (phase k1_grid), timed at ``TB_WINDOW_TIMED`` lanes beside K1's
#: standalone form on the same slices (phase kernel)
TB_WINDOW_CASES = ((64, 24, (12, 24, 48)), (128, 48, (96,)),
                   (256, 96, (30, 240)), (512, 192, (60, 480)))
TB_WINDOW_LANES = 37
TB_WINDOW_WINDOWS = 3
TB_WINDOW_TIMED = (2048, 4096)


def _window_read_len(W: int) -> int:
    """Read length of a window batch: the main path's 10 kbp at W = 64,
    elsewhere 4 kbp, long enough for every timed call to find most lanes
    active."""
    return 10_000 if W == 64 else 4_000


def _window_batch(device, cfg: AlignerConfig, lanes: int, read_len: int,
                  seed: int):
    """One main window's inputs as the fused loop meets them: `lanes`
    reads of `read_len` / 2 to `read_len` bases (sentinel-padded as
    ``pad_geometry`` pads them), references within ~2 % substitutions,
    one in ten shifted by up to 3 bases, each lane at its own window
    start; one in 16 lanes starting past its row's end (the start clamps),
    one in 16 within W of its read's end (inactive), one in 16 with its
    reference 2 W further on (its window fails), one in 20 already failed;
    offsets of which some run into the op buffer's drop column; and a
    state for the commit (``TB_WINDOW_WINDOWS`` level counts or more)."""
    rng = np.random.default_rng(seed)
    Lr, Lf = pad_geometry(cfg, read_len, read_len, 0)
    bases = rng.integers(0, 4, (lanes, read_len)).astype(np.uint8)
    refs = np.full((lanes, Lf), 9, np.uint8)
    refs[:, :read_len] = np.where(rng.random(bases.shape) < 0.02,
                                  rng.integers(0, 4, bases.shape), bases)
    reads = np.full((lanes, Lr), 255, np.uint8)
    reads[:, :read_len] = bases
    lens = rng.integers(read_len // 2, read_len + 1, lanes).astype(np.int32)
    start = rng.integers(0, read_len // 2, lanes).astype(np.int32)
    shift = rng.integers(-3, 4, lanes) * (rng.random(lanes) < 0.1)
    kind = rng.random(lanes) * 16
    start[kind < 1] = Lr
    tail = (kind >= 1) & (kind < 2)
    start[tail] = lens[tail] - rng.integers(0, cfg.W, int(tail.sum()))
    shift[(kind >= 2) & (kind < 3)] = 2 * cfg.W
    windows = max(n_main_windows(read_len, cfg), TB_WINDOW_WINDOWS)
    budget = total_op_budget(read_len, cfg)
    dev = lambda a: torch.from_numpy(a).to(device)       # noqa: E731
    state = {"read_pos": dev(start),
             "ref_pos": dev(np.maximum(start + shift, 0).astype(np.int32)),
             "off": dev(rng.integers(0, budget, lanes).astype(np.int32)),
             "dist": dev(rng.integers(0, 40, lanes).astype(np.int32)),
             "failed": dev(rng.random(lanes) < 0.05),
             "buf": dev(np.full((lanes, budget + 1), 4, np.uint8)),
             "levels": torch.full((windows,), window_step.LEVELS_FLOOR,
                                  dtype=torch.int32, device=device)}
    return dev(reads), dev(refs), dev(lens), state


def _state_fields(state: dict) -> list:
    """A window state's fields as the window form is held to its plain
    version: every field, the op buffer without its drop column."""
    return [state[k][:, :-1] if k == "buf" else state[k] for k in state]


def _tb_window_check(device, cfg: AlignerConfig, lanes: int, seed: int,
                     windows: int = TB_WINDOW_WINDOWS) -> dict:
    """K1's window form against ``tb_window_plain`` (run on `device`)
    over `windows` windows in a row on a ``_window_batch`` of `lanes`
    lanes, each window's state carried to the next: max abs err 0 over
    every state field, the level counts and the op buffer less its drop
    column, or raise.  The row counts the lanes the batch holds of each
    kind at the first window."""
    reads, refs, read_len, state = _window_batch(
        device, cfg, lanes, _window_read_len(cfg.W), seed)
    plain = {k: v.clone() for k, v in state.items()}
    rp, lr = state["read_pos"], reads.shape[1]
    kinds = dict(clamped=int((rp > lr - cfg.W).sum()),
                 inactive=int((read_len - rp <= cfg.W).sum()),
                 failed_before=int(state["failed"].sum()))
    plain_ms = []
    groups = -(-lanes // _k1_block(cfg).lanes)
    for w in range(windows):
        # a wide case's window 1 on one block, which walks every lane group
        one = _xwide(cfg, "tb_fused") and w == 1
        with _grid_of(1) if one else contextlib.nullcontext():
            window_step.genasm_tb_window(reads, refs, read_len, state,
                                         cfg=cfg, window=w)
        _sync(device)
        t0 = time.perf_counter()
        window_step.tb_window_plain(reads, refs, read_len, plain, cfg=cfg,
                                    window=w)
        _sync(device)
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        err = _max_abs_err("tb_window", _state_fields(state),
                           _state_fields(plain),
                           f"W={cfg.W} k={cfg.k} {lanes} lanes window {w}")
    return dict(name="tb_window", W=cfg.W, k=cfg.k, lanes=lanes,
                windows=windows, max_abs_err=err, plain_ms=plain_ms[0],
                plain_on=device.type, **kinds, groups=groups,
                loop_window=1 if _xwide(cfg, "tb_fused") and groups > 1
                else None,
                failed_after=int(state["failed"].sum()),
                levels=state["levels"][:windows].tolist())


def _tb_window_bound(cfg: AlignerConfig, reads, state, read_len, meta):
    """Least time on an H100 for one window of K1's window form, and what
    bounds it: the bytes it must move (each lane's two W-base slices, its
    length and state read, a committing lane's state and ops written, a
    failing lane's flag) over HBM bandwidth, against the integer
    operations of the fill (each lane's W columns to its level count) and
    of the walks the committing lanes take (their op counts, from K1's
    standalone form on the same slices, `meta`) over the INT32 rate."""
    B = reads.shape[0]
    dist = meta[genasm_dc.META_DIST, :B].long().cpu()
    nops = meta[genasm_dc.META_NOPS, :B].long().cpu()
    active = ((read_len - state["read_pos"] > cfg.W)
              & ~state["failed"]).cpu()
    commit = active & (dist <= cfg.k)
    ops_written = int(torch.clamp(nops[commit], max=cfg.tb_max_ops).sum())
    nbytes = (B * (2 * cfg.W + 5 * 4 + 1) + int(commit.sum()) * 4 * 4
              + ops_written + int((active & ~commit).sum()))
    levels = torch.clamp(dist, max=cfg.k) + 1
    fill_ops = int(levels.sum()) * cfg.W * cfg.nw * OPS_PER_CELL_WORD
    walk_ops = int(nops[commit].sum()) * OPS_PER_WALK_STEP
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (fill_ops + walk_ops) / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations",
            int(commit.sum()), ops_written)


def _tb_window_rows(device: torch.device, reps: int,
                    lane_counts=TB_WINDOW_TIMED,
                    cases=TB_WINDOW_CASES) -> list[dict]:
    """K1's window form timed at each of ``TB_WINDOW_CASES``' (W, k) and
    `lane_counts` on a ``_window_batch`` (the W = 64 rows at the main
    path's 10 kbp reads), beside K1's standalone form on the same slices
    (``window_prep_plain``'s pm and text): device ms of each (a CUDA graph
    of `reps` calls; at W = 512 one call a timing, ``W512_REPS``), event
    ms, and the window form's bound (``_tb_window_bound``).  Each call
    commits into the batch's state, so later calls find lanes further on
    (the reads are long enough that most stay active).  At W = 64 the
    first window is also held to ``tb_window_plain`` on the card (max abs
    err 0); elsewhere the checks of phase k1_grid hold the form to it.  No
    single PyTorch call computes a window (``library_ms`` null)."""
    rows = []
    for W, O, ks in cases:
        for k in ks:
            cfg = AlignerConfig(W=W, O=O, k=k)
            # one call a timing where a call takes 8-580 ms (W > 256)
            slow = cfg.nw > genasm_dc.TEMPLATE_NW
            n = W512_REPS if slow else reps
            for lanes in lane_counts:
                reads, refs, read_len, state = _window_batch(
                    device, cfg, lanes, _window_read_len(W), seed=W + k)
                pm, text = window_step.window_prep_plain(
                    reads, refs, state["read_pos"], state["ref_pos"],
                    cfg=cfg)
                kw = dict(cfg=cfg, commit_limit=cfg.stride,
                          max_ops=cfg.tb_max_ops, max_steps=cfg.tb_max_steps)
                ops, meta = genasm_dc.genasm_tb_fused(pm, text, **kw)
                bound_ms, bound_by, n_commit, ops_written = _tb_window_bound(
                    cfg, reads, state, read_len, meta)
                del ops, meta
                row = dict(name="tb_window", W=W, k=k, lanes=lanes,
                           library_ms=None, committed_lanes=n_commit,
                           committed_ops=ops_written, bound_ms=bound_ms,
                           bound_by=bound_by, max_abs_err=None,
                           plain_ms=None, checked_by="k1_grid")
                if W == 64:
                    plain = {key: v.clone() for key, v in state.items()}
                    window_step.genasm_tb_window(reads, refs, read_len,
                                                 state, cfg=cfg, window=0)
                    _sync(device)
                    t0 = time.perf_counter()
                    window_step.tb_window_plain(reads, refs, read_len,
                                                plain, cfg=cfg, window=0)
                    _sync(device)
                    row.update(plain_ms=(time.perf_counter() - t0) * 1e3,
                               checked_by="plain", max_abs_err=_max_abs_err(
                                   "tb_window", _state_fields(state),
                                   _state_fields(plain),
                                   f"W=64 k={k} {lanes} lanes"))
                    del plain

                def window_call():
                    window_step.genasm_tb_window(reads, refs, read_len,
                                                 state, cfg=cfg, window=0)
                alone = _timing("tb_fused", cfg,
                                lambda: genasm_dc.genasm_tb_fused(pm, text,
                                                                  **kw),
                                n, device, warm=0 if slow else 2)
                row.update(_timing("tb_window", cfg, window_call, n, device,
                                   warm=0 if slow else 2),
                           standalone_ms=alone["ms"],
                           standalone_event_ms=alone["event_ms"])
                del reads, refs, read_len, state, pm, text
                if device.type == "cuda":
                    gc.collect()
                    torch.cuda.empty_cache()
                emit("kernel", **row)
                rows.append(row)
    return rows


def _geometry_row(name: str, cfg: AlignerConfig, usage) -> dict:
    """A kernel row's block, store and (with ``usage``, on the card)
    occupancy and ptxas fields: K1 beyond W = 64 its geometry, band
    placement, band bytes a lane in device memory, blocks per SM and
    ptxas; the tails' and K3's rows as their grids give them."""
    if name.startswith("tail"):
        return _tail_geometry(name, cfg, usage=usage)[1]
    if name == "dc_band":
        return _k3_geometry(cfg, usage=usage)[1]
    if cfg.W == 64:
        return {}
    geo = _k1_block(cfg)
    row = dict(_k1_geometry(cfg),
               placement="xwide" if _xwide(cfg, "tb_fused")
               else geo.placement,
               store_bytes_per_lane=4 * geo.store_words,
               ptxas=(usage or {}).get(_instantiation("tb_fused", cfg)))
    if usage is not None:
        row["blocks_per_sm"] = (
            genasm_dc.xwide_occupancy("tb_fused", geo)
            if _xwide(cfg, "tb_fused")
            else genasm_dc.tb_fused_occupancy(cfg, geo))[0]
    return row


def _repeated(case, times: int):
    """A ``_case`` whose lanes (the last axis of every input, and the
    columns) are repeated `times` times."""
    inputs, kw, cols = case
    return (tuple(t.repeat(*[1] * (t.dim() - 1), times) for t in inputs),
            kw, np.tile(cols, times))


def _later_lanes(name: str, cfg: AlignerConfig, inputs, kw, got,
                 device) -> dict:
    """A wide kernel's outputs at a few lanes of a big call (the first
    two, the middle and the last: past the card's resident blocks, the
    later ones fall to a block's later lane groups) against the kernel
    run on those lanes alone (each in a block's first group): max abs
    err 0 or raise.  {} below NW = 9 or off the card."""
    if not _xwide(cfg, name) or device.type != "cuda":
        return {}
    B = inputs[0].shape[-1]
    lanes = sorted({0, 1, B // 2, B - 1})
    idx = torch.tensor(lanes, device=device)
    alone = KERNELS[name][0](*(t.index_select(-1, idx).contiguous()
                               for t in inputs), **kw)
    return dict(later_lanes=lanes, later_lanes_max_abs_err=_max_abs_err(
        name, alone, [o.index_select(-1, idx) for o in got],
        f"W={cfg.W} k={cfg.k}: lanes {lanes} of {B}"))


def _ladder_rows(device: torch.device, reps: int, usage, ladder,
                 lanes: int, distinct: int | None = None,
                 warm: int = 2) -> list[dict]:
    """K1, the rung's tail and K3 at each rung of `ladder` ((W, O, ks):
    ``W256_TIMED``, ``W512_TIMED``) on `lanes` lanes (K1 and K3 on the
    same windows; `distinct` of them drawn and repeated, where given),
    timed alone (device ms, event ms, bound, after `warm` calls; no plain
    version: the grids hold these kernels equal to it, and at NW >= 9 a
    few lanes that blocks reach on later groups are held to the kernel
    on those lanes alone, ``_later_lanes``), with block, store bytes a
    lane, ptxas registers and spills, blocks per SM, the peak of device
    memory the row allocated (``peak_bytes``) and its seconds (a rung's
    first row with its inputs' making).  K1's and the tails' rows also
    carry ``store_floor_ms`` (``_store_floor_ms``).  Each call's outputs are freed
    before the next (K3's band is 32 GB at W = 512, k = 480, K4's store
    in flight 20 GB)."""
    W, O, ks = ladder
    rng = np.random.default_rng(W)
    drawn = distinct or lanes
    rows = []
    for k in ks:
        t0 = time.perf_counter()
        cfg = AlignerConfig(W=W, O=O, k=k)
        tail = "tail_banded" if cfg.tail_banded else "tail_full"
        square = _repeated(_case("tb_fused", cfg, drawn, rng, device),
                           lanes // drawn)
        cases = {"tb_fused": square,
                 tail: _repeated(_case(tail, cfg, drawn, rng, device),
                                 lanes // drawn),
                 "dc_band": (square[0], dict(cfg=cfg), square[2])}
        for name, (inputs, kw, cols) in cases.items():
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            call = lambda: KERNELS[name][0](*inputs, **kw)  # noqa: E731
            got = call()
            dist, steps = _dist_and_steps(name, got)
            bound_ms, bound_by = _bound(cfg, inputs, got, cols, dist, steps)
            later = _later_lanes(name, cfg, inputs, kw, got, device)
            del got
            row = {**_geometry_row(name, cfg, usage),
                   "store_floor_ms": _store_floor_ms(name, cfg, cols, dist),
                   **dict(name=name, W=W, k=k, lanes=lanes,
                          max_abs_err=None, plain_ms=None, plain_on=None,
                          checked_by="grids", distinct_lanes=drawn,
                          solved=int((dist <= cfg.k).sum())), **later,
                   **_timing(name, cfg, call, reps, device, warm=warm),
                   "bound_ms": bound_ms, "bound_by": bound_by}
            del call
            gc.collect()
            if device.type == "cuda":
                row["peak_bytes"] = torch.cuda.max_memory_allocated(device)
                torch.cuda.empty_cache()
            row["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            emit("kernel", **row)
            rows.append(row)
    return rows


def _gate_row(device: torch.device, lanes: int, reps: int,
              usage: dict | None = None) -> dict:
    """The rescue ladder's gate kernel alone (``ladder_graph.ladder_gate``,
    no condition set) against its plain version on a dispatch's ``failed``
    of `lanes` lanes, three of them set and then none (max abs err 0 or
    raise); on the first its device ms, the bound (the lanes' bytes read
    once and one word written, against one operation a lane) and
    ``failed.any()``, the one PyTorch call computing the same, as the
    library's time."""
    failed = torch.zeros(lanes, dtype=torch.bool, device=device)
    failed[np.random.default_rng(27).choice(lanes, 3, replace=False)] = True
    err, plain_ms = 0, None
    for f in (failed, torch.zeros_like(failed)):
        got = ladder_graph.ladder_gate(f)
        _sync(device)
        t0 = time.perf_counter()
        ref = ladder_graph.ladder_gate_plain(f)
        _sync(device)
        plain_ms = plain_ms or (time.perf_counter() - t0) * 1e3
        err = max(err, int((got.long() - ref.long()).abs().max()))
    if err:
        raise AssertionError(f"ladder_gate: kernel and plain version differ "
                             f"(max abs err {err})")
    call = lambda: ladder_graph.ladder_gate(failed)     # noqa: E731
    t_bytes = (lanes + 4) / HBM_BYTES_PER_S
    t_ops = lanes / INT32_OPS_PER_S
    return dict(name="ladder_gate", W=None, k=None, lanes=lanes,
                max_abs_err=err, plain_ms=plain_ms,
                ms=_device_ms(call, reps, device) or _time_ms(call, reps,
                                                              device),
                event_ms=_time_ms(call, reps, device),
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=_device_ms(lambda: failed.any(), reps, device),
                ptxas=(usage or {}).get("ladder_gate"))


#: K1's geometry grid: (W, O, k, early_term, lanes); every (NW, KP, NWB)
#: instantiation, W = 40 and 48 (m_pad > W), idle levels above k (k=40),
#: no early termination, lane counts that are no multiple of a block's
#: lanes, blocks of fewer lanes (W = 96 and 128 at k = 48), the band in
#: device memory (KP = 128: k = 64 .. W - 1 at W = 65, 96 and 128), and
#: the main path's own batch width (2,048, timed)
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
           (96, 36, 64, True, 37), (96, 36, 95, True, 1),
           (128, 48, 64, True, 37), (128, 48, 127, True, 37),
           (128, 48, 96, False, 37), (128, 48, 127, True, 1),
           (65, 24, 64, True, 37), (65, 24, 64, True, 1),
           (64, 24, 12, True, 2048), (64, 24, 24, True, 2048),
           (64, 24, 48, True, 2048)]
#: one width of each NW = 5..8 (W = 144 and 208 with m_pad > W), (W, O)
WIDE_WIDTHS = {5: (144, 48), 6: (192, 64), 7: (208, 72), 8: (256, 96)}
#: the k that reaches each wide (KP, NWB) at the least cost: NWB 1, 2 at
#: KP = 16 (k = 12, 15); 2, 3 at KP = 32 (24, 31); 3, 4, 5 at KP = 64 (40,
#: 48, 63); 5, 6, 7, 8 at KP = 128 (64, 80, 100, 120; NWB <= NW); NW at
#: KP = 256 (128)
WIDE_KS = (12, 15, 24, 31, 40, 48, 63, 64, 80, 100, 120, 128)


def _wide_ks(nw: int):
    """The ``WIDE_KS`` of NW's instantiations: at KP = 128 those whose
    band, ceil((2k+3)/32) words, is no wider than the vector."""
    return [k for k in WIDE_KS if not 64 < k < 128
            or -(-(2 * k + 3) // 32) <= nw]


#: K1's grid at NW = 5..8: every (NW, KP, NWB) these widths reach, each on
#: its route (``genasm_dc.kernel_family``: the register fill, or the
#: template ``TEMPLATE_KEPT`` keeps), at 37 lanes (a register-fill case
#: also on a grid of fewer blocks than its 10 lane groups, ``_loop_check``:
#: W = 256 at k = 40..128), and a few at 1 lane (W = 256, k = 240 and 255;
#: no early termination at W = 192, k = 100)
K1_WIDE_GRID = [(*WIDE_WIDTHS[nw], k, True, 37) for nw in WIDE_WIDTHS
                for k in _wide_ks(nw)] + [
    (256, 96, 240, True, 1), (256, 96, 255, True, 1), (144, 48, 12, True, 1),
    (192, 64, 100, False, 1)]


#: the wide family's grid (NW >= 9): (W, O, k, early_term, lanes) of K1
#: and K3.  One kernel serves every (NW, KP, NWB) at run time, so one case
#: a width class and layout: W = 288 (NW 9, KP 32, nwb 2), W = 320 (NW 10,
#: KP 256, the whole vector, no early termination) and W = 512 at KP 64
#: and 512 at 37 lanes, each also on a grid of fewer blocks than lane
#: groups (``_loop_check``); at 1 lane W = 512, k = 511 (K3's analytic
#: column 0) and W = 1024, k = 700 (NW 32, KP 1,024: 101 level strips); at
#: 2 lanes W = 1100, k = 40 (NW 35: two word strips, K3's window words
#: across their boundary).
#: The plain version takes ~1-2 s a case on the card: with the tails'
#: about 30 s
XWIDE_GRID = [(288, 96, 20, True, 37), (320, 96, 200, False, 37),
              (512, 192, 60, True, 37), (512, 192, 480, True, 37),
              (512, 192, 511, True, 1), (1024, 300, 700, True, 1),
              (1100, 300, 40, True, 2)]


def _k1_block(cfg: AlignerConfig):
    """K1's block for `cfg`: its template's, or the wide family's."""
    if _xwide(cfg, "tb_fused"):
        return genasm_dc.xwide_geometry(cfg, "tb_fused")
    return genasm_dc.tb_fused_geometry(cfg)


def _k1_geometry(cfg: AlignerConfig) -> dict:
    return dict(W=cfg.W, k=cfg.k, NW=cfg.nw,
                KP=genasm_dc.levels_bucket(cfg.k), NWB=cfg.nwb,
                **_block_row(cfg, _k1_block(cfg)))


def _k1_cases():
    """(kernel, config, lanes) of ``K1_GRID`` and ``K1_WIDE_GRID``, in
    phase k1_grid's order."""
    for W, O, k, early_term, lanes in K1_GRID + K1_WIDE_GRID + XWIDE_GRID:
        yield "tb_fused", AlignerConfig(W=W, O=O, k=k,
                                        early_term=early_term), lanes


def phase_k1_grid(device: torch.device, reps: int = 20,
                  refs=None) -> list[dict]:
    """K1 over its geometry grid, each case held against tb_fused_plain
    with max abs err 0 (the untimed cases' plain outputs from `refs`, a
    future of ``_plain_refs("k1")``, where given); the 2,048-lane cases
    timed.  Then K1's window form at each of ``TB_WINDOW_CASES``
    (``_tb_window_check``: ``TB_WINDOW_LANES`` lanes, ``TB_WINDOW_WINDOWS``
    windows in a row), with its block."""
    rng = np.random.default_rng(GRID_SEEDS["k1"])
    refs = None if refs is None else iter(refs.result())
    rows = []
    for name, cfg, lanes in _k1_cases():
        what = (f"W={cfg.W} k={cfg.k} early_term={cfg.early_term} "
                f"lanes={lanes}")
        row = _check_case(name, cfg, lanes, rng, device,
                          reps if lanes >= 2048 else 0, what, refs,
                          loop=True)
        row.update(_k1_geometry(cfg), early_term=cfg.early_term)
        emit("k1_grid", **row)
        rows.append(row)
    _done(refs)
    for W, O, ks in TB_WINDOW_CASES:
        for k in ks:
            cfg = AlignerConfig(W=W, O=O, k=k)
            geo = (_k1_block(cfg) if _xwide(cfg, "tb_fused")
                   else genasm_dc.tb_fused_geometry(cfg, window=True))
            row = _tb_window_check(device, cfg, TB_WINDOW_LANES,
                                   seed=GRID_SEEDS["k1"] + W + k)
            row.update(NW=cfg.nw, KP=genasm_dc.levels_bucket(k),
                       NWB=cfg.nwb, **_block_row(cfg, geo))
            emit("k1_grid", **row)
            rows.append(row)
    return rows


def phase_k1_occupancy(usage: dict) -> dict:
    """Per K1 instantiation of the default ladder, of W = 96 and 128 at
    k = 48 (fewer lanes a block), of KP = 128 (W = 96, k = 64; W = 128,
    k = 96: the band in device memory) and of NW = 5..8 (``K1_WIDE_GRID``'s
    37-lane cases, one a (NW, KP, NWB); the wide family's kernel where
    ``genasm_dc.kernel_family`` names it): its block, the dynamic shared
    bytes a block asks for and the kernel's limit as the card reports it,
    active blocks per SM on this card, and ptxas's registers and spills.
    Returns the rows of the default ladder's k (12, 24, 48)."""
    out = {}
    wide = [case[:3] for case in K1_WIDE_GRID if case[4] == 37]
    for W, O, k in ((32, 12, 5), (32, 12, 20), (64, 24, 12), (64, 24, 15),
                    (64, 24, 24), (64, 24, 48), (96, 36, 48),
                    (128, 48, 48), (96, 36, 64), (128, 48, 96), *wide):
        cfg = AlignerConfig(W=W, O=O, k=k)
        row = _k1_geometry(cfg)
        blocks, limit = (
            genasm_dc.xwide_occupancy("tb_fused", _k1_block(cfg))
            if _xwide(cfg, "tb_fused") else genasm_dc.tb_fused_occupancy(
                cfg, genasm_dc.tb_fused_geometry(cfg)))
        if limit < row["shared_bytes"]:
            raise AssertionError(f"K1 W={W} k={k}: the card allows {limit} "
                                 f"B of dynamic shared memory, a block asks "
                                 f"for {row['shared_bytes']}")
        if blocks == 0:
            raise AssertionError(f"K1 W={W} k={k}: no block of "
                                 f"{row['threads']} threads fits an SM")
        row.update(blocks_per_sm=blocks, card_shared_bytes=limit,
                   ptxas=usage.get(_instantiation("tb_fused", cfg)))
        emit("k1_occupancy", **row)
        if W == 64 and k in K1_ONE_THREAD_MS:
            out[k] = row
    return out


#: K3's grid: K1's (K3 has K1's (NW, KP, NWB) instantiations), each in
#: both band placements at NW <= 4 and in ``K3_PLACEMENT``'s at NW = 5..8,
#: at 37 and 1 lanes
K3_GRID = [case for case in K1_GRID + K1_WIDE_GRID + XWIDE_GRID
           if case[4] < 2048]


def _k3_cases(timed_lanes=(2048, 4096)):
    """(kernel, config, lanes) of ``K3_GRID`` and the main path's shapes at
    each of `timed_lanes`, in phase k3_grid's order."""
    timed = [(64, 24, k, True, lanes) for lanes in timed_lanes
             for k in (12, 24, 48)]
    for W, O, k, early_term, lanes in K3_GRID + timed:
        yield "dc_band", AlignerConfig(W=W, O=O, k=k,
                                       early_term=early_term), lanes


def _k3_placements(cfg: AlignerConfig) -> tuple:
    """K3's band placements instantiated for `cfg`: both at NW <= 4, the
    one ``K3_PLACEMENT`` names at NW = 5..8, the wide family's own at NW
    >= 9."""
    if _xwide(cfg, "dc_band"):
        return ("xwide",)
    if cfg.nw <= genasm_dc.NARROW_NW:
        return K3_PLACEMENTS
    return (genasm_dc.K3_PLACEMENT[genasm_dc.levels_bucket(cfg.k)],)


def phase_k3_grid(device: torch.device, reps: int = 20,
                  usage: dict | None = None,
                  timed_lanes=(2048, 4096), refs=None) -> list[dict]:
    """K3 over ``K3_GRID``, then the main path's shapes (W=64, k = 12, 24,
    48) at each of `timed_lanes`, timed; each case in both band
    placements, launched through the C entry point at that placement's
    geometry (``k3_launcher``) and held against ``dc_band_plain`` with max
    abs err 0; each row with its block, shared bytes asked and allowed,
    blocks per SM and ptxas's report (with ``usage``), the timed rows with
    their device ms and bound.  `refs` (a future of
    ``_plain_refs("k3")``) holds the untimed cases' plain outputs."""
    rng = np.random.default_rng(GRID_SEEDS["k3"])
    refs = None if refs is None else iter(refs.result())
    rows = []
    for _, cfg, lanes in _k3_cases(timed_lanes):
        W, k, early_term = cfg.W, cfg.k, cfg.early_term
        inputs, kw, cols = _case("dc_band", cfg, lanes, rng, device)
        ref, plain_ms, plain_on = _reference("dc_band", inputs, kw, device,
                                             refs, cfg, lanes)
        for placement in _k3_placements(cfg):
            geo, geo_row = _k3_geometry(cfg, placement, usage)
            call = k3_launcher(cfg, geo, inputs)
            got = call()
            what = (f"W={W} k={k} early_term={early_term} lanes={lanes} "
                    f"{placement}")
            row = dict(name="dc_band", W=W, k=k, early_term=early_term,
                       lanes=lanes, max_abs_err=_max_abs_err(
                           "dc_band", got, ref, what),
                       plain_ms=plain_ms, plain_on=plain_on, **geo_row,
                       **_loop_check("dc_band", cfg, call, ref, lanes,
                                     geo.lanes, device, what))
            if lanes >= 2048:
                row.update(_timing("dc_band", cfg, call, reps, device, inputs,
                                   got, cols))
            emit("k3_grid", **row)
            rows.append(row)
    _done(refs)
    return rows


#: the tails' grid: (W, O, k, tail_store, kernel), every (NW, KP, NWB)
#: instantiation of tail_fused_kernel: K4 at W <= 32 (nwb == nw at the
#: base k), K2 where the band is the whole vector (tail_store='band'),
#: W = 40 and 48 (m_pad > W), W = 96 and 128; W=128, k=48, whose lane
#: fits no block's shared memory (global only); and KP = 128 (global only)
#: as 'auto' and 'full' resolve it (K4, W = 65 to 128) and as 'band' does
#: (K2, its band the whole vector)
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
             (128, 48, 48, "auto", "tail_full"),
             (96, 36, 64, "auto", "tail_full"),
             (128, 48, 64, "band", "tail_banded"),
             (128, 48, 96, "full", "tail_full"),
             (128, 48, 127, "auto", "tail_full"),
             (65, 24, 64, "auto", "tail_full")]
#: the tails' grid at NW = 5..8: every (NW, KP, NWB) these widths reach,
#: each on its route (the register fill, or the template kept there,
#: device memory only): 'auto' at K1's ks (K2 where the band is narrower
#: than the vector, else K4), 'full' for K4 at KP = 16, 32 and 64, and K2
#: with the whole vector as its band ('band', W = 144, k = 128); at 37
#: lanes (the register fill's also on fewer blocks than lane groups,
#: ``_loop_check``), and a few at 1 lane
TAIL_WIDE_GRID = [
    (*WIDE_WIDTHS[nw], k, "auto") for nw in WIDE_WIDTHS
    for k in _wide_ks(nw)] + [
    (*WIDE_WIDTHS[nw], k, "full") for nw in WIDE_WIDTHS
    for k in (12, 24, 48) if nw > 5 or k < 48] + [
    (144, 48, 128, "band")]
TAIL_WIDE_GRID = [(W, O, k, store, "tail_banded" if AlignerConfig(
    W=W, O=O, k=k, tail_store=store).tail_banded else "tail_full")
    for W, O, k, store in TAIL_WIDE_GRID]
TAIL_WIDE_ONE = [(256, 96, 240, "auto", "tail_full"),
                 (144, 48, 12, "auto", "tail_banded"),
                 (208, 72, 80, "auto", "tail_banded")]
#: the tails' grid at NW >= 9 (the wide family, K2 and K4 one kernel): K2
#: ('auto' where the band is narrower: W = 288, k = 20 and W = 512, k =
#: 120) and K4 (W = 512, k = 480) at 37 lanes, each also on a grid of
#: fewer blocks than lane groups (``_loop_check``); at 1 lane W = 1024,
#: k = 700 (KP = 1,024) and W = 1100, k = 40 (two word strips), K2 and K4
TAIL_XWIDE_GRID = [(W, O, k, store, "tail_banded" if AlignerConfig(
    W=W, O=O, k=k, tail_store=store).tail_banded else "tail_full")
    for W, O, k, store in ((288, 96, 20, "auto"), (512, 192, 120, "auto"),
                           (512, 192, 480, "auto"))]
TAIL_XWIDE_ONE = [(1024, 300, 700, "auto", "tail_full"),
                  (1100, 300, 40, "auto", "tail_banded"),
                  (1100, 300, 40, "full", "tail_full")]
#: the main path's tails, timed at 2,048 lanes in both placements
TAIL_TIMED = [(64, 24, 12, "auto", "tail_banded"),
              (64, 24, 24, "auto", "tail_full"),
              (64, 24, 48, "auto", "tail_full")]


def _tail_cases(lane_counts=(37, 1, 2048)):
    """(kernel, config, lanes) of ``TAIL_GRID`` at each of `lane_counts`
    below 2,048 and ``TAIL_TIMED`` at the others, in phase tail_grid's
    order."""
    for lanes in lane_counts:
        wide = (TAIL_WIDE_GRID + TAIL_XWIDE_GRID if lanes > 1
                else TAIL_WIDE_ONE + TAIL_XWIDE_ONE)
        for W, O, k, tail_store, name in (TAIL_TIMED if lanes >= 2048
                                          else TAIL_GRID + wide):
            yield name, AlignerConfig(W=W, O=O, k=k,
                                      tail_store=tail_store), lanes


def phase_tail_grid(device: torch.device, reps: int = 20,
                    usage: dict | None = None,
                    lane_counts=(37, 1, 2048), refs=None) -> list[dict]:
    """K2 and K4 over ``TAIL_GRID`` at 37 and 1 lanes and ``TAIL_TIMED``
    at 2,048 (timed), each case in both store placements wherever one
    lane's store fits a block's shared memory (else global only), launched
    through the C entry point at that placement's geometry
    (``tail_launcher``) and held against the plain version with max abs
    err 0 (the untimed cases' from `refs`, a future of
    ``_plain_refs("tail")``, where given)."""
    rng = np.random.default_rng(GRID_SEEDS["tail"])
    refs = None if refs is None else iter(refs.result())
    rows = []
    for name, cfg, lanes in _tail_cases(lane_counts):
        W, k, tail_store = cfg.W, cfg.k, cfg.tail_store
        if (name == "tail_banded") != cfg.tail_banded:
            raise AssertionError(f"W={W} k={k} tail_store={tail_store} "
                                 f"does not select {name}")
        inputs, kw, cols = _case(name, cfg, lanes, rng, device)
        ref, plain_ms, plain_on = _reference(name, inputs, kw, device,
                                             refs, cfg, lanes)
        places = (("xwide",) if _xwide(cfg, name) else
                  PLACEMENTS if cfg.nw <= genasm_dc.NARROW_NW else
                  (genasm_dc.TAIL_PLACEMENT[(cfg.nw,
                                             genasm_dc.levels_bucket(k))],))
        for placement in places:
            try:
                geo, geo_row = _tail_geometry(name, cfg, placement, usage)
            except ValueError as exc:       # the lane fits no block
                emit("tail_grid", name=name, W=W, k=k, lanes=lanes,
                     placement=placement, skipped=str(exc))
                continue
            call = tail_launcher(name, cfg, geo, inputs, kw)
            got = call()
            what = f"W={W} k={k} lanes={lanes} {placement}"
            row = dict(name=name, W=W, k=k, tail_store=tail_store,
                       lanes=lanes, max_abs_err=_max_abs_err(
                           name, got, ref, what),
                       plain_ms=plain_ms, plain_on=plain_on, **geo_row,
                       **_loop_check(name, cfg, call, ref, lanes, geo.lanes,
                                     device, what))
            if lanes >= 2048:
                row.update(_timing(name, cfg, call, reps, device, inputs, got,
                                   cols))
            emit("tail_grid", **row)
            rows.append(row)
    _done(refs)
    return rows


#: each grid's seed for its inputs
GRID_SEEDS = {"k1": 15, "tail": 16, "k3": 17}
GRID_CASES = {"k1": _k1_cases, "tail": _tail_cases, "k3": _k3_cases}


def _plain_refs(grid: str) -> list:
    """``(case, plain outputs, ms)`` of each case of `grid` (``"k1"``,
    ``"tail"`` or ``"k3"``: its phase's cases at their default lanes, in
    its order, inputs drawn from its seed): for the untimed cases (fewer
    than 2,048 lanes) the plain version's outputs on the CPU, as numpy
    arrays, and its host ms; None for the timed ones and the wide
    family's (NW >= 9: their plain fills take GBs), whose plain version
    runs on the card.  A worker process computes them while the kernels
    build; the phase holds its kernels to them (``_reference``)."""
    rng = np.random.default_rng(GRID_SEEDS[grid])
    cpu = torch.device("cpu")
    out = []
    for name, cfg, lanes in GRID_CASES[grid]():
        inputs, kw, _ = _case(name, cfg, lanes, rng, cpu)
        ref, ms = (None, None)
        if lanes < 2048 and cfg.nw <= genasm_dc.TEMPLATE_NW:
            ref, ms = _plain(name, inputs, kw, cpu)
            ref = tuple(t.numpy() for t in ref)
        out.append(((name, repr(cfg), lanes), ref, ms))
    return out


def _worker_init() -> None:
    """A worker process's set-up: one thread (it runs beside the build)."""
    torch.set_num_threads(1)


# ---- phase 4: the main path at a real size, fused then split ----

def long_reads(n_pairs: int = 2048, read_len: int = 10_000,
               genome_len: int = 5_000_000):
    """The main path's batch: PBSIM2-like CLR reads at 10 % error."""
    genome = synth_genome(genome_len, seed=2022)
    return simulate_reads(genome, n_pairs, ReadSimConfig(read_len=read_len,
                                                         error_rate=0.10,
                                                         seed=2022))


def _simulated(fn, *args, **kw):
    """``(fn(*args, **kw), its seconds)``, for a worker process."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, time.perf_counter() - t0


def _drive(device: torch.device, backend: str, rs,
           cfg: AlignerConfig | None = None, mesh=None,
           rescue_rounds: int = 2):
    """Align `rs` through ``GenASMAligner.align`` on `backend` at `cfg`
    (default: the default geometry, W=64, O=24, k=12, ladder to 48), on
    `mesh` if one is given, the launch counts set to 0 just before and
    read just after.  Fails unless exactly the backend's kernels ran on
    the card (or, on the CPU, exactly their plain versions).  Returns the
    aligner, the result, the host seconds and the counts."""
    cfg = (cfg or AlignerConfig()).replace(backend=backend)
    aligner = GenASMAligner(cfg, rescue_rounds=rescue_rounds, device=device,
                            mesh=mesh)
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
            or any(taken[n] for n in taken if n not in expected)):
        raise AssertionError(f"{what} did not run on the {device} path "
                             f"alone: {taken}, other path {other}")
    return taken, other


def phase_main_path(device: torch.device, rs, sample: int = 64):
    """The fused backend on the main path's batch.  Returns the phase's
    numbers and the AlignResult."""
    aligner, res, align_s, taken, other = _drive(device, "fused", rs)
    if aligner.last_run["rounds_run"] < 2:
        raise AssertionError(f"rescue ladder did not run: {aligner.last_run}")
    nm = n_main_windows(max(len(r) for r in rs.reads), aligner.cfg)
    if taken["tb_fused"] != aligner.last_run["rounds_run"] * nm or \
            set(taken) != set(genasm_dc.KERNELS):
        raise AssertionError(f"not one K1 launch a main window ({nm} a "
                             f"rung) and no other kernel's: {taken}")
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


def _cpu_align(backend: str, reads, refs, cfg: AlignerConfig,
               rescue_rounds: int = 2):
    """The CPU side of a card-against-CPU check (``_cuda_equals_cpu``), at
    `cfg` padded to ``CPU_LANE_TILE`` lanes: (result, the aligner's
    last_run, seconds).  A worker process can run it ahead."""
    aligner, res, seconds, _, _ = _drive(
        torch.device("cpu"), backend, SimpleNamespace(
            reads=reads, ref_segments=refs),
        cfg.replace(lane_tile=CPU_LANE_TILE), rescue_rounds=rescue_rounds)
    return res, aligner.last_run, seconds


def _cuda_equals_cpu(device, backend, reads, refs, cfg=None, what="",
                     rescue_rounds: int = 2, cpu=None):
    """Align on `device` (at `cfg`) and on the CPU (``_cpu_align``, or its
    result `cpu` where a worker ran it); raise unless every field is
    equal.  Returns (result, aligner's last_run with the launch counts on
    `device` under ``launches``, seconds per device)."""
    results, runs, seconds = {}, {}, {}
    cfg = cfg or AlignerConfig()
    aligner, results[device.type], seconds[device.type], taken, _ = _drive(
        device, backend, SimpleNamespace(reads=reads, ref_segments=refs),
        cfg, rescue_rounds=rescue_rounds)
    runs[device.type] = dict(aligner.last_run, launches=taken)
    results["cpu"], runs["cpu"], seconds["cpu"] = cpu or _cpu_align(
        backend, reads, refs, cfg, rescue_rounds)
    _assert_same_result(results[device.type], results["cpu"],
                        f"end to end ({backend}{what})")
    if any(runs[device.type][key] != runs["cpu"][key]
           for key in ("rounds_run", "levels_run_total")):
        raise AssertionError(f"end to end ({backend}{what}): ladder counts "
                             f"differ: {runs}")
    return results[device.type], runs[device.type], seconds


#: the W = 128 ladder of phase end_to_end: k = 15 -> 30 -> 60 -> 120
#: (KP = 16, 32, 64, 128; the geometry docs/backends.md sizes), and its
#: batch: pairs, read length, the lane with a burst only k = 120 aligns,
#: the burst's bases
WIDE_CFG = AlignerConfig(W=128, O=42, k=15)
WIDE_ROUNDS = 3
WIDE_BATCH = (3, 200, 1, 64)
#: the W = 256 ladder of phase end_to_end: k = 30 -> 60 -> 120 -> 240
#: (KP = 32, 64, 128, 256; NW = 8), and its batch: 8 reads of 500 bp, the
#: lane with a 128-base insertion that only k = 240 aligns; the same 8
#: pairs then pass through a bucket-mode session
W256_CFG = AlignerConfig(W=256, O=96, k=30)
W256_ROUNDS = 3
W256_BATCH = (8, 500, 1, 128)
#: the W = 512 ladder of phase end_to_end: k = 60 -> 120 -> 240 -> 480
#: (KP = 64, 128, 256, 512; NW = 16, the wide family), and its batch: 8
#: reads of 1,000 bp, the lane with a 256-base insertion that only k = 480
#: aligns; the same 8 pairs then pass through a bucket-mode and a
#: device-mode session
W512_CFG = AlignerConfig(W=512, O=192, k=60)
W512_ROUNDS = 3
W512_BATCH = (8, 1_000, 1, 256)
#: the W = 512 device-mode session at a batch whose scratch is GBs: this
#: many pairs of 1 kbp (lane 1 with ``W512_BATCH``'s burst), so that every
#: rung's kernels run on more lane groups than the card holds blocks (K4
#: at k = 480: 264 one-lane blocks, 19.8 GB) and each captured rung keeps
#: its scratch in its graph's own pool: the captures that come later size
#: their grids by what the earlier ones left (``genasm_dc.free_bytes``)
W512_SCALE = 320


def end_to_end_cases(n_pairs: int = 8, read_len: int = 600,
                     tile_pairs: int = 8, tile_read_len: int = 600) -> list:
    """Phase end_to_end's cases, (name, backend, reads, refs, config,
    rescue rounds): each backend on `n_pairs` reads of `read_len`; the
    fused backend on them with one read given a 16-base insertion that
    only the third rung (k = 48) aligns; the fused backend at
    ``lane_tile=2816`` (what the reference's ``lane_tile='auto'`` gives at
    the default geometry: a pad unit, no block size) on `tile_pairs`
    reads; each backend on the W = 128 ladder (``WIDE_CFG``,
    ``WIDE_ROUNDS``, ``WIDE_BATCH``) with one read only k = 120 aligns,
    on the W = 256 ladder (``W256_CFG``, ``W256_ROUNDS``, ``W256_BATCH``)
    with one read only k = 240 aligns, and on the W = 512 ladder
    (``W512_CFG``, ``W512_ROUNDS``, ``W512_BATCH``) with one read only
    k = 480 aligns."""
    genome = synth_genome(1_000_000, seed=7)
    rs = simulate_reads(genome, n_pairs, ReadSimConfig(read_len=read_len,
                                                       seed=7))
    cfg = AlignerConfig()
    cases = [(backend, backend, rs.reads, rs.ref_segments, cfg, 2)
             for backend in PATH_KERNELS]
    cases.append(("three_rungs", "fused",
                  *_with_burst(rs, min(5, n_pairs - 1), 16, seed=3), cfg, 2))
    tile = simulate_reads(genome, tile_pairs, ReadSimConfig(
        read_len=tile_read_len, seed=8))
    cases.append(("lane_tile_2816", "fused", tile.reads, tile.ref_segments,
                  AlignerConfig(lane_tile=2816), 2))
    n_wide, wide_len, lane, burst = WIDE_BATCH
    wide = simulate_reads(genome, n_wide, ReadSimConfig(read_len=wide_len,
                                                        seed=10))
    reads, refs = _with_burst(wide, lane, burst, seed=5)
    cases += [(f"w128_{backend}", backend, reads, refs, WIDE_CFG,
               WIDE_ROUNDS) for backend in PATH_KERNELS]
    n_wide, wide_len, lane, burst = W256_BATCH
    wide = simulate_reads(genome, n_wide, ReadSimConfig(read_len=wide_len,
                                                        seed=11))
    reads, refs = _with_burst(wide, lane, burst, seed=5)
    cases += [(f"w256_{backend}", backend, reads, refs, W256_CFG,
               W256_ROUNDS) for backend in PATH_KERNELS]
    n_wide, wide_len, lane, burst = W512_BATCH
    wide = simulate_reads(genome, n_wide, ReadSimConfig(read_len=wide_len,
                                                        seed=12))
    reads, refs = _with_burst(wide, lane, burst, seed=5)
    cases += [(f"w512_{backend}", backend, reads, refs, W512_CFG,
               W512_ROUNDS) for backend in PATH_KERNELS]
    return cases


def end_to_end_cpu(**sizes) -> dict:
    """The CPU side of every case of phase end_to_end (``_cpu_align``),
    run in a worker process while the kernels build."""
    return {name: _cpu_align(backend, reads, refs, cfg, rounds)
            for name, backend, reads, refs, cfg, rounds
            in end_to_end_cases(**sizes)}


def phase_end_to_end(device: torch.device, n_pairs: int = 8,
                     read_len: int = 600, tile_pairs: int = 8,
                     tile_read_len: int = 600, cpu=None) -> None:
    """Every case of ``end_to_end_cases`` on `device` against the same on
    the CPU, every field equal, and the ladder counts: the burst read of
    ``three_rungs`` takes k = 48 (``rounds_run == 3``), that of the W =
    128 cases k = 120 (``rounds_run == 4``), that of the W = 256 cases
    k = 240 and of the W = 512 cases k = 480 (``rounds_run == 4``, on the
    card K1 and K4, or K3, launched at KP = 128, 256 and 512:
    ``_launched_kps``).  After ``w256_fused`` the same pairs pass through
    a bucket-mode session (``plan(W256_CFG, rescue_rounds=3)``), after
    ``w512_fused`` through a bucket-mode and a device-mode session, every
    record equal to the card's aligner (``_session_pass``).  `cpu`: a
    future of ``end_to_end_cpu`` at these sizes, else the CPU runs
    here."""
    sizes = dict(n_pairs=n_pairs, read_len=read_len, tile_pairs=tile_pairs,
                 tile_read_len=tile_read_len)
    cpu = cpu.result() if cpu is not None else end_to_end_cpu(**sizes)
    want_k = {"three_rungs": (min(5, n_pairs - 1), 48, 3),
              "w128_fused": (WIDE_BATCH[2], 120, 4),
              "w128_split": (WIDE_BATCH[2], 120, 4),
              "w256_fused": (W256_BATCH[2], 240, 4),
              "w256_split": (W256_BATCH[2], 240, 4),
              "w512_fused": (W512_BATCH[2], 480, 4),
              "w512_split": (W512_BATCH[2], 480, 4)}
    #: the kernels each W = 128 / 256 / 512 case must launch at KP = 128 /
    #: 256 / 512
    want_kp = {"w128_fused": (128, ("tb_fused", "tail_full")),
               "w128_split": (128, ("dc_band",)),
               "w256_fused": (256, ("tb_fused", "tail_full")),
               "w256_split": (256, ("dc_band",)),
               "w512_fused": (512, ("tb_fused", "tail_full")),
               "w512_split": (512, ("dc_band",))}
    for name, backend, reads, refs, cfg, rounds in end_to_end_cases(**sizes):
        with _launched_kps() as kps:
            res, run, seconds = _cuda_equals_cpu(
                device, backend, reads, refs, cfg, f", {name}", rounds,
                cpu[name])
        if name in want_k:
            lane, k, n_rounds = want_k[name]
            if (run["rounds_run"] != n_rounds or res.k_used[lane] != k
                    or res.failed[lane]):
                raise AssertionError(f"{name}: the burst read did not take "
                                     f"the k={k} rung: {run}, k_used "
                                     f"{res.k_used[lane]}")
        kp, kernels = want_kp.get(name, (None, ()))
        missing = [kernel for kernel in kernels
                   if device.type == "cuda" and (kernel, kp) not in kps]
        if missing:
            raise AssertionError(f"{name}: {missing} not launched at KP = "
                                 f"{kp}: {sorted(kps)}")
        emit("end_to_end", backend=backend, case=name, pairs=len(reads),
             read_len=len(reads[0]), equal=True, seconds=seconds,
             k_used=res.k_used.tolist(), failed_share=float(
                 res.failed.mean()),
             launches=run.get("launches"),
             launches_by_kp={f"{kernel}@{kp}": n
                             for (kernel, kp), n in sorted(kps.items())},
             **{key: run[key] for key in ("rounds_run", "levels_run_total")})
        if name == "w256_fused":
            _session_pass("w256", plan(W256_CFG, rescue_rounds=W256_ROUNDS,
                                       batch_lanes=len(reads),
                                       cache="private", device=device),
                          reads, refs, res, device, phase="end_to_end")
        if name == "w512_fused":
            for mode in ("bucket", "device"):
                _session_pass(f"w512_{mode}", plan(
                    W512_CFG, rescue_rounds=W512_ROUNDS, rescue_mode=mode,
                    batch_lanes=len(reads), cache="private", device=device),
                    reads, refs, res, device, phase="end_to_end")
            if device.type == "cuda":
                _w512_scale_pass(device)


def _w512_scale_pass(device: torch.device, n_pairs: int = W512_SCALE) -> None:
    """``W512_SCALE`` pairs through a device-mode session (``plan(W512_CFG,
    rescue_mode='device')``, every rung captured), every record equal to
    the card's aligner on the same pairs (``_session_pass``), the burst
    read aligned at k = 480.  Each wide launch's grid is read off
    ``genasm_dc.xwide_blocks`` (lane groups, blocks, scratch bytes, the
    free bytes it was sized by, whether it was captured); the pass fails
    unless some launch's scratch is 1 GiB or more and some captured
    launch has more lane groups than blocks."""
    genome = synth_genome(1_000_000, seed=7)
    _, read_len, lane, burst = W512_BATCH
    rs = simulate_reads(genome, n_pairs, ReadSimConfig(read_len=read_len,
                                                       seed=13))
    reads, refs = _with_burst(rs, lane, burst, seed=5)
    _, want, aligner_s, _, _ = _drive(
        device, "fused", SimpleNamespace(reads=reads, ref_segments=refs),
        W512_CFG, rescue_rounds=W512_ROUNDS)
    if want.k_used[lane] != 480 or want.failed[lane]:
        raise AssertionError(f"w512 scale: the burst read took k = "
                             f"{want.k_used[lane]}, not 480")
    grids = []
    pick = genasm_dc.xwide_blocks

    def spy(geo, B, resident, free=None):
        blocks = pick(geo, B, resident, free)
        grids.append(dict(groups=-(-B // geo.lanes), blocks=blocks,
                          scratch_bytes=4 * geo.block_words * blocks,
                          free_bytes=free, captured=bool(
                              torch.cuda.is_current_stream_capturing())))
        return blocks
    torch.cuda.reset_peak_memory_stats(device)
    genasm_dc.xwide_blocks = spy
    try:
        _session_pass("w512_device_scale", plan(
            W512_CFG, rescue_rounds=W512_ROUNDS, rescue_mode="device",
            batch_lanes=n_pairs, cache="private", device=device),
            reads, refs, want, device, phase="end_to_end")
    finally:
        genasm_dc.xwide_blocks = pick
    captured = [g for g in grids if g["captured"]]
    if max(g["scratch_bytes"] for g in grids) < 2 ** 30 or not any(
            g["groups"] > g["blocks"] for g in captured):
        raise AssertionError(f"w512 scale: no launch of 1 GiB of scratch, "
                             f"or no captured launch looped: {grids}")
    emit("end_to_end", pass_="w512_device_scale_grids", pairs=n_pairs,
         aligner_s=aligner_s, grids=grids,
         captured_scratch_bytes=sum(g["scratch_bytes"] for g in captured),
         peak_bytes=torch.cuda.max_memory_allocated(device))


#: where each wrapper's C entry point takes k among its integer arguments
_K_ARG = {"tb_fused": 3, "tb_window": 6, "tail_banded": 4, "tail_full": 4,
          "dc_band": 3}


@contextlib.contextmanager
def _launched_kps():
    """Within this context, count every kernel launch by (kernel, KP): a
    spy on ``genasm_dc._launch``, through which every wrapper launches."""
    counts = {}
    inner = genasm_dc._launch

    def spy(name, *tensors, ints, block=(), entry=None):
        k = ints[_K_ARG[(entry or name).removesuffix("_xwide")]]
        key = (name, genasm_dc.levels_bucket(k))
        counts[key] = counts.get(key, 0) + 1
        return inner(name, *tensors, ints=ints, block=block, entry=entry)
    genasm_dc._launch = spy
    try:
        yield counts
    finally:
        genasm_dc._launch = inner


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


def session_stream(n_pairs: int = 1024, lengths=(1_000, 16_000),
                   n_burst: int = 8, n_short: int = 128,
                   short_lengths=(300, 1_000), n_cpu: int = 8):
    """Phase session's stream (`n_pairs` pairs over `lengths`, `n_burst`
    bursts), its split pass's `n_short` pairs and their simulation
    seconds, and the session's result on the CPU for the first `n_cpu`
    short pairs; a worker process makes them while the kernels build."""
    genome = synth_genome(5_000_000, seed=2022)
    t0 = time.perf_counter()
    reads, refs, burst = ragged_pairs(genome, n_pairs, *lengths, seed=2026,
                                      n_burst=n_burst)
    short, short_refs, _ = ragged_pairs(genome, n_short, *short_lengths,
                                        seed=4052)
    sim_s = time.perf_counter() - t0
    return ((reads, refs, burst, short, short_refs), sim_s,
            _session_on(torch.device("cpu"), short[:n_cpu],
                        short_refs[:n_cpu]))


def _session_on(device: torch.device, reads, refs) -> AlignResult:
    """The pairs through a fresh session of phase session's spec on
    `device`."""
    session = plan(AlignerConfig(), rescue_rounds=2, batch_lanes=1024,
                   cache="private", device=device)
    try:
        return session.align(reads, refs)
    finally:
        session.close()


def phase_session(device: torch.device, n_pairs: int = 1024,
                  lengths=(1_000, 16_000), n_burst: int = 8,
                  n_short: int = 128, short_lengths=(300, 1_000),
                  n_cpu: int = 8, stream=None) -> dict:
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
    against the card's occupancy query for K1.  `stream`: a future of
    ``session_stream`` at these sizes (the pairs and the CPU's result),
    else both are made here."""
    (reads, refs, burst, short, short_refs), sim_s, cpu_short = (
        stream.result() if stream is not None else session_stream(
            n_pairs, lengths, n_burst, n_short, short_lengths, n_cpu))
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
    _assert_same_result(_session_on(device, short[:n_cpu],
                                    short_refs[:n_cpu]), cpu_short,
                        "session on the card vs on the CPU")
    # the Hopper lane-tile model against the card's occupancy query
    occupancy = {e["k"]: e["blocks_per_sm"]
                 for e in launch_plan(cfg, 16_384, 2, device)
                 if e["kernel"] == "tb_fused"}
    model = {k: plan_lane_tile(cfg.replace(k=k)) // (
        H100_SMS * genasm_dc.tb_fused_geometry(cfg.replace(k=k),
                                               window=True).lanes)
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

def _same_step_output(got, want, what: str,
                      gate_on_card: bool = False) -> None:
    """Raise unless two align steps' (out, summary) are equal field for
    field (a mesh's per-shard tuples shard for shard); where
    `gate_on_card` (`got` from a device-mode ladder graph) its
    ``gate_syncs`` must be 0, the eager step's being its host syncs."""
    for part, a, b in (("out", got[0], want[0]), ("summary", got[1],
                                                  want[1])):
        if set(a) != set(b):
            raise AssertionError(f"{what}: {part} keys {set(a)} vs "
                                 f"{set(b)}")
        for key in b:
            x, y = a[key], b[key]
            if gate_on_card and key == "gate_syncs":
                if x != 0:
                    raise AssertionError(f"{what}: the ladder graph made "
                                         f"{x} gate syncs")
                continue
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
    ladder = exe.graphs is not None and exe.graphs.ladder is not None
    _sync(device)
    genasm_dc.reset_counts()
    ladder_graph.reset_counts()
    launched = exe.graphs.ladder.launches if ladder else 0
    t0 = time.perf_counter()
    got = exe(*args)
    call_s = time.perf_counter() - t0
    _sync(device)
    graph_s = time.perf_counter() - t0
    row = dict(what=what)
    if ladder:              # one launch; the later rungs counted at retire
        rounds = int(got[0]["rounds_run"])
        exe.retired(rounds)
        row.update(rounds_run=rounds, gate_syncs=got[0]["gate_syncs"],
                   ladder_launches=exe.graphs.ladder.launches - launched,
                   gate_launches=ladder_graph.LAUNCHES["ladder_gate"])
        if row["ladder_launches"] != 1:
            raise AssertionError(f"{what}: {row['ladder_launches']} "
                                 f"launches of the ladder graph")
    graph_launches = dict(genasm_dc.LAUNCHES)
    genasm_dc.reset_counts()
    t0 = time.perf_counter()
    want = exe.step(*args)
    _sync(device)
    eager_s = time.perf_counter() - t0
    eager_launches = dict(genasm_dc.LAUNCHES)
    _same_step_output(got, want, what, gate_on_card=ladder)
    if graph_launches != eager_launches:
        raise AssertionError(f"{what}: the graphs launched "
                             f"{graph_launches}, the eager step "
                             f"{eager_launches}")
    row.update(equal_to_eager=True, launches=graph_launches, call_s=call_s,
               graph_s=graph_s, eager_s=eager_s,
               eager_gate_syncs=want[0].get("gate_syncs"))
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
                compile_s=g.compile_s,
                ladder=g.ladder_stats if g.ladder is not None else None)


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


def graph_sets(lanes: int = 1024, short_lengths=(600, 1_000),
               long_lengths=(9_000, 15_500), n_burst: int = 4):
    """Phase graphs' two sets of `lanes` pairs (a 1 kbp one with `n_burst`
    insertion bursts, a 16 kbp one) and their simulation seconds; a worker
    process makes them while the kernels build."""
    genome = synth_genome(5_000_000, seed=2022)
    t0 = time.perf_counter()
    sets = {"1k": ragged_pairs(genome, lanes, *short_lengths, seed=8081,
                               n_burst=n_burst),
            "16k": ragged_pairs(genome, lanes, *long_lengths, seed=9091)}
    return sets, time.perf_counter() - t0


def phase_graphs(device: torch.device, lanes: int = 1024,
                 short_lengths=(600, 1_000), long_lengths=(9_000, 15_500),
                 n_burst: int = 4, reps: int = 3, n_tenant: int = 8,
                 tenant_short=(1_000, 2_000), tenant_bulk=(8_000, 16_000),
                 gateway_lanes: int = 512, linger_s: float = 0.05,
                 gateway_store=None, timeout_s: float = 600.0,
                 sets=None) -> list:
    """The session's executables as captured CUDA graphs
    (``serve.graphs``), held against their eager steps on the card; budget
    55 s.  Default ``AlignerConfig()`` (W=64, O=24, k=12, fused),
    ``rescue_rounds=2``, `lanes` a dispatch.  (a) Bucket mode at a 1 kbp
    and a 16 kbp read bucket (`short_lengths`, `long_lengths`): ``exe(*
    args)`` against ``exe.step(*args)`` on the same uploaded batch, every
    output field and the kernel launches equal; each graph's nodes,
    memory pool, capture and instantiate seconds.  (b) Device mode at the
    1 kbp bucket, one graph with conditional nodes a dispatch: on the set
    with `n_burst` insertion bursts (all three rungs run) and on its reads
    aligned to themselves (no lane fails: rungs 1-2 skipped), one launch,
    no gate sync, outputs and launches (counted at retire) equal to the
    eager step's, records equal to ``GenASMAligner``'s, 3 and 1 rounds.
    (c) ``session.dispatch`` wall (the session's ``wall_s``) of each
    bucket, warm (each executable called once first, so its clone-outs
    find their memory cached), `reps` times in turns, in bucket mode and
    in device mode
    (a session each), with the upload's host time beside it (a spy on
    ``transfer.to_device``), the executable's call (span
    ``device.execute``), its replay or ladder launch and its clone-out,
    the cyclic GC's pauses and the threads alive (``_spied_parts``) and
    the batch's submits less the dispatch (the padding, staged as pairs
    arrive); every record equal to ``GenASMAligner``; no host gate in
    device mode; and each part of a bucket-mode dispatch timed alone from
    an idle card (``_dispatch_parts``).
    (d) Two threaded sessions sharing one compile cache, from two client
    threads, on the 1 kbp bucket: records equal.  (f) A 16 kbp capture on
    one thread while another launches, downloads and pins memory in a
    loop: the graphs equal the eager step.  (e) The gateway at the
    reference's 50 ms linger (`linger_s`) on a threaded session
    (`gateway_lanes`): `n_tenant` short and `n_tenant` bulk pairs as in
    phase ``gateway``, records equal; dispatches and mean pairs a
    dispatch.  With `gateway_store` (phase ``gateway``'s executables: the
    same spec and pairs) the pass measures dispatching, not builds.
    `sets`: a future of ``graph_sets`` at these lanes and lengths, else
    they are simulated here."""
    genome = synth_genome(5_000_000, seed=2022)
    cfg = AlignerConfig()
    sets, sim_s = (sets.result() if sets is not None else
                   graph_sets(lanes, short_lengths, long_lengths, n_burst))
    exact = (sets["1k"][0], [r.copy() for r in sets["1k"][0]], [])
    want = {name: GenASMAligner(cfg, rescue_rounds=2, device=device).align(
        reads, refs) for name, (reads, refs, _) in (*sets.items(),
                                                    ("1k_exact", exact))}
    if int(want["1k"].k_used.max()) != 48:
        raise AssertionError("no burst lane of the 1 kbp set took k=48")
    store = CompileCache()
    session = plan(cfg, rescue_rounds=2, batch_lanes=lanes,
                   max_inflight=2, cache=store, device=device)
    longest = {name: (max(map(len, reads)), max(map(len, refs)))
               for name, (reads, refs, _) in sets.items()}
    buckets = {name: session.bucket_for(*n) for name, n in longest.items()}
    buckets["1k_exact"] = buckets["1k"]
    emit("graphs_stream", sim_s=sim_s, buckets=buckets, pairs=lanes,
         threads=[t.name for t in threading.enumerate()],
         main_windows={name: n_main_windows(rb, cfg)
                       for name, (rb, _) in buckets.items()})
    rows = []

    def bucket_args(name, rounds):
        reads, refs, _ = exact if name == "1k_exact" else sets[name]
        rb, fb = buckets[name]
        Lr, Lf = pad_geometry(cfg, rb, fb, rounds or 0)
        arrays = session._pad_batch(reads, refs, lanes, Lr, Lf)
        return (rb, fb), transfer.to_device(arrays, device)

    # (a) and (b): captured against eager
    for name, rounds in (("1k", None), ("16k", None), ("1k", 2),
                         ("1k_exact", 2)):
        (rb, fb), args = bucket_args(name, rounds)
        t0 = time.perf_counter()
        exe = session._executable(cfg, lanes, rb, fb, rescue_rounds=rounds)
        build_s = time.perf_counter() - t0
        row = _graph_against_eager(
            exe, args, device, f"{name} bucket, rescue_rounds={rounds}")
        row.update(bucket=[rb, fb], lanes=lanes, build_s=build_s,
                   main_windows=n_main_windows(rb, cfg),
                   mode="bucket" if rounds is None else "device")
        if rounds is not None:
            _device_mode_records(exe, args, want[name], row, device,
                                 3 if name == "1k" else 1)
        rows.append(row)
        emit("graphs", **row)

    # (c) the dispatch wall, warm, the buckets in turns, in bucket mode and
    # in device mode
    dsession = plan(cfg, rescue_rounds=2, rescue_mode="device",
                    batch_lanes=lanes, max_inflight=2, cache=store,
                    device=device)
    modes = {"bucket": session, "device": dsession}
    for mode, s in modes.items():
        s.warmup(longest.values())
        rounds = 2 if mode == "device" else None
        for name in sets:       # one call each: warms its clone-outs' memory
            (rb, fb), args = bucket_args(name, rounds)
            s._executable(cfg, lanes, rb, fb, rescue_rounds=rounds)(*args)
    _sync(device)
    uploads, gates = [], []
    upload, gate = transfer.to_device, serve_graphs.any_failed

    def timed_upload(*a, **kw):
        t = time.perf_counter()
        out = upload(*a, **kw)
        uploads.append(time.perf_counter() - t)
        return out

    def counted_gate(*a, **kw):
        gates.append(1)
        return gate(*a, **kw)
    walls = {mode: {name: [] for name in sets} for mode in modes}
    futs = {mode: {name: [] for name in sets} for mode in modes}
    executes = {}
    transfer.to_device, serve_graphs.any_failed = timed_upload, counted_gate
    try:
        with _spied_parts() as parts:
            for mode, s in modes.items():
                s.obs.tracer.reset()
            for _ in range(reps):
                for mode, s in modes.items():
                    for name, (reads, refs, _) in sets.items():
                        w0 = s.stats["wall_s"]
                        parts.clear()
                        t0 = time.perf_counter()
                        futs[mode][name].append([s.submit(r, f) for r, f
                                                 in zip(reads, refs)])
                        wall = s.stats["wall_s"] - w0
                        walls[mode][name].append(dict(
                            wall_s=wall, upload_s=uploads[-1],
                            staging_s=time.perf_counter() - t0 - wall,
                            **parts.summary()))
            for mode, s in modes.items():
                executes[mode] = [r["t1"] - r["t0"]
                                  for r in s.obs.tracer.records()
                                  if r["name"] == "device.execute"]
                s.flush()
        for mode, per_set in futs.items():
            for name, per_rep in per_set.items():
                for fs in per_rep:
                    _assert_records([f.result() for f in fs], want[name],
                                    f"graphs dispatch pass, {mode}, {name}")
    finally:
        transfer.to_device, serve_graphs.any_failed = upload, gate
    for s in modes.values():
        s.close()
    if device.type == "cuda" and gates:
        raise AssertionError(f"device-mode dispatches gated on the host "
                             f"{len(gates)} times")
    net = {}
    for mode, per_set in walls.items():
        for i, row in enumerate(w for rep in zip(*per_set.values())
                                for w in rep):
            row["execute_s"] = executes[mode][i]      # the executable's call
        net[mode] = {name: float(np.median([w["wall_s"] - w["upload_s"]
                                            for w in v]))
                     for name, v in per_set.items()}
    rows.append(dict(what="dispatch wall", walls_s=walls, net_median_s=net,
        ratio_16k_to_1k={mode: n["16k"] / n["1k"] for mode, n in net.items()},
        host_gates=len(gates),
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
    for mode, n in net.items():
        if device.type == "cuda" and n["16k"] > 2 * n["1k"]:
            raise AssertionError(f"a 16 kbp {mode}-mode dispatch less its "
                                 f"upload took {n['16k']:.4f} s, over twice "
                                 f"the 1 kbp bucket's {n['1k']:.4f} s")
    return rows


def _device_mode_records(exe, args, want, row, device, rounds: int) -> None:
    """A device-mode executable's call on `args` decoded as a session's
    retire decodes it: its records, k_used and rounds_run equal
    ``GenASMAligner``'s on the same pairs (`want`), `rounds` rungs run;
    its ``levels_run_total`` (at the bucket's read length) goes into
    `row`."""
    out, _ = exe(*args)
    host = transfer.to_host({k: out[k] for k in (
        "ops", "n_ops", "dist", "failed", "read_consumed", "ref_consumed",
        "k_used")})
    exe.retired(int(out["rounds_run"]))
    n = len(want.cigars)
    recs = records_from_state(*decode_batch(host, n, 0))   # k_used in host
    _assert_records(recs, want, f"{row['what']}: decoded")
    run = int(out["rounds_run"])
    if device.type == "cuda" and run != rounds:
        raise AssertionError(f"{row['what']}: {run} rounds run, not {rounds}")
    row.update(rounds_checked=run, levels_run_total=int(
        out["levels_run_total"]), records_equal_aligner=True)


class _Parts(list):
    """(part, seconds) pairs of the dispatches underway (``_spied_parts``)."""

    def summary(self) -> dict:
        out = {"threads": threading.active_count()}
        for name, sec in self:
            out[f"{name}_s"] = out.get(f"{name}_s", 0.0) + sec
        return out


@contextlib.contextmanager
def _spied_parts():
    """Within the block, every captured executable's replay (or ladder
    launch) and clone-out, and every pause of the cyclic garbage collector,
    outside a session's retire (which a sync dispatch runs inline before
    its own clock starts), appended to the yielded list as (part,
    seconds): what grows when a dispatch wall grows."""
    parts = _Parts()
    started, retiring = [], threading.local()

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            sec = time.perf_counter() - started.pop()
            if not getattr(retiring, "on", False):
                parts.append((f"gc{info['generation']}", sec))

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if not getattr(retiring, "on", False):
                parts.append((name, time.perf_counter() - t0))
            return out
        return run

    def retire(self, d):
        retiring.on = True
        try:
            return saved[3](self, d)
        finally:
            retiring.on = False
    saved = (serve_graphs.CapturedGraph.replay, ladder_graph.CondGraph.launch,
             serve_graphs._clone, AlignSession._retire)
    serve_graphs.CapturedGraph.replay = timed("replay", saved[0])
    ladder_graph.CondGraph.launch = timed("replay", saved[1])
    serve_graphs._clone = timed("clone", saved[2])
    AlignSession._retire = retire
    gc.callbacks.append(on_gc)
    try:
        yield parts
    finally:
        gc.callbacks.remove(on_gc)
        (serve_graphs.CapturedGraph.replay, ladder_graph.CondGraph.launch,
         serve_graphs._clone, AlignSession._retire) = saved


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


def _mapper_inputs(genome_len: int, n_reads: int, read_len: int):
    """Phase mapper's reads and genome with their planted decoys."""
    genome = synth_genome(genome_len, seed=2022)
    rs = simulate_reads(genome, n_reads, ReadSimConfig(
        read_len=read_len, error_rate=0.10, seed=2022))
    return rs, *plant_decoys(genome, rs, decoys_per_read=4)


def mapper_cpu(genome_len: int = 5_000_000, n_reads: int = 1024,
               read_len: int = 1_000, batch_lanes: int = 1024,
               n_cpu: int = 16):
    """Phase mapper's CPU mapper on the first `n_cpu` reads: (its mapped
    reads, seconds); a worker process runs it while the kernels build."""
    rs, g2, _ = _mapper_inputs(genome_len, n_reads, read_len)
    with ReadMapper(g2, MapperConfig(), rescue_rounds=2,
                    batch_lanes=batch_lanes, device="cpu") as cpu_mapper:
        t0 = time.perf_counter()
        mapped = cpu_mapper.map_batch(rs.reads[:n_cpu]).mapped
        return mapped, time.perf_counter() - t0


def phase_mapper(device: torch.device, genome_len: int = 5_000_000,
                 n_reads: int = 1024, read_len: int = 1_000,
                 batch_lanes: int = 1024, n_cpu: int = 16,
                 cpu=None) -> None:
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
    launched, no plain call.  `cpu`: a future of ``mapper_cpu`` at these
    sizes, else the CPU mapper runs here."""
    t0 = time.perf_counter()
    rs, g2, decoy_pos = _mapper_inputs(genome_len, n_reads, read_len)
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
    cpu_mapped, cpu_s = (cpu.result() if cpu is not None else mapper_cpu(
        genome_len, n_reads, read_len, batch_lanes, n_cpu))
    if [dataclasses.astuple(m) for m in cpu_mapped] != \
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

    def spy(model, opt_cfg, grad_accum=1, **kw):
        step = real(model, opt_cfg, grad_accum, **kw)

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
        min_param_change=min(moved), digest=replica_digest(state),
        peak_memory_bytes=peak,
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
    emit("train", leg="c", **{k: v for k, v in out["c"].items()
                              if k != "digest"})
    return out


# ---- phase train_dp: data-parallel training and the LM dry run ----

#: leg (a): the world of one against phase train (c), same seed: an
#: all-reduce over one rank and a division by 1 change nothing
DP_ONE_RTOL = 1e-6
#: leg (b): data-parallel ranks against one rank with the same global
#: batch, float32, TF32 off: float32 rounding of the gradients' other sum
#: order only (tests/test_torch_train_dp.py holds the same bound on the
#: CPU)
DP_TOL = dict(rtol=1e-5, atol=1e-5)
#: seconds a leg's ranks may take, each
DP_LEG_TIMEOUT_S = 300
#: leg (a)'s run of launch.train, phase train (c)'s arguments
DP_TRAIN_ARGS = ["--arch", "llama3.2-1b", "--steps", "4", "--batch", "4",
                 "--seq", "1024", "--ckpt-every", "1000", "--log-every", "1"]
#: leg (b)'s runs of launch.train, float32 compute, 3 steps each:
#: Llama-3.2-1B at published widths cut to 2 layers (1.54 GB of
#: gradients a sync), and tiny OLMoE with a checkpoint every step and a
#: failure at step 2 (rank 0's saves, the barriers, every rank's restore)
DP_B_CASES = {
    "llama3.2-1b x2 layers": ["--arch", "llama3.2-1b", "--layers", "2",
                              "--batch", "4", "--seq", "256",
                              "--ckpt-every", "1000"],
    "olmoe-1b-7b tiny": ["--arch", "olmoe-1b-7b", "--tiny", "--batch", "8",
                         "--seq", "64", "--ckpt-every", "1"]}
DP_B_ARGS = ["--steps", "3", "--dtype", "float32", "--log-every", "1"]
#: tools/torch_train_cards.py's run of launch.train at world 1 and world
#: n: Llama-3.2-1B at full width and depth in float32 compute (in bf16 a
#: world of n may drift from a world of one by a master weight's rounding
#: flipping its bf16 copy: 1.3e-5 at world 4 on the CPU, PERF.md 7), a
#: global batch of 8 x 512 tokens that 1, 2, 4 and 8 ranks divide
DP_CARDS_ARGS = ["--arch", "llama3.2-1b", "--steps", "4", "--batch", "8",
                 "--seq", "512", "--dtype", "float32", "--ckpt-every",
                 "1000", "--log-every", "1"]
#: leg (e): the model axis, leg (b)'s two cases (``--model-parallel 2``):
#: Llama-3.2-1B cut to 2 layers on (2, 2) over 4 ranks and on (1, 2) over
#: 2 of them, tiny OLMoE (experts over ``model``, a failure at step 2) on
#: (1, 2); each against leg (b)'s one rank
MP_MESHES = ((2, 2), (1, 2))
MP_ARGS = ["--model-parallel", "2"]
#: below this a gradient element's RMS over the steps is float32 noise
#: (``tests/test_torch_train_dp.py::_noise_elements``); such elements are
#: held to MP_NOISE_TOL and must be under 1 in 10^4 of the state
MP_NOISE = 1e-7
MP_NOISE_TOL = dict(rtol=1e-4, atol=1e-4)


@contextlib.contextmanager
def _environ(**env):
    """``os.environ`` with `env` set for the block (None: removed)."""
    saved = {k: os.environ.get(k) for k in env}
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _world_of_one():
    """The environment ``torch.distributed.run`` gives the one rank of a
    world of one, its store on a free local port: under it
    ``launch.train.main`` initialises the process group itself."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    return _environ(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
                    LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port))


@contextlib.contextmanager
def _kept_states():
    """``launch.train``'s ``make_train_step`` wrapped for the block so
    that each step's state is kept: yields a dict whose ``"state"`` is
    the last step's."""
    seen = {}
    real = train_launch.make_train_step

    def spy(*args, **kw):
        step = real(*args, **kw)

        def kept(state, batch):
            out = step(state, batch)
            seen["state"] = out[0]
            return out
        return kept
    train_launch.make_train_step = spy
    try:
        yield seen
    finally:
        train_launch.make_train_step = real


#: seconds a leg's ranks wait for their go (``_wait_for_go``) before they
#: give up: they start before the script's first phase
DP_GO_TIMEOUT_S = 1500


def _start_leg(leg: str, n: int, out: Path, device: torch.device,
               tiny: bool) -> subprocess.Popen:
    """Start `n` ranks of ``chip_smoke.py --train-dp-child <leg>`` with
    ``python -m torch.distributed.run --standalone``, their output in
    `out`.  Each rank imports what it needs, then waits for ``<out>/go``
    (``_finish_leg``) before it touches the device, so their start-up
    can overlap earlier phases.  `device` and `tiny` (the models at
    ``tiny_config``) serve a rehearsal on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"), OMP_NUM_THREADS="4",
               CHIP_SMOKE_PID=str(os.getpid()))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", str(Path(__file__).resolve()),
           "--train-dp-child", leg, str(out), device.type,
           "tiny" if tiny else "full"]
    with open(out / f"{leg}.stdout", "w") as so, \
            open(out / f"{leg}.stderr", "w") as se:
        return subprocess.Popen(cmd, stdout=so, stderr=se, env=env,
                                start_new_session=True)


def _stop_leg(proc: subprocess.Popen) -> None:
    """Stop `proc`'s launcher and ranks if they still run: SIGTERM to the
    launcher, which stops its ranks (each in a session of its own), and
    SIGKILL to its group past 20 s; a waiting rank also exits once its
    launcher is gone (``_wait_for_go``)."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _finish_leg(leg: str, proc: subprocess.Popen, out: Path) -> dict:
    """Let the ranks of `proc` (``_start_leg``) go and return rank 0's
    record; a rank that fails (or outlives DP_LEG_TIMEOUT_S from its go)
    fails the leg."""
    (out / "go").touch()
    t0 = time.perf_counter()
    try:
        proc.wait(timeout=DP_LEG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        _stop_leg(proc)
    tail = {k: (out / f"{leg}.{k}").read_text()[-4000:]
            for k in ("stdout", "stderr")}
    if proc.returncode != 0:
        raise AssertionError(f"train_dp ({leg}): exit {proc.returncode} "
                             f"after {time.perf_counter() - t0:.1f} s\n"
                             f"{tail['stdout']}\n{tail['stderr']}")
    rec = json.loads((out / f"{leg}.json").read_text())
    rec["leg_s"] = time.perf_counter() - t0
    return rec


def _run_leg(leg: str, n: int, out: Path, device: torch.device,
             tiny: bool) -> dict:
    """``_start_leg`` and at once ``_finish_leg``."""
    return _finish_leg(leg, _start_leg(leg, n, out, device, tiny), out)


def _wait_for_go(out: Path, name: str = "go") -> None:
    """Block until ``<out>/<name>`` exists; SystemExit past
    DP_GO_TIMEOUT_S or once the launcher that started this rank, or the
    script that started the launcher, is gone."""
    t0, launcher = time.perf_counter(), os.getppid()
    script = int(os.environ.get("CHIP_SMOKE_PID", 0))
    while not (out / name).exists():
        if time.perf_counter() - t0 > DP_GO_TIMEOUT_S:
            raise SystemExit(f"no go in {DP_GO_TIMEOUT_S} s")
        if os.getppid() != launcher or (script and not _alive(script)):
            raise SystemExit("the launcher or the script is gone")
        time.sleep(0.05)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _max_rel(got, want) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def _losses(metrics: dict) -> list:
    return [r["loss"] for r in metrics["log"] if "loss" in r]


def _dp_compare(got, want) -> dict:
    """The data-parallel state `got` against the single rank's `want`:
    max abs error over every parameter and AdamW leaf and whether all are
    within DP_TOL."""
    a, b = flat_state(got), flat_state(want)
    worst, ok = 0.0, True
    for k, t in a.items():
        if t.dtype.is_floating_point:
            err = (t - b[k]).abs()
            worst = max(worst, float(err.max()))
            ok &= bool((err <= DP_TOL["atol"] + DP_TOL["rtol"]
                        * b[k].abs()).all())
        else:
            ok &= torch.equal(t, b[k])
    return dict(max_abs_err=worst, within_tol=ok)


def _dp_child_b(out: Path, kind: str, tiny: bool, pre: dict) -> None:
    """Leg (b): two ranks sharing cuda:0 over gloo (host-staged), each
    running ``launch.train.main`` with ``--device cuda:0 --backend gloo``
    on each of DP_B_CASES.  The first run's entry point initialises the
    group from the launcher's environment and destroys it; the ranks
    then form a group over a fresh file store (a second group over the
    launcher's store could read the first's stale addresses), which the
    second run and OLMoE's router check use as they find it.  Rank 0
    then runs each case alone through the same entry point (the
    launcher's RANK and WORLD_SIZE removed), with the same global batch,
    and holds the states to DP_TOL; last it hands its one-rank Llama
    state to leg (e) (``_hand_over``).  `pre`: ``_warm_up``'s."""
    import torch.distributed as dist
    from repro_torch.models.moe import global_batch, router_topk
    dev = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    r, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    _check_tf32_off()
    size = ["--tiny"] if tiny else []
    rec = {"transport": "gloo, host-staged", "world": n,
           "warm_up_s": pre["warm_up_s"]}
    states = {}

    def dp_run(i, name, args):
        path = out / f"b{i}_metrics.json"
        t0 = time.perf_counter()
        with _kept_states() as seen:
            train_launch.main(args + DP_B_ARGS + [
                "--model-parallel", "1", "--device", str(dev), "--backend",
                "gloo", "--ckpt-dir",
                str(out / f"ckpt_b{i}"), "--metrics-out", str(path)] + (
                size if i == 0 else []) + (
                ["--inject-failure-at", "2"] if i == 1 else []))
        states[name] = seen["state"]
        return path, time.perf_counter() - t0

    cases = list(DP_B_CASES.items())
    paths = {cases[0][0]: dp_run(0, *cases[0])}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(out / "store_b"), n), rank=r, world_size=n)
    try:
        paths[cases[1][0]] = dp_run(1, *cases[1])
        cfg = dataclasses.replace(tiny_config(get_config("olmoe-1b-7b")),
                                  dtype="float32")
        model = get_model(cfg, device=dev, param_dtype="float32",
                          generator=torch.Generator(device=dev)
                          .manual_seed(1))
        x = torch.randn((8, 16, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
        w = model.layers[0].moe["router"]
        mine = x[r * 8 // n:(r + 1) * 8 // n]
        with torch.no_grad():
            want = float(router_topk(x, w, cfg)[2])
            with global_batch(dist.group.WORLD):
                got = float(router_topk(mine, w, cfg)[2])
            local = float(router_topk(mine, w, cfg)[2])
        auxes = [None] * n
        dist.all_gather_object(auxes, (got, local))
        rec["olmoe_aux"] = dict(global_batch=want,
                                ranks=[g for g, _ in auxes],
                                per_rank_mean=sum(v for _, v in auxes) / n)
    finally:
        dist.destroy_process_group()
    if r != 0:
        return
    single_llama = None
    for i, (name, args) in enumerate(cases):
        path, seconds = paths[name]
        dp = json.loads(path.read_text())
        t0 = time.perf_counter()
        with _environ(RANK=None, WORLD_SIZE=None), _kept_states() as seen:
            single = train_launch.main(args + DP_B_ARGS + [
                "--device", str(dev), "--ckpt-dir",
                str(out / f"ckpt_b{i}_one")] + (size if i == 0 else []))
        losses = _losses(dp)
        ones = [row["loss"] for row in single if "loss" in row]
        rec[name] = dict(
            losses=losses, single_losses=ones,
            loss_rel_err=_max_rel(losses, ones), sync_ms=dp["sync_ms"],
            step_ms=dp["step_ms"], restarts=dp["restarts"],
            backend=dp["backend"], mesh=dp["mesh"], device=dp["device"],
            replicas_bit_identical=all(d == dp["digests"][0]
                                       for d in dp["digests"]),
            params=dp["params"], seconds=seconds,
            single_seconds=time.perf_counter() - t0,
            **_dp_compare(states[name], seen["state"]))
        if i == 0:
            single_llama = flat_state(seen["state"])
        del states[name], seen["state"]
        if kind == "cuda":
            torch.cuda.empty_cache()
    (out / "b.json").write_text(json.dumps(rec))
    t0 = time.perf_counter()
    _hand_over(out, single_llama, kind, sender=True)
    rec_s = {"hand_over_s": time.perf_counter() - t0}
    (out / "b_hand_over.json").write_text(json.dumps(rec_s))


#: elements of the float32 vector ``tools/torch_train_cards.py`` reduces
DP_RING_ELEMS = 1 << 28


def _dp_child_cards(out: Path, kind: str, tiny: bool) -> None:
    """``tools/torch_train_cards.py``'s ranks, one card each over NCCL:
    the int8 ring against ``dist.all_reduce`` on the same float32 vector
    (device ms, median of 5, and the ring's error against the exact
    sum), then DP_CARDS_ARGS's run of ``launch.train.main`` at this world
    (on the group the ranks made)."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import compressed_allreduce
    from repro_torch.launch.train import _ms, _timed
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", local) if kind == "cuda" else \
        torch.device(kind)
    if kind == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    else:
        dist.init_process_group("gloo")
    r, n = dist.get_rank(), dist.get_world_size()
    try:
        g = torch.randn(DP_RING_ELEMS >> (16 if tiny else 0), device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(r))

        def timed(fn):
            times = []
            call = _timed(fn, dev, times)
            for _ in range(5):
                out_ = call()
                _sync(dev)
            return out_, sorted(_ms(times))[2]

        def exact():
            t = g.clone()
            dist.all_reduce(t)
            return t
        want, ar_ms = timed(exact)
        got, ring_ms = timed(lambda: compressed_allreduce(g))
        err = float((got - want).abs().max() / want.abs().max())
        nbytes = g.numel() * 4
        ring = dict(elems=g.numel(), all_reduce_ms=ar_ms, int8_ring_ms=ring_ms,
                    rel_err=err, bound=0.05,
                    all_reduce_bus_gb_s=2 * (n - 1) / n * nbytes / ar_ms / 1e6,
                    int8_ring_bus_gb_s=2 * (n - 1) / n * (nbytes / 4)
                    / ring_ms / 1e6, nvlink_gb_s=450.0)
        del g, want, got
        if kind == "cuda":
            torch.cuda.empty_cache()
        path = out / "cards_metrics.json"
        train_launch.main(DP_CARDS_ARGS + (["--tiny"] if tiny else []) + [
            "--model-parallel", "1", "--device", kind, "--ckpt-dir",
            str(out / "ckpt_cards"), "--metrics-out", str(path)])
        if r == 0:
            (out / "cards.json").write_text(json.dumps(
                {"ring": ring, "a": json.loads(path.read_text())}))
    finally:
        dist.destroy_process_group()


def mp_cards_axes(n: int) -> list:
    """The model axes ``tools/torch_train_cards.py`` trains on over `n`
    cards: the whole world, then 2 (for n = 4: (1, 4) and (2, 2))."""
    return sorted({m for m in (n, 2) if m > 1 and n % m == 0},
                  reverse=True)


def _dp_child_cards_mp(out: Path, kind: str, tiny: bool) -> None:
    """``tools/torch_train_cards.py``'s model-axis ranks, one card each
    over NCCL: for each model axis of ``mp_cards_axes``, the all-reduce
    of one activation (a data rank's tokens x d_model, float32) over the
    ``model`` group (device ms, median of 5), then DP_CARDS_ARGS's run of
    ``launch.train.main`` with ``--model-parallel M``."""
    import torch.distributed as dist
    from repro_torch.launch.train import _ms, _timed
    from repro_torch.runtime.elastic import make_elastic_mesh
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cuda", local) if kind == "cuda" else \
        torch.device(kind)
    if kind == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev)
    else:
        dist.init_process_group("gloo")
    r, n = dist.get_rank(), dist.get_world_size()
    rec = {}
    try:
        for m in mp_cards_axes(n):
            mesh = make_elastic_mesh(m, devices=[dev])
            cfg = tiny_config(get_config("llama3.2-1b")) if tiny else \
                get_config("llama3.2-1b")
            rows = 8 // (n // m)
            x = torch.randn((rows * 512, cfg.d_model), device=dev)
            times = []
            call = _timed(lambda: dist.all_reduce(
                x, group=mesh.get_group("model")), dev, times)
            for _ in range(5):
                call()
                _sync(dev)
            ms = sorted(_ms(times))[2]
            path = out / f"cards_mp{m}_metrics.json"
            train_launch.main(DP_CARDS_ARGS + (["--tiny"] if tiny else []) + [
                "--model-parallel", str(m), "--device", kind, "--ckpt-dir",
                str(out / f"ckpt_cards_mp{m}"), "--metrics-out", str(path)])
            if r == 0:
                rec[f"{n // m}x{m}"] = dict(
                    run=json.loads(path.read_text()), all_reduce_ms=ms,
                    all_reduce_bytes=x.numel() * 4,
                    model_all_reduce_bus_gb_s=2 * (m - 1) / m
                    * x.numel() * 4 / ms / 1e6)
        if r == 0:
            (out / "cards_mp.json").write_text(json.dumps(rec))
    finally:
        dist.destroy_process_group()


def _hand_over(out: Path, flat: dict, kind: str, sender: bool) -> dict:
    """Leg (b)'s one-rank Llama state (`flat`, name -> tensor) from leg
    (b)'s rank 0 (`sender`) to leg (e)'s rank 0, which passes its own
    gathered state of the same layout as `flat` (anywhere) and gets
    (b)'s on the legs' device `kind`.  On the card by CUDA IPC: the sender writes each leaf's
    handle (``torch.multiprocessing.reductions.reduce_tensor``) to
    ``hand_over.pkl`` and keeps its tensors until the receiver, done with
    the mapped leaves, touches ``hand_over.done``: no byte is copied.  On
    the CPU (a rehearsal): a gloo group of the two over
    a file store, one broadcast a leaf."""
    import pickle
    import torch.distributed as dist
    if kind == "cuda":
        if sender:
            from torch.multiprocessing.reductions import reduce_tensor
            shared = {k: reduce_tensor(t.detach()) for k, t in flat.items()}
            torch.cuda.synchronize()
            tmp = out / "hand_over.tmp"
            tmp.write_bytes(pickle.dumps(shared))
            os.replace(tmp, out / "hand_over.pkl")
            _wait_for_go(out, "hand_over.done")
            return flat
        _wait_for_go(out, "hand_over.pkl")
        shared = pickle.loads((out / "hand_over.pkl").read_bytes())
        return {k: fn(*args) for k, (fn, args) in shared.items()}
    dist.init_process_group("gloo", store=dist.FileStore(
        str(out / "store_hand_over"), 2), rank=0 if sender else 1,
        world_size=2)
    got = {}
    try:
        for key in sorted(flat):
            t = flat[key].detach()
            host = t.cpu() if sender else torch.empty(t.shape,
                                                      dtype=t.dtype)
            dist.broadcast(host, 0)
            got[key] = host.to(kind)
    finally:
        dist.destroy_process_group()
    return got


def _noise_mask(got: dict, want: dict, key: str, steps: int = 3):
    """``tests/test_torch_train_dp.py::_noise_elements``: the elements of
    state leaf `key` whose gradient's RMS over `steps` (AdamW's
    bias-corrected sqrt(v)) is below MP_NOISE in both states and not
    zero in both; None for the step."""
    if key == "opt.step":
        return None
    name = key.split(".", 2)[-1] if key.startswith("opt.") else key[6:]
    vb = want[f"opt.v.{name}"]
    va = got[f"opt.v.{name}"].to(vb.device)
    corr = 1 - AdamWConfig().b2 ** steps
    return ((va / corr).sqrt() < MP_NOISE) & ((vb / corr).sqrt() < MP_NOISE) \
        & ((va != 0) | (vb != 0))


def _mp_compare(got: dict, want: dict) -> dict:
    """The gathered model-parallel state `got` (moved a leaf at a time to
    `want`'s device) against the one rank's `want`: every element within
    DP_TOL, but a
    noise element (``_noise_mask``) may miss it and is then held to
    MP_NOISE_TOL; those exempted must be under 1 in 10^4 of the state.
    (At Llama-3.2-1B's 128,256 tied rows most rows see no token, and
    their softmax-sized gradients count as noise: ~1/3 of the state, so
    the count is of the exempted elements, not of the noise ones.)"""
    worst = worst_noise = 0.0
    ok, n_noise, n_exempt, n_all = True, 0, 0, 0
    for k, b in want.items():
        a = got[k].to(b.device)
        n_all += b.numel()
        if not b.dtype.is_floating_point:
            ok &= torch.equal(a, b)
            continue
        err = (a - b).abs()
        out = err > DP_TOL["atol"] + DP_TOL["rtol"] * b.abs()
        worst = max(worst, float(err.max()))
        noise = _noise_mask(got, want, k)
        if noise is not None:
            n_noise += int(noise.sum())
            exempt = out & noise
            n_exempt += int(exempt.sum())
            if bool(exempt.any()):
                nb = MP_NOISE_TOL["atol"] + MP_NOISE_TOL["rtol"] * b.abs()
                ok &= bool((err[exempt] <= nb[exempt]).all())
                worst_noise = max(worst_noise, float(err[exempt].max()))
            out = out & ~noise
        ok &= not bool(out.any())
    return dict(max_abs_err=worst, noise_elements=n_noise,
                exempted_elements=n_exempt,
                exempted_max_abs_err=worst_noise, elements=n_all,
                within_tol=ok and n_exempt * 10_000 < n_all)


def _close(got: list, want: list) -> bool:
    return len(got) == len(want) and all(
        abs(g - w) <= DP_TOL["atol"] + DP_TOL["rtol"] * abs(w)
        for g, w in zip(got, want))


def _check_leg_e(e: dict, device: torch.device) -> dict:
    """Leg (e)'s record checked: each mesh's Llama losses and gathered
    state within DP_TOL of leg (b)'s one rank (noise elements as
    ``_mp_compare`` holds them), the ranks that hold a block
    bit-identical, each rank's state bytes equal to the dry run's, the
    attention, MLP and vocabulary split (no block gathered); OLMoE on
    (1, 2): its losses with one restart, its experts split, and the
    split layer's output and router loss equal to the whole layer's.
    Adds the card's name and power limit and emits the record (before
    any check fails)."""
    e["card"] = _smi() if device.type == "cuda" else None
    emit("train_dp", leg="e", **e)
    for shape in MP_MESHES:
        row = e[f"llama {shape[0]}x{shape[1]}"]
        gathered = [p for p in row["paths"] if p.endswith("gathered")]
        if not (row["within_tol"] and _close(row["losses"],
                                             row["single_losses"])
                and row["replicas_agree"] and not gathered
                and row["state_bytes"] == row["dryrun_state_bytes"]
                and any(p.startswith("attention: split")
                        for p in row["paths"])):
            raise AssertionError(f"train_dp (e) llama {shape}: {row}")
    ol, ex = e["olmoe 1x2"], e["olmoe_experts"]
    if not (_close(ol["losses"], ol["single_losses"]) and ol["restarts"] == 1
            and ol["replicas_agree"]
            and ol["state_bytes"] == ol["dryrun_state_bytes"]
            and "moe: split, 2 of 4 experts" in ol["paths"]
            and ex["y_max_abs_err"] <= DP_TOL["atol"]
            and abs(ex["aux_split"] - ex["aux_whole"])
            <= 1e-6 * abs(ex["aux_whole"])):
        raise AssertionError(f"train_dp (e) olmoe: {ol} {ex}")
    return e


def _dp_child_e(out: Path, kind: str, tiny: bool, pre) -> None:
    """Leg (e): the model axis.  Four ranks sharing cuda:0 over gloo
    (host-staged), warmed up on their (2, 2) group before the go
    (``_warm_up``: `pre`), run beside leg (b) from the go
    ``launch.train.main``
    with ``--model-parallel 2`` on leg (b)'s Llama case: on (2, 2) over
    the four, then on (1, 2) over ranks 0 and 1 (a group over a file
    store), and leg (b)'s OLMoE case on (1, 2) with its failure at step
    2 (a restore of a sharded state); then OLMoE's experts split over
    ``model`` against the whole layer (its output and router loss) on
    one batch.  After each Llama run rank 0 gathers the state's leaves
    (``ModelParallel.gather_to_root``); at the end it gets leg (b)'s
    one-rank state (``_hand_over``, once (b) is done) and holds both
    meshes' states and losses to it, and the OLMoE losses to (b)'s one
    rank.  ``marks_s``: seconds from the go as each part ends."""
    import torch.distributed as dist
    from repro_torch.checkpoint.ckpt import param_of
    from repro_torch.distributed.model_parallel import of, shard_model
    from repro_torch.launch.dryrun import MeshAxes, train_memory
    from repro_torch.models.moe import global_batch, moe_ffn
    from repro_torch.runtime.elastic import make_elastic_mesh
    from repro_torch.train.step import replicas_agree
    dev = pre["device"]
    r = int(os.environ["RANK"])
    _check_tf32_off()
    t_go = time.perf_counter()
    size = ["--tiny"] if tiny else []
    (llama, llama_args), (olmoe, olmoe_args) = DP_B_CASES.items()
    rec = {"transport": "gloo, host-staged", "marks_s": {},
           "warm_up_s": pre["warm_up_s"]}
    gathered = {}

    def mark(what):
        rec["marks_s"][what] = time.perf_counter() - t_go

    def mp_run(shape, name, args, extra):
        path = out / f"e_{name}_{shape[0]}x{shape[1]}.json"
        t0 = time.perf_counter()
        with _kept_states() as seen:
            train_launch.main(args + DP_B_ARGS + MP_ARGS + extra + [
                "--device", str(dev), "--backend", "gloo", "--ckpt-dir",
                str(out / f"ckpt_e_{name}_{shape[0]}"), "--metrics-out",
                str(path)])
        seconds = time.perf_counter() - t0
        state = seen.pop("state")
        mp = of(state["model"])
        full = {k: t.detach().clone() if param_of(k) is None else
                mp.gather_to_root(t, param_of(k))
                for k, t in flat_state(state).items()}
        return json.loads(path.read_text()) if r == 0 else None, full, \
            seconds, mp
    try:
        for shape in MP_MESHES:
            if shape == (1, 2):
                dist.destroy_process_group()
                if r >= 2:
                    return
                dist.init_process_group("gloo", store=dist.FileStore(
                    str(out / "store_e"), 2), rank=r, world_size=2)
                os.environ["WORLD_SIZE"] = "2"
            m, full, seconds, mp = mp_run(shape, llama, llama_args, size)
            if r == 0:          # in host memory: not in the next peak
                gathered[shape] = {k: t.cpu() for k, t in full.items()}
                mem = train_memory(
                    dataclasses.replace(
                        tiny_config(get_config("llama3.2-1b")) if tiny
                        else get_config("llama3.2-1b"), n_layers=2,
                        dtype="float32"), 256, 4,
                    MeshAxes(("data", "model"), shape))
                rec[f"llama {shape[0]}x{shape[1]}"] = dict(
                    mesh=m["mesh"], world=m["world"], losses=_losses(m),
                    step_ms=m["step_ms"], collective_ms=m["collective_ms"],
                    paths=m["paths"], staged=m["staged"],
                    state_bytes=m["state_bytes"],
                    dryrun_state_bytes=m["dryrun_state_bytes"],
                    replicas_agree=replicas_agree(m["digests"]),
                    peak_memory_bytes=m["peak_memory_bytes"],
                    dryrun_total_bytes=mem["total_bytes"],
                    dryrun_activation_bytes=mem["activation_bytes"],
                    seconds=seconds)
            del full
            mark(f"llama {shape[0]}x{shape[1]}")
        m, full, seconds, _ = mp_run((1, 2), olmoe, olmoe_args,
                                     ["--tiny", "--inject-failure-at", "2"])
        mark("olmoe 1x2")
        if r == 0:
            rec["olmoe 1x2"] = dict(
                mesh=m["mesh"], losses=_losses(m), restarts=m["restarts"],
                paths=m["paths"], state_bytes=m["state_bytes"],
                dryrun_state_bytes=m["dryrun_state_bytes"],
                replicas_agree=replicas_agree(m["digests"]),
                seconds=seconds)
        # OLMoE's experts over ``model`` against the whole layer
        cfg = dataclasses.replace(tiny_config(get_config("olmoe-1b-7b")),
                                  dtype="float32")
        whole = get_model(cfg, device=dev, param_dtype="float32",
                          generator=torch.Generator(device=dev)
                          .manual_seed(1))
        split = get_model(cfg, device=dev, param_dtype="float32",
                          generator=torch.Generator(device=dev)
                          .manual_seed(1))
        mp = shard_model(split, make_elastic_mesh(2, devices=[dev]))
        x = torch.randn((8, 16, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
        with torch.no_grad():
            y1, aux1 = moe_ffn(whole.layers[0].moe, x, cfg)
            with global_batch(mp.group["data"]):
                y2, aux2 = moe_ffn(split.layers[0].moe, x, cfg)
        if r == 0:
            rec["olmoe_experts"] = dict(
                paths=dict(mp.paths), y_max_abs_err=float((y1 - y2).abs()
                                                          .max()),
                aux_whole=float(aux1), aux_split=float(aux2))
        mark("olmoe experts")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if r != 0:
        return
    want = _hand_over(out, gathered[(1, 2)], kind, sender=False)
    mark("hand over")
    b = json.loads((out / "b.json").read_text())
    try:
        _compare_e(rec, gathered, want, b, llama, olmoe)
    finally:
        del want
        (out / "hand_over.done").touch()
    mark("compare")
    (out / "e.json").write_text(json.dumps(rec))


def _compare_e(rec, gathered, want, b, llama, olmoe) -> None:
    """Leg (e)'s rows against leg (b)'s one rank: the Llama losses and
    gathered states (``_mp_compare``), the OLMoE losses."""
    for shape in MP_MESHES:
        row = rec[f"llama {shape[0]}x{shape[1]}"]
        ones = b[llama]["single_losses"]
        row.update(single_losses=ones,
                   loss_rel_err=_max_rel(row["losses"], ones),
                   **_mp_compare(gathered[shape], want))
    ones = b[olmoe]["single_losses"]
    rec["olmoe 1x2"].update(single_losses=ones,
                            loss_rel_err=_max_rel(rec["olmoe 1x2"]
                                                  ["losses"], ones))


#: the warm-up before the go of legs (b) and (e): one float32 step of tiny
#: Llama (d_model 64) through launch.main, 4 x 256 tokens
WARM_ARGS = ["--arch", "llama3.2-1b", "--tiny", "--steps", "1", "--batch",
             "4", "--seq", "256", "--dtype", "float32", "--ckpt-every",
             "1000", "--log-every", "1"]


def _warm_up(out: Path, leg: str, kind: str) -> dict:
    """A rank's start-up before the go, off the critical path: its device,
    CUDA context and kernels (one WARM_ARGS step through
    ``launch.train.main``, the card's cached memory released after); leg
    (e)'s ranks take the (2, 2) group of the four from the launcher's
    environment first and warm up on it with ``--model-parallel 2`` (the
    host-staged collectives too), each of leg (b)'s ranks alone.
    Returns the device and the warm-up's seconds."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    dev = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    if kind == "cuda":
        torch.cuda.set_device(dev)
    args = WARM_ARGS + ["--device", str(dev), "--ckpt-dir",
                        str(out / f"ckpt_warm_{leg}_{os.environ['RANK']}")]
    with contextlib.redirect_stdout(None):
        if leg == "e":
            dist.init_process_group("gloo")
            train_launch.main(args + MP_ARGS + ["--backend", "gloo"])
        else:
            with _environ(RANK=None, WORLD_SIZE=None):
                train_launch.main(args)
    if kind == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return {"device": dev, "warm_up_s": time.perf_counter() - t0}


def train_dp_child(argv) -> None:
    """A rank of phase ``train_dp``'s legs, started by ``_run_leg``."""
    leg, out, kind, size = argv[0], Path(argv[1]), argv[2], argv[3]
    if leg in ("b", "e"):
        pre = _warm_up(out, leg, kind)
        _wait_for_go(out)
        if leg == "e":
            _dp_child_e(out, kind, size == "tiny", pre)
        else:
            _dp_child_b(out, kind, size == "tiny", pre)
        return
    _wait_for_go(out)
    {"cards": _dp_child_cards, "cards_mp": _dp_child_cards_mp}[leg](
        out, kind, size == "tiny")


def _leg_a(device: torch.device, train_c: dict, tmp: Path,
           tiny: bool) -> dict:
    """Leg (a): phase train (c)'s run of ``launch.train.main`` again as
    the one rank of a world of one (``_world_of_one``: the entry point
    initialises NCCL from the launcher's environment, takes
    ``cuda:LOCAL_RANK`` and syncs the gradients), in this process: a
    rank of its own would add ~25 s of start-up and a cold first step.
    Its losses against phase train (c)'s within DP_ONE_RTOL, and whether
    its final state is bit-equal to (c)'s (``replica_digest``)."""
    path = tmp / "a_metrics.json"
    with _world_of_one():
        train_launch.main(DP_TRAIN_ARGS + (["--tiny"] if tiny else []) + [
            "--device", device.type, "--ckpt-dir", str(tmp / "ckpt_a"),
            "--metrics-out", str(path)])
    a = json.loads(path.read_text())
    losses = _losses(a)
    rel = _max_rel(losses, train_c["losses"])
    if len(losses) != len(train_c["losses"]) or rel > DP_ONE_RTOL:
        raise AssertionError(f"train_dp (a): losses {losses} against "
                             f"phase train (c)'s {train_c['losses']}")
    warm = sorted(a["step_ms"][1:])[len(a["step_ms"][1:]) // 2]
    return dict(
        transport=a["backend"], world=a["world"], mesh=a["mesh"],
        device=a["device"], losses=losses, train_c_losses=train_c["losses"],
        loss_rel_err=rel, tol=DP_ONE_RTOL,
        state_bit_equal_to_train_c=a["digests"][0] == train_c["digest"],
        step_ms=a["step_ms"], warm_step_ms=warm,
        tokens_per_s=4 * 1024 / warm * 1e3, sync_ms=a["sync_ms"],
        compute_bound_ms=train_c["compute_bound_ms"],
        train_c_warm_step_ms=train_c["warm_step_ms"],
        peak_memory_bytes=a["peak_memory_bytes"], params=a["params"],
        wall_s=a["wall_s"],
        card=_smi() if device.type == "cuda" else None)


def _leg_c(device: torch.device, tmp: Path, tiny: bool) -> dict:
    """Leg (c): the int8 ring on the device, in a world of one of this
    process (NCCL on the card): ``_quant`` / ``_dequant`` and
    ``compressed_allreduce`` against the CPU, bit for bit, then one step
    of leg (a)'s model cut to 2 layers through ``launch.train.main``
    with ``--grad-compress`` and without."""
    import torch.distributed as dist
    from repro_torch.distributed.collectives import (_dequant, _quant,
                                                     compressed_allreduce)
    dev = torch.device(device.type, 0) if device.type == "cuda" else device
    with _world_of_one():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                device_id=dev if dev.type == "cuda"
                                else None)
        try:
            x = torch.randn((4, 4097),
                            generator=torch.Generator().manual_seed(3))
            q, sc = _quant(x.to(dev))
            cq, csc = _quant(x)
            got = compressed_allreduce(x[0].to(dev))
            want = _dequant(*_quant(x[0]))
            c = dict(quant_equal=torch.equal(q.cpu(), cq),
                     scale_equal=torch.equal(sc.cpu(), csc),
                     dequant_equal=torch.equal(_dequant(q, sc).cpu(),
                                               _dequant(cq, csc)),
                     allreduce_equal=torch.equal(got.cpu(), want),
                     allreduce_max_abs_err=float((got.cpu() - want)
                                                 .abs().max()))
            runs = {}
            for name, extra in (("int8_ring", ["--grad-compress"]),
                                ("all_reduce", [])):
                path = tmp / f"c_{name}.json"
                train_launch.main(
                    ["--arch", "llama3.2-1b", "--layers", "2", "--steps",
                     "1", "--batch", "4", "--seq", "1024", "--ckpt-every",
                     "1000", "--log-every", "1", "--device", device.type,
                     "--ckpt-dir", str(tmp / f"ckpt_c_{name}"),
                     "--metrics-out", str(path)]
                    + (["--tiny"] if tiny else []) + extra)
                runs[name] = json.loads(path.read_text())
        finally:
            dist.destroy_process_group()
    c["step_losses"] = {k: v["log"][0]["loss"] for k, v in runs.items()}
    c["sync_ms"] = {k: v["sync_ms"] for k, v in runs.items()}
    c["step_ms"] = {k: v["step_ms"] for k, v in runs.items()}
    c["states_equal"] = runs["int8_ring"]["digests"] == \
        runs["all_reduce"]["digests"]
    if not (c["quant_equal"] and c["scale_equal"] and c["dequant_equal"]
            and c["allreduce_equal"]):
        raise AssertionError(f"train_dp (c): the device's int8 ring "
                             f"differs from the CPU: {c}")
    ls = c["step_losses"]
    if ls["int8_ring"] != ls["all_reduce"] or not all(
            math.isfinite(v) for v in ls.values()):
        raise AssertionError(f"train_dp (c): step losses {ls}")
    return c


def _leg_d(warm_step_ms: float, tokens: int) -> dict:
    """Leg (d): ``launch.dryrun`` on ``llama3.2-1b`` x ``train_4k`` and
    leg (a)'s step (`warm_step_ms` for `tokens` tokens) against the cell's
    roofline at `tokens` a card: the compute term scaled by the tokens,
    the memory term's lower bound (AdamW's state bytes, and the batch's
    scaled), no collective in a world of one."""
    from repro_torch.launch import dryrun
    from repro_torch.analysis.roofline import HBM_BW
    t0 = time.perf_counter()
    rec = dryrun.run_cell("llama3.2-1b", "train_4k")
    roof = rec["roofline"]
    scale = tokens / (rec["rows"] * rec["seq"])     # a card's tokens -> (a)
    lower = roof["bytes_lower_bound"]
    compute_ms = roof["compute_s"] * 1e3 * scale
    memory_ms = (lower["state_bytes"] + lower["batch_bytes"] * scale) \
        / HBM_BW * 1e3
    bound_ms = max(compute_ms, memory_ms)
    return dict(
        arch="llama3.2-1b", shape="train_4k", cards=rec["cards"],
        rows=rec["rows"], roofline={k: roof[k] for k in (
            "compute_s", "memory_s", "collective_s", "dominant", "bound_s",
            "flops_global", "bytes_lower_bound", "memory_upper_s",
            "bytes_upper_bound_global", "coll_wire_bytes_per_card",
            "int8_ring_bytes_per_card", "model_flops", "useful_fraction",
            "n_params")},
        memory=rec["memory"], compute_ms_at_tokens=compute_ms,
        memory_lower_ms_at_tokens=memory_ms, bound_ms_at_tokens=bound_ms,
        memory_upper_ms_at_tokens=roof["memory_upper_s"] * 1e3 * scale,
        tokens=tokens, step_over_bound=warm_step_ms / bound_ms,
        dryrun_s=time.perf_counter() - t0)


def phase_train_dp(device: torch.device, train_c: dict,
                   tiny: bool = False, leg_b=None, leg_e=None) -> dict:
    """Data-parallel and model-parallel training and the LM dry run, one
    line a leg, budget 35 s for (a)-(d) and 25 s for (e): (b) two ranks
    sharing the card over gloo, started by ``torch.distributed.run``,
    against one rank; (e) the model axis, four ranks sharing the card
    over gloo (``_dp_child_e``): leg (b)'s cases with ``--model-parallel
    2`` on (2, 2) and (1, 2) against (b)'s one rank; (a) a world of one
    over NCCL through ``launch.train.main`` at Llama-3.2-1B's full width
    and depth, its losses against phase train (c)'s; (c) the int8 ring on
    the card; (d) ``launch.dryrun`` on ``llama3.2-1b`` x ``train_4k`` and
    leg (a)'s step against its bound.  `leg_b` and `leg_e` are (b)'s and
    (e)'s ranks and their directory (one for both) if ``_start_leg``
    started them earlier.  `tiny` (the models at ``tiny_config``, the CPU
    as `device`) is a rehearsal."""
    import tempfile
    if device.type == "cuda":
        torch.cuda.empty_cache()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        if leg_b is None:
            leg_b = (_start_leg("b", 2, tmp, device, tiny), tmp)
            leg_e = (_start_leg("e", 4, tmp, device, tiny), tmp)
        # (b) and (e) first, side by side: their ranks need ~30 GB of the
        # card, which this process holds cached once (a) has run; (b)'s
        # rank 0 ends once it has handed its one-rank state to (e)
        try:
            b = _finish_leg("b", *leg_b)
        except AssertionError as err:   # (b) waits on (e): show (e) too
            _stop_leg(leg_e[0])
            tail = {k: (leg_e[1] / f"e.{k}").read_text()[-4000:]
                    for k in ("stdout", "stderr")}
            raise AssertionError(f"{err}\n(e):\n{tail['stdout']}\n"
                                 f"{tail['stderr']}") from None
        for name in DP_B_CASES:
            row = b[name]
            if not (row["within_tol"] and row["replicas_bit_identical"]
                    and row["backend"] == "gloo"):
                raise AssertionError(f"train_dp (b) {name}: {row}")
        if b["olmoe-1b-7b tiny"]["restarts"] != 1:
            raise AssertionError(f"train_dp (b): no restart: {b}")
        aux = b["olmoe_aux"]
        if not all(abs(g - aux["global_batch"]) <= 1e-6 * abs(
                aux["global_batch"]) for g in aux["ranks"]):
            raise AssertionError(f"train_dp (b): router aux {aux}")
        res["b"] = b
        emit("train_dp", leg="b", **b)
        res["e"] = _check_leg_e(_finish_leg("e", *leg_e), device)
        t0 = time.perf_counter()
        res["a"] = _leg_a(device, train_c, tmp, tiny)
        res["a"]["leg_s"] = time.perf_counter() - t0
        emit("train_dp", leg="a", **res["a"])
        t0 = time.perf_counter()
        res["c"] = _leg_c(device, tmp, tiny)
        res["c"]["leg_s"] = time.perf_counter() - t0
        emit("train_dp", leg="c", **res["c"])
    res["d"] = _leg_d(res["a"]["warm_step_ms"], 4 * 1024)
    emit("train_dp", leg="d", **res["d"])
    return res


def main() -> None:
    import tempfile
    t0 = time.perf_counter()
    phase_s = {}

    def timed(phase, fn, *args, **kw):
        start = time.perf_counter()
        out = fn(*args, **kw)
        phase_s[phase] = time.perf_counter() - start
        print(f"[chip_smoke] {phase}: {phase_s[phase]:.2f} s, "
              f"{time.perf_counter() - t0:.2f} s in all", file=sys.stderr,
              flush=True)
        return out

    smi = phase_device()
    cuda = torch.device("cuda")
    # three worker processes run on the CPU the grids' untimed plain
    # versions first (the grids wait on them), simulate the main batch
    # (~20 s of Python) and the pairs of phases session and graphs (~17
    # s), and run the CPU sides of phases end_to_end, session and mapper,
    # and phase train_dp's leg (b) ranks start up (and then wait), while
    # the kernels build and the grids run
    sim = concurrent.futures.ProcessPoolExecutor(
        3, mp_context=multiprocessing.get_context("spawn"),
        initializer=_worker_init)
    refs = {grid: sim.submit(_plain_refs, grid) for grid in GRID_SEEDS}
    batch = sim.submit(_simulated, long_reads)
    split_profile = sim.submit(long_reads, 512, read_len=300)
    e2e_cpu = sim.submit(end_to_end_cpu)
    streams = {"session": sim.submit(session_stream),
               "graphs": sim.submit(graph_sets),
               "mapper": sim.submit(mapper_cpu)}
    dp_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    leg_b = _start_leg("b", 2, dp_dir, cuda, False)
    leg_e = _start_leg("e", 4, dp_dir, cuda, False)
    try:
        kernels = _phases(cuda, timed, phase_s, sim, batch, refs,
                          split_profile, e2e_cpu, streams, (leg_b, dp_dir),
                          (leg_e, dp_dir))
    finally:
        _stop_leg(leg_b)
        _stop_leg(leg_e)
        sim.shutdown(cancel_futures=True)
        shutil.rmtree(dp_dir, ignore_errors=True)
    emit("done", seconds=time.perf_counter() - t0, phase_seconds=phase_s)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _families(usage: dict, name: str) -> dict:
    """Kernel `name`'s instantiations in the build, by family: "NW 1-4"
    (W <= 128, the source in ``SOURCES``), "NW 5-8" (W = 129..256, its
    ``*_wide.cu``: K3's, and K1's / the tails' at ``TEMPLATE_KEPT``) and
    "NW 9+" (the wide family's one kernel, its ``*_xwide.cu``, which K1
    and the tails also run at the other NW = 5..8 configurations), as
    ptxas reports them (K2 and K4 share one template, and one wide
    kernel)."""
    template = {"tb_fused": "tb_fused", "dc_band": "dc_band"}.get(
        name, "tail_fused")
    out = {"NW 1-4": 0, "NW 5-8": 0,
           "NW 9+": int(f"{template}_xwide" in usage)}
    for key in usage:
        m = re.match(rf"{template}<NW=(\d+),", key)
        if m:
            out["NW 1-4" if int(m.group(1)) <= genasm_dc.NARROW_NW
                else "NW 5-8"] += 1
    return out


def _phases(cuda, timed, phase_s, sim, batch, refs, split_profile,
            e2e_cpu, streams, leg_b, leg_e) -> list:
    """Every phase after ``phase_device``, in order; returns the
    ``kernels`` line's entries."""
    usage = timed("build", phase_build)
    rows = timed("kernel", phase_kernels, cuda, usage=usage)
    grids = {"tb_fused": timed("k1_grid", phase_k1_grid, cuda,
                               refs=refs["k1"])}
    occupancy = timed("k1_occupancy", phase_k1_occupancy, usage)
    tails = timed("tail_grid", phase_tail_grid, cuda, usage=usage,
                  refs=refs["tail"])
    grids.update({name: [r for r in tails if r["name"] == name]
                  for name in ("tail_banded", "tail_full")})
    grids["dc_band"] = timed("k3_grid", phase_k3_grid, cuda, usage=usage,
                             refs=refs["k3"])
    rs, sim_s = timed("batch", batch.result)
    emit("batch", pairs=len(rs.reads), read_len=len(rs.reads[0]),
         sim_s=sim_s, waited_s=phase_s["batch"])
    fused, fused_res = timed("main_path", phase_main_path, cuda, rs)
    split = timed("main_path_split", phase_main_path_split, cuda, rs, fused,
                  fused_res, profile_rs=split_profile.result())
    timed("end_to_end", phase_end_to_end, cuda, cpu=e2e_cpu)
    timed("mesh", phase_mesh, cuda, rs, fused, fused_res)
    timed("session", phase_session, cuda, stream=streams["session"])
    store = timed("gateway", phase_gateway, cuda)
    graph_rows = timed("graphs", phase_graphs, cuda, gateway_store=store,
                       sets=streams["graphs"])
    timed("mapper", phase_mapper, cuda, cpu=streams["mapper"])
    sim.shutdown()
    timed("paper", phase_paper, cuda)
    timed("lm", phase_lm, cuda)
    trained = timed("train", phase_train, cuda)
    timed("train_dp", phase_train_dp, cuda, trained["c"], leg_b=leg_b,
          leg_e=leg_e)
    timed("profiles", phase_profiles)
    launches = {**fused["launches"], "dc_band": split["launches"]["dc_band"],
                "ladder_gate": next(r["gate_launches"] for r in graph_rows
                                    if r.get("rounds_run") == 3)}
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
            sources=WIDE_SOURCES[name], instantiations=_families(usage, name),
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in own + grids[name]
                            if r["max_abs_err"] is not None),
            ms=base["ms"], plain_ms=base["plain_ms"],
            bound_ms=base["bound_ms"], bound_by=base["bound_by"],
            library_ms=None, W=base["W"], k=base["k"], lanes=base["lanes"],
            by_k=by_k)
        if name == "tb_fused":
            # the main path launches K1's window form: its rows beside the
            # standalone form on the same slices
            entry["window_form"] = dict(replaces=WINDOW_REPLACES, rows=[
                {key: r[key] for key in (
                    "W", "k", "lanes", "ms", "event_ms", "standalone_ms",
                    "bound_ms", "bound_by", "plain_ms", "max_abs_err",
                    "checked_by", "committed_lanes", "library_ms")}
                for r in rows if r["name"] == "tb_window"])
        wide = [r for r in own if r["W"] != 64]
        if wide:
            entry["by_width"] = [dict(W=r["W"], k=r["k"], ms=r["ms"],
                                      event_ms=r["event_ms"],
                                      plain_ms=r["plain_ms"],
                                      bound_ms=r["bound_ms"],
                                      bound_by=r["bound_by"],
                                      placement=r.get("placement"),
                                      store_bytes_per_lane=r.get(
                                          "store_bytes_per_lane"),
                                      blocks_per_sm=r.get("blocks_per_sm"),
                                      lanes=r["lanes"],
                                      **{key: r[key] for key in (
                                          "lanes_per_block", "threads",
                                          "shared_bytes", "chunk",
                                          "staging_rows") if key in r},
                                      ptxas=r.get("ptxas"),
                                      peak_bytes=r.get("peak_bytes"))
                                 for r in wide]
        kernels.append(entry)
    gate = next(r for r in rows if r["name"] == "ladder_gate")
    kernels.append(dict(
        name="ladder_gate", route="cuda", source=SOURCES["ladder_gate"],
        replaces=GATE_REPLACES, launches=launches["ladder_gate"],
        **{key: gate[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "event_ms", "lanes", "ptxas")}))
    return kernels


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-dp-child"]:
        train_dp_child(sys.argv[2:])
    else:
        main()
