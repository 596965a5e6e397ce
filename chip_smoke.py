"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card (and K1
over a grid of its block geometries, with its occupancy), drives
the aligner's main path (``GenASMAligner.align``) on PBSIM2-like long
reads through the fused backend (K1, K2, K4) and the split backend (K3 and
the PyTorch traceback), holds the two results equal, and checks the kernel
path against the CPU plain path end to end on both backends.
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

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core.aligner import GenASMAligner             # noqa: E402
from repro_torch.core.config import AlignerConfig              # noqa: E402
from repro_torch.core.windowing import n_main_windows          # noqa: E402
from repro_torch.core.oracle import validate_cigar             # noqa: E402
from repro_torch.data.genome import (ReadSimConfig, simulate_reads,  # noqa: E402
                                     synth_genome)
from repro_torch.kernels import build, genasm_dc               # noqa: E402
from repro_torch.kernels.ops import _to_kernel_layout          # noqa: E402

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
SOURCE = "src/repro_torch/kernels/csrc/genasm_fused.cu"
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
    """Build and load the library; returns ptxas's usage per kernel."""
    t0 = time.perf_counter()
    lib = build.build()
    build.load_library()
    seconds = time.perf_counter() - t0
    usage = _ptxas_usage(build.ptxas_report(lib).read_text())
    emit("build", seconds=seconds, library=lib.name, ptxas=usage)
    return usage


def _kernel_name(kind: str, args) -> str:
    """kind<NW=..,KP=..> (K1: also NWB=..) of an instantiation."""
    return f"{kind}<" + ",".join(f"{p}={a}" for p, a in zip(
        ("NW", "KP", "NWB"), args)) + ">"


def _ptxas_usage(report: str) -> dict:
    """{kernel<NW,KP[,NWB]>: "registers / spill stores / spill loads"}
    from ptxas -v output."""
    usage, name, spill = {}, None, ""
    for line in report.splitlines():
        if "Function properties for" in line:
            mangled = line.split()[-1]
            kind = next((k for k in KERNELS if f"{k}_kernel" in mangled),
                        None)
            name = None
            if kind is not None:
                args = re.search(r"_kernelI((?:Li\d+E)+)E", mangled).group(1)
                name = _kernel_name(kind, re.findall(r"Li(\d+)E", args))
        elif "spill stores" in line:
            nums = re.findall(r"(\d+) bytes", line)
            spill = f"spill stores {nums[1]} B, spill loads {nums[2]} B"
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


def _check_case(name: str, cfg: AlignerConfig, n_pairs: int, rng, device,
                reps: int, what: str) -> dict:
    """One kernel call against its plain version on the same inputs (max
    abs err 0 or raise); with reps > 0 also its times and bound."""
    wrapper, plain, _ = KERNELS[name]
    inputs, kw, cols = _case(name, cfg, n_pairs, rng, device)
    call = lambda: wrapper(*inputs, **kw)               # noqa: E731
    got = call()
    _sync(device)
    start = time.perf_counter()
    ref = plain(*inputs, **kw)
    _sync(device)
    plain_ms = (time.perf_counter() - start) * 1e3
    err = max(int((a.long() - b.long()).abs().max()) for a, b in
              zip(got, ref))
    if err != 0:
        raise AssertionError(f"{name} {what}: kernel and plain version "
                             f"differ (max abs err {err})")
    dist, steps = _dist_and_steps(name, got)
    row = dict(name=name, k=cfg.k, lanes=n_pairs, max_abs_err=err,
               plain_ms=plain_ms, solved=int((dist <= cfg.k).sum()))
    if reps:
        for _ in range(2):
            call()
        event_ms = _time_ms(call, reps, device)
        device_ms = _device_ms(call, reps, device)
        bound_ms, bound_by = _bound(cfg, inputs, got, cols, dist, steps)
        row.update(ms=event_ms if device_ms is None else device_ms,
                   event_ms=event_ms, bound_ms=bound_ms, bound_by=bound_by)
    return row


def phase_kernels(device: torch.device, n_pairs: int = 4096,
                  reps: int = 20) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes.
    On the card ``ms`` is the device time per launch (``_device_ms``);
    ``event_ms`` the CUDA-event time per call of back-to-back wrapper
    calls, the host's time between launches included."""
    rng = np.random.default_rng(2022)
    cases = [("tb_fused", 12), ("tb_fused", 24), ("tb_fused", 48),
             ("tail_banded", 12), ("tail_full", 24), ("tail_full", 48),
             ("dc_band", 12), ("dc_band", 24), ("dc_band", 48)]
    rows = []
    for name, k in cases:
        cfg = AlignerConfig(k=k)
        if name.startswith("tail") and (name == "tail_banded") != cfg.tail_banded:
            raise AssertionError(f"k={k} does not select {name}")
        row = _check_case(name, cfg, n_pairs, rng, device, reps, f"k={k}")
        if name == "tb_fused":
            row["one_thread_ms"] = K1_ONE_THREAD_MS[k]
        emit("kernel", **row)
        rows.append(row)
    return rows


#: K1's geometry grid: (W, O, k, early_term, lanes); every (NW, KP, NWB)
#: instantiation, idle levels above k (k=40), no early termination, lane
#: counts that are no multiple of a block's lanes, and the main path's
#: own batch width (2,048, timed)
K1_GRID = [(16, 6, 4, True, 37), (32, 12, 5, True, 37),
           (32, 12, 20, True, 37), (64, 24, 12, True, 37),
           (64, 24, 15, True, 37), (64, 24, 24, True, 37),
           (64, 24, 40, True, 37),
           (64, 24, 48, True, 37), (64, 24, 12, False, 37),
           (64, 24, 48, False, 37), (64, 24, 12, True, 1),
           (64, 24, 24, True, 1), (64, 24, 48, True, 1),
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
    """Per K1 instantiation: its block, the dynamic shared bytes a block
    asks for and the instantiation's limit as the card reports it, active
    blocks per SM on this card, and ptxas's registers and spills.  Returns
    the rows of the default ladder's k (12, 24, 48)."""
    out = {}
    for W, O, k in ((32, 12, 5), (32, 12, 20), (64, 24, 12), (64, 24, 15),
                    (64, 24, 24), (64, 24, 48)):
        cfg = AlignerConfig(W=W, O=O, k=k)
        row = _k1_geometry(cfg)
        blocks, limit = genasm_dc.tb_fused_occupancy(
            cfg, genasm_dc.tb_fused_geometry(cfg))
        if limit < row["shared_bytes"]:
            raise AssertionError(f"K1 k={k}: the card allows {limit} B of "
                                 f"dynamic shared memory, a block asks for "
                                 f"{row['shared_bytes']}")
        row.update(blocks_per_sm=blocks, card_shared_bytes=limit,
                   ptxas=usage.get(_kernel_name(
                       "tb_fused", (row["NW"], row["KP"], row["NWB"]))))
        emit("k1_occupancy", **row)
        if k in K1_ONE_THREAD_MS:
            out[k] = row
    return out


# ---- phase 4: the main path at a real size, fused then split ----

def long_reads(n_pairs: int = 2048, read_len: int = 10_000,
               genome_len: int = 5_000_000):
    """The main path's batch: PBSIM2-like CLR reads at 10 % error."""
    genome = synth_genome(genome_len, seed=2022)
    return simulate_reads(genome, n_pairs, ReadSimConfig(read_len=read_len,
                                                         error_rate=0.10,
                                                         seed=2022))


def _drive(device: torch.device, backend: str, rs):
    """Align `rs` through ``GenASMAligner.align`` on `backend` at the
    default geometry (W=64, O=24, k=12, ladder to 48), the launch counts
    set to 0 just before and read just after.  Fails unless exactly the
    backend's kernels ran on the card (or, on the CPU, exactly their plain
    versions).  Returns the aligner, the result, the host seconds and the
    counts."""
    aligner = GenASMAligner(AlignerConfig(backend=backend), rescue_rounds=2,
                            device=device)
    genasm_dc.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    res = aligner.align(rs.reads, rs.ref_segments)
    _sync(device)
    seconds = time.perf_counter() - t0
    taken, other = (dict(c) for c in _counts(device))
    expected = PATH_KERNELS[backend]
    if (min(taken[n] for n in expected) == 0 or max(other.values()) != 0
            or any(taken[n] for n in KERNELS if n not in expected)):
        raise AssertionError(f"{backend} path did not run on the {device} "
                             f"path alone: {taken}, other path {other}")
    return aligner, res, seconds, taken, other


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
    it 500 bp reads, since the profiler takes minutes to sum the events of
    the main batch's millions of launches)."""
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


def _device_breakdown(run) -> dict:
    """Device time of one more main-path batch under torch.profiler, by
    kernel (ours by name, the rest of PyTorch's together, copies), beside
    the batch's host-clock time; the idle share is the part of the wall
    time no kernel or copy ran.  ``profile_s`` is the host time the
    profiler then takes to collect and sum the events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    ms = dict.fromkeys([*KERNELS, "torch_kernels", "memcpy"], 0.0)
    launches = dict.fromkeys(ms, 0)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in KERNELS if f"{k}_kernel" in ev.key),
                    "memcpy" if "memcpy" in ev.key.lower()
                    else "torch_kernels")
        ms[name] += ev.self_device_time_total / 1e3
        launches[name] += ev.count
    busy = sum(ms.values()) / 1e3
    wall = t1 - t0
    return dict(wall_s=wall, device_ms=ms, device_launches=launches,
                device_busy_s=busy,
                idle_share=1 - busy / wall if busy else None,
                profile_s=time.perf_counter() - t1)


# ---- phase 5: kernel path against plain path, end to end ----

def phase_end_to_end(device: torch.device, n_pairs: int = 32,
                     read_len: int = 2_000) -> None:
    """Each backend on `device` against the same backend on the CPU."""
    genome = synth_genome(1_000_000, seed=7)
    rs = simulate_reads(genome, n_pairs, ReadSimConfig(read_len=read_len,
                                                       seed=7))
    for backend in PATH_KERNELS:
        results, seconds = {}, {}
        for dev in (device, torch.device("cpu")):
            _, results[dev.type], seconds[dev.type], _, _ = _drive(
                dev, backend, rs)
        a = results[device.type]
        _assert_same_result(a, results["cpu"], f"end to end ({backend})")
        emit("end_to_end", backend=backend, pairs=n_pairs,
             read_len=read_len, equal=True, seconds=seconds,
             failed_share=float(a.failed.mean()))


def main() -> None:
    t0 = time.perf_counter()
    smi = phase_device()
    usage = phase_build()
    cuda = torch.device("cuda")
    rows = phase_kernels(cuda)
    phase_k1_grid(cuda)
    occupancy = phase_k1_occupancy(usage)
    t1 = time.perf_counter()
    rs = long_reads()
    emit("batch", pairs=len(rs.reads), read_len=len(rs.reads[0]),
         sim_s=time.perf_counter() - t1)
    fused, fused_res = phase_main_path(cuda, rs)
    split = phase_main_path_split(cuda, rs, fused, fused_res,
                                  profile_rs=long_reads(read_len=500))
    phase_end_to_end(cuda)
    launches = {**fused["launches"], "dc_band": split["launches"]["dc_band"]}
    kernels = []
    for name, (_, _, replaces) in KERNELS.items():
        base = next(r for r in rows if r["name"] == name)
        by_k = {r["k"]: dict(ms=r["ms"], event_ms=r["event_ms"],
                             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"])
                for r in rows if r["name"] == name}
        if name == "tb_fused":
            for k, row in by_k.items():
                occ = occupancy[k]
                row.update(ptxas=occ["ptxas"],
                           shared_bytes=occ["card_shared_bytes"],
                           blocks_per_sm=occ["blocks_per_sm"])
        kernels.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rows
                            if r["name"] == name),
            ms=base["ms"], plain_ms=base["plain_ms"],
            bound_ms=base["bound_ms"], bound_by=base["bound_by"],
            library_ms=None, k=base["k"], lanes=base["lanes"], by_k=by_k))
    emit("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
