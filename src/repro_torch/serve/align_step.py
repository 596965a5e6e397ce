"""The alignment step (port of ``repro/serve/align_step.py``): one batched
alignment plus its summary, the function a session's executable runs.

``make_align_step(cfg, L, device=...)`` is the plain windowed step (one
rung of the k-doubling ladder: K1 per main window and K2 / K4 for the
tail on backend 'fused', K3 and the PyTorch traceback on 'split');
``make_align_step(cfg, L, rescue_rounds=r, device=...)`` the whole ladder
on the device (``core.windowing.align_pairs_rescued``).  With a mesh
(``launch.mesh.DeviceMesh``) a step takes and returns one tensor a pair
shard (``distributed.sharding``), and its summary is reduced over every
shard.  ``launch_plan`` lists the kernel launches a step makes on each
shard, with their blocks, and on the card their occupancy: what a session
prepares once per executable.
"""
from __future__ import annotations

import torch

from ..core.aligner import check_mesh_device, resolve_device
from ..core.config import KERNEL_BACKENDS, AlignerConfig
from ..core.windowing import (align_pairs, align_pairs_rescued, bucket_avals,
                              n_main_windows, rescue_schedule,
                              self_tail_width)
from ..distributed.sharding import check_shards, pair_devices
from ..kernels import build, genasm_dc


def align_step(reads, read_len, refs, ref_len, *, cfg: AlignerConfig,
               max_read_len: int, rescue_rounds: int | None = None,
               mesh=None):
    """One batched alignment step + summary stats, on the device of the
    inputs (on a mesh: per-shard inputs and outputs).  rescue_rounds=None
    runs plain ``align_pairs``; an int runs the k-doubling ladder on the
    device.  The summary's values are 0-d int32 tensors on that device,
    on a mesh the first shard's, summed over every shard (no host
    sync)."""
    if rescue_rounds is None:
        out = align_pairs(reads, read_len, refs, ref_len, cfg=cfg,
                          max_read_len=max_read_len, mesh=mesh)
    else:
        out = align_pairs_rescued(reads, read_len, refs, ref_len, cfg=cfg,
                                  max_read_len=max_read_len,
                                  rescue_rounds=rescue_rounds, mesh=mesh)
    return out, step_summary(out, cfg, rescue_rounds, mesh)


def step_summary(out: dict, cfg: AlignerConfig, rescue_rounds: int | None,
                 mesh=None) -> dict:
    """An align step's summary of its outputs `out`: 0-d int32 tensors on
    the device of the (first shard's) lanes, summed over every shard, no
    host sync."""
    dev = (out["dist"] if mesh is None else out["dist"][0]).device
    i32 = torch.int32

    def total(fn, *keys):
        """fn of the lanes' `keys`, counted over every lane of every
        shard."""
        parts = zip(*(out[k] if mesh is not None else (out[k],)
                      for k in keys))
        return torch.stack([fn(*p).sum(dtype=i32).to(dev)
                            for p in parts]).sum(dtype=i32)

    summary = {
        "n_failed": total(lambda failed: failed, "failed"),
        "total_edits": total(lambda dist: dist, "dist"),
        "total_ops": total(lambda n_ops: n_ops, "n_ops"),
    }
    if rescue_rounds is not None:
        summary["n_rescued"] = total(
            lambda failed, k_used: ~failed & (k_used > cfg.k),
            "failed", "k_used")
        rounds = out["rounds_run"]      # a 0-d tensor from the ladder graph
        summary["rounds_run"] = (
            rounds.to(i32) if isinstance(rounds, torch.Tensor)
            else torch.full((), rounds, dtype=i32, device=dev))
    return summary


def on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether tensor `t` lies on `device` (an index-less device matches
    any index of its type)."""
    return t.device.type == device.type and device.index in (None,
                                                             t.device.index)


def make_align_step(cfg: AlignerConfig, max_read_len: int, mesh=None,
                    rescue_rounds: int | None = None, *, device):
    """The align-step factory (plain or rescued, one code path), and what
    ``repro_torch.api.AlignSession`` prepares per length bucket.  The step
    takes (reads, read_len, refs, ref_len) on `device` (CUDA unless the
    caller asks for the CPU; raises where there is none), on a mesh one
    tensor a shard, each on its shard's device, and returns (out,
    summary)."""
    device = resolve_device(device)
    mesh = check_mesh_device(mesh, device)

    def step(reads, read_len, refs, ref_len):
        args = (reads, read_len, refs, ref_len)
        if mesh is not None:
            check_shards(args, mesh)
        else:
            for name, t in zip(("reads", "read_len", "refs", "ref_len"),
                               args):
                if not on_device(t, device):
                    raise ValueError(f"{name} is on {t.device}; this step "
                                     f"runs on {device}")
        return align_step(reads, read_len, refs, ref_len, cfg=cfg,
                          max_read_len=max_read_len,
                          rescue_rounds=rescue_rounds, mesh=mesh)
    return step


def make_align_step_rescued(cfg: AlignerConfig, max_read_len: int,
                            mesh=None, rescue_rounds: int = 2, *, device):
    """Alias for make_align_step(..., rescue_rounds=rescue_rounds)."""
    return make_align_step(cfg, max_read_len, mesh,
                           rescue_rounds=rescue_rounds, device=device)


def align_input_specs(batch: int, read_len: int, cfg: AlignerConfig,
                      rescue_rounds: int = 0):
    """(shape, dtype) of a step's inputs for `batch` pairs of `read_len`
    reads: the bucket_avals geometry with a 1.3x read->ref length model.
    With rescue_rounds, the ref padding covers the FINAL round's tail
    width (the contract of align_pairs_rescued)."""
    return bucket_avals(cfg, batch, read_len, int(read_len * 1.3),
                        rescue_rounds)


def _rung_kernels(cfg: AlignerConfig, windows: bool) -> list:
    """The kernels one rung of the ladder launches: K1 (if any main
    window) and the tail kernel on 'fused'; K3 (if any main window) on
    'split', whose tail is plain PyTorch."""
    if cfg.backend == "fused":
        tail = "tail_banded" if cfg.tail_banded else "tail_full"
        return ["tb_fused", tail] if windows else [tail]
    return ["dc_band"] if windows else []


def _geometry(name: str, cfg: AlignerConfig):
    """Kernel `name`'s block at `cfg`: the wide family's where
    ``genasm_dc.kernel_family`` names it, else its template's."""
    if genasm_dc.kernel_family(cfg, name) == "xwide":
        return genasm_dc.xwide_geometry(cfg, name, self_tail_width(cfg))
    if name == "tb_fused":                  # the main windows' form
        return genasm_dc.tb_fused_geometry(cfg, window=True)
    if name == "dc_band":
        return genasm_dc.dc_band_geometry(cfg)
    wt = self_tail_width(cfg)
    return genasm_dc.tail_geometry(cfg, wt, cfg.W + wt)


_OCCUPANCY = {"tb_fused": genasm_dc.tb_fused_occupancy,
              "tail_banded": genasm_dc.tail_occupancy,
              "tail_full": genasm_dc.tail_occupancy,
              "dc_band": genasm_dc.dc_band_occupancy}


def _occupancy(name: str, cfg: AlignerConfig, geo) -> tuple:
    if genasm_dc.kernel_family(cfg, name) == "xwide":
        return genasm_dc.xwide_occupancy(name, geo)
    return _OCCUPANCY[name](cfg, geo)


def launch_plan(cfg: AlignerConfig, max_read_len: int,
                rescue_rounds: int | None, device, mesh=None) -> tuple:
    """The kernel launches of one step, shard by shard and rung by rung: a
    dict per (shard, rung, kernel) with the shard's index and device, the
    kernel's name, the rung's k, its block (``genasm_dc``'s geometry: a
    template's, or the wide family's, ``genasm_dc.kernel_family``) and,
    on CUDA, the blocks one SM holds and the kernel's dynamic
    shared-memory limit
    (``genasm_dc.*_occupancy``; the query also allows the block's shared
    memory, once per kernel and device, so the first launch pays no
    setup).  Without a mesh the one shard is `device`.  On CUDA it raises
    ValueError where one block's scratch exceeds the card's free memory
    (``genasm_dc.check_scratch_fits``: the wide family's one refusal),
    and builds (at first use) and loads the kernel library.  Launches
    nothing, transfers nothing.  Backend 'plain' launches no kernel."""
    if cfg.backend not in KERNEL_BACKENDS:
        return ()
    devices = (torch.device(device),) if mesh is None else pair_devices(mesh)
    cuda = devices[0].type == "cuda"
    rungs = rescue_schedule(cfg, rescue_rounds or 0)
    if cuda:
        if any(genasm_dc.kernel_family(c, name) == "xwide"
               for c in rungs for name in genasm_dc.KERNELS):
            # the wide family's scratch
            for dev in devices:
                free = genasm_dc.free_bytes(dev)
                for c in rungs:
                    genasm_dc.check_scratch_fits(c, free)
        build.load_library()
    windows = n_main_windows(max_read_len, cfg) > 0
    plan = []
    for shard, dev in enumerate(devices):
        for c in rungs:
            for name in _rung_kernels(c, windows):
                geo = _geometry(name, c)
                entry = {"shard": shard, "device": dev, "kernel": name,
                         "k": c.k, "geometry": geo, "blocks_per_sm": None,
                         "shared_limit": None}
                if cuda:
                    with torch.cuda.device(dev):
                        entry["blocks_per_sm"], entry["shared_limit"] = \
                            _occupancy(name, c, geo)
                plan.append(entry)
    return tuple(plan)
