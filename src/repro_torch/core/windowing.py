"""Windowed long-read alignment (port of ``repro/core/windowing.py``).

A (read, ref-segment) pair is aligned as a sequence of W x W windows: DC+TB
inside the window on *reversed* contents (so the traceback emits
front-first ops), commit the first W-O read characters' worth of ops,
advance, repeat; the final <= W read chars align in one tail window
against the remaining reference.  All pairs advance in lockstep; pairs
whose window edit distance exceeds k are flagged ``failed``.

Three decisions of the port (see PERF.md):

* the reference's ``lax.scan`` over the main windows is a Python loop with
  one DC launch per window (K1 on backend 'fused', K3 on 'split'); every
  intermediate stays on the device;
* the reference's on-device round gate ``lax.cond(any(failed))`` is a host
  check of ``failed.any()`` before each rescue round.  It is the one
  device-to-host sync of the ladder, counted in the returned
  ``gate_syncs``;
* on a mesh (``mesh=``) the reference's ``shard_map`` is one pass a
  shard, each on its own device, driven by the host in lockstep, window
  by window; the gate reads every shard in one sync.
"""
from __future__ import annotations

import dataclasses

import torch

from ..distributed.sharding import check_shards
from ..kernels.genasm_dc import tb_fused_geometry
from ..kernels.ops import genasm_tail_fused_op, genasm_tb_fused_op
from .bitops import SENTINEL_PAT, SENTINEL_TEXT
from .config import AlignerConfig
from .genasm import dc, dc_jmajor
from .oracle import OP_NONE
from .traceback import traceback

SENTINEL_READ = SENTINEL_PAT    # never matches (out of PM alphabet)
SENTINEL_REF = SENTINEL_TEXT    # maps to the all-ones PM row


def n_main_windows(max_read_len: int, cfg: AlignerConfig) -> int:
    """Windows before every problem's remaining read length is <= W."""
    return max(0, -(-(max_read_len - cfg.W) // cfg.stride))


def total_op_budget(max_read_len: int, cfg: AlignerConfig) -> int:
    nm = n_main_windows(max_read_len, cfg)
    return nm * (cfg.stride + cfg.k) + cfg.W + self_tail_width(cfg)


def self_tail_width(cfg: AlignerConfig) -> int:
    return cfg.W + 4 * cfg.k


def rescue_schedule(cfg: AlignerConfig, rescue_rounds: int):
    """The k-doubling ladder: round r runs with k_r = min(k * 2**r, W - 1),
    deduplicated once the cap is hit."""
    cfgs = [cfg]
    for _ in range(rescue_rounds):
        new_k = min(cfgs[-1].k * 2, cfg.W - 1)
        if new_k == cfgs[-1].k:
            break
        cfgs.append(dataclasses.replace(cfgs[-1], k=new_k))
    return tuple(cfgs)


def pad_geometry(cfg: AlignerConfig, max_read_len: int, max_ref_len: int,
                 rescue_rounds: int = 0) -> tuple[int, int]:
    """(Lr, Lf) padded array widths: reads carry >= W sentinels past
    read_len, refs enough for the final rescue round's tail width."""
    wt = self_tail_width(rescue_schedule(cfg, rescue_rounds)[-1])
    return max_read_len + cfg.W + 1, max_ref_len + cfg.W + wt + 1


# ---- bucket-shaped geometry (the session front door's shape classes) ----
#
# ``repro_torch.api.AlignSession`` never derives pad widths from a batch's
# ragged max_read_len: it quantises lengths to power-of-two BUCKETS and
# prepares one executable per bucket.  These helpers are the single source
# of truth for that geometry; the aligner's exact-shape path uses the same
# pad_geometry.

def pow2_bucket(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor): the static length class a
    ragged length is padded into."""
    assert n >= 0 and floor >= 1
    b = 1 << max(n - 1, floor - 1, 0).bit_length()
    return max(b, floor)


def bucket_avals(cfg: AlignerConfig, lanes: int, read_bucket: int,
                 ref_bucket: int, rescue_rounds: int = 0):
    """The (shape, dtype) of each of one bucket's four inputs (reads,
    read_len, refs, ref_len): what a session's executable accepts and
    nothing else (see repro_torch.api.session)."""
    Lr, Lf = pad_geometry(cfg, read_bucket, ref_bucket, rescue_rounds)
    return (((lanes, Lr), torch.uint8), ((lanes,), torch.int32),
            ((lanes, Lf), torch.uint8), ((lanes,), torch.int32))


#: Hopper lane-tile planning constants (NVIDIA H100 SXM): SMs, the shared
#: memory and threads one SM holds, the shared memory the card reserves
#: for each resident block, and the resident blocks an SM allows
H100_SMS = 132
SM_SHARED_BYTES = 233_472
SM_THREADS = 2048
BLOCK_RESERVED_SHARED_BYTES = 1024
SM_MAX_BLOCKS = 32


def plan_lane_tile(cfg: AlignerConfig, sms: int = H100_SMS,
                   sm_shared_bytes: int = SM_SHARED_BYTES,
                   sm_threads: int = SM_THREADS) -> int:
    """The lanes one wave of K1 holds at `cfg`'s geometry: ``sms`` SMs x
    K1 blocks per SM x lanes per block, with the block from
    ``kernels.genasm_dc.tb_fused_geometry``.  Blocks per SM: as many as
    the SM's shared memory holds at the block's dynamic shared bytes plus
    the 1 KB the card reserves per block, and its threads, at most 32.
    Registers are not modelled: at the default geometry (W=64, k=12)
    shared memory binds first, 7 blocks of 8 lanes, 7,392 lanes.  Plain
    arithmetic, the same on the CPU and the card.

    ``plan(..., lane_tile='auto')`` resolves to this (``resolve_config``);
    in the port ``lane_tile`` is only the batch pad unit.  Raises
    ValueError, naming W, k and the bytes, where K1 fits no block (and
    where the kernels are not instantiated for `cfg`)."""
    geo = tb_fused_geometry(cfg)
    per_block = geo.shared_bytes + BLOCK_RESERVED_SHARED_BYTES
    blocks = min(sm_shared_bytes // per_block, sm_threads // geo.threads,
                 SM_MAX_BLOCKS)
    if blocks == 0:
        raise ValueError(
            f"W={cfg.W} k={cfg.k}: one K1 block of {geo.lanes} lane(s) "
            f"needs {per_block:,} bytes of shared memory (reserve "
            f"included) but an SM has sm_shared_bytes={sm_shared_bytes:,}")
    return sms * blocks * geo.lanes


def _slice_rev(seq, pos, width: int, length):
    """Per row: seq[pos:pos+width] reversed, with the `length` real chars
    packed at the front (sentinel padding after).  The start clamps into
    the row like the reference's ``dynamic_slice``."""
    p = torch.clamp(pos.long(), 0, seq.shape[1] - width)
    t = torch.arange(width, device=seq.device)
    src = (t[None, :] + (width - length.long())[:, None]) % width
    return torch.gather(seq, 1, p[:, None] + width - 1 - src)


def _append_ops(buf, off, ops, nops, active):
    """Scatter window ops into the per-row op buffer at offset `off`, in
    place.  ``buf``'s last column is a drop slot for ops that fall outside
    (the reference's ``mode='drop'``); callers slice it off."""
    max_w = ops.shape[1]
    ar = torch.arange(max_w, device=buf.device)
    pos = off.long()[:, None] + ar[None, :]
    drop = buf.shape[1] - 1
    valid = (ar[None, :] < nops[:, None]) & active[:, None] & (pos < drop)
    buf.scatter_(1, torch.where(valid, pos, drop), ops)
    return buf


def _shard_pass(reads, read_len, refs, ref_len, cfg: AlignerConfig,
                max_read_len: int):
    """One shard's pass of one rung, as a generator: each ``next()`` runs
    one main window; the return value is the shard's outputs, with its
    per-window level counts ``levels`` ((nm,) int32, on its device, no
    host sync).  The geometry (nm, op budget, tail width) comes from the
    batch-wide `max_read_len` and the arrays' widths, never from the
    shard's own lanes."""
    B = reads.shape[0]
    dev = reads.device
    W, k, stride = cfg.W, cfg.k, cfg.stride
    nm = n_main_windows(max_read_len, cfg)
    wt = self_tail_width(cfg)
    op_budget = total_op_budget(max_read_len, cfg)
    read_len = read_len.to(torch.int32)
    ref_len = ref_len.to(torch.int32)

    def zeros():
        return torch.zeros(B, dtype=torch.int32, device=dev)

    read_pos, ref_pos, off, dist = zeros(), zeros(), zeros(), zeros()
    failed = torch.zeros(B, dtype=torch.bool, device=dev)
    levels = []
    buf = torch.full((B, op_budget + 1), OP_NONE, dtype=torch.uint8,
                     device=dev)
    wfull = torch.full((B,), W, dtype=torch.int32, device=dev)
    for _ in range(nm):
        active = (read_len - read_pos > W) & ~failed
        pat = _slice_rev(reads, read_pos, W, wfull)
        txt = _slice_rev(refs, ref_pos, W, wfull)
        if cfg.backend == "fused":
            tb = genasm_tb_fused_op(pat, txt, cfg=cfg, commit_limit=stride,
                                    max_ops=cfg.tb_max_ops,
                                    max_steps=cfg.tb_max_steps)
            solved, levels_run = tb["solved"], tb["levels"]
        else:
            res = dc(pat, txt, wfull, wfull, cfg)
            tb = traceback(res.store, pat, txt, wfull, wfull, res.dist,
                           stride, cfg=cfg, mode=cfg.store,
                           max_ops=cfg.tb_max_ops,
                           max_steps=cfg.tb_max_steps)
            solved, levels_run = res.solved, res.levels_run
        commit = active & solved
        _append_ops(buf, off, tb["ops"], torch.where(commit, tb["n_ops"], 0),
                    commit)
        read_pos = torch.where(commit, read_pos + tb["read_adv"], read_pos)
        ref_pos = torch.where(commit, ref_pos + tb["ref_adv"], ref_pos)
        off = torch.where(commit, off + tb["n_ops"], off)
        dist = torch.where(commit, dist + tb["cost"], dist)
        failed = failed | (active & ~solved)
        levels.append(levels_run.to(torch.int32))
        yield

    # ---- tail window: remaining read (in (O, W]) vs remaining ref ----
    m_tail = torch.clamp(read_len - read_pos, 0, W)
    n_rem = ref_len - ref_pos
    n_tail = torch.clamp(n_rem, 0, wt)
    tail_bad = (n_rem > wt) | (n_rem < torch.clamp(m_tail - 2 * k, min=0))
    pat_t = _slice_rev(reads, read_pos, W, m_tail)
    txt_t = _slice_rev(refs, ref_pos, wt, n_tail)
    if cfg.backend == "fused":
        tb_t = genasm_tail_fused_op(pat_t, txt_t, m_tail, n_tail, cfg=cfg,
                                    n_text=wt, commit_limit=2 * (W + wt),
                                    max_ops=W + wt, max_steps=W + wt + 4)
        solved_t = tb_t["solved"]
    else:
        # the tail has no kernel on these backends: the full SENE fill and
        # the 'and' traceback, as in the reference
        res_t = dc_jmajor(pat_t, txt_t, m_tail, n_tail, k=k, n=wt, nw=cfg.nw,
                          store="and")
        tb_t = traceback(res_t.store, pat_t, txt_t, m_tail, n_tail,
                         res_t.dist, 2 * (W + wt), cfg=cfg, mode="and",
                         max_ops=W + wt, max_steps=W + wt + 4)
        solved_t = res_t.solved
    t_ok = ~failed & ~tail_bad & solved_t
    _append_ops(buf, off, tb_t["ops"], torch.where(t_ok, tb_t["n_ops"], 0),
                t_ok)
    return {
        "ops": buf[:, :op_budget],
        "n_ops": torch.where(t_ok, off + tb_t["n_ops"], off),
        "dist": torch.where(t_ok, dist + tb_t["cost"], dist),
        "failed": failed | tail_bad | ~solved_t,
        "read_consumed": torch.where(t_ok, read_pos + tb_t["read_adv"],
                                     read_pos),
        "ref_consumed": torch.where(t_ok, ref_pos + tb_t["ref_adv"], ref_pos),
        "levels": (torch.stack(levels) if levels else
                   torch.zeros(0, dtype=torch.int32, device=dev)),
    }


def shard_rung(reads, read_len, refs, ref_len, cfg: AlignerConfig,
               max_read_len: int) -> dict:
    """One shard's whole pass of one rung (``_shard_pass`` run to its
    end): what a session's CUDA graph of one shard captures
    (``serve.graphs``); no host sync."""
    gen = _shard_pass(reads, read_len, refs, ref_len, cfg, max_read_len)
    try:
        while True:
            next(gen)
    except StopIteration as done:
        return done.value


def rung_levels(levels: list):
    """A rung's level count from each shard's per-window levels: the sum
    over windows of the maximum over shards, a 0-d int32 tensor on the
    first shard's device."""
    dev = levels[0].device
    return torch.stack([lv.to(dev) for lv in levels]).amax(0).sum(
        dtype=torch.int32)


def _rung(shards, cfg: AlignerConfig, max_read_len: int):
    """One rung over every shard, the windows in lockstep: window w of
    shard 0, then of shard 1, and so on, each shard on its device's
    current stream, so the devices of a multi-GPU mesh run together.
    Returns the shards' outputs and the rung's level count
    (``rung_levels``)."""
    passes = [_shard_pass(*shard, cfg, max_read_len) for shard in shards]
    outs = [None] * len(passes)
    live = list(range(len(passes)))
    while live:
        for i in list(live):
            try:
                next(passes[i])
            except StopIteration as done:
                outs[i] = done.value
                live.remove(i)
    return outs, rung_levels([o.pop("levels") for o in outs])


def _shards_of(args, mesh) -> list:
    """The batch as (reads, read_len, refs, ref_len) a shard: the one
    batch without a mesh, else the per-shard tensors ``args`` hold."""
    if mesh is None:
        return [tuple(args)]
    check_shards(args, mesh)
    return list(zip(*args))


def unshard(outs: list, mesh, keys) -> dict:
    """Per-lane outputs as the caller gave the inputs: tensors without a
    mesh, tuples of per-shard tensors on one."""
    if mesh is None:
        return {key: outs[0][key] for key in keys}
    return {key: tuple(o[key] for o in outs) for key in keys}


LANE_KEYS = ("ops", "n_ops", "dist", "failed", "read_consumed",
             "ref_consumed")


def align_pairs(reads, read_len, refs, ref_len, *, cfg: AlignerConfig,
                max_read_len: int, mesh=None) -> dict:
    """Batched windowed alignment on the device of the inputs.

    reads: (B, Lr) uint8 codes, sentinel-padded by >= W past read_len;
    refs: (B, Lf) uint8 codes, sentinel-padded by >= W+4k past ref_len.
    Returns the op buffer, n_ops, dist, failed, read/ref consumption and
    the level count summed over windows (a 0-d tensor).

    `mesh` (a ``launch.mesh.DeviceMesh``): each input is a tuple of one
    tensor a pair shard, each on its shard's device
    (``transfer.to_device(..., shards=sharding.pair_shards(B, cfg,
    mesh))``), and so is each per-lane output; every shard runs the
    batch's `max_read_len` geometry, and ``levels_run_total`` sums each
    window's maximum over all shards.  Equal to the unsharded run."""
    outs, levels = _rung(_shards_of((reads, read_len, refs, ref_len), mesh),
                         cfg, max_read_len)
    return {**unshard(outs, mesh, LANE_KEYS), "levels_run_total": levels,
            "n_main_windows": n_main_windows(max_read_len, cfg)}


def any_failed(failed: list) -> bool:
    """The round gate: whether any lane of any shard is still failed, read
    in one device-to-host sync."""
    dev = failed[0].device
    return bool(torch.stack([f.any().to(dev) for f in failed]).any())


def ladder_start(B: int, device, budget: int) -> dict:
    """A shard's ladder state before round 0: every lane failed, no op."""
    st = {key: torch.zeros(B, dtype=torch.int32, device=device) for key in (
        "n_ops", "dist", "read_consumed", "ref_consumed", "k_used")}
    st["ops"] = torch.full((B, budget), OP_NONE, dtype=torch.uint8,
                           device=device)
    st["failed"] = torch.ones(B, dtype=torch.bool, device=device)
    return st


def ladder_merge(st: dict, out: dict, cfg_r: AlignerConfig, final: bool,
                 budget: int) -> dict:
    """A shard's ladder state after a round at `cfg_r` whose outputs are
    `out`: lanes the round newly solved take its results (and k_used);
    the `final` round also merges the partial progress of still-failed
    lanes, so rescue_rounds=0 equals align_pairs.  No host sync."""
    newly = st["failed"] & ~out["failed"]
    upd = newly | (st["failed"] & out["failed"]) if final else newly
    ops_r = torch.nn.functional.pad(
        out["ops"], (0, budget - out["ops"].shape[1]), value=OP_NONE)
    new = {"ops": torch.where(upd[:, None], ops_r, st["ops"])}
    for key in ("n_ops", "dist", "read_consumed", "ref_consumed"):
        new[key] = torch.where(upd, out[key], st[key])
    new["k_used"] = torch.where(newly, cfg_r.k, st["k_used"])
    new["failed"] = st["failed"] & out["failed"]
    return new


def align_pairs_rescued(reads, read_len, refs, ref_len, *,
                        cfg: AlignerConfig, max_read_len: int,
                        rescue_rounds: int = 2, mesh=None) -> dict:
    """Multi-round k-doubling rescue on the device: round 0 is plain
    ``align_pairs``; each later round re-runs the whole batch with doubled
    k, and a per-lane mask freezes lanes already solved (``ladder_merge``).
    A round runs only while some lane is still failed (the host gate, one
    sync per later round); a skipped round would change nothing, and
    neither would any round after it.

    refs must be sentinel-padded for the FINAL round's tail width.  Returns
    the align_pairs dict plus k_used (0 where never solved), rounds_run,
    n_rounds and gate_syncs.

    `mesh`: as for ``align_pairs``.  Each shard's state stays on its
    device for the whole ladder; the gate is global, so a later round runs
    on every shard while any lane of any shard is failed (its solved lanes
    frozen, their levels still counted), as in the reference."""
    cfgs = rescue_schedule(cfg, rescue_rounds)
    shards = _shards_of((reads, read_len, refs, ref_len), mesh)
    budget = total_op_budget(max_read_len, cfgs[-1])
    state = [ladder_start(shard[0].shape[0], shard[0].device, budget)
             for shard in shards]
    levels = torch.zeros((), dtype=torch.int32, device=shards[0][0].device)
    rounds_run = gate_syncs = 0
    for rnd, cfg_r in enumerate(cfgs):
        if rnd > 0:
            gate_syncs += 1
            if not any_failed([st["failed"] for st in state]):
                break
        outs, lv = _rung(shards, cfg_r, max_read_len)
        state = [ladder_merge(st, out, cfg_r, rnd == len(cfgs) - 1, budget)
                 for st, out in zip(state, outs)]
        levels = levels + lv
        rounds_run += 1
    return {**unshard(state, mesh, LANE_KEYS + ("k_used",)),
            "levels_run_total": levels, "rounds_run": rounds_run,
            "n_rounds": len(cfgs), "gate_syncs": gate_syncs}
