"""Windowed long-read alignment (port of ``repro/core/windowing.py``).

A (read, ref-segment) pair is aligned as a sequence of W x W windows: DC+TB
inside the window on *reversed* contents (so the traceback emits
front-first ops), commit the first W-O read characters' worth of ops,
advance, repeat; the final <= W read chars align in one tail window
against the remaining reference.  All pairs advance in lockstep; pairs
whose window edit distance exceeds k are flagged ``failed``.

Two decisions of the port (see PERF.md):

* the reference's ``lax.scan`` over the main windows is a Python loop with
  one DC launch per window (K1 on backend 'fused', K3 on 'split'); every
  intermediate stays on the device;
* the reference's on-device round gate ``lax.cond(any(failed))`` is a host
  check of ``failed.any()`` before each rescue round.  It is the one
  device-to-host sync of the ladder, counted in the returned
  ``gate_syncs``.
"""
from __future__ import annotations

import dataclasses

import torch

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


def align_pairs(reads, read_len, refs, ref_len, *, cfg: AlignerConfig,
                max_read_len: int) -> dict:
    """Batched windowed alignment on the device of the inputs.

    reads: (B, Lr) uint8 codes, sentinel-padded by >= W past read_len;
    refs: (B, Lf) uint8 codes, sentinel-padded by >= W+4k past ref_len.
    Returns the op buffer, n_ops, dist, failed, read/ref consumption and
    the level count summed over windows (a 0-d tensor)."""
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
    levels = torch.zeros((), dtype=torch.int32, device=dev)
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
        levels = levels + levels_run

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
        "levels_run_total": levels,
        "n_main_windows": nm,
    }


def align_pairs_rescued(reads, read_len, refs, ref_len, *,
                        cfg: AlignerConfig, max_read_len: int,
                        rescue_rounds: int = 2) -> dict:
    """Multi-round k-doubling rescue on the device: round 0 is plain
    ``align_pairs``; each later round re-runs the whole batch with doubled
    k, and a per-lane mask freezes lanes already solved.  A round runs only
    while some lane is still failed (the host gate, one sync per later
    round); a skipped round would change nothing, and neither would any
    round after it.

    refs must be sentinel-padded for the FINAL round's tail width.  Returns
    the align_pairs dict plus k_used (0 where never solved), rounds_run,
    n_rounds and gate_syncs."""
    cfgs = rescue_schedule(cfg, rescue_rounds)
    B = reads.shape[0]
    dev = reads.device
    budget = total_op_budget(max_read_len, cfgs[-1])

    def zeros():
        return torch.zeros(B, dtype=torch.int32, device=dev)

    ops = torch.full((B, budget), OP_NONE, dtype=torch.uint8, device=dev)
    n_ops, dist, rcon, fcon, k_used = zeros(), zeros(), zeros(), zeros(), zeros()
    failed = torch.ones(B, dtype=torch.bool, device=dev)
    levels = torch.zeros((), dtype=torch.int32, device=dev)
    rounds_run = gate_syncs = 0
    for rnd, cfg_r in enumerate(cfgs):
        if rnd > 0:
            gate_syncs += 1
            if not bool(failed.any()):
                break
        out = align_pairs(reads, read_len, refs, ref_len, cfg=cfg_r,
                          max_read_len=max_read_len)
        newly = failed & ~out["failed"]
        # the final round also merges the partial progress of still-failed
        # lanes, so rescue_rounds=0 equals plain align_pairs
        upd = newly
        if rnd == len(cfgs) - 1:
            upd = newly | (failed & out["failed"])
        ops_r = torch.nn.functional.pad(
            out["ops"], (0, budget - out["ops"].shape[1]), value=OP_NONE)
        ops = torch.where(upd[:, None], ops_r, ops)
        n_ops = torch.where(upd, out["n_ops"], n_ops)
        dist = torch.where(upd, out["dist"], dist)
        rcon = torch.where(upd, out["read_consumed"], rcon)
        fcon = torch.where(upd, out["ref_consumed"], fcon)
        k_used = torch.where(newly, cfg_r.k, k_used)
        failed = failed & out["failed"]
        levels = levels + out["levels_run_total"]
        rounds_run += 1
    return {"ops": ops, "n_ops": n_ops, "dist": dist, "failed": failed,
            "k_used": k_used, "read_consumed": rcon, "ref_consumed": fcon,
            "levels_run_total": levels, "rounds_run": rounds_run,
            "n_rounds": len(cfgs), "gate_syncs": gate_syncs}
