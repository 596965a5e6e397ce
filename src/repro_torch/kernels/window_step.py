"""One main window of backend 'fused' in one launch: K1's window form.

``genasm_tb_window`` runs the body of the reference's main-window scan
(``append_main`` in ``repro/core/windowing.py``) as one launch of K1
(``csrc/tb_fused.cuh``; where ``genasm_dc.kernel_family`` names the wide
family, W >= 129, ``csrc/tb_fused_xwide.cu``): K1 reads
each lane's reversed W-base slices of the reads and references at its
positions (the reference's ``_slice_rev``), builds the pattern masks and
text in shared memory (the ops layer's ``_pad_to_tile`` /
``_to_kernel_layout``), fills, walks, and commits its ops and state into
the pass's op buffer and state in place (``_append_ops`` and the state's
``jnp.where`` updates, which XLA fuses on the TPU).  So a main window is
one launch, and one node of a session's CUDA graph.

``tb_window_plain`` is its plain PyTorch version: ``window_prep_plain``,
``genasm_dc.tb_fused_plain`` and ``window_commit_plain`` composed.  On CPU
tensors the entry runs it; on CUDA tensors it launches the kernel or
raises.  It counts under K1's name: one ``genasm_dc.LAUNCHES["tb_fused"]``
or ``genasm_dc.PLAIN_CALLS["tb_fused"]`` a window.  The split and plain
backends use the plain pieces here (``slice_rev``, ``advance``,
``append_ops``).  Nothing here builds or loads the library at import.
"""
from __future__ import annotations

import torch

from ..core.config import AlignerConfig
from . import genasm_dc
from .ops import _pad_to_tile, _to_kernel_layout, _unpack_meta

#: where a pass's per-window level counts start: below any count, so the
#: kernel's running max over lanes equals the plain version's max
LEVELS_FLOOR = -(2 ** 31)


def slice_rev(seq, pos, width: int, length):
    """Per row: seq[pos:pos+width] reversed, with the `length` real chars
    packed at the front (sentinel padding after).  The start clamps into
    the row like the reference's ``dynamic_slice``."""
    p = torch.clamp(pos.long(), 0, seq.shape[1] - width)
    t = torch.arange(width, device=seq.device)
    src = (t[None, :] + (width - length.long())[:, None]) % width
    return torch.gather(seq, 1, p[:, None] + width - 1 - src)


def append_ops(buf, off, ops, nops, active):
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


def advance(state: dict, tb: dict, solved, levels_run, read_len, W: int,
            window: int) -> None:
    """Commit one main window's traceback `tb` (standard layout: ops
    (B, max_ops) uint8, n_ops, read_adv, ref_adv, cost) into the pass's
    `state` in place (``read_pos``, ``ref_pos``, ``off``, ``dist``,
    ``failed``, ``buf``, ``levels``), as the reference's scan body does;
    ``levels[window]`` takes `levels_run`."""
    read_pos, failed = state["read_pos"], state["failed"]
    active = (read_len - read_pos > W) & ~failed
    commit = active & solved
    append_ops(state["buf"], state["off"], tb["ops"],
               torch.where(commit, tb["n_ops"], 0), commit)
    for key, step in (("read_pos", "read_adv"), ("ref_pos", "ref_adv"),
                      ("off", "n_ops"), ("dist", "cost")):
        state[key].copy_(torch.where(commit, state[key] + tb[step],
                                     state[key]))
    failed.copy_(failed | (active & ~solved))
    state["levels"].select(0, window).copy_(levels_run)


def window_prep_plain(reads, refs, read_pos, ref_pos, *,
                      cfg: AlignerConfig):
    """One main window's K1 inputs: the (B, W) reversed slices of `reads`
    (B, Lr) and `refs` (B, Lf) uint8 at `read_pos` / `ref_pos` (B,) int32
    (each start clamped into its row), as pm (5, NW, Bp) and text (W, Bp)
    int32, Bp = B padded to ``cfg.lane_tile`` with all-'A' lanes."""
    B = reads.shape[0]
    wfull = torch.full((B,), cfg.W, dtype=torch.int32, device=reads.device)
    pat = slice_rev(reads, read_pos, cfg.W, wfull)
    txt = slice_rev(refs, ref_pos, cfg.W, wfull)
    return _to_kernel_layout(*_pad_to_tile(pat, txt, cfg.lane_tile), cfg)


def window_commit_plain(ops_k, meta, state: dict, read_len, *,
                        cfg: AlignerConfig, window: int) -> None:
    """Commit K1's outputs of main window `window` (ops (max_ops, Bp),
    meta (META_ROWS, Bp) int32, Bp >= B) into the pass's `state`, in
    place (``advance``); ``levels[window]`` becomes the max of the first
    B lanes' level counts."""
    B = read_len.shape[0]
    tb = _unpack_meta(ops_k.T[:B].to(torch.uint8), meta[:, :B], cfg)
    advance(state, tb, tb["solved"], tb["levels"], read_len, cfg.W, window)


def tb_window_plain(reads, refs, read_len, state: dict, *,
                    cfg: AlignerConfig, window: int) -> None:
    """The plain version of ``genasm_tb_window``: ``window_prep_plain``,
    K1's plain version and ``window_commit_plain``."""
    pm, text = window_prep_plain(reads, refs, state["read_pos"],
                                 state["ref_pos"], cfg=cfg)
    ops, meta = genasm_dc.tb_fused_plain(
        pm, text, cfg=cfg, commit_limit=cfg.stride, max_ops=cfg.tb_max_ops,
        max_steps=cfg.tb_max_steps)
    window_commit_plain(ops, meta, state, read_len, cfg=cfg, window=window)


def _check(name: str, t, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def genasm_tb_window(reads, refs, read_len, state: dict, *,
                     cfg: AlignerConfig, window: int) -> None:
    """Main window `window` of the fused loop in one launch of K1: the
    (B, W) reversed slices of `reads` (B, Lr) and `refs` (B, Lf) uint8 at
    the state's ``read_pos`` / ``ref_pos`` (each start clamped into its
    row), K1's fill and walk, and the commit into the pass's `state`, in
    place: ``read_pos``, ``ref_pos``, ``off``, ``dist`` (B,) int32,
    ``failed`` (B,) bool, ``buf`` (B, budget + 1) uint8 (its last column
    the drop slot) and ``levels`` (windows,) int32, whose entry `window`
    becomes the max of the lanes' level counts (the kernel takes the max
    into it: it must hold ``LEVELS_FLOOR``).  `read_len` (B,) int32.
    The kernel runs the B lanes only; the plain version pads them to
    ``cfg.lane_tile``, which changes no output."""
    device = reads.device
    B = reads.shape[0]
    _check("reads", reads, torch.uint8, (B, reads.shape[1]), device)
    _check("refs", refs, torch.uint8, (B, refs.shape[1]), device)
    _check("read_len", read_len, torch.int32, (B,), device)
    for key in ("read_pos", "ref_pos", "off", "dist"):
        _check(key, state[key], torch.int32, (B,), device)
    _check("failed", state["failed"], torch.bool, (B,), device)
    buf, levels = state["buf"], state["levels"]
    _check("buf", buf, torch.uint8, (B, buf.shape[1]), device)
    _check("levels", levels, torch.int32, (levels.shape[0],), device)
    if min(reads.shape[1], refs.shape[1]) < cfg.W or buf.shape[1] < 1 or \
            not 0 <= window < levels.shape[0]:
        raise ValueError(f"reads of {reads.shape[1]} and refs of "
                         f"{refs.shape[1]} columns for W={cfg.W}, a buffer "
                         f"of {buf.shape[1]}, window {window} of "
                         f"{levels.shape[0]}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain version for device "
                         f"{device}: pass CPU or CUDA tensors")
    if device.type == "cpu":
        genasm_dc._bump(genasm_dc.PLAIN_CALLS, "tb_fused")
        tb_window_plain(reads, refs, read_len, state, cfg=cfg, window=window)
        return
    if not B:
        return
    tensors = (reads, refs, read_len, state["read_pos"], state["ref_pos"],
               state["off"], state["dist"], state["failed"], buf,
               levels[window:window + 1])
    ints = (B, reads.shape[1], refs.shape[1], buf.shape[1], cfg.W, cfg.nw,
            cfg.k, cfg.nwb, cfg.ncols_band, int(cfg.early_term), cfg.stride,
            cfg.tb_max_ops, cfg.tb_max_steps)
    if genasm_dc.kernel_family(cfg, "tb_fused") == "xwide":
        genasm_dc._xwide_launch("tb_fused", cfg, tensors, ints, B=B,
                                entry="tb_window_xwide")
        return
    geo = genasm_dc.tb_fused_geometry(cfg, window=True)
    genasm_dc._launch(
        "tb_fused", *tensors, genasm_dc._store(B, geo.store_words, device),
        ints=ints, block=(geo.lanes, geo.threads,
                          genasm_dc.PLACEMENTS.index(geo.placement),
                          geo.shared_bytes),
        entry="tb_window")
