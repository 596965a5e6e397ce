"""The main-window loop's own work around K1 (``csrc/window_step.cu``).

Each main window of backend 'fused' is three launches: ``window_prep``
(the window's reversed read and reference slices as K1's pattern masks and
text), K1 (``genasm_dc.genasm_tb_fused``) and ``window_commit`` (K1's ops
appended to the pass's op buffer, the lanes' positions, offsets,
distances and failures advanced, the window's level count kept).  They
port the body of the reference's main-window scan around its Pallas call
(``append_main`` in ``repro/core/windowing.py``): ``_slice_rev``, the ops
layer's ``_pad_to_tile`` / ``_to_kernel_layout``, ``_append_ops`` and the
state's ``jnp.where`` updates, which XLA fuses.  In plain PyTorch those
are some 75 small ops a window; a session's CUDA graph holds each as a
node, and a graph's launch costs host time by its nodes.

``window_prep_plain`` and ``window_commit_plain`` are the plain PyTorch
versions.  On CPU tensors the wrappers run them; on CUDA tensors they
launch the kernels or raise.  ``LAUNCHES`` counts the kernels' launches
(through ``genasm_dc``'s counting, so a captured graph's replays count
them), ``PLAIN_CALLS`` the plain versions' calls.  The commit updates the
state in place, in both versions.  Nothing here builds or loads the
library at import.
"""
from __future__ import annotations

import torch

from ..core.config import AlignerConfig
from . import genasm_dc
from .ops import _pad_to_tile, _to_kernel_layout, _unpack_meta

KERNELS = ("window_prep", "window_commit")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
genasm_dc.register_counts(LAUNCHES, PLAIN_CALLS)
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
    """The plain version of ``window_prep``."""
    B = reads.shape[0]
    wfull = torch.full((B,), cfg.W, dtype=torch.int32, device=reads.device)
    pat = slice_rev(reads, read_pos, cfg.W, wfull)
    txt = slice_rev(refs, ref_pos, cfg.W, wfull)
    return _to_kernel_layout(*_pad_to_tile(pat, txt, cfg.lane_tile), cfg)


def window_commit_plain(ops_k, meta, state: dict, read_len, *,
                        cfg: AlignerConfig, window: int) -> None:
    """The plain version of ``window_commit``."""
    B = read_len.shape[0]
    tb = _unpack_meta(ops_k.T[:B].to(torch.uint8), meta[:, :B], cfg)
    advance(state, tb, tb["solved"], tb["levels"], read_len, cfg.W, window)


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


def _cuda(device) -> bool:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain version for device "
                         f"{device}: pass CPU or CUDA tensors")
    return device.type == "cuda"


def _launch(name: str, *args) -> None:
    lib = genasm_dc._library()
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        genasm_dc._count_launch(name, LAUNCHES)
        rc = getattr(lib, f"genasm_{name}_launch")(
            *[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], stream)
    genasm_dc._check_rc(lib, f"genasm_{name} kernel launch", rc)


def window_prep(reads, refs, read_pos, ref_pos, *, cfg: AlignerConfig):
    """One main window's K1 inputs: the (B, W) reversed slices of `reads`
    (B, Lr) and `refs` (B, Lf) uint8 at `read_pos` / `ref_pos` (B,) int32
    (each start clamped into its row), as pm (5, NW, Bp) and text (W, Bp)
    int32, Bp = B padded to ``cfg.lane_tile`` with all-'A' lanes."""
    device = reads.device
    B = reads.shape[0]
    _check("reads", reads, torch.uint8, (B, reads.shape[1]), device)
    _check("refs", refs, torch.uint8, (B, refs.shape[1]), device)
    for name, t in (("read_pos", read_pos), ("ref_pos", ref_pos)):
        _check(name, t, torch.int32, (B,), device)
    if not _cuda(device):
        genasm_dc._bump(PLAIN_CALLS, "window_prep")
        return window_prep_plain(reads, refs, read_pos, ref_pos, cfg=cfg)
    Bp = B + (-B) % cfg.lane_tile
    pm = torch.empty((5, cfg.nw, Bp), dtype=torch.int32, device=device)
    text = torch.empty((cfg.W, Bp), dtype=torch.int32, device=device)
    _launch("window_prep", reads, refs, read_pos, ref_pos, pm, text,
            reads.shape[1], refs.shape[1], B, Bp, cfg.W, cfg.nw)
    return pm, text


def window_commit(ops_k, meta, state: dict, read_len, *, cfg: AlignerConfig,
                  window: int) -> None:
    """Commit K1's outputs of main window `window` (ops (max_ops, Bp),
    meta (META_ROWS, Bp) int32) into the pass's `state`, in place:
    ``read_pos``, ``ref_pos``, ``off``, ``dist`` (B,) int32, ``failed``
    (B,) bool, ``buf`` (B, budget + 1) uint8 (its last column the drop
    slot) and ``levels`` (windows,) int32, whose entry `window` becomes
    the max of the lanes' level counts (the kernel takes the max into it:
    it must hold ``LEVELS_FLOOR``).  `read_len` (B,) int32."""
    device = read_len.device
    B = read_len.shape[0]
    Bp = ops_k.shape[1]
    _check("ops", ops_k, torch.int32, (ops_k.shape[0], Bp), device)
    _check("meta", meta, torch.int32, (genasm_dc.META_ROWS, Bp), device)
    _check("read_len", read_len, torch.int32, (B,), device)
    for key in ("read_pos", "ref_pos", "off", "dist"):
        _check(key, state[key], torch.int32, (B,), device)
    _check("failed", state["failed"], torch.bool, (B,), device)
    buf, levels = state["buf"], state["levels"]
    _check("buf", buf, torch.uint8, (B, buf.shape[1]), device)
    _check("levels", levels, torch.int32, (levels.shape[0],), device)
    if Bp < B or not 0 <= window < levels.shape[0]:
        raise ValueError(f"{Bp} kernel lanes for {B} pairs, window {window} "
                         f"of {levels.shape[0]}")
    if not _cuda(device):
        genasm_dc._bump(PLAIN_CALLS, "window_commit")
        window_commit_plain(ops_k, meta, state, read_len, cfg=cfg,
                            window=window)
        return
    _launch("window_commit", ops_k, meta, read_len, state["read_pos"],
            state["ref_pos"], state["off"], state["dist"], state["failed"],
            buf, levels[window:window + 1], B, Bp, cfg.W, cfg.k,
            ops_k.shape[0], buf.shape[1])
