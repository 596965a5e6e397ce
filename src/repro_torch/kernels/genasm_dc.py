"""The fused GenASM-DC+TB kernels: wrappers, launch counts and plain versions.

Three kernels, each a port of a Pallas TPU kernel of
``repro/kernels/genasm_dc.py`` and written by hand in CUDA C++ in
``csrc/genasm_fused.cu``:

  * K1 ``genasm_tb_fused``    <- ``_kernel_fused``: improved GenASM-DC
    (SENE + DENT + ET) of a square W x W window, then the traceback walked
    in the same kernel over the stored DENT band.
  * K2 ``genasm_tail_banded`` <- ``_kernel_tail_banded``: the ragged
    rectangular tail (m_len <= W pattern chars against n_len <= n_text
    text chars) with a per-lane diagonal band store.
  * K4 ``genasm_tail_full``   <- ``_kernel_tail_fused``: the same tail with
    the full (k+1, n_text+1, NW) SENE store, taken when the band is no
    strict win (``cfg.tail_banded`` False: every rescue rung at W=64).

Layout as on the TPU: one problem per lane, lanes innermost.  Inputs are
``pm (5, NW, B)`` int32 (the 0-active pattern masks' bits, row 4 all ones),
``text (n, B)`` int32 and, for the tails, ``m_len``/``n_len`` ``(1, B)``
int32.  Outputs are ``ops (max_ops, B)`` int32, front-first, padded with
OP_NONE, and ``meta (META_ROWS, B)`` int32 (rows ``META_*``).

``META_LVL`` holds, per lane, ``min(dist, k) + 1`` with early termination
and ``k + 1`` without; the TPU kernel wrote the same statistic per lane
tile.  Only its maximum over the batch is ever read (``ops._unpack_meta``),
and both give ``min(max dist, k) + 1`` there, so the results agree.

Each wrapper checks device, dtype, shape and contiguity.  For a CPU tensor
it runs the kernel's plain PyTorch version (vectorised over lanes, the
reference's arithmetic, words as int64 in [0, 2**32)); for a CUDA tensor it
launches the kernel and raises if the launch fails; any other device
raises.  ``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls of
the plain versions, one per wrapper call, so a run can show which path did
the work.
"""
from __future__ import annotations

import torch

from ..core.bitops import (MASK32, WORD_BITS, extract_window, from_bits32,
                           ones_below, shift1)
from ..core.config import AlignerConfig
from ..core.oracle import OP_DEL, OP_INS, OP_MATCH, OP_NONE, OP_SUBST

# meta row layout of the fused kernels (8 rows, as on the TPU)
META_DIST, META_LVL, META_NOPS, META_RD, META_RF, META_DFIN, META_OK = range(7)
META_ROWS = 8

KERNELS = ("tb_fused", "tail_banded", "tail_full")
#: kernel launches per wrapper; plain-version calls per wrapper
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0


# --------------------------------------------------------------------------
# plain PyTorch versions: a bitvector is a (B, NW) int64 tensor of words,
# the layout of core.bitops
# --------------------------------------------------------------------------

def _pm_lookup(pmw, cj):
    """(B, NW) mask words of text chars cj (B,) from pmw (B, 5, NW); codes
    outside the alphabet select all ones."""
    valid = (cj >= 0) & (cj < 4)
    words = pmw[torch.arange(cj.shape[0], device=cj.device),
                torch.where(valid, cj, 0)]
    return torch.where(valid[:, None], words, MASK32)


def _column0(k: int, nw: int, B: int, device):
    """Column 0 of every level: R_0[d] = ones_below(d)."""
    return [ones_below(d, nw, device).expand(B, nw) for d in range(k + 1)]


def _next_column(prev, pm_j, t: int, k: int):
    """All k+1 levels of column j from column j-1 (SENE recurrence);
    t = j - 1 is the text index."""
    cur = [shift1(prev[0], int(t > 0)) | pm_j]
    for d in range(1, k + 1):
        M = shift1(prev[d], int(t > d)) | pm_j
        S = shift1(prev[d - 1], int(t >= d))
        I = shift1(cur[d - 1], int(t >= d - 1))
        cur.append(M & S & prev[d - 1] & I)
    return cur


def _first_hit(stack, bit_idx, guard, k: int):
    """dist = lowest level of the (k+1, B, NW) stack whose bit ``bit_idx``
    (B,) is 0 where ``guard``, else k+1."""
    idx = (bit_idx // WORD_BITS)[None, :, None].expand(stack.shape[0], -1, 1)
    word = torch.gather(stack, 2, idx)[..., 0]
    hit = (((word >> (bit_idx % WORD_BITS)) & 1) == 0) & guard
    levels = torch.arange(k + 1, device=stack.device)[:, None]
    return torch.where(hit, levels, k + 1).min(dim=0).values


def _d_end(dist, cfg: AlignerConfig):
    if cfg.early_term:
        return torch.clamp(dist, max=cfg.k) + 1
    return torch.full_like(dist, cfg.k + 1)


def _bit_zero(words, idx):
    """bit idx (B,) of (B, NW) words == 0 (idx already clipped)."""
    w = torch.gather(words, 1, (idx // WORD_BITS)[:, None])[:, 0]
    return ((w >> (idx % WORD_BITS)) & 1) == 0


def _walk(*, dist, k, init_i, init_j, commit_limit, max_ops, max_steps,
          zbit, peq_at, text_at):
    """GenASM-TB walk, vectorised over lanes: per-lane (i, j, d) cursors
    advanced with the =,X,D,I preference, a tail drain (pattern exhausted
    -> remaining text as deletions) and the commit-limit stop.
    ``zbit(dd, jj, ii)`` tests bit ii of the stored R_jj[dd]."""
    B = dist.shape[0]
    dev = dist.device
    lanes = torch.arange(B, device=dev)
    i, j, d = init_i, init_j, dist
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    nops, rd, rf = zeros, zeros, zeros
    done = dist > k
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    ops = torch.full((max_ops + 1, B), OP_NONE, dtype=torch.int64, device=dev)
    for _ in range(max_steps):
        if bool(done.all()):       # later steps change no output
            break
        tail = i < 0
        stopped = rd >= commit_limit
        active = ~done & ~stopped
        jpos, dpos = j > 0, d > 0
        peq = peq_at(text_at(j), i)
        mA = jpos & peq & zbit(d, j - 1, i - 1) & ~tail
        sA = jpos & dpos & zbit(d - 1, j - 1, i - 1) & ~tail
        dA = jpos & dpos & zbit(d - 1, j - 1, i) & ~tail
        iA = dpos & zbit(d - 1, j, i - 1) & ~tail
        tail_emit = tail & jpos
        any_edge = mA | sA | dA | iA | tail_emit
        cM = mA
        cS = ~mA & sA
        cD = ~mA & ~sA & dA
        cI = ~mA & ~sA & ~dA & iA
        op = torch.where(cM, OP_MATCH, torch.where(cS, OP_SUBST, torch.where(
            cD, OP_DEL, torch.where(cI, OP_INS, OP_DEL))))
        takes_read = active & (cM | cS | cI)
        takes_ref = active & (cM | cS | cD | tail_emit)
        costs = active & (cS | cD | cI | tail_emit)
        new_i = i - takes_read.long()
        new_j = j - takes_ref.long()
        emit = active & any_edge
        slot = torch.where(emit & (nops < max_ops), nops, max_ops)
        ops[slot, lanes] = op          # row max_ops is the drop slot
        nops = nops + emit.long()
        finished = (new_i < 0) & (new_j <= 0)
        ok = ok & torch.where(active & ~finished,
                              any_edge | ((i < 0) & (j <= 0)), True)
        done = done | (active & finished) | stopped
        i, j = new_i, new_j
        d = d - costs.long()
        rd = rd + takes_read.long()
        rf = rf + takes_ref.long()
    return ops[:max_ops], (nops, rd, rf, d, ok)


def _pack(ops, dist, d_end, walk_state):
    nops, rd, rf, d, ok = walk_state
    meta = torch.zeros((META_ROWS, dist.shape[0]), dtype=torch.int64,
                       device=dist.device)
    for row, val in ((META_DIST, dist), (META_LVL, d_end), (META_NOPS, nops),
                     (META_RD, rd), (META_RF, rf), (META_DFIN, d),
                     (META_OK, ok.long())):
        meta[row] = val
    return ops.to(torch.int32), meta.to(torch.int32)


def _text_at(text, jj):
    n = text.shape[0]
    idx = torch.clamp(jj - 1, 0, n - 1)
    return torch.gather(text, 0, idx[None, :])[0].to(torch.int64)


def _pm_words(pm):
    """Kernel-layout pm (5, NW, B) int32 bits -> (B, 5, NW) int64 words."""
    return from_bits32(pm).permute(2, 0, 1)


def _peq_at(pmw, m_pad):
    def peq_at(cj, ii):
        return _bit_zero(_pm_lookup(pmw, cj), torch.clamp(ii, 0, m_pad - 1))
    return peq_at


def tb_fused_plain(pm, text, *, cfg: AlignerConfig, commit_limit: int,
                   max_ops: int, max_steps: int):
    """Plain version of K1: column-major DC fill of the W x W window storing
    the DENT band of the last ncols_band columns, then the walk."""
    W, k, nw, nwb = cfg.W, cfg.k, cfg.nw, cfg.nwb
    m_pad, ncb = cfg.m_pad, cfg.ncols_band
    col0 = W + 1 - ncb
    band_hi = m_pad - WORD_BITS * nwb
    B = pm.shape[-1]
    dev = pm.device
    lanes = torch.arange(B, device=dev)
    pmw = _pm_words(pm)
    band = torch.empty((k + 1, ncb, B, nwb), dtype=torch.int64, device=dev)

    def store(j: int, cols):
        band[:, j - col0] = extract_window(torch.stack(cols),
                                           min(max(j - 2 - k, 0), band_hi), nwb)

    cols = _column0(k, nw, B, dev)
    if col0 == 0:
        store(0, cols)
    for j in range(1, W + 1):
        cols = _next_column(cols, _pm_lookup(pmw, text[j - 1].long()), j - 1, k)
        if j >= col0:
            store(j, cols)
    tgt = torch.full((B,), W - 1, dtype=torch.int64, device=dev)
    dist = _first_hit(torch.stack(cols), tgt,
                      torch.ones(B, dtype=torch.bool, device=dev), k)

    def zbit(dd, jj, ii):
        base = torch.clamp(jj - 2 - k, 0, band_hi)
        off = ii - base
        inband = (off >= 0) & (off < nwb * WORD_BITS)
        offc = torch.clamp(off, 0, nwb * WORD_BITS - 1)
        words = band[torch.clamp(dd, 0, k), torch.clamp(jj - col0, 0, ncb - 1),
                     lanes]
        return torch.where(ii < 0, jj <= dd, _bit_zero(words, offc) & inband)

    ops, state = _walk(
        dist=dist, k=k, init_i=torch.full((B,), W - 1, dtype=torch.int64,
                                          device=dev),
        init_j=torch.full((B,), W, dtype=torch.int64, device=dev),
        commit_limit=commit_limit, max_ops=max_ops, max_steps=max_steps,
        zbit=zbit, peq_at=_peq_at(pmw, m_pad),
        text_at=lambda jj: _text_at(text, jj))
    return _pack(ops, dist, _d_end(dist, cfg), state)


def _tail_fill(pmw, text, n_len, k: int, nw: int, on_column):
    """Ragged column-major fill of a tail: columns past a lane's n_len
    freeze their left neighbour.  ``on_column(j, cols)`` sees each column
    after it is final; returns the last column."""
    cols = _column0(k, nw, pmw.shape[0], pmw.device)
    for j in range(1, text.shape[0] + 1):
        cur = _next_column(cols, _pm_lookup(pmw, text[j - 1].long()), j - 1, k)
        live = (j <= n_len)[:, None]
        cols = [torch.where(live, r, p) for r, p in zip(cur, cols)]
        on_column(j, cols)
    return cols


def _tail_dist(cols, m_len, m_pad, k):
    tm = torch.clamp(m_len - 1, 0, m_pad - 1)
    return _first_hit(torch.stack(cols), tm, m_len >= 1, k)


def tail_banded_plain(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                      n_text: int, commit_limit: int, max_ops: int,
                      max_steps: int):
    """Plain version of K2: ragged tail fill storing, per column, the band
    window around the lane's own diagonal, then the walk."""
    k, nw, nwb, m_pad = cfg.k, cfg.nw, cfg.nwb, cfg.m_pad
    band_hi = m_pad - WORD_BITS * nwb
    B = pm.shape[-1]
    dev = pm.device
    lanes = torch.arange(B, device=dev)
    pmw = _pm_words(pm)
    m_len, n_len = m_len[0].long(), n_len[0].long()
    diag = m_len - 1 - n_len
    band = torch.empty((k + 1, n_text, B, nwb), dtype=torch.int64, device=dev)

    def tail_base(jj):
        return torch.clamp(jj + diag - (k + 1), 0, band_hi)

    def store(j, cols):
        band[:, j - 1] = extract_window(torch.stack(cols), tail_base(j), nwb)

    dist = _tail_dist(_tail_fill(pmw, text, n_len, k, nw, store), m_len,
                      m_pad, k)

    def zbit(dd, jj, ii):
        off = ii - tail_base(jj)
        inband = (off >= 0) & (off < nwb * WORD_BITS)
        offc = torch.clamp(off, 0, nwb * WORD_BITS - 1)
        words = band[torch.clamp(dd, 0, k), torch.clamp(jj, 1, n_text) - 1,
                     lanes]
        z = torch.where(jj <= 0, ii < dd, _bit_zero(words, offc) & inband)
        return torch.where(ii < 0, jj <= dd, z)

    ops, state = _walk(
        dist=dist, k=k, init_i=m_len - 1, init_j=n_len,
        commit_limit=commit_limit, max_ops=max_ops, max_steps=max_steps,
        zbit=zbit, peq_at=_peq_at(pmw, m_pad),
        text_at=lambda jj: _text_at(text, jj))
    return _pack(ops, dist, _d_end(dist, cfg), state)


def tail_full_plain(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                    n_text: int, commit_limit: int, max_ops: int,
                    max_steps: int):
    """Plain version of K4: ragged tail fill storing every full column
    vector of every level, then the walk over full vectors."""
    k, nw, m_pad = cfg.k, cfg.nw, cfg.m_pad
    B = pm.shape[-1]
    dev = pm.device
    lanes = torch.arange(B, device=dev)
    pmw = _pm_words(pm)
    m_len, n_len = m_len[0].long(), n_len[0].long()
    store = torch.empty((k + 1, n_text + 1, B, nw), dtype=torch.int64,
                        device=dev)
    store[:, 0] = torch.stack(_column0(k, nw, B, dev))

    def keep(j, cols):
        store[:, j] = torch.stack(cols)

    dist = _tail_dist(_tail_fill(pmw, text, n_len, k, nw, keep), m_len,
                      m_pad, k)

    def zbit(dd, jj, ii):
        words = store[torch.clamp(dd, 0, k), torch.clamp(jj, 0, n_text),
                      lanes]
        z = _bit_zero(words, torch.clamp(ii, 0, m_pad - 1))
        return torch.where(ii < 0, jj <= dd, z)

    ops, state = _walk(
        dist=dist, k=k, init_i=m_len - 1, init_j=n_len,
        commit_limit=commit_limit, max_ops=max_ops, max_steps=max_steps,
        zbit=zbit, peq_at=_peq_at(pmw, m_pad),
        text_at=lambda jj: _text_at(text, jj))
    return _pack(ops, dist, _d_end(dist, cfg), state)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(cfg, pm, text, n_text, lens=()):
    device = pm.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain version for device "
                         f"{device}: pass CPU or CUDA tensors")
    B = pm.shape[-1]
    _check("pm", pm, (5, cfg.nw, B), device)
    _check("text", text, (n_text, B), device)
    for name, t in zip(("m_len", "n_len"), lens):
        _check(name, t, (1, B), device)
    return device.type == "cuda"


def _outputs(max_ops, B, device):
    return (torch.empty((max_ops, B), dtype=torch.int32, device=device),
            torch.empty((META_ROWS, B), dtype=torch.int32, device=device))


def _launch(name, cfg, *tensors, ints):
    """Launch kernel `name` of the CUDA library on the current stream of
    the tensors' device; raise if the launch is refused."""
    from .build import load_library
    lib = load_library()
    fn = getattr(lib, f"genasm_{name}_launch")
    if not 0 < cfg.lane_tile <= 1024:
        raise ValueError(f"lane_tile={cfg.lane_tile}: a CUDA block holds "
                         f"1..1024 threads")
    if cfg.nw > 2:
        raise ValueError(f"W={cfg.W}: the CUDA kernels are instantiated for "
                         f"W <= 64 (two words per bitvector)")
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        LAUNCHES[name] += 1
        rc = fn(*[t.data_ptr() for t in tensors], *ints, cfg.lane_tile, stream)
    if rc != 0:
        raise RuntimeError(f"genasm_{name} kernel launch failed: CUDA error "
                           f"{rc} ({lib.genasm_error_string(rc).decode()})")


def genasm_tb_fused(pm, text, *, cfg: AlignerConfig, commit_limit: int,
                    max_ops: int, max_steps: int):
    """K1: fused DC+TB of square W x W windows.  Returns (ops, meta)."""
    cuda = _check_inputs(cfg, pm, text, cfg.W)
    if not cuda:
        PLAIN_CALLS["tb_fused"] += 1
        return tb_fused_plain(pm, text, cfg=cfg, commit_limit=commit_limit,
                              max_ops=max_ops, max_steps=max_steps)
    B = pm.shape[-1]
    ops, meta = _outputs(max_ops, B, pm.device)
    if B:
        band = torch.empty((cfg.k + 1, cfg.ncols_band, cfg.nwb, B),
                           dtype=torch.int32, device=pm.device)
        _launch("tb_fused", cfg, pm, text, ops, meta, band,
                ints=(B, cfg.W, cfg.nw, cfg.k, cfg.nwb, cfg.ncols_band,
                      int(cfg.early_term), commit_limit, max_ops, max_steps))
    return ops, meta


def _tail(name, plain, store_shape, pm, text, m_len, n_len, *, cfg, n_text,
          commit_limit, max_ops, max_steps):
    cuda = _check_inputs(cfg, pm, text, n_text, (m_len, n_len))
    if not cuda:
        PLAIN_CALLS[name] += 1
        return plain(pm, text, m_len, n_len, cfg=cfg, n_text=n_text,
                     commit_limit=commit_limit, max_ops=max_ops,
                     max_steps=max_steps)
    B = pm.shape[-1]
    ops, meta = _outputs(max_ops, B, pm.device)
    if B:
        store = torch.empty(store_shape + (B,), dtype=torch.int32,
                            device=pm.device)
        _launch(name, cfg, pm, text, m_len, n_len, ops, meta, store,
                ints=(B, n_text, cfg.W, cfg.nw, cfg.k, cfg.nwb,
                      int(cfg.early_term), commit_limit, max_ops, max_steps))
    return ops, meta


def genasm_tail_banded(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                       n_text: int, commit_limit: int, max_ops: int,
                       max_steps: int):
    """K2: rectangular tail with the per-lane diagonal band store."""
    return _tail("tail_banded", tail_banded_plain,
                 (cfg.k + 1, n_text, cfg.nwb), pm, text, m_len, n_len,
                 cfg=cfg, n_text=n_text, commit_limit=commit_limit,
                 max_ops=max_ops, max_steps=max_steps)


def genasm_tail_full(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                     n_text: int, commit_limit: int, max_ops: int,
                     max_steps: int):
    """K4: rectangular tail with the full SENE store."""
    return _tail("tail_full", tail_full_plain,
                 (cfg.k + 1, n_text + 1, cfg.nw), pm, text, m_len, n_len,
                 cfg=cfg, n_text=n_text, commit_limit=commit_limit,
                 max_ops=max_ops, max_steps=max_steps)


def genasm_tail_fused(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                      n_text: int, commit_limit: int, max_ops: int,
                      max_steps: int):
    """The tail kernel ``cfg.tail_banded`` selects (K2, else K4)."""
    fn = genasm_tail_banded if cfg.tail_banded else genasm_tail_full
    return fn(pm, text, m_len, n_len, cfg=cfg, n_text=n_text,
              commit_limit=commit_limit, max_ops=max_ops, max_steps=max_steps)
