"""Banded X-drop pre-filter: kill hopeless candidates before alignment
(port of ``repro/mapper/prefilter.py``; the same scores for the same
packed batch).

LOGAN (arXiv:2002.05200) showed X-drop is the GPU-friendly pruning
idiom: a fixed-shape banded score wavefront, no data-dependent control
flow, terminated by masking instead of branching.  ``xdrop_extend``
scores EVERY (read, candidate) prefix pair of a batch on the device in
one call: one upload of the packed arrays, a loop of ``S + Sr`` wave
steps on int32 tensors (about twenty PyTorch kernels a step, no host
sync), one download of the ``(N,)`` scores.

The DP is the classic antidiagonal wavefront over a diagonal band:
cell (i, j) lives at wave d = i + j, offset c = i - j in [-band, band],
and depends only on waves d-1 (gap moves, offset +-1) and d-2 (the
match/mismatch diagonal, same offset) — so every wave updates all 2b+1
offsets of all N lanes at once and a lane's whole score table is two
live waves.  Per lane we track the best score seen; a lane whose current
wave drops more than ``x_drop`` below its best is frozen (the X-drop
termination).

Scoring is +1 match, -2 mismatch, -2 gap.  The penalties must outweigh
the match reward: with unit penalties the optimal banded alignment of
two random DNA strings drifts upward, so decoys would outrun the
X-drop.  At 1:2 a decoy lane freezes within a few dozen waves with a
best near 0, while a true candidate at error rate e still gains
~(1 - 3e) per base.  The pipeline's keep threshold (``min_score_frac``)
sits in the gap between the two.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import transfer
from ..core.aligner import resolve_device
from ..core.windowing import SENTINEL_READ, SENTINEL_REF

#: "minus infinity" for int32 score cells: deep enough that a dead cell
#: can never win, shallow enough that D gap penalties can't underflow.
_NEG = -(1 << 20)


def _wave_tables(S: int, Sr: int, band: int, device):
    """Per wave d = 1 .. S + Sr (rows) and band offset (columns): the read
    and ref columns each cell compares (clipped, shared by all lanes), and
    which cells exist (``ok_cell``) and compare two characters
    (``ok_char``).  Built on the device from aranges, with the
    reference's floor division and Python-sign modulo."""
    offs = torch.arange(-band, band + 1, dtype=torch.int32, device=device)
    d = torch.arange(1, S + Sr + 1, dtype=torch.int32, device=device)
    dc = d[:, None] + offs[None, :]
    i = dc // 2
    j = (d[:, None] - offs[None, :]) // 2
    ok_cell = ((dc % 2) == 0) & (i >= 0) & (j >= 0) & (i <= S) & (j <= Sr)
    ok_char = ok_cell & (i >= 1) & (j >= 1)
    ri = (i - 1).clamp(0, S - 1).long()
    fj = (j - 1).clamp(0, Sr - 1).long()
    return ri, fj, ok_cell, ok_char


def xdrop_extend(reads, refs, *, band: int = 16, x_drop: int = 24,
                 match: int = 1, mismatch: int = 2, gap: int = 2,
                 device="cuda") -> np.ndarray:
    """Best banded X-drop extension score per lane, on ``device`` (the card
    unless the caller asks for the CPU; it raises where there is none).

    reads: (N, S)        uint8 codes, SENTINEL_READ-padded past each read.
    refs:  (N, S + band) uint8 codes, SENTINEL_REF-padded past each slice
           (the two sentinels never compare equal, so padding is
           automatically mismatch — no length arrays needed).
    Returns (N,) int32 best scores as numpy, anchored at cell (0, 0):
    extension starts where the chain said the alignment starts.
    """
    device = resolve_device(device)
    reads = np.asarray(reads, np.uint8)
    refs = np.asarray(refs, np.uint8)
    N, S = reads.shape
    Sr = refs.shape[1]
    C = 2 * band + 1
    rd, rf = transfer.to_device((reads, refs), device)
    ri, fj, ok_cell, ok_char = _wave_tables(S, Sr, band, device)
    i32 = dict(dtype=torch.int32, device=device)
    s_match = torch.tensor(match, **i32)
    s_miss = torch.tensor(-mismatch, **i32)
    neg_col = torch.full((N, 1), _NEG, **i32)
    neg = torch.full((), _NEG, **i32)
    prev1 = torch.full((N, C), _NEG, **i32)
    prev1[:, band] = 0                       # wave 0: only cell (0, 0)
    prev2 = torch.full((N, C), _NEG, **i32)
    best = torch.zeros((N,), **i32)
    alive = torch.ones((N,), dtype=torch.bool, device=device)
    for t in range(S + Sr):
        rc = rd.index_select(1, ri[t])
        fc = rf.index_select(1, fj[t])
        s = torch.where((rc == fc) & ok_char[t], s_match, s_miss)
        diag = prev2 + s
        up = torch.cat([neg_col, prev1[:, :-1]], dim=1) - gap
        left = torch.cat([prev1[:, 1:], neg_col], dim=1) - gap
        cur = torch.maximum(diag, torch.maximum(up, left))
        cur = torch.where(ok_cell[t], cur, neg)
        wave_best = cur.amax(dim=1)
        best = torch.where(alive, torch.maximum(best, wave_best), best)
        alive = alive & (wave_best >= best - x_drop)
        cur = torch.where(alive[:, None], cur, neg)   # freeze: X-drop stop
        prev1, prev2 = cur, prev1
    return transfer.to_host({"best": best})["best"]


def pack_pairs(read_prefixes, ref_slices, seg_len: int, band: int,
               lanes: int | None = None):
    """Pad a ragged batch of (read prefix, ref slice) code arrays into the
    sentinel-padded (N, seg_len) / (N, seg_len + band) arrays
    ``xdrop_extend`` consumes.  ``lanes`` pads the lane count too (the
    pipeline buckets N to a power of two); pad lanes are all-sentinel and
    score 0 — callers slice them off."""
    n = len(read_prefixes)
    lanes = n if lanes is None else lanes
    reads = np.full((lanes, seg_len), SENTINEL_READ, np.uint8)
    refs = np.full((lanes, seg_len + band), SENTINEL_REF, np.uint8)
    for i, (r, f) in enumerate(zip(read_prefixes, ref_slices)):
        r = np.asarray(r, np.uint8)[:seg_len]
        f = np.asarray(f, np.uint8)[:seg_len + band]
        reads[i, :len(r)] = r
        refs[i, :len(f)] = f
    return reads, refs
