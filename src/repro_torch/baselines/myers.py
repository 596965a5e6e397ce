"""Edlib-style baseline: Myers' (1999) bit-parallel NW edit distance (port
of ``repro.baselines.myers``).

Multi-word (block) variant, batched over pairs: the algorithmic core of
Edlib [Šošić & Šikić 2017].  Edlib additionally skips out-of-band blocks
(Ukkonen banding); the reference models that factor in its benchmark and
so does not implement it.

Convention is Myers' original: Peq bit i == 1 iff P[i] == c (1-active,
opposite of GenASM's).  Words follow ``core.bitops``: int64 in [0, 2**32),
every complement taken as ``MASK32 ^ x``, a carry read as ``s >> 32`` of an
int64 sum.

The reference unrolls the carry chain of the multi-word addition over
the words, ~6 operations a word and text column.  Eager PyTorch pays a
launch (on the card) or a dispatch (on the CPU) for each, so
``_add_carry`` resolves the carries word-parallel instead: one text
column of ``myers_distance`` runs the same operations whatever ``nw``
is (``tests/test_torch_baselines.py`` counts them).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.bitops import MASK32, shift1
from ..core.oracle import OP_DEL, OP_INS, OP_MATCH, OP_SUBST

WORD = 32


def build_peq(pat_codes: torch.Tensor, nw: int,
              n_symbols: int = 4) -> torch.Tensor:
    """(B, n_symbols+1, NW) int64 words; bit set where the pattern char
    equals the symbol.  Padding rows (>= m_len) match nothing, and the
    last row (out-of-alphabet text) is zero."""
    pat = pat_codes.to(torch.int64)
    pad = nw * WORD - pat.shape[-1]
    if pad:
        pat = torch.nn.functional.pad(pat, (0, pad), value=255)
    sym = torch.arange(n_symbols, dtype=torch.int64, device=pat.device)
    eq = (pat[:, None, :] == sym[None, :, None]).to(torch.int64)
    eq = eq.reshape(eq.shape[0], n_symbols, nw, WORD)
    w = torch.ones(WORD, dtype=torch.int64, device=pat.device) \
        << torch.arange(WORD, dtype=torch.int64, device=pat.device)
    peq = (eq * w).sum(dim=-1)
    zero = torch.zeros((peq.shape[0], 1, nw), dtype=torch.int64,
                       device=pat.device)
    return torch.cat([peq, zero], dim=1)


def _add_carry(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-word addition a + b over the word axis (axis -1, LSW first),
    modulo 2**(32 * NW), as the reference's unrolled carry chain.

    Word-parallel: word w's sum s generates a carry (s >> 32) or
    propagates one (its low 32 bits all ones; it cannot do both).  The
    carry into word w is the generate bit of the highest word below w
    that does not propagate (a ``cummax`` over word indices), 0 where
    there is none."""
    s = a + b
    lo = s & MASK32
    gen = torch.nn.functional.pad(s >> WORD, (1, 0))
    idx = torch.arange(1, a.shape[-1] + 1, dtype=torch.int64,
                       device=a.device)
    stop = torch.where(lo == MASK32, 0, idx)      # 1 + index, or 0: propagates
    last = torch.cummax(stop, dim=-1).values
    last = torch.nn.functional.pad(last[..., :-1], (1, 0))
    return (lo + torch.gather(gen, -1, last)) & MASK32


def myers_distance(pat_codes, text_codes, m_len, n_len, *, nw: int,
                   n: int) -> torch.Tensor:
    """Global (NW) edit distance per pair, (B,) int32 on the tensors'
    device.  pat_codes (B, <= 32*nw) with 255 padding; text_codes (B, n)
    with out-of-alphabet padding past n_len (a code is clipped into
    [0, 4], so the pad 9 selects the zero row).  The score is tracked at
    bit m_len-1, columns past n_len are frozen, and the horizontal deltas
    shift in +1 (Ph) and 0 (Mh): the first column is a gap column.

    Each text column costs a fixed number of tensor operations whatever
    ``nw`` is (``_add_carry``)."""
    dev = text_codes.device
    B = text_codes.shape[0]
    peq = build_peq(pat_codes.to(dev), nw)
    n_sym = peq.shape[1] - 1
    m_len = torch.as_tensor(m_len, device=dev).to(torch.int64)
    n_len = torch.as_tensor(n_len, device=dev).to(torch.int64)
    # the reference's gather at word (m_len-1)//32: a negative index counts
    # from the top word
    tgt_word = (((m_len - 1) // WORD) % nw)[:, None]
    tgt_off = (m_len - 1) % WORD
    cols = torch.arange(n, device=dev).clamp(max=text_codes.shape[1] - 1)
    c = text_codes[:, cols].to(torch.int64).clamp(0, n_sym)
    eq_cols = torch.gather(peq, 1, c[:, :, None].expand(B, n, nw)) \
        .permute(1, 0, 2).contiguous()                     # (n, B, NW)
    live = (torch.arange(n, device=dev)[:, None] < n_len[None, :])
    live_w = live[:, :, None]
    # the shift-ins as tensors on the device (an int would be copied there
    # every column)
    ones = torch.ones((B, 1), dtype=torch.int64, device=dev)
    zeros = torch.zeros_like(ones)

    VP = torch.full((B, nw), MASK32, dtype=torch.int64, device=dev)
    VN = torch.zeros((B, nw), dtype=torch.int64, device=dev)
    score = m_len.clone()
    for j in range(n):
        Eq = eq_cols[j]
        Xv = Eq | VN
        Xh = (_add_carry(Eq & VP, VP) ^ VP) | Eq
        Ph = VN | (MASK32 ^ (Xh | VP))
        Mh = VP & Xh
        ph_t = (torch.gather(Ph, 1, tgt_word)[:, 0] >> tgt_off) & 1
        mh_t = (torch.gather(Mh, 1, tgt_word)[:, 0] >> tgt_off) & 1
        score = score + torch.where(live[j], ph_t - mh_t, 0)
        Ph = shift1(Ph, ones)
        Mh = shift1(Mh, zeros)
        VP = torch.where(live_w[j], Mh | (MASK32 ^ (Xv | Ph)), VP)
        VN = torch.where(live_w[j], Ph & Xv, VN)
    return score.to(torch.int32)


def banded_traceback(p: np.ndarray, t: np.ndarray, k: int):
    """Host-side banded DP traceback that recovers the CIGAR once the
    bit-parallel distance is known (Edlib recomputes the path similarly).
    Returns (dist, ops front-first) or (None, None) if |ED| > k."""
    m, n = len(p), len(t)
    bw = 2 * k + 1
    INF = 10 ** 9
    D = np.full((m + 1, bw), INF, np.int64)
    D[0, k:min(bw, k + n + 1)] = np.arange(min(n + 1, bw - k))
    for i in range(1, m + 1):
        lo = max(0, i - k)
        hi = min(n, i + k)
        for j in range(lo, hi + 1):
            s = j - i + k
            best = INF
            if j > 0 and 0 <= s <= bw - 1:
                best = min(best, D[i - 1, s] + (p[i - 1] != t[j - 1]))
            if s + 1 <= bw - 1:
                best = min(best, D[i - 1, s + 1] + 1)  # I (consume read)
            if j > 0 and s - 1 >= 0:
                best = min(best, D[i, s - 1] + 1)      # D (consume ref)
            D[i, s] = best
    if n - m + k < 0 or n - m + k >= bw or D[m, n - m + k] > k:
        return None, None
    dist = int(D[m, n - m + k])
    ops = []
    i, j = m, n
    while i > 0 or j > 0:
        s = j - i + k
        d = D[i, s]
        if i > 0 and j > 0 and D[i - 1, s] + (p[i - 1] != t[j - 1]) == d:
            ops.append(OP_MATCH if p[i - 1] == t[j - 1] else OP_SUBST)
            i -= 1; j -= 1
        elif j > 0 and s - 1 >= 0 and D[i, s - 1] + 1 == d:
            ops.append(OP_DEL); j -= 1
        else:
            ops.append(OP_INS); i -= 1
    ops.reverse()
    return dist, np.array(ops, np.uint8)
