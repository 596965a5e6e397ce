"""KSW2-style baseline: banded global alignment with affine gaps (port of
``repro.baselines.dp``).

KSW2 [Suzuki & Kasahara 2018; Li 2018] computes banded affine-gap DP with
SIMD difference recurrences.  Here the band (width 2*bw+1) lies across a
tensor's last axis and pairs across its first; the within-row horizontal
gap chain is a (min,+) prefix scan (``torch.cummin``, the reference's
``associative_scan(minimum)``) instead of KSW2's lazy-F loop.  Unit costs
(sub=1, open=0, ext=1) reproduce edit distance for comparison with the
bit-parallel aligners; affine costs exercise the full recurrence.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.oracle import OP_DEL, OP_INS, OP_MATCH, OP_SUBST

INF = 1 << 28


def banded_affine_dist(pat_codes, text_codes, m_len, n_len, *, bw: int,
                       m: int, sub: int = 1, gapo: int = 0,
                       gape: int = 1) -> torch.Tensor:
    """Banded global affine-gap cost per pair, (B,) int32 on the tensors'
    device.  Band slot s = j - i + bw.

    pat (B, m) padded with 255; text (B, n) padded out-of-alphabet.
    Returns INF-ish where the band was exceeded, as the reference: the
    vertical-gap state E grows past INF unclamped, H is clamped to INF each
    row, and a pair with |n_len - m_len| > bw gets INF."""
    dev = text_codes.device
    i32 = torch.int32
    B, n = text_codes.shape
    W = 2 * bw + 1
    sl = torch.arange(W, dtype=i32, device=dev)
    m_len = torch.as_tensor(m_len, device=dev).to(i32)
    n_len = torch.as_tensor(n_len, device=dev).to(i32)
    pat = pat_codes.to(dev).to(i32)
    text = text_codes.to(i32)

    # row 0: H[0][j] = gapo + gape*j (global, leading ref gap)
    j0 = sl - bw
    H = torch.where(j0 >= 0, torch.where(j0 > 0, gapo + gape * j0, 0), INF)
    H = H.to(i32).expand(B, W).contiguous()
    E = torch.full((B, W), INF, dtype=i32, device=dev)  # vertical-gap state
    inf_col = torch.full((B, 1), INF, dtype=i32, device=dev)

    # every row's inputs at once: the column j of slot s at row i, the
    # text char there (index clipped as the reference's gather), whether
    # the pair's read char matches it, and the row's masks
    rows = torch.arange(1, m + 1, dtype=i32, device=dev)
    j_at = rows[:, None] + sl[None, :] - bw                         # (m, W)
    tc = text[:, (j_at - 1).clamp(0, n - 1).to(torch.int64)]    # (B, m, W)
    pc = pat[:, (rows - 1).clamp(max=pat.shape[1] - 1).to(torch.int64)]
    mis = torch.where(pc[:, :, None] == tc, 0, sub).to(i32)
    diag_ok = j_at >= 1
    first_col = j_at == 0
    out_of_ref = (j_at[None] < 0) | (j_at[None] > n_len[:, None, None])
    live = rows[:, None] <= m_len[None, :]                         # (m, B)
    col0 = gapo + gape * rows                                      # (m,)
    f_in = gapo - sl * gape
    f_out = sl * gape

    for r in range(m):
        # diagonal: H[i-1][j-1] is slot s at row i-1; vertical: slot s+1
        up_H = torch.cat([H[:, 1:], inf_col], dim=1)
        up_E = torch.cat([E[:, 1:], inf_col], dim=1)
        E_new = torch.minimum(up_E + gape, up_H + (gapo + gape))  # read gap
        Hd = torch.where(diag_ok[r], H + mis[:, r], INF)
        H_noF = torch.minimum(Hd, E_new)
        # boundary: j == 0 column (all-read gap) = gapo + gape * i
        H_noF = torch.where(first_col[r], col0[r], H_noF)
        # horizontal chain F via (min,+) prefix scan along slots
        run = torch.cummin(H_noF + f_in, dim=1).values
        F = torch.cat([inf_col, run[:, :-1]], dim=1) + f_out
        H_new = torch.where(out_of_ref[:, r], INF,
                            torch.minimum(H_noF, F))
        keep = live[r][:, None]
        H = torch.where(keep, H_new, H).clamp(max=INF)
        E = torch.where(keep, E_new, E)
    # answer at slot s = n_len - m_len + bw
    s_fin = (n_len - m_len + bw).clamp(0, W - 1).to(torch.int64)
    out = torch.gather(H, 1, s_fin[:, None])[:, 0]
    return torch.where((n_len - m_len).abs() > bw, INF, out).to(i32)


def affine_traceback(p: np.ndarray, t: np.ndarray, bw: int,
                     sub: int = 1, gapo: int = 0, gape: int = 1):
    """Host-side banded affine traceback (KSW2 keeps a direction matrix;
    costs here are tiny after banding).  Returns (cost, ops) or
    (None, None)."""
    m, n = len(p), len(t)
    if abs(n - m) > bw:
        return None, None
    W = 2 * bw + 1
    INFN = 1 << 28
    H = np.full((m + 1, W), INFN, np.int64)
    for j in range(0, min(bw, n) + 1):
        H[0, j + bw] = (gapo + gape * j) if j else 0
    for i in range(1, m + 1):
        for j in range(max(0, i - bw), min(n, i + bw) + 1):
            s = j - i + bw
            best = INFN
            if j == 0:
                best = gapo + gape * i
            if j > 0:
                best = min(best, H[i - 1, s]
                           + (sub if p[i - 1] != t[j - 1] else 0))
            if s + 1 < W:
                best = min(best, H[i - 1, s + 1] + gapo + gape)  # read gap
            if j > 0 and s - 1 >= 0:
                best = min(best, H[i, s - 1] + gapo + gape)      # ref gap
            H[i, s] = best
    cost = H[m, n - m + bw]
    if cost >= INFN:
        return None, None
    ops = []
    i, j = m, n
    while i > 0 or j > 0:
        s = j - i + bw
        c = H[i, s]
        if i > 0 and j > 0 and \
                H[i - 1, s] + (sub if p[i - 1] != t[j - 1] else 0) == c:
            ops.append(OP_MATCH if p[i - 1] == t[j - 1] else OP_SUBST)
            i -= 1; j -= 1
        elif i > 0 and s + 1 < W and H[i - 1, s + 1] + gapo + gape == c:
            ops.append(OP_INS); i -= 1
        elif j > 0 and s - 1 >= 0 and H[i, s - 1] + gapo + gape == c:
            ops.append(OP_DEL); j -= 1
        elif j == 0 and gapo + gape * i == c:
            ops.append(OP_INS); i -= 1
        else:  # pragma: no cover
            raise AssertionError("traceback stuck")
    ops.reverse()
    return int(cost), np.array(ops, np.uint8)
