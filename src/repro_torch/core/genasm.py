"""GenASM-DC (distance calculation) in PyTorch, baseline and improved fills
(port of ``repro.core.genasm``).

Semantics (exact, testable): after consuming j text chars, bit i of R_j[d]
is 0  <=>  Levenshtein(P[0..i], T[0..j-1]) <= d.  The recurrence is
GenASM's (MICRO'20 Alg. 1) with exact first-column boundary bits:

    M = (R_{j-1}[d]   << 1 | [j-1 >  d  ]) | PM[T[j-1]]
    S = (R_{j-1}[d-1] << 1 | [j-1 >= d  ])
    D =  R_{j-1}[d-1]
    I = (R_j  [d-1]   << 1 | [j-1 >= d-1])
    R_j[d] = M & S & D & I            (R_j[0] = M)

Two fill orders:
  * ``dc_jmajor`` — text-major fill storing full bitvectors per (column,
    level): 'edges4' (all of M, S, D, I) or 'and' (SENE).  Its column step
    ``jmajor_columns`` is also the fill of every kernel's plain version
    (``kernels.genasm_dc``).
  * ``dc_dmajor`` — level-major fill with whole-batch early termination
    and the DENT band store, for square W x W windows.

Inputs are *reversed* windows, so the traceback emits operations
front-first.  Words are int64 in [0, 2**32) (``core.bitops``).
"""
from __future__ import annotations

import dataclasses

import torch

from .bitops import build_pm_ext, extract_window, get_bit, ones_below, shift1
from .config import AlignerConfig


@dataclasses.dataclass
class DCResult:
    dist: torch.Tensor          # (B,) int32; k+1 where no level solved
    solved: torch.Tensor        # (B,) bool
    r_final: torch.Tensor | None  # (B, k+1, NW) final column (jmajor only)
    store: dict                 # storage for traceback, mode-dependent
    levels_run: torch.Tensor    # () int32: levels actually computed (ET)


def _boundary_bits(j: int, d):
    """Shift-in bits (M, S, I) of column j, level(s) d."""
    t = j - 1
    return (t > d), (t >= d), (t >= d - 1)


def _lookup_pm(pm, codes_j):
    """pm: (B, n_sym+1, NW); codes_j: (B, ...) -> (B, ..., NW).
    Out-of-alphabet (sentinel) text chars map to the all-ones mask (row
    n_sym)."""
    B, _, nw = pm.shape
    idx = torch.clamp(codes_j.long(), 0, pm.shape[1] - 1)
    return torch.gather(pm, 1, idx.reshape(B, -1, 1).expand(-1, -1, nw)
                        ).reshape(*idx.shape, nw)


def _dist_from_final(r_final, m_len, k: int):
    """min d whose target bit (m_len-1) is 0, else k+1."""
    bits = get_bit(r_final, m_len.long()[:, None] - 1)           # (B, k+1)
    levels = torch.arange(k + 1, device=r_final.device)
    dist = torch.where(bits == 0, levels, k + 1).min(dim=1).values
    return dist.to(torch.int32), dist <= k


def jmajor_columns(pm, text_codes, n_len, *, k: int, edges: bool = False):
    """Text-major GenASM-DC over the columns of ``text_codes`` (B, n):
    every level of column j from column j-1, columns past a problem's
    n_len frozen at their left neighbour.  pm: (B, n_sym+1, NW) words.
    Returns R (n+1, B, k+1, NW) and, with ``edges``, the M/S/D/I edge
    vectors (n+1, B, k+1, NW, 4), all ones where not computed.

    The cells run in wavefront order, the order of the kernels' systolic
    fill: at step s level d computes column j = s - d from its own column
    j-1 and level d-1's columns j and j-1 (one and two steps old), so a
    step is every level at once and the fill takes n + k steps, not
    n x k."""
    B, _, nw = pm.shape
    n = text_codes.shape[1]
    dev = pm.device
    d_ar = torch.arange(k + 1, device=dev)
    cur = ones_below(d_ar, nw, dev).expand(B, k + 1, nw).contiguous()
    prev = cur
    R = torch.empty((n + 1, B, k + 1, nw), dtype=torch.int64, device=dev)
    R[0] = cur
    E = (torch.full((n + 1, B, k + 1, nw, 4), 0xFFFFFFFF, dtype=torch.int64,
                    device=dev) if edges else None)
    ones = torch.full((B, 1, nw), 0xFFFFFFFF, dtype=torch.int64, device=dev)
    live_len = n_len.long()[:, None]
    for s in range(1, n + k + 1):
        j = s - d_ar                                   # (k+1,) columns
        pm_j = _lookup_pm(pm, text_codes[:, torch.clamp(j - 1, 0, n - 1)])
        bM, bS, bI = _boundary_bits(j[:, None], d_ar[:, None])
        below_new = torch.cat([ones, cur[:, :-1]], 1)  # R_j[d-1]
        below_old = torch.cat([ones, prev[:, :-1]], 1)  # R_{j-1}[d-1]
        M = shift1(cur, bM) | pm_j
        S = shift1(below_old, bS)
        I = shift1(below_new, bI)
        on = (j >= 1) & (j <= n)
        live = (on & (j <= live_len))[..., None]       # (B, k+1, 1)
        prev = cur
        cur = torch.where(live, M & S & below_old & I, cur)
        R[j[on], :, d_ar[on]] = cur[:, on].transpose(0, 1)
        if edges:
            e = torch.where(live[..., None],
                            torch.stack([M, S, below_old, I], -1), 0xFFFFFFFF)
            E[j[on], :, d_ar[on]] = e[:, on].transpose(0, 1)
    return R, E


def dc_jmajor(pat_codes, text_codes, m_len, n_len, *, k: int, n: int,
              nw: int, store: str = "and") -> DCResult:
    """Text-major GenASM-DC with full-bitvector storage.

    pat_codes: (B, <= m_pad); positions >= m_len hold sentinel 255.
    text_codes: (B, n); positions >= n_len hold a sentinel (>= n_symbols).
    Returns storage with the column axis leading: 'R' (n+1, B, k+1, NW)
    and, for store='edges4', 'edges' (n+1, B, k+1, NW, 4)."""
    if text_codes.shape[1] != n:
        raise ValueError(f"text has {text_codes.shape[1]} columns, n={n}")
    R, edges = jmajor_columns(build_pm_ext(pat_codes, nw), text_codes,
                              n_len.long(), k=k, edges=store == "edges4")
    dist, solved = _dist_from_final(R[n], m_len, k)
    st = {"R": R}
    if edges is not None:
        st["edges"] = edges
    return DCResult(dist, solved, R[n], st,
                    torch.tensor(k + 1, dtype=torch.int32, device=R.device))


def dc_dmajor(pat_codes, text_codes, *, cfg: AlignerConfig) -> DCResult:
    """Level-major improved GenASM-DC: ET + SENE + DENT band storage.

    Uniform square windows: pat_codes (B, <= m_pad), text_codes (B, W).
    Whole-batch early termination: the level loop stops as soon as every
    problem's solution is contained in the computed levels; ``levels_run``
    is the level at which it stops.  With ET that test is one host sync
    per level.  Levels from levels_run up stay zero in the band."""
    B = pat_codes.shape[0]
    W, k, nw, nwb = cfg.W, cfg.k, cfg.nw, cfg.nwb
    n = W
    dev = pat_codes.device
    ncb = cfg.ncols_band
    col0 = n + 1 - ncb
    pm = build_pm_ext(pat_codes, nw)
    idx = torch.clamp(text_codes.long(), 0, pm.shape[1] - 1)
    pm_cols = torch.gather(pm, 1, idx[:, :, None].expand(B, n, nw))
    pm_cols = pm_cols.transpose(0, 1)                            # (n, B, NW)
    bases = torch.tensor([cfg.band_base(j) for j in range(col0, n + 1)],
                         dtype=torch.int64, device=dev)[:, None]
    t = torch.arange(n, device=dev)[:, None, None]      # text index of col j

    def fill(d: int, below):
        """Row of level d (n+1, B, NW); ``below`` is level d-1's row.  Only
        M depends on the same level's previous column; S, D and I come
        from the row below and are combined for every column at once."""
        r = ones_below(torch.full((B,), d, device=dev), nw, dev)
        if below is None:
            rest = None
        else:
            rest = (shift1(below[:-1], (t >= d).long()) & below[:-1]
                    & shift1(below[1:], (t >= d - 1).long()))
        cols = [r]
        for j in range(1, n + 1):
            r = shift1(r, int(j - 1 > d)) | pm_cols[j - 1]
            if rest is not None:
                r = r & rest[j - 1]
            cols.append(r)
        return torch.stack(cols)

    band = torch.zeros((k + 1, ncb, B, nwb), dtype=torch.int64, device=dev)
    row = fill(0, None)
    band[0] = extract_window(row[col0:], bases, nwb)
    dist = torch.where(get_bit(row[n], W - 1) == 0, 0, k + 1)
    d = 1
    while d <= k and not (cfg.early_term and not bool((dist > k).any())):
        row = fill(d, row)
        band[d] = extract_window(row[col0:], bases, nwb)
        hit = get_bit(row[n], W - 1) == 0
        dist = torch.where((dist > k) & hit, d, dist)
        d += 1
    return DCResult(dist.to(torch.int32), dist <= k, None, {"Rb": band},
                    torch.tensor(d, dtype=torch.int32, device=dev))


def dc(pat_codes, text_codes, m_len, n_len, cfg: AlignerConfig) -> DCResult:
    """Dispatch: store='band' fills the square band, through the DC kernel
    K3 (``kernels.ops.genasm_dc_op``) on backends 'split' and 'fused' and
    through ``dc_dmajor`` on 'plain'; the other stores take the full
    text-major fill."""
    if cfg.store == "band":
        if cfg.backend != "plain":
            # local import: the kernels' plain versions use this module
            from ..kernels.ops import genasm_dc_op
            dist, band, levels = genasm_dc_op(pat_codes, text_codes, cfg=cfg)
            return DCResult(dist, dist <= cfg.k, None, {"Rb": band}, levels)
        return dc_dmajor(pat_codes, text_codes, cfg=cfg)
    return dc_jmajor(pat_codes, text_codes, m_len, n_len, k=cfg.k,
                     n=text_codes.shape[1], nw=cfg.nw, store=cfg.store)
