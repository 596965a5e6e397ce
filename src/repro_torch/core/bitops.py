"""Multi-word bitvector primitives (PyTorch port of ``repro.core.bitops``).

An m-bit status vector is ``NW = ceil(m/32)`` 32-bit words, word 0 least
significant, the word dimension innermost.  Bit convention (GenASM /
Wu-Manber "0-active"): bit i == 0 means *active*.

Word representation, decided once here for the whole port: PyTorch on the
CPU has no ``>>`` for ``uint32``, and ``>>`` on ``int32`` is arithmetic,
while GenASM needs logical shifts (the ``v >> 31`` carry of ``shift1`` and
the funnel shift of ``extract_window``).  So the plain path holds every
word as ``int64`` in [0, 2**32), masking with ``MASK32`` after each
``<<``.  At the kernel boundary the same bits travel as ``int32`` tensors
(``to_bits32``) that the CUDA code reads as ``uint32_t``.
"""
from __future__ import annotations

import torch

WORD_BITS = 32
MASK32 = 0xFFFFFFFF

# Alphabet + pad sentinels.  SENTINEL_PAT pads reads (never matches: its
# PM bits stay 1); SENTINEL_TEXT pads refs (selects the all-ones PM row);
# the two differ so pad-vs-pad never matches.
N_SYMBOLS = 4
SENTINEL_PAT = 255
SENTINEL_TEXT = N_SYMBOLS + 5


def n_words(m_bits: int) -> int:
    return -(-m_bits // WORD_BITS)


def to_bits32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 tensor holding the same 32 bits."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def from_bits32(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 words in [0, 2**32)."""
    return bits.to(torch.int64) & MASK32


def shift1(v: torch.Tensor, carry_in) -> torch.Tensor:
    """Shift a (..., NW) word vector left by one bit; ``carry_in`` (0/1,
    scalar or broadcastable to v[..., 0]) enters at bit 0."""
    carry_in = torch.as_tensor(carry_in, dtype=torch.int64, device=v.device)
    hi = v >> (WORD_BITS - 1)
    carry = torch.cat([carry_in.expand(v[..., :1].shape), hi[..., :-1]], dim=-1)
    return ((v << 1) & MASK32) | carry


def get_bit(v: torch.Tensor, idx) -> torch.Tensor:
    """Bit ``idx`` (int, broadcastable over v's batch dims) of a (..., NW)
    word vector, as int64 in {0, 1}.  Indices index like the reference's
    gather: a negative word index counts from the top word, and a word
    index out of [0, NW) after that reads all ones."""
    nw = v.shape[-1]
    idx = torch.as_tensor(idx, dtype=torch.int64, device=v.device)
    idx = idx.expand(v.shape[:-1])
    oob = (idx < -WORD_BITS * nw) | (idx >= WORD_BITS * nw)
    w = torch.gather(v, -1, ((idx // WORD_BITS) % nw)[..., None])[..., 0]
    return torch.where(oob, 1, (w >> (idx % WORD_BITS)) & 1)


def ones_below(d, nw: int, device=None) -> torch.Tensor:
    """Word vector whose ``d`` lowest bits are 0 and the rest 1 (~0 << d):
    the GenASM-DC init of error level d.  Result shape d.shape + (nw,)."""
    d = torch.as_tensor(d, dtype=torch.int64, device=device)[..., None]
    base = torch.arange(nw, dtype=torch.int64, device=d.device) * WORD_BITS
    lo = torch.clamp(d - base, 0, WORD_BITS)
    return torch.where(lo >= WORD_BITS, torch.zeros_like(lo),
                       (torch.full_like(lo, MASK32) << lo) & MASK32)


def build_pm(pat_codes: torch.Tensor, nw: int,
             n_symbols: int = N_SYMBOLS) -> torch.Tensor:
    """Pattern bitmasks PM[c]: bit i == 0 iff P[i] == c.  pat_codes (..., m)
    with SENTINEL_PAT past the true length.  Returns (..., n_symbols, NW)."""
    pat = pat_codes.to(torch.int64)
    pad = nw * WORD_BITS - pat.shape[-1]
    if pad:
        pat = torch.nn.functional.pad(pat, (0, pad), value=SENTINEL_PAT)
    sym = torch.arange(n_symbols, dtype=torch.int64, device=pat.device)
    mm = (pat[..., None, :] != sym[:, None]).to(torch.int64)
    mm = mm.reshape(*mm.shape[:-1], nw, WORD_BITS)
    weights = torch.ones(WORD_BITS, dtype=torch.int64, device=pat.device) \
        << torch.arange(WORD_BITS, dtype=torch.int64, device=pat.device)
    return (mm * weights).sum(dim=-1)


def build_pm_ext(pat_codes: torch.Tensor, nw: int,
                 n_symbols: int = N_SYMBOLS) -> torch.Tensor:
    """PM with an extra all-ones row for sentinel text characters."""
    pm = build_pm(pat_codes, nw, n_symbols)
    ones = torch.full(pm.shape[:-2] + (1, nw), MASK32, dtype=torch.int64,
                      device=pm.device)
    return torch.cat([pm, ones], dim=-2)


def extract_window(v: torch.Tensor, base, nwb: int) -> torch.Tensor:
    """Funnel-shift extraction of the 32*nwb-bit window starting at bit
    ``base`` (0 <= base <= 32*NW - 32*nwb) from a (..., NW) word vector.
    Returns (..., nwb)."""
    nw = v.shape[-1]
    base = torch.as_tensor(base, dtype=torch.int64, device=v.device)
    base = base.expand(v.shape[:-1])
    w0 = base // WORD_BITS
    s = (base % WORD_BITS)[..., None]
    idx = w0[..., None] + torch.arange(nwb + 1, dtype=torch.int64,
                                       device=v.device)
    words = torch.gather(v, -1, torch.clamp(idx, 0, nw - 1))
    lo, hi = words[..., :nwb], words[..., 1:]
    # s == 0 must not shift by 32: select explicitly, as the reference does
    funnel = (lo >> s) | ((hi << (WORD_BITS - s)) & MASK32)
    return torch.where(s == 0, lo, funnel)


def window_bit(win: torch.Tensor, base, idx) -> torch.Tensor:
    """Absolute bit ``idx`` of a window stored by ``extract_window`` at bit
    offset ``base``; the caller keeps base <= idx < base + 32*nwb."""
    return get_bit(win, torch.as_tensor(idx, device=win.device)
                   - torch.as_tensor(base, device=win.device))
