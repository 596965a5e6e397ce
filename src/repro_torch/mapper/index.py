"""Minimizer hash index over a reference genome (host numpy; a copy of
``repro/mapper/index.py``, the same arrays for the same genome).

The paper (and its GPU successors) benchmark GenASM on *candidate* pairs
produced by a seeding stage like minimap2's.  This module is that
stage's index: (w, k) minimizers over the 2-bit genome codes, stored as
two hash-sorted parallel arrays (``hashes``, ``positions``) and queried
with ``np.searchsorted`` — no python dicts, so build and lookup are
vectorized numpy end to end and the index itself is trivially
picklable/shippable.

Minimizer selection is the standard scheme: hash every k-mer with an
invertible 64-bit mixer (so low-complexity k-mers don't all collide at
the low end), then keep the argmin of every w-wide window of hashes.
Two identical error-free stretches of >= w + k - 1 bases always select
the same minimizer, which is what makes read-vs-index anchor lookup
work under sequencing error.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: out-of-alphabet codes (N bases, pad sentinels) poison any k-mer that
#: covers them: their hash is forced to the max value and dropped.
_BAD_HASH = np.uint64(0xFFFFFFFFFFFFFFFF)


def _mix64(h: np.ndarray, mask: np.uint64) -> np.ndarray:
    """Invertible 64-bit integer finalizer (minimap2's hash64), masked to
    the 2k-bit k-mer space.  Spreads adjacent/low-complexity k-mers so the
    window-argmin picks near-uniformly among them."""
    h = h & mask
    h = (~h + (h << np.uint64(21))) & mask
    h = h ^ (h >> np.uint64(24))
    h = (h + (h << np.uint64(3)) + (h << np.uint64(8))) & mask
    h = h ^ (h >> np.uint64(14))
    h = (h + (h << np.uint64(2)) + (h << np.uint64(4))) & mask
    h = h ^ (h >> np.uint64(28))
    h = (h + (h << np.uint64(31))) & mask
    return h


def kmer_hashes(codes: np.ndarray, k: int) -> np.ndarray:
    """Mixed hash of every k-mer of ``codes`` (length n-k+1).  K-mers that
    cover a non-ACGT code (>= 4: read/ref sentinels, N bases) get
    ``_BAD_HASH`` so they can never become minimizers."""
    codes = np.asarray(codes)
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    c64 = codes.astype(np.uint64)
    km = np.zeros(n, np.uint64)
    for j in range(k):
        km = (km << np.uint64(2)) | (c64[j:j + n] & np.uint64(3))
    mask = np.uint64((1 << (2 * k)) - 1) if 2 * k < 64 else _BAD_HASH
    h = _mix64(km, mask)
    bad = (codes >= 4).astype(np.int32)
    cum = np.concatenate([[0], np.cumsum(bad)])
    h[(cum[k:] - cum[:-k]) > 0] = _BAD_HASH
    return h


def minimizers(codes: np.ndarray, k: int, w: int) -> tuple[np.ndarray,
                                                           np.ndarray]:
    """(hashes, positions) of the (w, k)-minimizers of ``codes``: for every
    window of w consecutive k-mers, the position of the minimum hash
    (ties -> leftmost), deduplicated.  Sequences shorter than w + k - 1
    fall back to a single window over whatever k-mers exist."""
    h = kmer_hashes(codes, k)
    if len(h) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    w = min(w, len(h))
    win = np.lib.stride_tricks.sliding_window_view(h, w)
    pos = np.unique(win.argmin(axis=1) + np.arange(len(win)))
    pos = pos[h[pos] != _BAD_HASH]
    return h[pos], pos.astype(np.int64)


@dataclasses.dataclass
class MinimizerIndex:
    """Hash-sorted minimizer table of one reference genome.

    ``hashes`` is sorted ascending; ``positions[i]`` is the genome offset
    of minimizer ``hashes[i]`` (equal hashes grouped, positions ascending
    within a group).  ``anchors(read)`` is the seed-lookup primitive the
    chaining stage consumes: every (read minimizer, genome occurrence)
    match as parallel (query_pos, ref_pos) arrays.  Minimizers occurring
    more than ``max_occ`` times in the genome (repeats) are skipped at
    lookup time, minimap2's ``-f`` style, so one repeat family can't
    explode the anchor list.
    """
    k: int
    w: int
    max_occ: int
    genome_len: int
    hashes: np.ndarray
    positions: np.ndarray

    @classmethod
    def build(cls, genome: np.ndarray, k: int = 13, w: int = 8,
              max_occ: int = 64) -> "MinimizerIndex":
        assert 0 < k <= 28 and w >= 1 and max_occ >= 1
        h, p = minimizers(np.asarray(genome, np.uint8), k, w)
        order = np.argsort(h, kind="stable")     # stable: positions ascend
        return cls(k, w, max_occ, len(genome), h[order],
                   p[order].astype(np.int64))

    def anchors(self, read: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """All (query_pos, ref_pos) seed matches of ``read`` against the
        index: read minimizer at query_pos equals a genome minimizer at
        ref_pos (both are k-mer start offsets)."""
        rh, rp = minimizers(np.asarray(read, np.uint8), self.k, self.w)
        if len(rh) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        lo = np.searchsorted(self.hashes, rh, "left")
        hi = np.searchsorted(self.hashes, rh, "right")
        cnt = hi - lo
        sel = np.nonzero((cnt > 0) & (cnt <= self.max_occ))[0]
        if len(sel) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        qpos = np.repeat(rp[sel], cnt[sel])
        rpos = np.concatenate([self.positions[lo[i]:hi[i]] for i in sel])
        return qpos.astype(np.int64), rpos

    def stats(self) -> dict:
        """Index telemetry (benchmarks / docs): minimizer density and the
        distinct-hash fraction that makes lookups near-unique."""
        n = len(self.hashes)
        return {"n_minimizers": int(n),
                "density": float(n / max(1, self.genome_len)),
                "n_distinct": int(len(np.unique(self.hashes))),
                "k": self.k, "w": self.w, "max_occ": self.max_occ}
