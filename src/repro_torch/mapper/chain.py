"""Colinear chaining: seed anchors -> candidate reference loci (host
numpy; a copy of ``repro/mapper/chain.py``).

minimap2-style two-stage chaining, sized for this repo's aligner: anchors
are first grouped by diagonal (ref_pos - query_pos; indel drift keeps a
true locus's anchors within a narrow diagonal band), then each group is
reduced to its best colinear subset (query-sorted anchors with
non-decreasing ref positions — a greedy LIS stand-in that drops the
stray repeat hits a diagonal band can trap).  A surviving chain is
extrapolated to a candidate (ref_start, ref_end) window: the segment the
GenASM windowed aligner consumes END TO END, so both ends matter — every
base the estimate over/undershoots costs one edit in the first/last
window.  First and last colinear anchors carry the local diagonal at
each end, which keeps that error within a few bases at long-read error
rates.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One candidate locus: align read end-to-end against
    genome[ref_start:ref_end].  ``score`` is the colinear anchor count
    (the chain's evidence); ``n_anchors`` the raw diagonal-group size;
    ``diag`` the group's median diagonal (ref_pos - query_pos) — which is
    also the implied mapping position of read offset 0."""
    ref_start: int
    ref_end: int
    score: int
    n_anchors: int
    diag: int


def _colinear_subset(q: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Indices of the greedy colinear subset: walk anchors in query order,
    keep those whose ref position does not step backwards.  Anchor counts
    per group are small (tens), so the python walk is negligible next to
    the vectorized grouping."""
    keep, last = [], -1
    for i in range(len(q)):
        if r[i] >= last:
            keep.append(i)
            last = r[i]
    return np.asarray(keep, np.int64)


def chain_anchors(qpos: np.ndarray, rpos: np.ndarray, read_len: int, *,
                  max_diag_gap: int | None = None, min_anchors: int = 3,
                  max_candidates: int = 8,
                  genome_len: int | None = None) -> list[Candidate]:
    """Chain (query_pos, ref_pos) anchors into candidate loci.

    max_diag_gap  — split diagonal groups where consecutive sorted
                    diagonals jump further than this (default scales with
                    read_len: indel drift grows with read length).
    min_anchors   — minimum colinear evidence for a candidate.
    max_candidates— keep at most this many, best colinear score first;
                    near-duplicate loci (within read_len // 2) dedupe to
                    the better-scoring chain.
    genome_len    — clip candidate windows to [0, genome_len).
    """
    if len(qpos) == 0:
        return []
    if max_diag_gap is None:
        max_diag_gap = max(32, read_len // 16)
    qpos = np.asarray(qpos, np.int64)
    rpos = np.asarray(rpos, np.int64)
    diag = rpos - qpos
    order = np.lexsort((qpos, diag))
    dg, qg, rg = diag[order], qpos[order], rpos[order]
    cut = np.nonzero(np.diff(dg) > max_diag_gap)[0] + 1
    bounds = np.concatenate([[0], cut, [len(dg)]])

    cands: list[Candidate] = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi - lo < min_anchors:
            continue
        o = np.argsort(qg[lo:hi], kind="stable")
        q, r = qg[lo:hi][o], rg[lo:hi][o]
        keep = _colinear_subset(q, r)
        if len(keep) < min_anchors:
            continue
        q, r = q[keep], r[keep]
        # extrapolate each end along its LOCAL diagonal: the unanchored
        # head/tail is a few minimizer spacings, so drift stays small
        start = int(r[0] - q[0])
        end = int(r[-1] + (read_len - q[-1]))
        if genome_len is not None:
            start, end = max(0, start), min(int(genome_len), end)
        if end - start < max(1, read_len // 4):
            continue
        cands.append(Candidate(start, end, int(len(keep)), int(hi - lo),
                               int(np.median(diag[order][lo:hi]))))

    cands.sort(key=lambda c: (-c.score, c.ref_start))
    out: list[Candidate] = []
    for c in cands:
        if any(abs(c.ref_start - o.ref_start) < max(1, read_len // 2)
               for o in out):
            continue                    # same locus, weaker chain
        out.append(c)
        if len(out) >= max_candidates:
            break
    return out
