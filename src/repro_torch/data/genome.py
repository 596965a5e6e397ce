"""Synthetic genome + PBSIM2-like long-read simulator (numpy copy of
``repro.data.genome``; the same seed gives the same reads).

A seeded random genome, reads sampled with a PacBio CLR-like edit profile
(default 10% errors split ~40/35/25 sub/ins/del), the true-locus
reference segment of each read, and the mapper's decoys: fabricated
candidate segments (``candidate_chains``) or partial repeats planted in
the genome (``plant_decoys``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ReadSimConfig:
    read_len: int = 10_000
    error_rate: float = 0.10
    sub_frac: float = 0.40
    ins_frac: float = 0.35
    del_frac: float = 0.25
    seed: int = 0


def synth_genome(length: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 4, length).astype(np.uint8)


def _event_probs(cfg: ReadSimConfig) -> tuple[float, float, float]:
    """(p_sub, p_ins, p_del) per emitted-position draw."""
    tot = cfg.sub_frac + cfg.ins_frac + cfg.del_frac
    return (cfg.error_rate * cfg.sub_frac / tot,
            cfg.error_rate * cfg.ins_frac / tot,
            cfg.error_rate * cfg.del_frac / tot)


def mutate(ref: np.ndarray, cfg: ReadSimConfig, rng) -> tuple[np.ndarray, int]:
    """Emit a read by walking `ref` with the error profile.  Returns
    (read[:read_len], ref_span_consumed)."""
    p_err = cfg.error_rate
    p_sub, p_ins, p_del = _event_probs(cfg)
    L = cfg.read_len
    # draw with slack: a deletion draw emits nothing, so provision by the
    # expected deletion mass (+6 sigma); top-up draws cover the tail risk
    need = L / max(1e-9, 1.0 - p_del)
    n = int(max(L * (1 + p_err), need + 6.0 * (need * p_del) ** 0.5) + 64)
    chunk = rng.random(n)
    ci = 0
    out = []
    i = 0  # ref cursor
    while len(out) < L and i < len(ref):
        if ci == len(chunk):
            chunk = rng.random(
                max(64, int((L - len(out)) / max(1e-9, 1.0 - p_del)) + 32))
            ci = 0
        x = chunk[ci]
        ci += 1
        if x < p_del:
            i += 1
        elif x < p_del + p_ins:
            out.append(rng.integers(0, 4))
        elif x < p_del + p_ins + p_sub:
            c = ref[i]
            out.append((c + 1 + rng.integers(0, 3)) % 4)
            i += 1
        else:
            out.append(ref[i])
            i += 1
    read = np.array(out[:L], dtype=np.uint8)
    if len(read) != L and i < len(ref):
        raise RuntimeError(f"short read {len(read)} < {L} with ref "
                           f"remaining (draw shortfall)")
    return read, i


@dataclasses.dataclass
class ReadSet:
    reads: list[np.ndarray]
    ref_segments: list[np.ndarray]   # true-locus candidate segments
    true_pos: np.ndarray
    spans: np.ndarray


def simulate_reads(genome: np.ndarray, n_reads: int,
                   cfg: ReadSimConfig = ReadSimConfig()) -> ReadSet:
    rng = np.random.default_rng(cfg.seed + 1)
    # ref consumed per emitted base is (1 - p_ins) / (1 - p_del)
    _, p_ins, p_del = _event_probs(cfg)
    span_ratio = (1.0 - p_ins) / max(1e-9, 1.0 - p_del)
    max_span = int(cfg.read_len * max(1.3, 1.15 * span_ratio)) + 64
    reads, segs, pos, spans = [], [], [], []
    for _ in range(n_reads):
        p = int(rng.integers(0, len(genome) - max_span))
        read, span = mutate(genome[p:p + max_span], cfg, rng)
        reads.append(read)
        segs.append(genome[p:p + span].copy())
        pos.append(p)
        spans.append(span)
    return ReadSet(reads, segs, np.array(pos), np.array(spans))


def candidate_chains(genome: np.ndarray, rs: ReadSet, decoys_per_read: int = 0,
                     seed: int = 7) -> list[tuple[int, np.ndarray]]:
    """minimap2 `-P`-like candidate list: for each read, the true-locus
    segment plus `decoys_per_read` random loci (which should fail to align).
    Returns list of (read_index, ref_segment)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, seg in enumerate(rs.ref_segments):
        out.append((i, seg))
        for _ in range(decoys_per_read):
            p = int(rng.integers(0, len(genome) - len(seg)))
            out.append((i, genome[p:p + len(seg)].copy()))
    return out


def plant_decoys(genome: np.ndarray, rs: ReadSet, decoys_per_read: int = 4,
                 chunk: int = 250, divergence: float = 0.03,
                 seed: int = 17) -> tuple[np.ndarray, np.ndarray]:
    """Plant partial-repeat decoy loci for END-TO-END mapper evaluation.

    ``candidate_chains`` hands an aligner fabricated decoy segments; a
    real mapper discovers its own candidates, so decoys must live IN the
    genome.  For each read, copy a ``chunk``-long piece from the interior
    of its true segment (lightly mutated by ``divergence``) to
    ``decoys_per_read`` random loci.  Seeding finds the shared chunk and
    chaining extrapolates a full candidate window around it — but the
    window's flanks are unrelated sequence, so the X-drop pre-filter
    (anchored at the window start) kills it, the way partial repeats
    behave in real mapping.  Decoy sites avoid every true locus and each
    other, so planting never corrupts ground truth.

    Returns (planted genome copy, (n_reads, decoys_per_read) decoy
    positions).
    """
    rng = np.random.default_rng(seed)
    g = genome.copy()
    occupied = [(int(p), int(p + s)) for p, s in zip(rs.true_pos, rs.spans)]
    pos = np.zeros((len(rs.reads), decoys_per_read), np.int64)
    for i, seg in enumerate(rs.ref_segments):
        # interior chunk: past any pre-filter prefix, clear of the tail
        lo = min(max(0, len(seg) - chunk), max(0, len(seg) // 2 - chunk // 2))
        src = seg[lo:lo + chunk].copy()
        for d in range(decoys_per_read):
            piece = src.copy()
            flip = rng.random(len(piece)) < divergence
            piece[flip] = (piece[flip] + 1 + rng.integers(
                0, 3, int(flip.sum()))) % 4
            for _ in range(1000):
                p = int(rng.integers(0, len(g) - len(piece)))
                if all(p + len(piece) <= a or p >= b for a, b in occupied):
                    break
            else:
                raise RuntimeError("no free decoy site found")
            g[p:p + len(piece)] = piece
            occupied.append((p, p + len(piece)))
            pos[i, d] = p
    return g, pos
