"""Synthetic genome + PBSIM2-like long-read simulator (numpy copy of
``repro.data.genome``; the same seed gives the same reads).

A seeded random genome, reads sampled with a PacBio CLR-like edit profile
(default 10% errors split ~40/35/25 sub/ins/del), and the true-locus
reference segment of each read.
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
