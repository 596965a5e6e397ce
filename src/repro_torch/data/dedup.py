"""GenASM as a data-pipeline operator (port of ``repro.data.dedup``):
alignment-based near-duplicate filtering of token sequences.

Token streams are reduced to the aligner's 4-symbol alphabet (2-bit hash
per token); near-duplicates then have small edit distance in the reduced
space (the reduction can only *lower* distance, so no true near-dup is
missed; unrelated pairs collide to ~expected-random distance ≈ 0.5/symbol,
far above threshold).  The alignment runs on the card (K1, K2, K4) unless
the caller passes ``device='cpu'``."""
from __future__ import annotations

import numpy as np

from ..core.aligner import GenASMAligner
from ..core.config import AlignerConfig


def tokens_to_dna(tokens: np.ndarray) -> np.ndarray:
    """2-bit hash of each token id (splitmix-style mix, xor-folded)."""
    t = tokens.astype(np.uint64)
    h = t * np.uint64(0x9E3779B97F4A7C15)
    h ^= h >> np.uint64(31)
    h *= np.uint64(0xBF58476D1CE4E5B9)
    h ^= h >> np.uint64(29)
    return (h & np.uint64(3)).astype(np.uint8)


def near_duplicates(seqs: list[np.ndarray], *, max_rate: float = 0.15,
                    cfg: AlignerConfig | None = None,
                    device="cuda") -> list[tuple[int, int, int]]:
    """All-pairs near-dup candidates among token sequences (for production,
    pre-bucket by MinHash; all-pairs keeps the operator self-contained).
    Returns (i, j, dist) pairs whose edit rate <= max_rate."""
    al = GenASMAligner(cfg or AlignerConfig(W=64, O=24, k=12),
                       rescue_rounds=1, device=device)
    enc = [tokens_to_dna(s) for s in seqs]
    pairs = [(i, j) for i in range(len(seqs)) for j in range(i + 1, len(seqs))
             if 0.8 <= len(enc[i]) / max(1, len(enc[j])) <= 1.25]
    if not pairs:
        return []
    res = al.align([enc[i] for i, _ in pairs], [enc[j] for _, j in pairs])
    out = []
    for (i, j), d, failed in zip(pairs, res.dist, res.failed):
        if not failed and d <= max_rate * max(len(enc[i]), len(enc[j])):
            out.append((i, j, int(d)))
    return out


def dedup_filter(seqs: list[np.ndarray], **kw) -> list[int]:
    """Indices to KEEP (first occurrence wins)."""
    dups = near_duplicates(seqs, **kw)
    drop = {j for _, j, _ in dups}
    return [i for i in range(len(seqs)) if i not in drop]
