"""Synthetic LM token pipeline (port of ``repro/data/tokens.py``): a
seeded Zipf-ish stream, packed batches, background prefetch, and a helper
that moves a batch to a device.  ``TokenStream.batch_at(i)`` returns the
reference's numpy arrays bit for bit."""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..core.aligner import resolve_device


class TokenStream:
    """Deterministic batch generator: batch i is a pure function of
    (seed, i) — replay after restart is exact."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 family: str = "dense", d_model: int = 0, n_codebooks: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.family = family
        self.d_model = d_model
        self.n_codebooks = n_codebooks

    def batch_at(self, i: int):
        rng = np.random.default_rng((self.seed << 20) ^ i)
        # Zipf-flavoured marginal over the vocab, repeated-ngram structure
        z = rng.zipf(1.3, size=(self.batch, self.seq + 1)).astype(np.int64)
        toks = (z % (self.vocab - 1)) + 1
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        if self.family == "audio":
            emb = rng.standard_normal(
                (self.batch, self.seq, self.d_model)).astype(np.float32)
            lab = rng.integers(0, self.vocab,
                               (self.batch, self.seq, self.n_codebooks))
            out = {"embeds": emb, "labels": lab.astype(np.int32)}
        if self.family == "vlm":
            pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32),
                                  (self.batch, self.seq))
            out["positions"] = np.stack([pos] * 3)
        return out

    def iterate(self, start: int = 0):
        i = start
        while True:
            yield self.batch_at(i)
            i += 1


class Prefetcher:
    """Host-side async prefetch (overlaps batch synthesis with device
    work)."""

    def __init__(self, it, depth: int = 2):
        self.q = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = False
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        for item in self.it:
            if self._stop:
                return
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def stop(self):
        self._stop = True


def to_device(batch: dict, device="cuda") -> dict:
    """A batch of numpy arrays as tensors on ``resolve_device(device)``
    (the card unless the caller asks for the CPU), dtypes kept."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in batch.items()}
