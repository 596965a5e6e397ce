"""Public aligner API (port of ``repro/core/aligner.py``): batch alignment
of (read, candidate-ref) pairs with failure rescue, host-side padding and
CIGAR decoding.

``GenASMAligner(..., device="cuda")`` runs the hand-written CUDA kernels
of its backend (``cfg.backend``, or the ``backend`` override: 'fused',
'split' or 'plain', see ``core.config``); ``device="cpu"`` runs their plain
PyTorch versions.  The default is the card, and it raises where there is
none.  Rescue (pairs whose per-window edit distance exceeds cfg.k retried
with doubled k) runs in one of two modes, equal per lane:

* ``device`` (default) — one upload, the whole k-doubling ladder on the
  device under a per-lane mask (``align_pairs_rescued``), one download;
* ``host`` — re-pad and re-upload the failed subset every round.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .cigar import decode_batch, ops_to_string, records_from_state
from .config import AlignerConfig, resolve_config
from .transfer import TransferStats
from .windowing import (SENTINEL_READ, SENTINEL_REF, align_pairs,
                        align_pairs_rescued, pad_geometry)

DNA = "ACGT"
RESCUE_MODES = ("device", "host")


def _lut(sentinel: int) -> np.ndarray:
    lut = np.full(128, sentinel, np.uint8)
    for i, c in enumerate(DNA):
        lut[ord(c)] = i
        lut[ord(c.lower())] = i
    return lut


def encode(seq: str) -> np.ndarray:
    """Encode a READ: non-ACGT chars -> SENTINEL_READ (never matches)."""
    return _lut(SENTINEL_READ)[np.frombuffer(seq.encode(), np.uint8)]


def encode_ref(seq: str) -> np.ndarray:
    """Encode a REFERENCE: non-ACGT chars -> SENTINEL_REF (the all-ones PM
    row), which never matches any read character, a read 'N' included."""
    return _lut(SENTINEL_REF)[np.frombuffer(seq.encode(), np.uint8)]


@dataclasses.dataclass
class AlignResult:
    dist: np.ndarray          # (B,) edit cost of the produced alignment
    cigars: list[str]         # run-length encoded, front-first, '=XID'
    ops: list[np.ndarray]     # raw op arrays
    failed: np.ndarray        # (B,) True if unalignable within rescue budget
    k_used: np.ndarray        # (B,) per-window threshold that succeeded
    read_consumed: np.ndarray | None = None  # (B,) read chars CIGAR consumes
    ref_consumed: np.ndarray | None = None   # (B,) ref chars CIGAR consumes

    def summary(self, n: int | None = None,
                base_k: int | None = None) -> dict:
        """Aggregate stats over the first `n` lanes (all by default); with
        `base_k` (the pre-rescue threshold) also the rescued lanes."""
        n = len(self.cigars) if n is None else n
        failed = np.asarray(self.failed[:n], bool)
        ok = ~failed
        out = {
            "n_pairs": int(n),
            "n_aligned": int(ok.sum()),
            "n_failed": int(failed.sum()),
            "total_edits": int(np.asarray(self.dist[:n])[ok].sum()),
            "total_ops": int(sum(len(self.ops[i]) for i in range(n)
                                 if ok[i])),
            "max_k_used": int(np.asarray(self.k_used[:n]).max(initial=0)),
        }
        if base_k is not None:
            out["n_rescued"] = int(
                (np.asarray(self.k_used[:n])[ok] > base_k).sum())
        if self.read_consumed is not None:
            out["read_bp"] = int(np.asarray(self.read_consumed[:n])[ok].sum())
        if self.ref_consumed is not None:
            out["ref_bp"] = int(np.asarray(self.ref_consumed[:n])[ok].sum())
        return out

    @classmethod
    def from_records(cls, recs: list) -> "AlignResult":
        """Assemble a batch AlignResult from per-lane result records."""
        return cls(
            np.array([r["dist"] for r in recs], np.int64),
            [r["cigar"] for r in recs],
            [r["ops"] for r in recs],
            np.array([not r["ok"] for r in recs], bool),
            np.array([r["k_used"] for r in recs], np.int32),
            np.array([r["read_consumed"] for r in recs], np.int32),
            np.array([r["ref_consumed"] for r in recs], np.int32))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises RuntimeError for CUDA where there is none, never
    moving silently to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on a CUDA device by default (GenASMAligner, "
            "plan) and torch.cuda.is_available() is False; pass "
            "device='cpu' to run the kernels' plain PyTorch versions")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device={device}: the port runs on 'cuda' "
                         f"(the kernels) or 'cpu' (their plain versions)")
    return device


class GenASMAligner:
    """Batch long-read aligner implementing the paper's improved GenASM.

    Pairs whose per-window edit distance exceeds cfg.k are retried with
    doubled k up to `rescue_rounds` times.  ``transfers`` counts the
    aligner's uploads, downloads and rescue-gate syncs; ``last_run`` holds
    the rounds and levels of the last device-mode batch, and its host
    clock split: upload through download (``ladder_s``, which waits for
    the device) and the CIGAR decode (``decode_s``)."""

    def __init__(self, cfg: AlignerConfig = AlignerConfig(),
                 rescue_rounds: int = 2, backend: str | None = None,
                 rescue_mode: str = "device", device="cuda"):
        if rescue_mode not in RESCUE_MODES:
            raise ValueError(f"rescue_mode={rescue_mode!r} is not one of "
                             f"{RESCUE_MODES}")
        self.cfg = resolve_config(cfg, backend=backend)
        self.rescue_rounds = rescue_rounds
        self.rescue_mode = rescue_mode
        self.device = resolve_device(device)
        self.transfers = TransferStats()
        self.last_run: dict = {}

    @staticmethod
    def _pad(seqs, width, pad_val):
        out = np.full((len(seqs), width), pad_val, np.uint8)
        lens = np.zeros(len(seqs), np.int32)
        for i, s in enumerate(seqs):
            lens[i] = len(s)
            out[i, :len(s)] = s
        return out, lens

    def align(self, reads, refs) -> AlignResult:
        """reads/refs: lists of np.uint8 code arrays (see `encode` /
        `encode_ref`)."""
        if len(reads) != len(refs):
            raise ValueError(f"{len(reads)} reads but {len(refs)} refs")
        if self.rescue_mode == "host":
            return self._align_host_loop(reads, refs)
        return self._align_device(reads, refs)

    def _upload(self, reads, refs, rescue_rounds, cfg):
        max_read_len = max(len(r) for r in reads)
        Lr, Lf = pad_geometry(cfg, max_read_len, max(len(f) for f in refs),
                              rescue_rounds)
        rpad, rlen = self._pad(reads, Lr, SENTINEL_READ)
        fpad, flen = self._pad(refs, Lf, SENTINEL_REF)
        dev = self.transfers.to_device((rpad, rlen, fpad, flen), self.device)
        return dev, max_read_len

    def _align_device(self, reads, refs) -> AlignResult:
        """One upload, the whole rescue ladder on the device, one download."""
        t0 = time.perf_counter()
        dev, max_read_len = self._upload(reads, refs, self.rescue_rounds,
                                         self.cfg)
        out = align_pairs_rescued(*dev, cfg=self.cfg,
                                  max_read_len=max_read_len,
                                  rescue_rounds=self.rescue_rounds)
        self.transfers.gate_syncs += out["gate_syncs"]
        host = self.transfers.to_host({key: out[key] for key in (
            "ops", "n_ops", "dist", "failed", "k_used", "read_consumed",
            "ref_consumed", "levels_run_total")})
        t1 = time.perf_counter()
        res = AlignResult.from_records(
            records_from_state(*decode_batch(host, len(reads), self.cfg.k)))
        self.last_run = {"rounds_run": out["rounds_run"],
                         "n_rounds": out["n_rounds"],
                         "levels_run_total": int(host["levels_run_total"]),
                         "ladder_s": t1 - t0,
                         "decode_s": time.perf_counter() - t1}
        return res

    def _align_host_loop(self, reads, refs) -> AlignResult:
        """Rescue on the host: re-pad and re-upload the failed subset."""
        B = len(reads)
        cfg = self.cfg
        dist = np.zeros(B, np.int64)
        failed = np.ones(B, bool)
        k_used = np.zeros(B, np.int32)
        rcon = np.zeros(B, np.int32)
        fcon = np.zeros(B, np.int32)
        all_ops: list[np.ndarray | None] = [None] * B
        todo = np.arange(B)
        for _ in range(self.rescue_rounds + 1):
            if len(todo) == 0:
                break
            dev, max_read_len = self._upload([reads[i] for i in todo],
                                             [refs[i] for i in todo], 0, cfg)
            out = align_pairs(*dev, cfg=cfg, max_read_len=max_read_len)
            host = self.transfers.to_host({key: out[key] for key in (
                "ops", "n_ops", "dist", "failed", "read_consumed",
                "ref_consumed")})
            ok = ~host["failed"]
            for loc, glob in enumerate(todo):
                if ok[loc]:
                    all_ops[glob] = host["ops"][loc, :host["n_ops"][loc]]
                    dist[glob] = host["dist"][loc]
                    failed[glob] = False
                    k_used[glob] = cfg.k
                    rcon[glob] = host["read_consumed"][loc]
                    fcon[glob] = host["ref_consumed"][loc]
            todo = np.array([g for g in todo if failed[g]])
            # rescue: double k (capped below W so the band math stays valid)
            new_k = min(cfg.k * 2, cfg.W - 1)
            if new_k == cfg.k:
                break
            cfg = dataclasses.replace(cfg, k=new_k)
        cigars = [ops_to_string(o) if o is not None else "" for o in all_ops]
        ops_out = [o if o is not None else np.zeros(0, np.uint8)
                   for o in all_ops]
        return AlignResult(dist, cigars, ops_out, failed, k_used, rcon, fcon)
