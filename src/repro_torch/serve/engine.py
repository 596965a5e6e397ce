"""Alignment serving engine (port of ``repro/serve/engine.py``): a thin
shim over the session front door (``repro_torch.api.AlignSession``).  The
engine keeps its micro-batching queue and legacy stats/results surface,
but every batch executes through the session's length-bucketed, prepared
executables, on the card unless it was built with ``device='cpu'``.

.. deprecated::
    New code should ``plan()`` a session directly (submit/futures,
    double-buffered dispatch, warm-up as a method).  This class remains
    for the engine-shaped call sites and tests."""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np

from ..api import plan
from ..core.config import AlignerConfig
from ..distributed.sharding import pair_pad_multiple, quantise_lanes


@dataclasses.dataclass
class AlignRequest:
    rid: int
    read: np.ndarray
    ref: np.ndarray


class AlignmentEngine:
    """Micro-batching server: collects requests to batches of `batch_size`
    (or `max_wait_s`), aligns through an AlignSession, returns per-request
    results.  Failed pairs (k exceeded after rescue) are reported
    unaligned, mirroring aligner thresholds in production mappers.

    Ragged final batches are padded up (stable shapes) by REPEATING the
    last real pair: a repeated real pair is exactly as alignable as its
    twin, so padding lanes can neither keep the rescue ladder running
    extra k-doubling rounds nor leak into per-request stats — padded
    lanes are dropped before results/stats are recorded.  (The session
    applies the same trick again at its lane quantum.)

    ``mesh`` (a ``launch.mesh.DeviceMesh``) shards every batch's pair axis
    over the mesh's data axes; batches then pad to ``pad_multiple`` =
    lane_tile * n_pair_shards (``distributed.sharding``), so each shard
    holds equal, tile-aligned lanes."""

    def __init__(self, cfg: AlignerConfig = AlignerConfig(),
                 batch_size: int = 64, max_wait_s: float = 0.05,
                 backend: str | None = None, rescue_rounds: int = 2,
                 pad_to_batch: bool = True, mesh=None,
                 executor: str = "sync", adaptive_lanes: bool = False,
                 cache="shared", obs=None, device="cuda"):
        # the engine's aligner IS a planned session: one spec resolution,
        # bucketed executables, compacted bucket rescue.  executor /
        # adaptive_lanes / cache / obs / device pass straight through
        self.aligner = plan(cfg, backend=backend,
                            rescue_rounds=rescue_rounds,
                            batch_lanes=batch_size, mesh=mesh,
                            executor=executor,
                            adaptive_lanes=adaptive_lanes, cache=cache,
                            obs=obs, device=device)
        self.obs = self.aligner.obs
        self.pad_multiple = pair_pad_multiple(self.aligner.cfg, mesh)
        self.batch_size = quantise_lanes(batch_size, self.aligner.cfg, mesh)
        self.max_wait_s = max_wait_s
        self.pad_to_batch = pad_to_batch
        self.queue: deque[AlignRequest] = deque()
        self.results: dict[int, dict] = {}
        self.stats = {"batches": 0, "aligned": 0, "failed": 0,
                      "padded_lanes": 0, "wall_s": 0.0}

    def submit(self, req: AlignRequest):
        self.queue.append(req)

    def _pad_target(self, n: int) -> int:
        """Lanes this batch is padded to: batch_size when pad_to_batch,
        else the next pair_pad_multiple (the session further quantises
        lanes to its power-of-two batch classes)."""
        base = self.batch_size if self.pad_to_batch else n
        return quantise_lanes(base, self.aligner.cfg, self.aligner.mesh)

    def _run_batch(self, batch):
        t0 = time.time()
        reads = [r.read for r in batch]
        refs = [r.ref for r in batch]
        n_pad = self._pad_target(len(batch)) - len(batch)
        if n_pad > 0:
            reads = reads + [reads[-1]] * n_pad
            refs = refs + [refs[-1]] * n_pad
        res = self.aligner.align(reads, refs)
        dt = time.time() - t0
        s = res.summary(len(batch))        # padding lanes never counted
        self.stats["batches"] += 1
        self.stats["padded_lanes"] += max(0, n_pad)
        self.stats["wall_s"] += dt
        self.stats["aligned"] += s["n_aligned"]
        self.stats["failed"] += s["n_failed"]
        for i, r in enumerate(batch):
            self.results[r.rid] = {
                "ok": not res.failed[i], "dist": int(res.dist[i]),
                "cigar": res.cigars[i], "k_used": int(res.k_used[i]),
            }

    def flush(self):
        while self.queue:
            batch = [self.queue.popleft()
                     for _ in range(min(self.batch_size, len(self.queue)))]
            self._run_batch(batch)

    def serve_until_empty(self):
        self.flush()
        return self.stats

    def gateway(self, policy=None, clock=None, auto_pump: bool = True):
        """A multi-tenant Gateway fronting this engine's session: priority
        lanes, per-request deadlines, cancellation and load shedding over
        the same executables.  The caller owns the returned gateway's
        close(); the engine keeps owning the session."""
        from ..api import Gateway, GatewayPolicy
        return Gateway(self.aligner, policy or GatewayPolicy(),
                       clock=clock, auto_pump=auto_pump)

    def close(self):
        """Shut down the underlying session (stops its background retire
        thread when executor='thread'; a no-op for the sync executor)."""
        self.aligner.close()
