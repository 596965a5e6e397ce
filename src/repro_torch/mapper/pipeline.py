"""ReadMapper: FASTQ-like read batches -> CIGARs, end to end (port of
``repro/mapper/pipeline.py``, names and semantics unchanged).

The four stages the paper's evaluation presumes:

1. **seed**   — minimizer lookup against a :class:`MinimizerIndex`
   (`index.py`, host numpy).
2. **chain**  — colinear chaining of anchors into candidate loci
   (`chain.py`): each candidate is a (ref_start, ref_end) window the
   windowed aligner can consume end to end.
3. **filter** — banded X-drop pre-filter (`prefilter.py`, one PyTorch
   wavefront for the whole batch on the session's device): candidates
   whose extension score can't clear ``min_score_frac`` of the scored
   prefix are killed before they cost a full alignment.
4. **align**  — survivors stream through a
   :class:`repro_torch.api.AlignSession` via ``submit``/``flush``: its
   length bucketing, executable cache, executors and bucket-compacted
   rescue are reused unchanged.  A candidate pair is byte-for-byte the
   pair a direct ``session.align`` call would see, so mapper CIGARs are
   bit-identical to standalone alignment (tests/test_torch_mapper.py).

Per read, the best surviving alignment (min edit distance, chain score
as tie-break) becomes its :class:`MappedRead`; the batch-level
:class:`MapBatchResult` carries the funnel telemetry (candidates, kill
rate, alignments).

The funnel rides the session's observability domain (repro_torch.obs):
each stage runs under its own span (``mapper.map_batch`` ->
``index.lookup`` / ``chain`` / ``prefilter`` / ``align``) and the
cumulative counters (``mapper_*_total``) live on the session's
registry; ``MapBatchResult.stats`` is the per-batch DELTA of those
counters (start-vs-end snapshot).  With ``obs='off'`` the funnel, like
the session, trades its telemetry for zero overhead (stats read zeros).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..api import session as api_session
from ..core.aligner import encode, encode_ref
from .chain import Candidate, chain_anchors
from .index import MinimizerIndex
from .prefilter import pack_pairs, xdrop_extend


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """Knobs for the seed/chain/filter stages (the align stage is the
    AlignSession's own plan).  Defaults sized for ~1kb reads at ~10%
    error."""
    k: int = 13                  # minimizer k-mer size
    w: int = 8                   # minimizer window (k-mers per window)
    max_occ: int = 64            # skip seeds occurring more often (repeats)
    min_anchors: int = 3         # colinear evidence floor per candidate
    max_candidates: int = 8      # loci tried per read
    prefilter: bool = True       # banded X-drop stage on/off
    seg_len: int = 128           # read prefix length the pre-filter scores
    band: int = 16               # X-drop diagonal band half-width
    x_drop: int = 24             # freeze a lane this far below its best
    min_score_frac: float = 0.25  # keep if best >= frac * scored prefix


@dataclasses.dataclass(frozen=True)
class CandidateOutcome:
    """Funnel record for one candidate of one read."""
    ref_start: int
    ref_end: int
    chain_score: int
    filter_score: int            # X-drop best (0 if pre-filter off)
    killed: bool                 # dropped by the pre-filter
    ok: bool                     # aligned within the session's k ladder
    dist: int                    # edit distance (-1 if killed / failed)


@dataclasses.dataclass(frozen=True)
class MappedRead:
    read_id: int
    ok: bool                     # at least one candidate aligned
    ref_start: int               # -1 when unmapped
    ref_end: int
    dist: int
    cigar: str
    k_used: int
    candidates: tuple            # CandidateOutcome per chained locus


@dataclasses.dataclass
class MapBatchResult:
    mapped: list                 # MappedRead, input order
    stats: dict                  # funnel counters (see _finalize)

    @property
    def n_mapped(self) -> int:
        return self.stats["n_mapped"]


class ReadMapper:
    """Index a genome once, then map read batches through seed -> chain ->
    pre-filter -> AlignSession.

    ``genome`` is an A/C/G/T string or ``encode_ref`` codes.  ``session``
    is an existing planned AlignSession to share; when omitted the mapper
    plans its own (forwarding ``plan_kwargs``, e.g. ``backend=``,
    ``rescue_rounds=``, ``device=``: the card unless ``device='cpu'``)
    and closes it with the mapper.  The pre-filter runs on the session's
    device.
    """

    #: MapBatchResult.stats key -> cumulative registry metric (deltas
    #: per batch; kill_rate is derived)
    FUNNEL_METRICS = {
        "n_reads": "mapper_reads_total",
        "n_mapped": "mapper_mapped_total",
        "n_candidates": "mapper_candidates_total",
        "n_killed": "mapper_killed_total",
        "n_aligned": "mapper_aligned_total",
        "n_no_candidates": "mapper_no_candidates_total",
    }

    def __init__(self, genome, cfg: MapperConfig | None = None, *,
                 session=None, **plan_kwargs):
        self.cfg = cfg or MapperConfig()
        self.genome = (encode_ref(genome) if isinstance(genome, str)
                       else np.asarray(genome, np.uint8))
        self.index = MinimizerIndex.build(
            self.genome, k=self.cfg.k, w=self.cfg.w,
            max_occ=self.cfg.max_occ)
        self._owns_session = session is None
        self.session = session if session is not None else api_session.plan(
            **plan_kwargs)
        # the mapper shares the session's observability domain: one
        # registry/trace carries the whole funnel -> align story
        self.obs = self.session.obs
        self._m = {k: self.obs.counter(name)
                   for k, name in self.FUNNEL_METRICS.items()}
        self._m_batches = self.obs.counter("mapper_batches_total")

    # -- stages ------------------------------------------------------------

    def candidates(self, read_codes: np.ndarray) -> list[Candidate]:
        """Stages 1+2 for one read: anchors -> chained candidate loci."""
        qpos, rpos = self.index.anchors(read_codes)
        return chain_anchors(
            qpos, rpos, len(read_codes),
            min_anchors=self.cfg.min_anchors,
            max_candidates=self.cfg.max_candidates,
            genome_len=self.index.genome_len)

    def _filter_scores(self, pairs, reads) -> np.ndarray:
        """Stage 3: one device call scoring every (read, candidate) pair.
        ``pairs`` is [(read_idx, Candidate)].  Lane count is padded to a
        power of two, as the reference pads it."""
        m = self.cfg
        lanes = 16
        while lanes < len(pairs):
            lanes *= 2
        packed_r, packed_f = pack_pairs(
            [reads[i][:m.seg_len] for i, _ in pairs],
            [self.genome[c.ref_start:c.ref_start + m.seg_len + m.band]
             for _, c in pairs],
            m.seg_len, m.band, lanes=lanes)
        scores = xdrop_extend(packed_r, packed_f, band=m.band,
                              x_drop=m.x_drop, device=self.session.device)
        return np.asarray(scores)[:len(pairs)]

    def _keep_threshold(self, read_len: int, cand: Candidate) -> int:
        scored = min(read_len, self.cfg.seg_len,
                     cand.ref_end - cand.ref_start + self.cfg.band)
        return max(1, int(self.cfg.min_score_frac * scored))

    # -- front end ---------------------------------------------------------

    def map_batch(self, reads) -> MapBatchResult:
        """Map a batch of reads (strings or ``encode`` code arrays).
        Each funnel stage runs under its own span; the batch stats are
        the registry-counter deltas across this call."""
        before = {k: m.value for k, m in self._m.items()}
        codes = [encode(r) if isinstance(r, str) else
                 np.asarray(r, np.uint8) for r in reads]

        with self.obs.span("mapper.map_batch", n_reads=len(codes)):
            with self.obs.span("index.lookup"):
                anchors = [self.index.anchors(rc) for rc in codes]
            with self.obs.span("chain"):
                per_read = [
                    chain_anchors(qpos, rpos, len(rc),
                                  min_anchors=self.cfg.min_anchors,
                                  max_candidates=self.cfg.max_candidates,
                                  genome_len=self.index.genome_len)
                    for (qpos, rpos), rc in zip(anchors, codes)]
            pairs = [(i, c) for i, cs in enumerate(per_read) for c in cs]

            if self.cfg.prefilter and pairs:
                with self.obs.span("prefilter", n_pairs=len(pairs)):
                    scores = self._filter_scores(pairs, codes)
                    keep = [s >= self._keep_threshold(len(codes[i]), c)
                            for s, (i, c) in zip(scores, pairs)]
            else:
                scores = np.zeros(len(pairs), np.int32)
                keep = [True] * len(pairs)

            with self.obs.span("align", n_pairs=sum(keep)):
                futs = {}                  # pair index -> AlignFuture
                for p, ((i, c), k) in enumerate(zip(pairs, keep)):
                    if k:
                        futs[p] = self.session.submit(
                            codes[i], self.genome[c.ref_start:c.ref_end])
                self.session.flush()
                results = {p: f.result() for p, f in futs.items()}
        return self._finalize(codes, per_read, pairs, scores, keep,
                              results, before)

    def _finalize(self, codes, per_read, pairs, scores, keep, results,
                  before):
        outcomes = [[] for _ in codes]    # CandidateOutcome per read
        best = [None] * len(codes)        # (dist, -chain_score, p)
        for p, ((i, c), s, k) in enumerate(zip(pairs, scores, keep)):
            res = results.get(p)
            ok = bool(res and res["ok"])
            dist = int(res["dist"]) if ok else -1
            outcomes[i].append(CandidateOutcome(
                c.ref_start, c.ref_end, c.score, int(s), not k, ok, dist))
            if ok:
                cand_key = (dist, -c.score, p)
                if best[i] is None or cand_key < best[i]:
                    best[i] = cand_key

        mapped = []
        for i, rc in enumerate(codes):
            if best[i] is None:
                mapped.append(MappedRead(i, False, -1, -1, -1, "", -1,
                                         tuple(outcomes[i])))
                continue
            _, _, p = best[i]
            _, c = pairs[p]
            res = results[p]
            mapped.append(MappedRead(
                i, True, c.ref_start, c.ref_start + int(res["ref_consumed"]),
                int(res["dist"]), res["cigar"], int(res["k_used"]),
                tuple(outcomes[i])))

        # record the funnel into the registry, then report this batch as
        # the counter DELTA across the call — MapBatchResult telemetry
        # is a registry view, not a hand-collected dict
        self._m_batches.inc()
        self._m["n_reads"].inc(len(codes))
        self._m["n_mapped"].inc(sum(1 for m in mapped if m.ok))
        self._m["n_candidates"].inc(len(pairs))
        self._m["n_killed"].inc(sum(1 for k in keep if not k))
        self._m["n_aligned"].inc(len(results))
        self._m["n_no_candidates"].inc(
            sum(1 for cs in per_read if not cs))
        stats = {k: self._m[k].value - before[k] for k in self._m}
        stats["kill_rate"] = (stats["n_killed"]
                              / max(1, stats["n_candidates"]))
        return MapBatchResult(mapped, stats)

    def map_read(self, read) -> MappedRead:
        return self.map_batch([read]).mapped[0]

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        if self._owns_session:
            self.session.close()

    def __enter__(self) -> "ReadMapper":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
