"""repro_torch.mapper — the mapping front half (port of ``repro.mapper``):
minimizer index, colinear chaining, X-drop pre-filter in PyTorch, and the
ReadMapper pipeline that feeds surviving candidates through the port's
AlignSession front door, on the card unless asked for the CPU.

    from repro_torch.mapper import ReadMapper, MapperConfig
    with ReadMapper(genome, rescue_rounds=2) as m:    # device="cuda"
        out = m.map_batch(reads)        # strings or encoded codes
        out.mapped[0].cigar, out.stats["kill_rate"]
"""
from .chain import Candidate, chain_anchors
from .index import MinimizerIndex, minimizers
from .pipeline import (CandidateOutcome, MapBatchResult, MappedRead,
                       MapperConfig, ReadMapper)
from .prefilter import pack_pairs, xdrop_extend

__all__ = [
    "Candidate", "chain_anchors", "MinimizerIndex", "minimizers",
    "CandidateOutcome", "MapBatchResult", "MappedRead", "MapperConfig",
    "ReadMapper", "pack_pairs", "xdrop_extend",
]
