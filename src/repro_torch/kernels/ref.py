"""Plain oracle for the DC kernel K3 (port of ``repro/kernels/ref.py``).

Defers to ``core.genasm.dc_dmajor`` (the level-major fill with
whole-batch early termination) and reshapes to the kernel's output
layout.  Levels from ``levels`` up are zero here; K3 fills every level.
"""
from __future__ import annotations

from ..core.config import AlignerConfig
from ..core.genasm import dc_dmajor


def genasm_dc_ref(pat_codes, text_codes, *, cfg: AlignerConfig):
    """pat/text: (B, W) standard layout.  Returns (dist (B,), band
    (k+1, ncb, nwb, B) as int64 words, levels ())."""
    res = dc_dmajor(pat_codes, text_codes, cfg=cfg)
    return res.dist, res.store["Rb"].permute(0, 1, 3, 2), res.levels_run
