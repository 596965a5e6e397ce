"""The host's ladder time of the fused main path over repeated aligns, in
one checkout.

    python3 tools/torch_ladder_probe.py TREE LABEL

TREE is the root of a checkout (this one, or another commit unpacked with
``git archive``); the script imports that tree's ``chip_smoke`` and
``repro_torch``, builds its kernels, and aligns the main path's batch
(2,048 x 10 kbp, ``chip_smoke.long_reads``) three times in one process
with the default config, printing one JSON line per align (``align_s``,
``ladder_s``, ``decode_s``); the second align runs under cProfile, whose
top functions by own time follow its line.  The first align of a process
carries its one-time costs; the third shows the steady state.  Run it in
turns (A, B, B, A), each a fresh process.  Needs a CUDA card.
"""
from __future__ import annotations

import cProfile
import io
import json
import pstats
import sys
import time
from pathlib import Path

import torch


def main() -> None:
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("torch_ladder_probe: no CUDA card")
    tree, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.core.aligner import GenASMAligner
    from repro_torch.core.config import AlignerConfig
    cs.phase_build()
    dev = torch.device("cuda")
    rs = cs.long_reads()
    for run in range(3):
        aligner = GenASMAligner(AlignerConfig(), rescue_rounds=2, device=dev)
        torch.cuda.synchronize()
        prof = cProfile.Profile() if run == 1 else None
        if prof:
            prof.enable()
        start = time.perf_counter()
        aligner.align(rs.reads, rs.ref_segments)
        torch.cuda.synchronize()
        if prof:
            prof.disable()
        print(json.dumps(dict(label=label, run=run,
                              align_s=time.perf_counter() - start,
                              ladder_s=aligner.last_run["ladder_s"],
                              decode_s=aligner.last_run["decode_s"])),
              flush=True)
        if prof:
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime") \
                .print_stats(22)
            print(out.getvalue()[-6000:], flush=True)


if __name__ == "__main__":
    main()
