"""The session front door of two checkouts in turns, on one card.

    python3 tools/torch_session_ab.py TREE [TREE ...]

Runs, for each TREE in the order given (a checkout of this repository,
e.g. ``git archive <commit>`` unpacked under ``build/``; ``.`` for this
one), one fresh process that imports that tree's ``chip_smoke.py`` and
drives phase ``session``'s stream (2,048 CLR pairs of 1-16 kbp at 10 %
error, 16 with an insertion burst; the default ``AlignerConfig()``,
``rescue_rounds=2``, ``batch_lanes=1024``) through five passes on one
executable store, without the profiler: (a) sync, bucket rescue, cold;
(b) the same, warm; (c) the threaded executor; (d) device rescue, cold;
(d_warm) the same, warm.  Each
pass's records are held against ``GenASMAligner`` of the same tree.
Prints one JSON line per tree: pairs/s of each pass, its ``wall_s``
(dispatch) and ``retire_wall_s``, its dispatches and builds, and the
aligner's pairs/s; then the card's name and power limit.  List the trees
in turns (parent, change, change, parent) to compare two commits.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

DRIVER = r"""
import json, sys, time
sys.path[:0] = [{tree!r}, {tree!r} + "/src"]
import torch
import chip_smoke as c
from repro_torch.api import CompileCache, plan
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.config import AlignerConfig

cuda = torch.device("cuda")
c.phase_build()
genome = c.synth_genome(5_000_000, seed=2022)
reads, refs, _ = c.ragged_pairs(genome, 2048, 1_000, 16_000, seed=2026,
                                n_burst=16)
cfg = AlignerConfig()
t0 = time.perf_counter()
want = GenASMAligner(cfg, rescue_rounds=2, device=cuda).align(reads, refs)
aligner_s = time.perf_counter() - t0
kw = dict(rescue_rounds=2, batch_lanes=1024, max_inflight=2,
          cache=CompileCache(), device=cuda)
row = dict(tree={tree!r}, aligner_pairs_per_s=len(reads) / aligner_s)
for label, extra in (("a", {{}}), ("b", {{}}), ("c", {{"executor": "thread"}}),
                     ("d", {{"rescue_mode": "device"}}),
                     ("d_warm", {{"rescue_mode": "device"}})):
    out = c._session_pass(label, plan(cfg, **extra, **kw), reads, refs,
                          want, cuda)
    row[label] = {{k: out[k] for k in ("pairs_per_s", "seconds", "wall_s",
                                       "retire_wall_s", "dispatches",
                                       "builds")}}
print("AB " + json.dumps(row), flush=True)
"""


def main() -> None:
    trees = sys.argv[1:]
    if not trees:
        raise SystemExit(__doc__)
    for tree in trees:
        tree = str(Path(tree).resolve())
        out = subprocess.run([sys.executable, "-c", DRIVER.format(tree=tree)],
                             cwd=tree, capture_output=True, text=True)
        lines = [line[3:] for line in out.stdout.splitlines()
                 if line.startswith("AB ")]
        if out.returncode or not lines:
            print(out.stdout[-2000:], out.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"{tree}: exit {out.returncode}")
        print(lines[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
