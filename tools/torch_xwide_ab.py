"""The wide family's rows at W = 512 in one checkout, for an A/B of two
commits inside one chip call.

    python3 tools/torch_xwide_ab.py TREE [--label NAME] [--ks 60,120,240,480]
                                    [--k3-lanes N]

TREE is the root of a checkout of the repository: this one, or another
commit unpacked with ``git archive`` (e.g. under ``build/``).  The script
imports that tree's ``chip_smoke`` and ``repro_torch`` (so it measures that
tree's kernels, built from its own sources) and prints one JSON line per
row: K1's window form beside the standalone form on the same slices at
W = 512, k = 60 and 480, 2,048 lanes (``chip_smoke._tb_window_rows``),
then K1, the rung's tail (K2 at k = 60, 120; K4 at 240, 480) and K3 at
each k of ``--ks`` on 2,048 lanes (``chip_smoke._ladder_rows``, 256 lanes
drawn and repeated), each row's device ms from a CUDA graph of one call,
its bound and its block.  ``--k3-lanes`` sets the tree's
``genasm_dc.XR_K3_LANES`` (K3's lane warps a block, where the tree has
them) for this run.  Run it in turns (A, B, B, A), each a fresh process;
compare only rows of one call.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--ks", default="60,120,240,480")
    ap.add_argument("--k3-lanes", type=int, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_xwide_ab: no CUDA card")
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import genasm_dc
    if args.k3_lanes is not None:
        if not hasattr(genasm_dc, "XR_K3_LANES"):
            raise SystemExit(f"torch_xwide_ab: {tree} has no XR_K3_LANES")
        genasm_dc.XR_K3_LANES = args.k3_lanes
    label = args.label or tree.name
    dev = torch.device("cuda")
    cs.phase_device()
    usage = cs.phase_build()
    ks = tuple(int(k) for k in args.ks.split(","))
    keep = ("name", "W", "k", "lanes", "ms", "event_ms", "standalone_ms",
            "bound_ms", "bound_by", "store_floor_ms", "ptxas",
            "blocks_per_sm", "lanes_per_block", "threads", "shared_bytes",
            "chunk", "staging_rows", "peak_bytes", "later_lanes_max_abs_err")
    rows = cs._tb_window_rows(dev, cs.W512_REPS, lane_counts=(2048,),
                              cases=[(512, 192, tuple(k for k in ks
                                                      if k in (60, 480)))])
    rows += cs._ladder_rows(dev, cs.W512_REPS, usage, (512, 192, ks), 2048,
                            distinct=cs.W512_DISTINCT, warm=0)
    for row in rows:
        print(json.dumps(dict(phase="xwide_ab", label=label,
                              **{k: row.get(k) for k in keep})), flush=True)


if __name__ == "__main__":
    main()
