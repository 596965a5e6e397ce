"""The rows of K1, K2 / K4 and K3 at a few widths in one checkout, for an
A/B of two commits inside one chip call.

    python3 tools/torch_xwide_ab.py TREE [--label NAME]
                                    [--ladder W:k,k,...]... [--k3-lanes N]

TREE is the root of a checkout of the repository: this one, or another
commit unpacked with ``git archive`` (e.g. under ``build/``).  The script
imports that tree's ``chip_smoke`` and ``repro_torch`` (so it measures that
tree's kernels, built from its own sources, through its own routes) and
prints one JSON line per row.  For each ``--ladder`` W and its ks (O =
3W/8; default ``512:60,120,240,480``): K1's window form beside the
standalone form on the same slices at each k, 2,048 lanes
(``chip_smoke._tb_window_rows``; at W = 512 only k = 60 and 480), with the
peak of device memory the row allocated; then K1, the rung's tail (K2
where ``cfg.tail_banded``, else K4) and K3 at each k on 2,048 lanes
(``chip_smoke._ladder_rows``, 256 lanes drawn and repeated), each row's
device ms from a CUDA graph (of 20 calls at W <= 256 after 2 warm-up
calls; of one call at W > 256, whose calls take 8-580 ms), its bound, its
block and its peak memory.  ``--k3-lanes`` sets the tree's
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

KEEP = ("name", "W", "k", "lanes", "ms", "event_ms", "standalone_ms",
        "bound_ms", "bound_by", "store_floor_ms", "ptxas", "family",
        "blocks_per_sm", "lanes_per_block", "threads", "shared_bytes",
        "placement", "store_bytes_per_lane", "chunk", "staging_rows",
        "peak_bytes", "later_lanes_max_abs_err")


def _ladder(spec: str) -> tuple:
    W, ks = spec.split(":")
    return int(W), tuple(int(k) for k in ks.split(","))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--ladder", type=_ladder, action="append",
                    help="W:k,k,... (repeatable)")
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
    for W, ks in args.ladder or [_ladder("512:60,120,240,480")]:
        wide = W > 256
        reps, warm = (cs.W512_REPS, 0) if wide else (20, 2)
        rows = []
        for k in ks:
            if wide and k not in (60, 480):
                continue
            torch.cuda.reset_peak_memory_stats(dev)
            window = cs._tb_window_rows(dev, reps, lane_counts=(2048,),
                                        cases=[(W, 3 * W // 8, (k,))])
            for row in window:
                row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            rows += window
            torch.cuda.empty_cache()
        rows += cs._ladder_rows(dev, reps, usage, (W, 3 * W // 8, ks), 2048,
                                distinct=cs.W512_DISTINCT, warm=warm)
        for row in rows:
            print(json.dumps(dict(phase="xwide_ab", label=label,
                                  **{k: row.get(k) for k in KEEP})),
                  flush=True)


if __name__ == "__main__":
    main()
