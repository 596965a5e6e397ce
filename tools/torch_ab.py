"""The four kernels and the fused main path of the port in one checkout,
for an A/B of two commits inside one chip call.

    python3 tools/torch_ab.py TREE [--label NAME] [--reps 20]

TREE is the root of a checkout of the repository: this one, or another
commit unpacked with ``git archive``.  The script imports that tree's
``chip_smoke`` and ``repro_torch`` (so it measures that tree's kernels,
built from its own sources), then prints one JSON line per measurement:
each kernel at 4,096 lanes on the inputs that tree's ``chip_smoke`` gives
it (K1 ``tb_fused`` and K3 ``dc_band`` at k = 12, 24 and 48, K2
``tail_banded`` at k = 12, K4 ``tail_full`` at k = 24 and 48), its device
ms per launch from a CUDA graph of ``--reps`` calls replayed between two
CUDA events; then ``chip_smoke.phase_main_path`` on the 2,048 x 10 kbp
batch (its ``main_path`` and ``main_path_profile`` lines); then a summary.
``issue_us`` is the host's time to issue one K1 wrapper call at the main
path's width (2,048 lanes, k=12): ``--issue`` calls back to back on the
host clock, the wait for the card after them left out (the queue holds
them all).
Run it in turns (A, B, B, A), each a fresh process.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


#: (kernel, k) timed at 4,096 lanes: each kernel at the k the main path
#: gives it (K2 at the base k, K4 on the rescue rungs)
KERNEL_CASES = [("tb_fused", 12), ("tb_fused", 24), ("tb_fused", 48),
                ("tail_banded", 12), ("tail_full", 24), ("tail_full", 48),
                ("dc_band", 12), ("dc_band", 24), ("dc_band", 48)]


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of `fn`: `reps` calls in one CUDA graph, replayed
    between two CUDA events (``chip_smoke._device_ms``, kept here because
    an older tree's ``chip_smoke`` may not have it)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--issue", type=int, default=200)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: no CUDA card")
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.core.config import AlignerConfig
    label = args.label or tree.name
    dev = torch.device("cuda")
    cs.phase_device()
    cs.phase_build()
    kernel_ms = {}
    for name, k in KERNEL_CASES:
        wrapper = cs.KERNELS[name][0]
        inputs, kw, _ = cs._case(name, AlignerConfig(k=k), 4096,
                                 np.random.default_rng(2022 + k), dev)
        for _ in range(3):
            wrapper(*inputs, **kw)
        ms = graph_ms(lambda: wrapper(*inputs, **kw), args.reps)
        kernel_ms[f"{name}@{k}"] = ms
        print(json.dumps(dict(phase="ab_kernel", label=label, name=name, k=k,
                              lanes=4096, ms=ms)), flush=True)
    wrapper = cs.KERNELS["tb_fused"][0]
    inputs, kw, _ = cs._case("tb_fused", AlignerConfig(k=12), 2048,
                             np.random.default_rng(2034), dev)
    issue_us = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(args.issue):
            wrapper(*inputs, **kw)
        issue_us.append((time.perf_counter() - start) * 1e6 / args.issue)
    torch.cuda.synchronize()
    print(json.dumps(dict(phase="ab_issue", label=label, k=12, lanes=2048,
                          calls=args.issue, issue_us=issue_us)), flush=True)
    fused, _ = cs.phase_main_path(dev, cs.long_reads())
    print(json.dumps(dict(phase="ab_summary", label=label,
                          kernel_ms=kernel_ms,
                          issue_us=min(issue_us),
                          pairs_per_s=fused["pairs_per_s"],
                          ladder_s=fused["ladder_s"],
                          decode_s=fused["decode_s"])), flush=True)


if __name__ == "__main__":
    main()
