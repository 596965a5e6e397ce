"""Host time of one launch of a session's captured graph, by its nodes.

    python3 tools/torch_launch_cost.py

For the default ``AlignerConfig()`` at 1,024 lanes and read buckets of 1,
4 and 16 kbp: the bucket-mode executable's graph launched by torch's
``replay()``, the same capture as the one child node of a
``kernels.ladder_graph.CondGraph``, the device-mode ladder graph (each
rung's gates and IF node nested in the body of the rung before), and the
same captures with every IF node at the top (``flat_ladder``); each the
median and the least host milliseconds of 20 launches from an idle card.
One JSON line per bucket, with the nodes of each; needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                          # noqa: E402
from repro_torch.api.session import build_executable           # noqa: E402
from repro_torch.core.config import AlignerConfig               # noqa: E402
from repro_torch.kernels import ladder_graph                    # noqa: E402


def host_ms(fn, reps: int = 20) -> tuple:
    """(median, least) host ms of `fn`, each call from an idle card."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return round(statistics.median(out), 4), round(min(out), 4)


def flat_ladder(graphs, device: torch.device):
    """A device-mode ``GraphedStep``'s captures as a ladder whose IF nodes
    all sit in the top graph, each body holding one rung."""
    flat = ladder_graph.CondGraph(device)
    for g in (*graphs.rungs[0], graphs.totals[0]):
        flat.child(g.graph)
    failed = [st["failed"] for st in graphs.states]
    for rnd in range(1, len(graphs.rungs)):
        body = flat.branch(failed, graphs.gate_flags[rnd - 1])
        for g in (*graphs.rungs[rnd], graphs.totals[rnd]):
            body.child(g.graph)
    flat.instantiate()
    return flat


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_launch_cost: no CUDA card")
    cuda = torch.device("cuda", 0)
    cs.phase_device()
    cs.phase_build()
    cfg = AlignerConfig()
    for rb in (1024, 4096, 16384):
        exe = build_executable(cfg, 1024, rb, rb, None, cuda)
        graph = exe.graphs.rungs[0][0]
        cond = ladder_graph.CondGraph(cuda)
        cond.child(graph.graph)
        cond.instantiate()
        ladder = build_executable(cfg, 1024, rb, rb, 2, cuda).graphs
        print(json.dumps(dict(
            read_bucket=rb, nodes=graph.stats["nodes"],
            torch_replay_ms=host_ms(graph.graph.replay),
            cond_child_launch_ms=host_ms(cond.launch),
            ladder_launch_ms=host_ms(ladder.ladder.launch),
            flat_ladder_launch_ms=host_ms(flat_ladder(ladder, cuda).launch),
            ladder_nodes=sum(st["nodes"] for st in ladder.stats))),
            flush=True)


if __name__ == "__main__":
    main()
