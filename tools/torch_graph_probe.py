"""Host cost of a session executable's CUDA graph on the card, and what
changes it.

    python3 tools/torch_graph_probe.py

Builds (captures) the executable of one bucket (1,024 lanes, the default
``AlignerConfig()``) at a 1 kbp and a 16 kbp read bucket, then times on
the host, each the median of 5 calls from an idle card: the graph's
``replay()`` alone and the executable's call (copy-in, replay,
clone-out).  It does so three times: fresh; after one run under
``torch.profiler`` (CUDA activity); and with a Python thread spinning
beside it (the GIL handed back and forth).  Prints one JSON line per
measurement and the card's name and power limit.  Needs one card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api.session import build_executable  # noqa: E402
from repro_torch.core import transfer  # noqa: E402
from repro_torch.core.config import AlignerConfig  # noqa: E402
from repro_torch.core.windowing import bucket_avals  # noqa: E402

LANES = 1024


def _host_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def _inputs(cfg, bucket, device):
    """A bucket's inputs of exact copies (random codes, full length)."""
    g = torch.Generator().manual_seed(bucket)
    (rs, _), (ls, _), (fs, _), _ = bucket_avals(cfg, LANES, bucket, bucket)
    reads = torch.randint(0, 4, rs, generator=g, dtype=torch.uint8)
    refs = torch.full(fs, 9, dtype=torch.uint8)
    refs[:, :bucket] = reads[:, :bucket]
    n = torch.full(ls, bucket, dtype=torch.int32)
    return transfer.to_device((reads.numpy(), n.numpy(), refs.numpy(),
                               n.numpy()), device)


def _measure(label: str, exes) -> None:
    for bucket, (exe, args) in exes.items():
        graph = exe.graphs.rungs[0][0]
        print(json.dumps(dict(when=label, read_bucket=bucket,
                              nodes=graph.stats["nodes"],
                              replay_ms=_host_ms(graph.replay),
                              call_ms=_host_ms(lambda: exe(*args)))),
              flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = AlignerConfig()
    exes = {}
    for bucket in (1024, 16384):
        t0 = time.perf_counter()
        exe = build_executable(cfg, LANES, bucket, bucket, None, device)
        print(json.dumps(dict(read_bucket=bucket, build_s=time.perf_counter()
                              - t0, **exe.graphs.stats[0])), flush=True)
        exes[bucket] = (exe, _inputs(cfg, bucket, device))
    _measure("fresh", exes)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        exes[1024][0](*exes[1024][1])
        torch.cuda.synchronize()
    _measure("after the profiler", exes)
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(1000))
    thread = threading.Thread(target=spin)
    thread.start()
    try:
        _measure("beside a spinning thread", exes)
    finally:
        stop.set()
        thread.join()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
