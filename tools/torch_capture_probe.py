"""Which work on another thread a session's CUDA graph capture survives,
on the card.

    python3 tools/torch_capture_probe.py [--kinds a,b,...]

For each kind of work below, one thread captures a fresh executable
(``api.session.build_executable``, the default ``AlignerConfig()``, a
16 kbp read bucket, 512 lanes: about a second of capture) while a second
thread repeats that work until the capture ends; then the captured call
is held against the eager step.  Prints one JSON line per kind: whether
the capture succeeded, how often the other thread's work ran, and the
error if any; then the card's name and power limit.  Kinds:

* ``download``: ``x.cpu()`` on a side stream (what a retire thread does);
* ``download_default``: the same on the default stream;
* ``pinned_upload``: a pinned host tensor copied to the card without a
  sync, on a side stream (a dispatch's upload);
* ``replay``: replays of another captured executable on a side stream;
* ``launch_plan``: a rescue rung's launch plan (occupancy queries);
* ``eager``: an eager align step on a side stream;
* ``free_graphs``: executables captured before the trial dropped one
  every 20 ms (their CUDA graphs destroyed);
* ``stream_sync``: ``torch.cuda.current_stream().synchronize()`` on the
  default stream;
* ``device_sync``: ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import json
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
from repro_torch.serve.align_step import launch_plan  # noqa: E402

KINDS = ("download", "download_default", "pinned_upload", "replay",
         "launch_plan", "eager", "free_graphs", "stream_sync", "device_sync")


def _inputs(cfg, lanes, bucket, device):
    g = torch.Generator().manual_seed(bucket + lanes)
    (rs, _), (ls, _), (fs, _), _ = bucket_avals(cfg, lanes, bucket, bucket)
    reads = torch.randint(0, 4, rs, generator=g, dtype=torch.uint8)
    refs = torch.full(fs, 9, dtype=torch.uint8)
    refs[:, :bucket] = reads[:, :bucket]
    n = torch.full(ls, bucket, dtype=torch.int32)
    return transfer.to_device((reads.numpy(), n.numpy(), refs.numpy(),
                               n.numpy()), device)


def _work(kind, device, side, other, small_args):
    """One repetition of `kind`'s work on the second thread."""
    if kind == "download":
        with torch.cuda.stream(side):
            torch.ones(1 << 16, device=device).cpu()
    elif kind == "download_default":
        torch.ones(1 << 16, device=device).cpu()
    elif kind == "pinned_upload":
        with torch.cuda.stream(side):
            torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True).to(
                device, non_blocking=True)
            side.synchronize()
    elif kind == "free_graphs":
        time.sleep(0.02)            # spread the frees over the capture
        if _work.doomed:
            _work.doomed.pop()
    elif kind == "replay":
        with torch.cuda.stream(side):
            other(*small_args)
            side.synchronize()
    elif kind == "launch_plan":
        launch_plan(AlignerConfig(k=24), 1024, None, device)
    elif kind == "eager":
        with torch.cuda.stream(side):
            other.step(*small_args)
            side.synchronize()
    elif kind == "stream_sync":
        torch.cuda.current_stream(device).synchronize()
    elif kind == "device_sync":
        torch.cuda.synchronize(device)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kinds", default=",".join(KINDS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = AlignerConfig()
    side = torch.cuda.Stream(device)
    other = build_executable(cfg, 256, 1024, 1024, None, device)
    small_args = _inputs(cfg, 256, 1024, device)
    other(*small_args)
    for i, kind in enumerate(args.kinds.split(",")):
        lanes = 512 + 128 * i            # a new shape: a fresh capture
        built, errors, reps = [], [], 0
        _work.doomed = ([build_executable(cfg, 128 * (j + 1), 1024, 1024,
                                          None, device) for j in range(12)]
                        if kind == "free_graphs" else [])

        def build():
            try:
                built.append(build_executable(cfg, lanes, 16384, 16384,
                                              None, device))
            except BaseException as e:          # reported below
                errors.append(repr(e)[:300])
        thread = threading.Thread(target=build)
        t0 = time.perf_counter()
        thread.start()
        while thread.is_alive():
            try:
                _work(kind, device, side, other, small_args)
            except BaseException as e:          # reported below
                errors.append(f"other thread: {e!r}"[:300])
                thread.join()
                break
            reps += 1
        thread.join()
        row = dict(kind=kind, capture_ok=bool(built) and not errors,
                   other_thread_reps=reps,
                   seconds=time.perf_counter() - t0, errors=errors)
        if built:
            torch.cuda.synchronize()
            args_ = _inputs(cfg, lanes, 16384, device)
            got, want = built[0](*args_), built[0].step(*args_)
            row["equal_to_eager"] = all(
                torch.equal(got[0][k], want[0][k]) for k in want[0]
                if isinstance(want[0][k], torch.Tensor))
        print(json.dumps(row), flush=True)
        torch.cuda.synchronize()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
