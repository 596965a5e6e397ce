"""K3 (``genasm_dc``, the split path's DC kernel) of the PyTorch/CUDA port
over its band placement, block size and ring chunk.

    python3 tools/torch_k3_sweep.py [--threads 128,256,512,1024]
                                    [--chunks 4,8,16] [--reps 20]
                                    [--widths 32,64,96,128] [--ks 12,24,48]

For each W of ``--widths`` (O = 3W/8; up to 256, whose NW = 5..8
instantiations live in ``dc_band_wide.cu``, one placement each) and each k of ``--ks`` (default the
ladder's 12, 24, 48) below W, at 2,048 and 4,096 lanes of the inputs
``chip_smoke.py`` gives K3: the kernel launched through its C entry point
(``chip_smoke.k3_launcher``) in each band placement (``staged``: the ring
in shared memory at each chunk; ``direct``) at each number of threads per
block (``genasm_dc.dc_band_geometry(cfg, threads, placement=...,
chunk=...)``; a block whose shared memory or registers do not fit
(``genasm_dc.max_threads``, then the card's occupancy query), a staged
block of fewer than 8 lanes, or a placement not instantiated, is
skipped), held against ``dc_band_plain`` (max abs err 0 or it raises), with its device ms per launch (``chip_smoke._device_ms``), its
block, shared bytes and blocks per SM.  ``genasm_dc.K3_PLACEMENT``,
``K3_LANES`` and ``K3_CHUNK`` record what this sweep measured fastest.
One JSON line per case; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                          # noqa: E402
from repro_torch.core.config import AlignerConfig               # noqa: E402
from repro_torch.kernels import genasm_dc                       # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", default="128,256,512,1024")
    ap.add_argument("--chunks", default="4,8,16")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--widths", default="32,64,96,128")
    ap.add_argument("--ks", default="12,24,48")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_sweep: no CUDA card")
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda")
    chunks = [int(c) for c in args.chunks.split(",")]
    for W in (int(w) for w in args.widths.split(",")):
        for k in (int(k) for k in args.ks.split(",")):
            if k >= W:
                continue
            cfg = AlignerConfig(W=W, O=3 * W // 8, k=k)
            for lanes in (2048, 4096):
                inputs, kw, _ = cs._case("dc_band", cfg, lanes,
                                         np.random.default_rng(k + W), dev)
                ref = genasm_dc.dc_band_plain(*inputs, **kw)
                for placement in genasm_dc.K3_PLACEMENTS:
                    for chunk in (chunks if placement == "staged"
                                  else [None]):
                        for threads in (int(t)
                                        for t in args.threads.split(",")):
                            try:
                                geo = genasm_dc.dc_band_geometry(
                                    cfg, threads, placement=placement,
                                    chunk=chunk)
                            except ValueError:
                                continue
                            blocks, _ = genasm_dc.dc_band_occupancy(cfg, geo)
                            if blocks == 0:     # its registers do not fit
                                continue
                            call = cs.k3_launcher(cfg, geo, inputs)
                            err = cs._max_abs_err("dc_band", call(), ref,
                                                  f"{geo}")
                            for _ in range(2):
                                call()
                            print(json.dumps(dict(
                                W=W, k=k, NW=cfg.nw,
                                KP=genasm_dc.levels_bucket(k), lanes=lanes,
                                placement=placement, chunk=geo.chunk,
                                threads=geo.threads,
                                lanes_per_block=geo.lanes,
                                ms=cs._device_ms(call, args.reps, dev),
                                max_abs_err=err,
                                shared_bytes=geo.shared_bytes,
                                blocks_per_sm=blocks)), flush=True)


if __name__ == "__main__":
    main()
