"""The tail kernels K2 and K4 of the PyTorch/CUDA port over their store
placement and block size.

    python3 tools/torch_tail_sweep.py [--threads 32,64,128,256] [--reps 20]
                                      [--widths 32,64,96,128] [--ks 12,24,48]

For each W of ``--widths`` (O = 3W/8; up to 256, whose NW = 5..8
instantiations live in ``tail_fused_wide.cu``) and each k of ``--ks``
(default the ladder's 12, 24, 48) below W, the tail kernel that configuration selects
(K2 ``tail_banded`` where the band is narrower than the vector, else K4
``tail_full``), at 2,048 and 4,096 lanes of the inputs ``chip_smoke.py``
gives it: the kernel launched through its C entry point in each store
placement (``shared``, ``global``) at each number of threads per block
(``genasm_dc.tail_geometry(cfg, ..., placement=..., threads=...)``; a
block whose lanes' stores do not fit shared memory, whose registers do not
fit the block (``genasm_dc.max_threads``) or an SM, or a placement not
instantiated (shared at W > 128) is skipped), held
against its plain version (max abs err 0 or it raises), with its device
ms per launch (``chip_smoke._device_ms``), its block, shared bytes and
blocks per SM.  ``genasm_dc.TAIL_PLACEMENT`` records, per (NW, KP), the
placement this sweep measured faster.  One JSON line per case; needs a
CUDA card.
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
    ap.add_argument("--threads", default="32,64,128,256")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--widths", default="32,64,96,128")
    ap.add_argument("--ks", default="12,24,48")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_tail_sweep: no CUDA card")
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda")
    for W in (int(w) for w in args.widths.split(",")):
        for k in (int(k) for k in args.ks.split(",")):
            if k >= W:
                continue
            cfg = AlignerConfig(W=W, O=3 * W // 8, k=k)
            name = "tail_banded" if cfg.tail_banded else "tail_full"
            n_text = W + 4 * k
            for lanes in (2048, 4096):
                inputs, kw, _ = cs._case(name, cfg, lanes,
                                         np.random.default_rng(k + W), dev)
                ref = cs.KERNELS[name][1](*inputs, **kw)
                for placement in genasm_dc.PLACEMENTS:
                    for threads in (int(t) for t in args.threads.split(",")):
                        if threads < min(genasm_dc.levels_bucket(k), 32):
                            continue        # less than one lane's group
                        try:
                            geo = genasm_dc.tail_geometry(
                                cfg, n_text, kw["max_ops"],
                                banded=name == "tail_banded",
                                placement=placement, threads=threads)
                        except ValueError:
                            continue
                        if geo.shared_bytes > genasm_dc.MAX_SHARED_BYTES:
                            continue
                        blocks, _ = genasm_dc.tail_occupancy(
                            cfg, geo, name == "tail_banded")
                        if blocks == 0:     # its registers do not fit
                            continue
                        call = cs.tail_launcher(name, cfg, geo, inputs, kw)
                        err = cs._max_abs_err(name, call(), ref,
                                              f"{geo}")
                        for _ in range(2):
                            call()
                        print(json.dumps(dict(
                            name=name, W=W, k=k, NW=cfg.nw,
                            KP=genasm_dc.levels_bucket(k), lanes=lanes,
                            placement=placement, threads=geo.threads,
                            lanes_per_block=geo.lanes,
                            ms=cs._device_ms(call, args.reps, dev),
                            max_abs_err=err, shared_bytes=geo.shared_bytes,
                            store_words=geo.store_words,
                            blocks_per_sm=blocks)), flush=True)


if __name__ == "__main__":
    main()
