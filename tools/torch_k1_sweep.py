"""K1 (``genasm_tb_fused``) of the PyTorch/CUDA port over block sizes.

    python3 tools/torch_k1_sweep.py [--threads 64,128,256,512] [--reps 20]
                                    [--widths 64] [--ks 12,24,48]

For each number of threads per block, each W of ``--widths`` (O = 3W/8;
W = 64 gives O = 24; up to 256, whose NW = 5..8 instantiations live in
``tb_fused_wide.cu``) and each k of ``--ks`` below W (default the ladder's
12, 24, 48), at 2,048 and 4,096 lanes of the inputs
``chip_smoke.py`` gives K1: the kernel launched at that block
(``genasm_dc.tb_fused_geometry(cfg, threads=...)``, through the C entry
point; the wrapper itself always launches ``K1_THREADS``; a block whose
shared memory or registers do not fit, ``genasm_dc.max_threads`` or the
card's occupancy query, is skipped) against
``tb_fused_plain`` (max abs err 0 or it raises), its device ms per launch
(``chip_smoke``'s CUDA graph timing), and the geometry, shared bytes and
blocks per SM of that block.  One JSON line per case; needs a CUDA card.
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
from repro_torch.kernels import build, genasm_dc                # noqa: E402


def launcher(cfg: AlignerConfig, geo, inputs, kw):
    """A call of K1 at block `geo` on `inputs`, and its (ops, meta)."""
    pm, text = inputs
    lanes = pm.shape[-1]
    ops = torch.empty((kw["max_ops"], lanes), dtype=torch.int32,
                      device=pm.device)
    meta = torch.empty((genasm_dc.META_ROWS, lanes), dtype=torch.int32,
                       device=pm.device)
    store = torch.empty((lanes, geo.store_words) if geo.store_words else 0,
                        dtype=torch.int32, device=pm.device)
    lib = build.load_library()

    def call():
        rc = lib.genasm_tb_fused_launch(
            pm.data_ptr(), text.data_ptr(), ops.data_ptr(), meta.data_ptr(),
            store.data_ptr(), lanes, cfg.W, cfg.nw, cfg.k, cfg.nwb,
            cfg.ncols_band, int(cfg.early_term), kw["commit_limit"],
            kw["max_ops"], kw["max_steps"], geo.lanes, geo.threads,
            genasm_dc.PLACEMENTS.index(geo.placement), geo.shared_bytes,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K1 at {geo}: CUDA error {rc}")
        return ops, meta
    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", default="64,128,256,512")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--widths", default="64")
    ap.add_argument("--ks", default="12,24,48")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_sweep: no CUDA card")
    cs.phase_device()
    cs.phase_build()
    dev = torch.device("cuda")
    cases = [(W, k) for W in (int(w) for w in args.widths.split(","))
             for k in (int(k) for k in args.ks.split(",")) if k < W]
    for threads in (int(t) for t in args.threads.split(",")):
        for W, k in cases:
            cfg = AlignerConfig(W=W, O=3 * W // 8, k=k)
            try:
                geo = genasm_dc.tb_fused_geometry(cfg, threads=threads)
            except ValueError as exc:   # its registers do not fit
                print(json.dumps(dict(threads=threads, W=W, k=k,
                                      skipped=str(exc))), flush=True)
                continue
            if geo.shared_bytes > genasm_dc.MAX_SHARED_BYTES:
                print(json.dumps(dict(threads=threads, W=W, k=k,
                                      shared_bytes=geo.shared_bytes,
                                      skipped="shared memory")), flush=True)
                continue
            blocks, _ = genasm_dc.tb_fused_occupancy(cfg, geo)
            if blocks == 0:
                print(json.dumps(dict(threads=threads, W=W, k=k,
                                      skipped="no block fits an SM")),
                      flush=True)
                continue
            for lanes in (2048, 4096):
                inputs, kw, _ = cs._case("tb_fused", cfg, lanes,
                                         np.random.default_rng(k), dev)
                call = launcher(cfg, geo, inputs, kw)
                got = call()
                ref = genasm_dc.tb_fused_plain(*inputs, **kw)
                err = max(int((a.long() - b.long()).abs().max())
                          for a, b in zip(got, ref))
                if err != 0:
                    raise AssertionError(f"threads={threads} W={W} k={k}: "
                                         f"K1 and tb_fused_plain differ "
                                         f"({err})")
                for _ in range(2):
                    call()
                print(json.dumps(dict(
                    threads=threads, W=W, k=k, lanes=lanes,
                    ms=cs._device_ms(call, args.reps, dev), max_abs_err=err,
                    G=geo.group, lanes_per_block=geo.lanes,
                    shared_bytes=geo.shared_bytes, blocks_per_sm=blocks)),
                      flush=True)


if __name__ == "__main__":
    main()
