"""Where a K1 launch's time goes: K1 built three ways and timed.

    python3 tools/torch_k1_breakdown.py [--reps 50] [--widths 64]
                                        [--ks 12,24,48]

Builds K1 (its body ``csrc/tb_fused.cuh`` and the two units that
instantiate it, ``tb_fused.cu`` and ``tb_fused_wide.cu``) three times into
``build/k1_breakdown/`` (one ``nvcc`` each, all started together): as it
is (``full``); with the walk switched off (``no_walk``); and with the walk
and the fill's band stores switched off (``no_walk_no_store``).  The
switches are two preprocessor macros that this script writes into a copy
of ``tb_fused.cuh``; it refuses to run if either place it patches has moved.
Then it times each build's K1 on the inputs ``chip_smoke.py`` gives it,
at 2,048 and 4,096 lanes for each W of ``--widths`` (O = 3W/8) and each k
of ``--ks`` below W (device ms per launch,
``chip_smoke._device_ms``).  ``full - no_walk`` is the walk's share, and
``no_walk - no_walk_no_store`` the band stores'.  The variants' outputs
are not checked: they compute less.  One JSON line per (k, lanes), and the
card's clocks before and after; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                          # noqa: E402
from repro_torch.core.config import AlignerConfig               # noqa: E402
from repro_torch.kernels import build, genasm_dc                # noqa: E402

#: the two switches, as (lines of the source, lines with its macro)
SWITCHES = [("  if (walker) {\n    const int w = threadIdx.x, wdist",
             "  if (walker && K1_WALK) {\n    const int w = threadIdx.x, wdist"),
            ("    if (on && j >= col0) store(j);",
             "    if (K1_STORE && on && j >= col0) store(j);")]
VARIANTS = {"full": (1, 1), "no_walk": (0, 1), "no_walk_no_store": (0, 0)}


def build_variants(out_dir: Path) -> dict:
    """{variant: its genasm_tb_fused_launch}, built in parallel."""
    src = (build.CSRC / "tb_fused.cuh").read_text()
    for line, switched in SWITCHES:
        if src.count(line) != 1:
            raise RuntimeError(f"source line not found once: {line!r}")
        src = src.replace(line, switched)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tb_fused.cuh").write_text(src)
    units = ("tb_fused.cu", "tb_fused_wide.cu")
    for name in (*units, "genasm_common.cuh"):   # beside the patched body
        shutil.copy(build.CSRC / name, out_dir / name)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", f"-DK1_WALK={walk}",
         f"-DK1_STORE={store}", "-o", str(out_dir / f"lib_{name}.so"),
         *(str(out_dir / unit) for unit in units)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (walk, store) in VARIANTS.items()}
    launches = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(out_dir / f"lib_{name}.so")).genasm_tb_fused_launch
        fn.argtypes = build._SIGNATURES["genasm_tb_fused_launch"]
        fn.restype = ctypes.c_int
        launches[name] = fn
    return launches


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--widths", default="64")
    ap.add_argument("--ks", default="12,24,48")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_breakdown: no CUDA card")
    cs.phase_device()
    launches = build_variants(ROOT / "build" / "k1_breakdown")
    print(json.dumps(dict(clocks_before=clocks())), flush=True)
    dev = torch.device("cuda")
    cases = [(W, k) for W in (int(w) for w in args.widths.split(","))
             for k in (int(k) for k in args.ks.split(",")) if k < W]
    for W, k in cases:
        cfg = AlignerConfig(W=W, O=3 * W // 8, k=k)
        geo = genasm_dc.tb_fused_geometry(cfg)
        for lanes in (2048, 4096):
            (pm, text), kw, _ = cs._case("tb_fused", cfg, lanes,
                                         np.random.default_rng(k), dev)
            ops = torch.empty((kw["max_ops"], lanes), dtype=torch.int32,
                              device=dev)
            meta = torch.empty((genasm_dc.META_ROWS, lanes),
                               dtype=torch.int32, device=dev)
            store = torch.empty((lanes, geo.store_words) if geo.store_words
                                else 0, dtype=torch.int32, device=dev)
            row = dict(W=W, k=k, lanes=lanes, placement=geo.placement)
            for name, fn in launches.items():
                def call(fn=fn):
                    rc = fn(pm.data_ptr(), text.data_ptr(), ops.data_ptr(),
                            meta.data_ptr(), store.data_ptr(), lanes, cfg.W,
                            cfg.nw, k,
                            cfg.nwb, cfg.ncols_band, int(cfg.early_term),
                            kw["commit_limit"], kw["max_ops"],
                            kw["max_steps"], geo.lanes, geo.threads,
                            genasm_dc.PLACEMENTS.index(geo.placement),
                            geo.shared_bytes,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{name}: CUDA error {rc}")
                for _ in range(3):
                    call()
                row[name] = cs._device_ms(call, args.reps, dev)
            print(json.dumps(row), flush=True)
    print(json.dumps(dict(clocks_after=clocks())), flush=True)


if __name__ == "__main__":
    main()
