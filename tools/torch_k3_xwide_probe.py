"""K3's wide kernel (``dc_band_xwide_kernel``, NW >= 9) on the card: checks,
block variants and source variants, at W = 512 on 2,048 lanes.

    python3 tools/torch_k3_xwide_probe.py check [--k3-lanes 8,16]
    python3 tools/torch_k3_xwide_probe.py blocks [--ks 60,120,240,480]
                                                 [--blocks 8x4,16x4,16x8]
    python3 tools/torch_k3_xwide_probe.py variants PATCHES.json [--ks ...]

``check``: builds the library, prints ptxas's report for the wide kernels
and the count of local-memory loads and stores (LDL / STL) in K3's SASS
(``cuobjdump``), holds K3 against ``dc_band_plain`` (max abs err 0 or
raise) at every case of ``chip_smoke.XWIDE_GRID`` and at W = 1056, k = 100
(9 lanes) and W = 1100, k = 300 (3 lanes), each multi-group case also on
a grid of a quarter of its groups, then times the wrapper (CUDA events, 2
calls after one) at W = 512, k = 60 / 120 / 240 / 480 for each
``XR_K3_LANES`` given.  ``blocks``: K3 launched through its C entry point
at each (lanes x chunk) given, the outputs of each held equal to the
first's, CUDA-event ms.  ``variants``: K3's unit built again (one ``nvcc``
each, started together) from copies of the sources with the text patches
of PATCHES.json (``{"name": [["old", "new"], ...]}``, applied to
``genasm_xwide_reg.cuh``; ``base`` is the tree's own), timed through the
wrapper; the variants compute less or more, their outputs are not
checked.  One JSON line a row; the card's name and power limit first.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs                                    # noqa: E402
from repro_torch.core.config import AlignerConfig          # noqa: E402
from repro_torch.kernels import build, genasm_dc           # noqa: E402

DEV = torch.device("cuda")


def _inputs(k: int):
    """W = 512 windows at 2,048 lanes (256 drawn, repeated)."""
    cfg = AlignerConfig(W=512, O=192, k=k)
    (pm, text), _, _ = cs._repeated(cs._case(
        "dc_band", cfg, 256, np.random.default_rng(512), DEV), 8)
    return cfg, pm, text


def _err(got, ref) -> int:
    return int(not all(torch.equal(a, b.to(a.device))
                       for a, b in zip(got, ref)))


def check(k3_lanes) -> None:
    usage = cs.phase_build()
    print(json.dumps({name: usage.get(name) for name in (
        "dc_band_xwide", "tb_fused_xwide", "tb_window_xwide",
        "tail_fused_xwide")}), flush=True)
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path())],
                          capture_output=True, text=True).stdout
    body = re.search(r"Function : \S*dc_band_xwide_kernel\S*(.*?)"
                     r"(?=\n\s*Function :|\Z)", sass, re.S)
    body = body.group(1) if body else ""
    print(json.dumps(dict(sass_lines=body.count("\n"),
                          LDL=len(re.findall(r"\bLDL", body)),
                          STL=len(re.findall(r"\bSTL", body)))), flush=True)
    rng = np.random.default_rng(17)
    for W, O, k, et, lanes in cs.XWIDE_GRID + [(1056, 300, 100, True, 9),
                                                (1100, 300, 300, True, 3)]:
        cfg = AlignerConfig(W=W, O=O, k=k, early_term=et)
        (pm, text), _, _ = cs._case("dc_band", cfg, lanes, rng, DEV)
        ref = genasm_dc.dc_band_plain(pm, text, cfg=cfg)
        row = dict(W=W, k=k, lanes=lanes, max_abs_err=cs._max_abs_err(
            "dc_band", genasm_dc.genasm_dc(pm, text, cfg=cfg), ref,
            f"W={W} k={k}"))
        groups = -(-lanes // genasm_dc.xwide_geometry(cfg, "dc_band").lanes)
        if groups > 1:
            with cs._grid_of(max(1, groups // 4)):
                row["loop_max_abs_err"] = cs._max_abs_err(
                    "dc_band", genasm_dc.genasm_dc(pm, text, cfg=cfg), ref,
                    f"W={W} k={k} loop")
        print(json.dumps(row), flush=True)
    for lanes in k3_lanes:
        genasm_dc.XR_K3_LANES = lanes
        for k in (60, 120, 240, 480):
            cfg, pm, text = _inputs(k)
            call = lambda: genasm_dc.genasm_dc(pm, text, cfg=cfg)  # noqa
            call()
            geo = genasm_dc.xwide_geometry(cfg, "dc_band")
            print(json.dumps(dict(k3_lanes=lanes, k=k, chunk=geo.chunk,
                                  shared_bytes=geo.shared_bytes,
                                  event_ms=cs._time_ms(call, 2, DEV))),
                  flush=True)
            del call
            torch.cuda.empty_cache()


def _launch(cfg, pm, text, lanes: int, chunk: int):
    """K3 through its C entry point at `lanes` x `chunk`."""
    B = pm.shape[-1]
    y = genasm_dc.xr_k3_layout(cfg.nw, cfg.k, cfg.nwb, cfg.W,
                               cfg.ncols_band, lanes, chunk)
    dist, levels = (torch.empty(B, dtype=torch.int32, device=DEV)
                    for _ in range(2))
    band = torch.empty((cfg.k + 1, cfg.ncols_band, cfg.nwb, B),
                       dtype=torch.int32, device=DEV)
    per_sm = genasm_dc._occupancy("dc_band_xwide", 32 * lanes, y["smem"])[0]
    blocks = min(-(-B // lanes), per_sm * genasm_dc.SMS)
    scratch = torch.empty(blocks * lanes * max(1, y["lane_words"]),
                          dtype=torch.int32, device=DEV)
    genasm_dc._launch(
        "dc_band", pm, text, band, dist, levels, scratch,
        ints=(B, cfg.W, cfg.nw, cfg.k, cfg.nwb, cfg.ncols_band,
              int(cfg.early_term)),
        block=(lanes, 32 * lanes, y["smem"], chunk, y["lane_words"],
               blocks), entry="dc_band_xwide")
    return (dist, band, levels), per_sm, y["smem"]


def blocks(ks, shapes) -> None:
    cs.phase_build()
    for k in ks:
        cfg, pm, text = _inputs(k)
        ref = None
        for lanes, chunk in shapes:
            y = genasm_dc.xr_k3_layout(cfg.nw, k, cfg.nwb, cfg.W,
                                       cfg.ncols_band, lanes, chunk)
            if y["smem"] > genasm_dc.MAX_SHARED_BYTES:
                continue
            out, per_sm, smem = _launch(cfg, pm, text, lanes, chunk)
            ref = ref or [t.clone() for t in out]
            err = _err(out, ref)
            del out
            ms = cs._time_ms(lambda: _launch(cfg, pm, text, lanes, chunk),
                             2, DEV)
            print(json.dumps(dict(k=k, lanes=lanes, chunk=chunk,
                                  shared_bytes=smem, blocks_per_sm=per_sm,
                                  ms=ms, differs=err)), flush=True)
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()


class _Mixed:
    """The tree's library with K3's wide entry points from `variant`."""

    def __init__(self, main, variant):
        self._main, self._variant = main, variant

    def __getattr__(self, name):
        if "dc_band_xwide" in name:
            fn = getattr(self._variant, name)
            fn.argtypes = build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            return fn
        return getattr(self._main, name)


def variants(patches: dict, ks) -> None:
    cs.phase_build()
    main = build.load_library()
    procs, libs = {}, {}
    for name, pairs in {"base": [], **patches}.items():
        out = ROOT / "build" / "k3_variants" / name
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for src in build.CSRC.iterdir():
            if src.suffix in (".cu", ".cuh"):
                text = src.read_text()
                if src.name == "genasm_xwide_reg.cuh":
                    for old, new in pairs:
                        if text.count(old) != 1:
                            raise SystemExit(f"{name}: patch not found "
                                             f"once: {old!r}")
                        text = text.replace(old, new)
                (out / src.name).write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I", str(out),
             "-o", str(out / "lib.so"), str(out / "dc_band_xwide.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-3000:]}")
        report = [line.strip() for line in log.splitlines()
                  if "registers" in line]
        print(json.dumps(dict(variant=name, ptxas=report[-1:])), flush=True)
        libs[name] = ctypes.CDLL(str(ROOT / "build" / "k3_variants" / name
                                     / "lib.so"))
    for k in ks:
        cfg, pm, text = _inputs(k)
        row = dict(k=k)
        for name, lib in libs.items():
            genasm_dc._library = lambda lib=lib: _Mixed(main, lib)
            call = lambda: genasm_dc.genasm_dc(pm, text, cfg=cfg)  # noqa
            call()
            row[name] = cs._time_ms(call, 2, DEV)
            del call
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("check", "blocks", "variants"))
    ap.add_argument("patches", nargs="?", type=Path)
    ap.add_argument("--ks", default="60,120,240,480")
    ap.add_argument("--k3-lanes", default="8,16")
    ap.add_argument("--blocks", default="8x4,8x8,16x4,16x8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k3_xwide_probe: no CUDA card")
    cs.phase_device()
    ks = [int(k) for k in args.ks.split(",")]
    if args.mode == "check":
        check([int(n) for n in args.k3_lanes.split(",")])
    elif args.mode == "blocks":
        blocks(ks, [tuple(int(v) for v in s.split("x"))
                    for s in args.blocks.split(",")])
    else:
        if args.patches is None:
            raise SystemExit("variants: name a PATCHES.json")
        variants(json.loads(args.patches.read_text()), ks)


if __name__ == "__main__":
    main()
