"""Where a K1 launch's time goes: K1 built three ways and timed; at NW >= 9
also the wide tail kernel (K2 / K4) and K3.

    python3 tools/torch_k1_breakdown.py [--reps 50] [--widths 64]
                                        [--ks 12,24,48] [--tree PATH]

Builds the kernel three times into ``build/k1_breakdown/`` (one ``nvcc``
each, all started together): as it is (``full``); with the walk switched
off (``no_walk``); and with the walk and the fill's stores switched off
(``no_walk_no_store``).  The switches are preprocessor macros that this
script writes into a copy of the sources; it refuses to run if a place it
patches has moved.  ``full - no_walk`` is the walk's share, ``no_walk -
no_walk_no_store`` the stores', ``no_walk_no_store`` the fill.  The
variants' outputs are not checked: they compute less.

Widths where K1 runs a template (``genasm_dc.kernel_family`` at the
first k): K1's body ``csrc/tb_fused.cuh`` and the units that instantiate
it (``tb_fused.cu``, ``tb_fused_wide.cu``), at 2,048 and 4,096 lanes.
Widths where it runs the wide family (from W = 129): the units
``tb_fused_xwide.cu``, ``tail_fused_xwide.cu`` and ``dc_band_xwide.cu``
with their headers, K1, the rung's tail (K2 where ``cfg.tail_banded``,
else K4) and K3 at 2,048 lanes (256 drawn, repeated, as
``chip_smoke._ladder_rows``; K3 at W <= 256 is a template, whose
variants are the full build's), O = 3W/8.  K3 walks nothing: its
``stores`` are the band's writes (staging and flush, or the ring's
stores), its ``fill`` the rest.  Two designs of the wide family are
known: the register fill for all three kernels (``genasm_xwide_reg.cuh``;
the no-store variant keeps each level group's top level, which the next
strip may read back from the store: 1/16 of K1's stores, and K3 stages
and writes nothing), and the register fill for K1 and the tails with K3
on the earlier shared ring of three steps.  ``--tree`` names another
checkout (e.g. the parent unpacked with ``git archive`` under
``build/``), whose ``chip_smoke`` and ``repro_torch`` are imported and
whose sources are patched, so one tool measures both designs.

The variants' kernels are called through the tree's own wrappers, with
the tree's library for every other entry point.  Device ms per launch
(``chip_smoke._device_ms``); one JSON line per (kernel, k, lanes), and the
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

#: the templates' switches in tb_fused.cuh, as (its lines, with the macros)
SWITCHES = [("  if (walker) {\n    const int w = threadIdx.x, wdist",
             "  if (walker && K1_WALK) {\n    const int w = threadIdx.x, wdist"),
            ("    if (on && j >= col0) store(j);",
             "    if (K1_STORE && on && j >= col0) store(j);")]
#: the wide family's switches by design, as {file: [(line, patched)]}
_WALK_SWITCHES = {
    "tb_fused_xwide.cu": [("    if ((threadIdx.x & 31) == 0) {\n"
                           "      const XrBand st{",
                           "    if (K1_WALK && (threadIdx.x & 31) == 0) {\n"
                           "      const XrBand st{")],
    "tail_fused_xwide.cu": [("    if ((threadIdx.x & 31) == 0) {\n"
                             "      // the lane's lengths",
                             "    if (K1_WALK && (threadIdx.x & 31) == 0) {\n"
                             "      // the lane's lengths")]}
WIDE_SWITCHES = {
    "register fill, K3 staged": {
        **_WALK_SWITCHES,
        "genasm_xwide_reg.cuh": [
            ("        if (on && d0 + l <= k && j >= sm.jlo &&",
             "        if (on && (K1_STORE || l == L - 1) &&\n"
             "            d0 + l <= k && j >= sm.jlo &&"),
            ("      stage<ON>(u, jt, nxt);",
             "      if (K1_STORE) stage<ON>(u, jt, nxt);"),
            ("            *reinterpret_cast<uint4*>(dst) = make_uint4(",
             "            if (K1_STORE) *reinterpret_cast<uint4*>(dst) = "
             "make_uint4("),
            ("          for (int b = b0; b < nwb; b += per, src += per, "
             "dst += hop)\n            *dst = __funnelshift_r(",
             "          for (int b = b0; b < nwb; b += per, src += per, "
             "dst += hop)\n            if (K1_STORE) *dst = "
             "__funnelshift_r(")]},
    "register fill, K3 ring": {
        **_WALK_SWITCHES,
        "genasm_xwide_reg.cuh": [("      if (on && d0 + l <= k && j >= sm.jlo &&",
                                  "      if (on && (K1_STORE || l == L - 1) &&\n"
                                  "          d0 + l <= k && j >= sm.jlo &&")],
        "dc_band_xwide.cu": [
            ("      if (s >= 1) f.store(s - 1, W, nwb, col0, base_of, put);",
             "      if (K1_STORE && s >= 1)\n"
             "        f.store(s - 1, W, nwb, col0, base_of, put);")]}}
VARIANTS = {"full": (1, 1), "no_walk": (0, 1), "no_walk_no_store": (0, 0)}


def _patch(text: str, switches, name: str) -> str:
    for line, switched in switches:
        if text.count(line) != 1:
            raise RuntimeError(f"{name}: source line not found once: "
                               f"{line!r}")
        text = text.replace(line, switched)
    return text


def _compile(build, out_dir: Path, units) -> dict:
    """{variant: its library}, one nvcc each, started together."""
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", f"-DK1_WALK={walk}",
         f"-DK1_STORE={store}", "-I", str(out_dir),
         "-o", str(out_dir / f"lib_{name}.so"),
         *(str(out_dir / unit) for unit in units)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for name, (walk, store) in VARIANTS.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(out_dir / f"lib_{name}.so"))
    return libs


def build_variants(build, out_dir: Path) -> dict:
    """The templates' K1: {variant: its genasm_tb_fused_launch}."""
    src = _patch((build.CSRC / "tb_fused.cuh").read_text(), SWITCHES,
                 "tb_fused.cuh")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "tb_fused.cuh").write_text(src)
    units = ("tb_fused.cu", "tb_fused_wide.cu")
    for name in (*units, "genasm_common.cuh"):   # beside the patched body
        shutil.copy(build.CSRC / name, out_dir / name)
    launches = {}
    for name, lib in _compile(build, out_dir, units).items():
        fn = lib.genasm_tb_fused_launch
        fn.argtypes = build._SIGNATURES["genasm_tb_fused_launch"]
        fn.restype = ctypes.c_int
        launches[name] = fn
    return launches


def build_wide_variants(build, out_dir: Path) -> tuple[str, dict]:
    """The wide family's K1 and K2 / K4 of the tree's design: (design,
    {variant: its library})."""
    design = next((d for d, files in WIDE_SWITCHES.items()
                   if all((build.CSRC / f).exists() and all(
                       (build.CSRC / f).read_text().count(line) == 1
                       for line, _ in sw) for f, sw in files.items())), None)
    if design is None:
        raise RuntimeError("the wide sources match no known design's "
                           "switches: update WIDE_SWITCHES")
    out_dir.mkdir(parents=True, exist_ok=True)
    for path in build.CSRC.iterdir():
        if path.suffix in (".cu", ".cuh"):
            shutil.copy(path, out_dir / path.name)
    for name, switches in WIDE_SWITCHES[design].items():
        (out_dir / name).write_text(_patch((build.CSRC / name).read_text(),
                                           switches, name))
    libs = _compile(build, out_dir, ("tb_fused_xwide.cu",
                                     "tail_fused_xwide.cu",
                                     "dc_band_xwide.cu"))
    return design, libs


class _Mixed:
    """A library whose wide entry points are a variant's, the rest the
    tree's own."""

    def __init__(self, build, main, variant):
        self._main, self._variant = main, variant
        self._build = build

    def __getattr__(self, name):
        if "xwide" in name:
            fn = getattr(self._variant, name)
            fn.argtypes = self._build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            return fn
        return getattr(self._main, name)


def clocks() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def template_rows(cs, genasm_dc, AlignerConfig, build, W, ks, reps, dev):
    launches = build_variants(build, ROOT / "build" / "k1_breakdown")
    for k in ks:
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
                row[name] = cs._device_ms(call, reps, dev)
            print(json.dumps(row), flush=True)


def wide_rows(cs, genasm_dc, AlignerConfig, build, W, ks, reps, dev, label):
    design, libs = build_wide_variants(
        build, ROOT / "build" / "k1_breakdown_wide" / label)
    main = build.load_library()
    rng = np.random.default_rng(W)
    for k in ks:
        cfg = AlignerConfig(W=W, O=3 * W // 8, k=k)
        tail = "tail_banded" if cfg.tail_banded else "tail_full"
        for name in ("tb_fused", tail, "dc_band"):
            inputs, kw, _ = cs._repeated(cs._case(name, cfg, 256, rng, dev),
                                         8)
            wrapper = cs.KERNELS[name][0]
            row = dict(label=label, design=design, name=name, W=W, k=k,
                       lanes=2048)
            for variant, lib in libs.items():
                genasm_dc._library = lambda lib=lib: _Mixed(build, main, lib)
                call = lambda: wrapper(*inputs, **kw)     # noqa: E731
                call()
                row[variant] = cs._device_ms(call, reps, dev)
                del call
                torch.cuda.empty_cache()
            row["walk"] = row["full"] - row["no_walk"]
            row["stores"] = row["no_walk"] - row["no_walk_no_store"]
            row["fill"] = row["no_walk_no_store"]
            print(json.dumps(row), flush=True)
            del inputs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--widths", default="64")
    ap.add_argument("--ks", default="12,24,48")
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k1_breakdown: no CUDA card")
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke as cs
    from repro_torch.core.config import AlignerConfig
    from repro_torch.kernels import build, genasm_dc
    cs.phase_device()
    cs.phase_build()
    print(json.dumps(dict(clocks_before=clocks())), flush=True)
    dev = torch.device("cuda")
    for W in (int(w) for w in args.widths.split(",")):
        ks = [int(k) for k in args.ks.split(",") if int(k) < W]
        if genasm_dc.kernel_family(AlignerConfig(W=W, O=3 * W // 8,
                                                 k=ks[0]),
                                   "tb_fused") == "xwide":
            wide_rows(cs, genasm_dc, AlignerConfig, build, W, ks, args.reps,
                      dev, args.label or tree.name)
        else:
            template_rows(cs, genasm_dc, AlignerConfig, build, W, ks,
                          args.reps, dev)
    print(json.dumps(dict(clocks_after=clocks())), flush=True)


if __name__ == "__main__":
    main()
