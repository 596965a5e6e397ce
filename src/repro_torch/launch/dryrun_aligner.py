"""Dry run of the aligner step with its roofline, on one card (port of
``repro/launch/dryrun_aligner.py``).

    python -m repro_torch.launch.dryrun_aligner [--banded-compute]
        [--batch 512] [--read-len 10000] [--W 64 --O 24 --k 12]
        [--out build/dryrun]

The reference lowers and compiles the step for 131,072 pairs of 10 kbp
on its production mesh of 256 chips (512 pairs a chip) and reads XLA's
memory and cost analyses.  The port builds the session's executable for
``--batch`` pairs of ``--read-len`` on one card: build = capture into a
CUDA graph (``serve.graphs``), the counterpart of ``.lower().compile()``.
It reports

* ``argument_bytes``: the executable's inputs (its static inputs on the
  card);
* ``temp_bytes``: the graph's memory pool, the counterpart of
  ``memory_analysis().temp_size_in_bytes``;
* ``compile_s``: capture plus instantiate, and the graph's nodes;
* the reference's analytic integer-op model, ``OPS_PER_CELL`` = 14
  lane-ops per (level, column, word) over every window of every pair at
  ``avg_levels`` (7 with early termination, k + 1 without), full words
  or, with ``--banded-compute``, the DENT band's, over the H100's INT32
  rate; a memory term over HBM3: the step's inputs read once and outputs
  written once (the kernels keep the DP on chip; XLA's "bytes accessed"
  has no PyTorch counterpart); and ``collective_s`` = 0 on one card;
* ``kernels``: each kernel the step's first rung launches, its block,
  its store's bytes a lane and the least time to write the batch's
  stores (``roofline.store_write_s``), and for each kernel that runs the
  wide family (``genasm_dc.kernel_family``: K1 and the tails from ``--W``
  129, K3 from 257) that family's scratch a block and in flight
  (``counting.gpu_scratch_in_flight``).

The production mesh (``make_production_mesh``, multi-pod) has no
counterpart: the port's mesh is the cards of one host (docs/port.md).
The JSON goes under ``--out`` (default ``build/dryrun``, ignored by git).
"""
from __future__ import annotations

import argparse
import json
import pathlib

import torch

from ..analysis.roofline import HBM_BW, INT32_OPS, store_write_s
from ..core import counting
from ..core.config import AlignerConfig
from ..core.windowing import n_main_windows, total_op_budget
from ..kernels.genasm_dc import kernel_family
from ..serve.align_step import align_input_specs, launch_plan

OPS_PER_CELL = 14      # shifts/ands/ors/selects per (level, column, word)
REFERENCE_CHIPS = 256  # the reference's production mesh
REFERENCE_BATCH = 131_072

#: bytes of an align step's per-lane outputs besides the op buffer:
#: n_ops, dist, read_consumed, ref_consumed (int32) and failed (bool)
_LANE_OUT_BYTES = 4 * 4 + 1


def step_bytes(batch: int, read_len: int, cfg: AlignerConfig) -> int:
    """Bytes an align step must move: its inputs (``align_input_specs``)
    read once and its outputs (the op buffer and the per-lane results)
    written once."""
    inputs = sum(torch.Size(shape).numel() * dtype.itemsize
                 for shape, dtype in align_input_specs(batch, read_len, cfg))
    outputs = batch * (total_op_budget(read_len, cfg) + _LANE_OUT_BYTES)
    return inputs + outputs


def analytic_terms(batch: int, read_len: int, cfg: AlignerConfig,
                   banded_compute: bool = False, chips: int = 1) -> dict:
    """The reference's analytic roofline of `batch` pairs of `read_len` on
    `chips` cards, with the H100's INT32 and HBM3 rates: compute, memory
    and collective seconds, the dominant term and the model's inputs."""
    n_win = n_main_windows(read_len, cfg) + 1
    avg_levels = 7.0 if cfg.early_term else cfg.k + 1
    nw_compute = cfg.nwb if banded_compute else cfg.nw
    ops = (batch / chips) * n_win * avg_levels * cfg.W * nw_compute \
        * OPS_PER_CELL
    bytes_dev = step_bytes(batch, read_len, cfg) / chips
    terms = {"compute_s": ops / INT32_OPS, "memory_s": bytes_dev / HBM_BW,
             "collective_s": 0.0}
    dom = max(terms, key=terms.get)
    return {**terms, "dominant": dom.replace("_s", ""),
            "int_ops_per_chip": ops, "bytes_per_dev": bytes_dev,
            "windows_per_pair": n_win, "avg_levels": avg_levels}


def kernel_rows(batch: int, read_len: int, cfg: AlignerConfig,
                free_bytes: int | None = None) -> list:
    """Each kernel of the step's first rung (``launch_plan`` on the CPU,
    which derives the blocks the card launches): its block, its store's
    bytes a lane and the least seconds to write `batch` lanes' stores,
    and each wide kernel's scratch
    (``counting.gpu_scratch_in_flight``, at `free_bytes`)."""
    rows = []
    for entry in launch_plan(cfg, read_len, None, "cpu"):
        name, geo = entry["kernel"], entry["geometry"]
        if name == "dc_band":
            lane_bytes = 4 * counting.gpu_split_store_words(cfg, 1)
        elif name == "tb_fused":
            lane_bytes = 4 * counting.gpu_store_words(cfg, 1)
        else:
            lane_bytes = 4 * counting.gpu_tail_store_words(
                cfg, 1, banded=name == "tail_banded")
        rows.append({"kernel": name, "k": entry["k"],
                     "block": {"lanes": geo.lanes, "threads": geo.threads,
                               "shared_bytes": geo.shared_bytes,
                               "placement": (
                                   "xwide" if kernel_family(cfg, name)
                                   == "xwide" else geo.placement)},
                     "store_bytes_per_lane": lane_bytes,
                     "store_write_s": store_write_s(lane_bytes, batch),
                     "scratch": counting.gpu_scratch_in_flight(
                         cfg, name, free_bytes=free_bytes)})
    return rows


def aligner_cell(batch: int = REFERENCE_BATCH // REFERENCE_CHIPS,
                 read_len: int = 10_000, cfg: AlignerConfig | None = None,
                 banded_compute: bool = False, device="cuda") -> dict:
    """Build (capture) the session executable for `batch` pairs of
    `read_len` on `device` and return the dry run's record."""
    from ..api.session import build_executable
    cfg = AlignerConfig() if cfg is None else cfg
    device = torch.device(device)
    exe = build_executable(cfg, batch, read_len, int(read_len * 1.3), None,
                           device)
    graphs = exe.graphs
    record = {
        "arch": "genasm-aligner", "shape": f"b{batch}_L{read_len}",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "chips": 1, "banded_compute": banded_compute,
        "memory": {"argument_bytes": sum(
            torch.Size(shape).numel() * dtype.itemsize
            for shape, dtype in exe.avals),
                   "temp_bytes": None if graphs is None
                   else graphs.pool_bytes},
        "graph_nodes": None if graphs is None
        else sum(st["nodes"] or 0 for st in graphs.stats),
        "roofline": analytic_terms(batch, read_len, cfg, banded_compute),
        "kernels": kernel_rows(batch, read_len, cfg,
                               torch.cuda.mem_get_info(device)[0]
                               if device.type == "cuda" else None),
        "compile_s": None if graphs is None else graphs.compile_s,
    }
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--banded-compute", action="store_true")
    ap.add_argument("--batch", type=int,
                    default=REFERENCE_BATCH // REFERENCE_CHIPS)
    ap.add_argument("--read-len", type=int, default=10_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) captures the executable; cpu "
                         "builds it eagerly (no graph, no memory figures)")
    ap.add_argument("--W", type=int, default=AlignerConfig.W)
    ap.add_argument("--O", type=int, default=AlignerConfig.O)
    ap.add_argument("--k", type=int, default=AlignerConfig.k)
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)
    cfg = AlignerConfig(W=args.W, O=args.O, k=args.k)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rec = aligner_cell(args.batch, args.read_len, cfg,
                       banded_compute=args.banded_compute,
                       device=args.device)
    bc = "_banded" if args.banded_compute else ""
    wk = "" if args.W == AlignerConfig.W else f"_W{args.W}_k{args.k}"
    path = out / (f"genasm-aligner__{torch.device(args.device).type}{bc}"
                  f"{wk}.json")
    path.write_text(json.dumps(rec, indent=1))
    r, mem = rec["roofline"], rec["memory"]
    print(f"[ok] aligner {rec['shape']}{bc} on {rec['device']}: "
          f"compute={r['compute_s']:.6f}s memory={r['memory_s']:.6f}s "
          f"coll={r['collective_s']:.3f}s dominant={r['dominant']} "
          f"argument={mem['argument_bytes']} temp={mem['temp_bytes']} "
          f"compile={rec['compile_s']} -> {path}")
    for row in rec["kernels"]:
        sc = row["scratch"] or {}
        print(f"  {row['kernel']} k={row['k']} lanes/block="
              f"{row['block']['lanes']} threads={row['block']['threads']} "
              f"store/lane={row['store_bytes_per_lane']} B "
              f"write>={row['store_write_s']:.6f}s"
              + (f" scratch/block={sc['scratch_bytes_per_block']} B "
                 f"in flight={sc['scratch_bytes_in_flight']} B "
                 f"({sc['lanes_in_flight']} lanes)" if sc else ""))


if __name__ == "__main__":
    main()
