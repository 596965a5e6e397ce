"""Quickstart of the PyTorch/CUDA port: align a handful of simulated long
reads with the improved GenASM aligner on the card (the hand-written
CUDA kernels K1, K2, K4) and show the paper's three ideas in action.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

``--device cpu`` runs the kernels' plain PyTorch twins instead.
"""
import argparse

from repro_torch.configs.genasm import CONFIG
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.counting import reduction_report
from repro_torch.data.genome import ReadSimConfig, simulate_reads, synth_genome

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--reads", type=int, default=4)
ap.add_argument("--len", type=int, default=600, dest="rlen")
ap.add_argument("--lane-tile", type=int, default=CONFIG.lane_tile,
                help="the batch pad unit (small keeps a CPU run small)")
args = ap.parse_args()

genome = synth_genome(100_000, seed=1)
rs = simulate_reads(genome, args.reads, ReadSimConfig(
    read_len=args.rlen, error_rate=0.08, seed=2))

cfg = CONFIG.replace(lane_tile=args.lane_tile)   # W=64 O=24 k=12, fused
aligner = GenASMAligner(cfg, device=args.device)
res = aligner.align(rs.reads, rs.ref_segments)

print(f"{args.reads} reads x {args.rlen} bp on {aligner.device} "
      f"(backend {cfg.backend})")
for i, cig in enumerate(res.cigars):
    print(f"read {i}: dist={res.dist[i]}  failed={res.failed[i]}")
    print(f"  cigar[:70] = {cig[:70]}...")

rep = reduction_report(cfg, avg_levels=7.0)
print("\npaper's improvements for this config (per window):")
print(f"  footprint: {rep['baseline_footprint_words']}w -> "
      f"{rep['improved_touched_words']:.0f}w "
      f"({rep['footprint_reduction_touched']:.1f}x, paper: 24x)")
print(f"  accesses : {rep['baseline_accesses']}w -> "
      f"{rep['improved_accesses']}w "
      f"({rep['access_reduction']:.1f}x, paper: 12x)")
print(f"  on-chip bytes/problem: {rep['vmem_bytes_per_problem']}")
assert not res.failed.any(), "a quickstart read failed to align"
