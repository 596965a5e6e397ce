"""End-to-end READ MAPPING driver of the PyTorch/CUDA port: minimizer
index over the genome, seed + colinear chain to candidate loci, banded
X-drop pre-filter (PyTorch on the card), then the survivors stream
through the session front door.  Decoys are planted in the genome
(``data.genome.plant_decoys``), so the pipeline has to find and reject
them itself.  The floors of ``examples/map_reads.py`` hold: >= 95 % of
reads at their true locus, no read mapped at a decoy, and a pre-filter
kill rate above 0.2.

    PYTHONPATH=src python examples/torch_map_reads.py [--reads 200]
        [--len 1000] [--fast] [--device cpu]
"""
import argparse
import time

from repro_torch.data.genome import (ReadSimConfig, plant_decoys,
                                     simulate_reads, synth_genome)
from repro_torch.mapper import MapperConfig, ReadMapper

ap = argparse.ArgumentParser()
ap.add_argument("--reads", type=int, default=200)
ap.add_argument("--len", type=int, default=1000, dest="rlen")
ap.add_argument("--genome", type=int, default=1_000_000)
ap.add_argument("--decoys", type=int, default=4)
ap.add_argument("--error-rate", type=float, default=0.10)
ap.add_argument("--W", type=int, default=64)
ap.add_argument("--device", default="cuda")
ap.add_argument("--lane-tile", type=int, default=128,
                help="the batch pad unit (small keeps a CPU run small)")
ap.add_argument("--fast", action="store_true",
                help="smoke size: small geometry, fewer/shorter reads")
args = ap.parse_args()
if args.fast:
    args.reads, args.rlen, args.genome, args.W = 24, 400, 120_000, 32

genome = synth_genome(args.genome, seed=11)
rs = simulate_reads(genome, args.reads,
                    ReadSimConfig(read_len=args.rlen,
                                  error_rate=args.error_rate, seed=5))
genome, decoy_pos = plant_decoys(genome, rs, decoys_per_read=args.decoys,
                                 chunk=max(160, args.rlen // 4), seed=13)
print(f"{args.reads} reads x {args.rlen}bp @ {args.error_rate:.0%} error, "
      f"{args.decoys} planted decoys/read, genome {len(genome):,}bp")

t0 = time.time()
mapper = ReadMapper(genome, MapperConfig(),
                    W=args.W, O=args.W * 3 // 8, k=args.W * 3 // 16,
                    rescue_rounds=2, batch_lanes=64,
                    lane_tile=args.lane_tile, device=args.device)
print(f"index: {mapper.index.stats()} ({time.time() - t0:.2f}s)")

with mapper:
    t0 = time.time()
    out = mapper.map_batch(rs.reads)      # the first batch builds buckets
    t_first = time.time() - t0
    t0 = time.time()
    out = mapper.map_batch(rs.reads)
    t_steady = time.time() - t0

st = out.stats
hits = sum(1 for mr, tp in zip(out.mapped, rs.true_pos)
           if mr.ok and abs(mr.ref_start - tp) <= 20)
decoy_hits = sum(1 for mr in out.mapped if mr.ok and
                 any(abs(mr.ref_start - dp) <= 50
                     for dp in decoy_pos[mr.read_id]))
recall = hits / st["n_reads"]
print(f"funnel: {st['n_candidates']} candidates from {st['n_reads']} reads "
      f"-> {st['n_killed']} killed by X-drop ({st['kill_rate']:.0%}) "
      f"-> {st['n_aligned']} aligned -> {st['n_mapped']} mapped")
print(f"true locus: {hits}/{st['n_reads']} ({recall:.1%}); "
      f"mapped at a decoy: {decoy_hits}")
print(f"first batch {t_first:.2f}s (builds), steady {t_steady:.2f}s = "
      f"{st['n_reads'] / t_steady:.1f} mapped reads/s on "
      f"{mapper.session.device}")

assert recall >= 0.95, f"recall {recall:.1%} below the 95% floor"
assert decoy_hits == 0, f"{decoy_hits} reads mapped at planted decoys"
assert st["kill_rate"] > 0.2, "pre-filter killed nothing"
print("OK")
