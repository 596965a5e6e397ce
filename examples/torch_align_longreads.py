"""End-to-end driver of the PyTorch/CUDA port mirroring the paper's
evaluation (§II): simulate PacBio-like reads from a genome, generate
candidate chains (true locus + decoys), align every candidate through
the session front door on the card, report throughput and accuracy.

    PYTHONPATH=src python examples/torch_align_longreads.py [--reads 16]
        [--len 2000] [--device cpu]

On the card the session's executables are captured CUDA graphs (built
once a bucket, replayed by every later dispatch); ``--device cpu`` runs
the kernels' plain PyTorch twins eagerly.
"""
import argparse
import time

import numpy as np

from repro_torch.api import plan
from repro_torch.core.config import AlignerConfig
from repro_torch.core.oracle import validate_cigar
from repro_torch.data.genome import (ReadSimConfig, candidate_chains,
                                     simulate_reads, synth_genome)

ap = argparse.ArgumentParser()
ap.add_argument("--reads", type=int, default=16)
ap.add_argument("--len", type=int, default=2000, dest="rlen")
ap.add_argument("--decoys", type=int, default=1)
ap.add_argument("--error-rate", type=float, default=0.10)
ap.add_argument("--genome", type=int, default=1_000_000)
ap.add_argument("--W", type=int, default=64)
ap.add_argument("--backend", choices=("fused", "split", "plain"),
                default="fused", help="aligner execution path")
ap.add_argument("--device", default="cuda")
ap.add_argument("--lane-tile", type=int, default=128,
                help="the batch pad unit (small keeps a CPU run small)")
args = ap.parse_args()

genome = synth_genome(args.genome, seed=11)
rs = simulate_reads(genome, args.reads,
                    ReadSimConfig(read_len=args.rlen,
                                  error_rate=args.error_rate, seed=5))
chains = candidate_chains(genome, rs, decoys_per_read=args.decoys)
print(f"{args.reads} reads x {args.rlen}bp @ {args.error_rate:.0%} error, "
      f"{len(chains)} candidate locations")

# plan once; the first pass builds each bucket's executable, the steady
# pass builds nothing
session = plan(AlignerConfig(W=args.W, O=args.W * 3 // 8, k=args.W * 3 // 16,
                             backend=args.backend),
               rescue_rounds=1, batch_lanes=len(chains),
               lane_tile=args.lane_tile, device=args.device)
reads = [rs.reads[i] for i, _ in chains]
refs = [seg for _, seg in chains]

t0 = time.time()
res = session.align(reads, refs)          # first call builds the buckets
t_first = time.time() - t0
built = session.cache.lowerings
t0 = time.time()
res = session.align(reads, refs)
t_steady = time.time() - t0
assert session.cache.lowerings == built, "steady state rebuilt!"
session.close()

ok = ~res.failed
step = 1 + args.decoys
aligned_true = sum(1 for i in range(0, len(chains), step) if ok[i])
rejected_decoys = sum(1 for i in range(len(chains))
                      if i % step != 0 and not ok[i])
for i in range(0, len(chains), max(1, len(chains) // 4)):
    if ok[i]:
        validate_cigar(reads[i], refs[i], res.ops[i], res.dist[i])

bp = sum(len(r) for r in reads)
print(f"aligned true loci: {aligned_true}/{args.reads}; "
      f"rejected decoys: {rejected_decoys}/{len(chains) - args.reads}")
print(f"summary: {res.summary(base_k=session.cfg.k)}")
print(f"first pass {t_first:.2f}s (builds), steady {t_steady:.2f}s = "
      f"{len(chains) / t_steady:.1f} pairs/s = "
      f"{bp / t_steady / 1e6:.2f} Mbp/s on {session.device} "
      f"({args.backend} backend)")
print(f"mean edit distance of true alignments: "
      f"{np.mean([res.dist[i] for i in range(0, len(chains), step) if ok[i]]):.1f}"
      f" (expected ~{args.error_rate * args.rlen * 0.95:.0f})")
assert aligned_true == args.reads, "a true locus failed to align"
