"""Alignment as a service through the port's front door
(``repro_torch.api``): plan an AlignSession with the background retire
executor, warm its length buckets before traffic (on the card each
bucket's executable is captured into a CUDA graph, so a dispatch is one
upload and one graph replay), stream ragged requests as futures while
the host CIGAR decode overlaps dispatch on the retire thread, and read
the compile-stability counters.  ``--gateway`` adds the multi-tenant
gateway (the reference's 2 ms linger and 1 ms sweeper).

    PYTHONPATH=src python examples/torch_serve_alignment.py
        [--requests 32] [--len 800] [--fast] [--gateway]
        [--metrics-dump] [--device cpu]
"""
import argparse
import threading
import time

from repro_torch.api import Gateway, GatewayPolicy, ShedError, plan
from repro_torch.core.config import AlignerConfig
from repro_torch.data.genome import ReadSimConfig, simulate_reads, synth_genome

ap = argparse.ArgumentParser()
ap.add_argument("--requests", type=int, default=32)
ap.add_argument("--len", type=int, default=800, dest="rlen")
ap.add_argument("--fast", action="store_true",
                help="small geometry for smoke runs")
ap.add_argument("--backend", choices=("fused", "split", "plain"),
                default="fused", help="aligner execution path")
ap.add_argument("--executor", choices=("thread", "sync"), default="thread")
ap.add_argument("--gateway", action="store_true",
                help="also demo the multi-tenant gateway: a latency "
                     "tenant with deadlines and a bulk tenant on "
                     "concurrent client threads")
ap.add_argument("--metrics-dump", action="store_true",
                help="dump each demo's obs registry as Prometheus text")
ap.add_argument("--device", default="cuda")
ap.add_argument("--lane-tile", type=int, default=128,
                help="the batch pad unit (small keeps a CPU run small)")
args = ap.parse_args()

cfg = AlignerConfig(W=32, O=12, k=8, backend=args.backend,
                    lane_tile=args.lane_tile) if args.fast \
    else AlignerConfig(W=64, O=24, k=12, backend=args.backend,
                       lane_tile=args.lane_tile)
genome = synth_genome(200_000 if args.fast else 500_000, seed=3)
# a RAGGED stream: three read-length classes hitting different buckets
lens = [max(64, args.rlen // 4), max(96, args.rlen // 2), args.rlen]
streams = [simulate_reads(genome, -(-args.requests // len(lens)),
                          ReadSimConfig(read_len=L, error_rate=0.08,
                                        seed=9 + i))
           for i, L in enumerate(lens)]
kw = dict(rescue_rounds=1, batch_lanes=8, executor=args.executor,
          device=args.device)

with plan(cfg, **kw) as session:
    buckets = sorted({session.bucket_for(len(r), len(s))
                      for rs in streams
                      for r, s in zip(rs.reads, rs.ref_segments)})
    session.warmup(buckets)
    tail = -(-args.requests // len(lens)) % session.spec.batch_lanes
    warm = session.warmup(buckets, lanes=tail) if tail \
        else session.cache.stats()
    print(f"warmed {warm['executables']} executables "
          f"(builds={warm['lowerings']}) on {session.device}")

    # req/s is end-to-end wall clock around the whole stream
    t0 = time.time()
    futures = {}
    for rs in streams:
        for read, seg in zip(rs.reads, rs.ref_segments):
            fut = session.submit(read, seg)
            futures[fut.rid] = fut
    session.flush()
    results = {rid: fut.result() for rid, fut in futures.items()}
    elapsed = max(time.time() - t0, 1e-9)

    st = session.session_stats()
    cc = st["compile_cache"]
    ok = sum(1 for r in results.values() if r["ok"])
    print(f"served {len(results)} requests in {st['dispatches']} dispatches "
          f"({st['pad_lanes']} pad lanes), {ok} aligned, "
          f"{len(results) - ok} failed, "
          f"{len(results) / elapsed:.1f} req/s end-to-end")
    if args.executor == "thread":
        print(f"retire thread absorbed {st['retire_wall_s']:.3f}s of host "
              f"decode + rescue alongside {st['wall_s']:.3f}s of dispatch")
    print(f"compile cache: {cc['lowerings']} builds "
          f"({cc['lowerings'] - warm['lowerings']} after warm-up, rescue-rung "
          f"lane classes) for {st['dispatches'] + st['rescue_dispatches']} "
          f"dispatches, {cc['hits']} hits")
    r0 = results[0]
    print(f"request 0: dist={r0['dist']} k_used={r0['k_used']} "
          f"cigar[:60]={r0['cigar'][:60]}")
    assert ok > 0

if args.metrics_dump:
    print("\n# ---- session metrics (Prometheus exposition text) ----")
    print(session.obs.prometheus(), end="")

if args.gateway:
    short_rs, long_rs = streams[0], streams[-1]
    with plan(cfg, **kw) as session:
        session.warmup(buckets)
        gw = Gateway(session, GatewayPolicy(linger_s=0.002))
        gw.start_sweeper(0.001)
        latency = gw.tenant("latency", priority=0, deadline_s=30.0)
        bulk = gw.tenant("bulk", priority=1)
        shed = [0]

        def client(ten, rs, pace):
            for read, seg in zip(rs.reads, rs.ref_segments):
                try:
                    ten.submit(read, seg)
                except ShedError:
                    shed[0] += 1
                time.sleep(pace)

        threads = [
            threading.Thread(target=client, args=(latency, short_rs, 0.002)),
            threading.Thread(target=client, args=(bulk, long_rs, 0.006)),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        gw.close()                      # drains: every future resolves
        st = gw.gateway_stats()
        print(f"gateway: {st['completed']} completed over 2 tenants "
              f"(capacity {st['capacity']}), {st['deadline_hits']} deadline "
              f"hits / {st['deadline_misses']} misses, {st['expired']} "
              f"expired, {st['shed']} shed, {st['partial_dispatches']} "
              f"partial dispatches")
        for name, ts in st["tenants"].items():
            print(f"  tenant {name}: submitted={ts['submitted']} "
                  f"completed={ts['completed']} hits={ts['deadline_hits']}")
        assert st["completed"] > 0 and st["expired"] == 0
        if args.metrics_dump:
            print("\n# ---- gateway metrics (Prometheus exposition "
                  "text) ----")
            print(gw.obs.prometheus(), end="")
