"""The port's observability package (``repro_torch.obs``) against the
reference's ``repro.obs``: registry semantics (memoised named and
labelled metrics, kind conflicts, fixed histogram edges, labelled views),
the tracer (per-thread nesting on an injectable clock, error attribution,
bounded records), the exporters, and the disabled bundle.  One sequence
of metric and span calls on a fake clock gives byte-identical Prometheus
text and JSON lines in both packages.  Then the session's side: the
legacy ``session.stats`` / cache counters equal the registry's reads,
``obs='off'`` reads zeros, a raising done-callback is recorded and never
poisons, and the span tree of a two-bucket batch with one rescue rung is
the reference session's, record for record.  The gateway's and the
mapper's counter families are registry views and read as the reference's
on the same traffic."""
import json
import threading

import numpy as np
import pytest

import repro.obs as ref_obs
from repro.api import plan as ref_plan
from repro.core.config import AlignerConfig as RefConfig
from repro_torch import obs as port_obs
from repro_torch.api import (AlignSession, CompileCache, Gateway,
                             GatewayPolicy, plan)
from repro_torch.core.config import AlignerConfig
from repro_torch.core import transfer
from repro_torch.obs import (MetricsRegistry, NULL_METRIC, NULL_REGISTRY,
                             NULL_SPAN, NULL_TRACER, OBS_OFF, Obs, Tracer,
                             default_registry, perfetto_trace,
                             prometheus_text, qualified_name, resolve_obs,
                             trace_jsonl, write_artifacts)

REF_CFG = RefConfig(W=16, O=6, k=2)
#: one spec for every session below (the reference's tests/test_obs.py)
PLAN_KW = dict(rescue_rounds=1, rescue_mode="bucket", batch_lanes=4)


def port_plan(**kw):
    return plan(W=16, O=6, k=2, backend="plain", device="cpu",
                **{**PLAN_KW, **kw})


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _corpus():
    """3 exact pairs + 1 decoy at len 30 (bucket 32x32, fills the 4-lane
    class) then 2 exact pairs at len 70 (bucket 128x128, partial,
    flush-dispatched).  The decoy fails the whole ladder, so exactly one
    compacted rescue rung runs."""
    rng = np.random.default_rng(77)
    reads, refs = [], []
    for _ in range(3):
        r = rng.integers(0, 4, 30).astype(np.uint8)
        reads.append(r)
        refs.append(r.copy())
    reads.append(rng.integers(0, 4, 30).astype(np.uint8))
    refs.append(rng.integers(0, 4, 30).astype(np.uint8))  # decoy
    for _ in range(2):
        r = rng.integers(0, 4, 70).astype(np.uint8)
        reads.append(r)
        refs.append(r.copy())
    return reads, refs


# --------------------------------------------------------------------------
# both packages, one sequence of calls
# --------------------------------------------------------------------------

def _drive(pkg, clk):
    """One fixed sequence of metric and span calls against package
    `pkg`'s registry and tracer; returns (prometheus text, JSON lines,
    perfetto events without their category)."""
    reg = pkg.MetricsRegistry()
    tr = pkg.Tracer(clock=clk)
    reg.counter("req_total", tenant="a").inc(3)
    reg.labeled(session="s1").counter("pairs_total").inc(7)
    reg.gauge("depth").set(2)
    reg.gauge("depth").add(-1)
    h = reg.histogram("lat_seconds", edges=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    with tr.span("session.dispatch", bucket="32x32", lanes=4):
        clk.advance(0.25)
        with tr.span("device.execute", lanes=4):
            clk.advance(0.5)
    with pytest.raises(RuntimeError):
        with tr.span("retire.decode", n=4):
            clk.advance(1.0)
            raise RuntimeError("boom")
    events = [{k: v for k, v in e.items() if k != "cat"}
              for e in pkg.perfetto_trace(tr)["traceEvents"]]
    return pkg.prometheus_text(reg), pkg.trace_jsonl(tr), events


def test_same_calls_give_the_same_exports_as_the_reference():
    port = _drive(port_obs, FakeClock())
    ref = _drive(ref_obs, FakeClock())
    assert port == ref
    text, jsonl, _ = port
    assert 'pairs_total{session="s1"} 7' in text.splitlines()
    assert [json.loads(line)["name"] for line in jsonl.splitlines()] == \
        ["device.execute", "session.dispatch", "retire.decode"]


def test_port_registry_is_its_own():
    assert default_registry() is default_registry()
    assert default_registry() is not ref_obs.default_registry()
    assert port_obs.DEFAULT_EDGES == ref_obs.DEFAULT_EDGES


# --------------------------------------------------------------------------
# registry semantics
# --------------------------------------------------------------------------

def test_registry_memoises_by_name_and_labels():
    reg = MetricsRegistry()
    c = reg.counter("x_total", tenant="a")
    assert reg.counter("x_total", tenant="a") is c
    assert reg.counter("x_total", tenant="b") is not c
    assert reg.counter("x_total") is not c
    c.inc()
    c.inc(5)
    assert c.value == 6
    g = reg.gauge("depth")
    g.set(3)
    g.add(-1)
    assert g.value == 2
    assert qualified_name(c.name, c.labels) == 'x_total{tenant="a"}'


def test_registry_kind_conflict_and_fixed_edges():
    reg = MetricsRegistry()
    reg.counter("m")
    with pytest.raises(TypeError):
        reg.gauge("m")
    h = reg.histogram("h_seconds", edges=(0.1, 1.0))
    assert reg.histogram("h_seconds", edges=(0.1, 1.0)) is h
    with pytest.raises(ValueError):
        reg.histogram("h_seconds", edges=(0.1, 2.0))


def test_histogram_cumulative_snapshot():
    h = MetricsRegistry().histogram("lat", edges=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    snap = h.snap()
    assert snap["buckets"] == {"0.1": 1, "1.0": 2, "+Inf": 3}
    assert snap["count"] == 3 and snap["sum"] == 0.05 + 0.5 + 5.0


def test_labeled_view_stamps_and_filters():
    base = MetricsRegistry()
    view = base.labeled(session="fused")
    c = view.counter("pairs_total")
    assert c is base.counter("pairs_total", session="fused")
    base.counter("other_total").inc()
    assert set(view.snapshot()) == {'pairs_total{session="fused"}'}
    assert set(base.snapshot()) == {'pairs_total{session="fused"}',
                                    "other_total"}
    assert view.labeled(shard="0").counter("pairs_total").labels == \
        (("session", "fused"), ("shard", "0"))


def test_counter_increments_are_exact_under_threads():
    """Counter.inc is a locked read-modify-write: 8 threads x 2,000
    increments, with a short switch interval, lose none."""
    import sys
    c = MetricsRegistry().counter("n_total")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [c.inc() for _ in range(2000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert c.value == 16_000


# --------------------------------------------------------------------------
# tracer semantics and exporters
# --------------------------------------------------------------------------

def test_tracer_nesting_timestamps_and_error_attr():
    clk = FakeClock()
    tr = Tracer(clock=clk)
    with tr.span("outer", x=1):
        clk.advance(1.0)
        with tr.span("inner"):
            clk.advance(0.5)
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("no")
    inner, outer, boom = tr.records()
    assert (inner["name"], inner["t0"], inner["t1"]) == ("inner", 1.0, 1.5)
    assert inner["parent"] == outer["sid"]
    assert (outer["t0"], outer["t1"], outer["parent"]) == (0.0, 1.5, None)
    assert boom["attrs"]["error"] == "RuntimeError"


def test_tracer_stacks_are_per_thread_and_bounded():
    tr = Tracer(clock=FakeClock())
    with tr.span("main.open"):
        t = threading.Thread(
            target=lambda: tr.span("worker").__enter__().__exit__(
                None, None, None), name="obs-worker")
        t.start()
        t.join(10)
    worker, main = tr.records()
    assert worker["parent"] is None and worker["thread"] == "obs-worker"
    assert main["parent"] is None
    small = Tracer(clock=FakeClock(), maxlen=4)
    for i in range(10):
        with small.span(f"s{i}"):
            pass
    assert [r["name"] for r in small.records()] == ["s6", "s7", "s8", "s9"]


def test_perfetto_export_and_write_artifacts(tmp_path):
    clk = FakeClock()
    obs = Obs.private(clock=clk)
    obs.counter("c_total").inc()
    with obs.span("work", lanes=4):
        clk.advance(0.002)
    doc = perfetto_trace(obs.tracer)
    (x,) = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert x["dur"] == pytest.approx(2000.0) and x["args"]["lanes"] == 4
    assert x["cat"] == "repro_torch.obs"
    paths = write_artifacts(obs, str(tmp_path), prefix="t")
    assert sorted(paths) == ["jsonl", "perfetto", "prometheus"]
    assert "c_total 1" in open(paths["prometheus"]).read()
    assert json.loads(open(paths["jsonl"]).read())["name"] == "work"
    assert prometheus_text(MetricsRegistry()) == ""
    assert trace_jsonl(Tracer()) == ""


# --------------------------------------------------------------------------
# the disabled bundle
# --------------------------------------------------------------------------

def test_resolve_obs_and_null_bundle():
    assert resolve_obs("off") is OBS_OFF and resolve_obs(False) is OBS_OFF
    bundle = Obs.private()
    assert resolve_obs(bundle) is bundle
    assert resolve_obs(None).enabled
    with pytest.raises(TypeError):
        resolve_obs(42)
    assert OBS_OFF.counter("anything", label="x") is NULL_METRIC
    assert OBS_OFF.histogram("h") is NULL_METRIC
    assert OBS_OFF.span("s", a=1) is NULL_SPAN
    assert OBS_OFF.labeled(session="x").counter("c") is NULL_METRIC
    assert NULL_REGISTRY.labeled(anything="y") is NULL_REGISTRY
    assert OBS_OFF.snapshot() == {} and OBS_OFF.prometheus() == ""
    assert NULL_TRACER.records() == []
    NULL_METRIC.inc()
    assert NULL_METRIC.value == 0


# --------------------------------------------------------------------------
# the session's counters and spans
# --------------------------------------------------------------------------

def test_session_stats_equal_registry_reads():
    reads, refs = _corpus()
    with port_plan() as s:
        s.align(reads, refs)
        snap = s.obs.snapshot()
        for key, name in AlignSession.STAT_METRICS.items():
            assert s.stats[key] == snap[name], (key, name)
        assert (s.stats["requests"], s.stats["dispatches"],
                s.stats["rescue_dispatches"]) == (6, 2, 1)
        assert s.cache.hits == snap["session_cache_hits_total"]
        assert s.cache.misses == snap["session_cache_misses_total"]
        assert s.cache.lowerings == snap["session_cache_lowerings_total"]
        assert s.cache.shared_hits == \
            snap["session_cache_shared_hits_total"]


def test_obs_off_session_reads_zeros_and_same_values():
    reads, refs = _corpus()
    with port_plan(obs="off") as off, port_plan() as on:
        assert off.obs is OBS_OFF
        assert all(m is NULL_METRIC for m in off._m.values())
        a, b = off.align(reads, refs), on.align(reads, refs)
        assert off.stats == {k: 0 for k in AlignSession.STAT_METRICS}
        assert a.cigars == b.cigars and list(a.dist) == list(b.dist)
        assert not a.failed[:3].any() and a.failed[3]


def test_compile_cache_and_transfer_families_match_registry():
    reg = MetricsRegistry()
    cc = CompileCache(registry=reg)
    cc.get(("k1",), lambda: "exe1")
    cc.get(("k1",), lambda: "exe1")
    cc.get(("k2",), lambda: "exe2")
    snap = reg.snapshot()
    assert cc.hits == snap["compile_cache_hits_total"] == 1
    assert cc.misses == snap["compile_cache_misses_total"] == 2
    assert cc.lowerings == snap["compile_cache_lowerings_total"] == 2
    transfer.reset()
    x = np.zeros((4, 8), np.uint8)
    dev = transfer.to_device((x, x), "cpu")
    transfer.to_host({"a": dev[0]})
    s = transfer.stats()
    snap = default_registry().snapshot()
    assert s.h2d_calls == snap["transfer_h2d_calls_total"] == 1
    assert s.d2h_calls == snap["transfer_d2h_calls_total"] == 1
    assert s.h2d_bytes == snap["transfer_h2d_bytes_total"] == 2 * x.nbytes
    assert s.d2h_bytes == snap["transfer_d2h_bytes_total"] == x.nbytes
    marker = default_registry().counter("compile_cache_hits_total").value
    transfer.reset()                    # per family, never registry-wide
    assert transfer.stats() == transfer.TransferStats()
    assert default_registry().counter(
        "compile_cache_hits_total").value == marker


def test_session_trace_equals_reference_session_trace():
    """2-bucket ragged batch, one rescue rung, sync executor, fake clock:
    the port's span records (names, nesting, attrs, sids, timestamps)
    equal the reference session's on the same pairs."""
    reads, refs = _corpus()
    traces = []
    for make in (lambda clk: port_plan(clock=clk),
                 lambda clk: ref_plan(REF_CFG, **PLAN_KW, clock=clk,
                                      cache="private")):
        with make(FakeClock()) as s:
            res = s.align(reads, refs)
        assert not res.failed[:3].any() and res.failed[3]
        traces.append(s.obs.tracer.records())
    port, ref = traces
    assert port == ref
    assert [r["name"] for r in port] == [
        "device.execute", "session.dispatch", "device.execute",
        "session.dispatch", "rescue.rung", "retire.decode", "retire.decode"]
    assert port[4]["attrs"] == {"k": 4, "lanes": 1, "n_todo": 1}


def _gateway_snapshot(pkg_plan, pkg_gateway, pkg_policy, cfg):
    """Four exact pairs through one tenant of a manual-pump gateway on a
    fake clock; returns (gateway, the gateway-family registry reads)."""
    clk = FakeClock()
    s = pkg_plan(cfg, rescue_rounds=0, batch_lanes=4, clock=clk)
    g = pkg_gateway(s, pkg_policy(capacity=64), clock=clk, auto_pump=False)
    try:
        rng = np.random.default_rng(3)
        ten = g.tenant("acme")
        pairs = []
        for _ in range(4):
            r = rng.integers(0, 4, 30).astype(np.uint8)
            pairs.append(ten.submit(r, r.copy()))
        g.pump(clk())
        for gf in pairs:
            assert gf.result()["ok"]
        snap = g.obs.snapshot()            # gateway shares the session obs
        return g, snap
    finally:
        g.close()
        s.close()


def test_gateway_family_matches_registry():
    """The gateway's legacy stats are views over the session's registry,
    and the gateway family reads as the reference gateway's does."""
    from repro.api import Gateway as RefGateway
    from repro.api import GatewayPolicy as RefPolicy
    g, snap = _gateway_snapshot(
        lambda cfg, **kw: plan(cfg, backend="plain", device="cpu", **kw),
        Gateway, GatewayPolicy, AlignerConfig(W=16, O=6, k=2))
    for key, name in Gateway.STAT_METRICS.items():
        assert g.stats[key] == snap[name], (key, name)
    assert g.stats["submitted"] == 4 and g.stats["completed"] == 4
    out = g.gateway_stats()
    assert out["submitted"] == snap["gateway_submitted_total"]
    assert out["tenants"]["acme"]["completed"] == \
        snap['gateway_tenant_completed_total{tenant="acme"}'] == 4
    # live-load gauges mirror the functional ints
    assert out["queued"] == snap["gateway_queued"] == 0
    assert out["outstanding"] == snap["gateway_outstanding"] == 0
    # completion latency lands in the histogram
    assert snap["gateway_latency_seconds"]["count"] == 4
    _, ref_snap = _gateway_snapshot(
        lambda cfg, **kw: ref_plan(cfg, cache="private", **kw), RefGateway,
        RefPolicy, REF_CFG)
    family = lambda sn: {k: v for k, v in sn.items()
                         if k.startswith("gateway")}
    assert family(snap) == family(ref_snap)


def test_mapper_funnel_matches_registry_deltas():
    """Each batch's funnel stats are the registry's counter deltas, the
    stage spans nest under the batch span, and the mapper family reads as
    the reference mapper's does on the same reads."""
    from repro.mapper import ReadMapper as RefReadMapper
    from repro_torch.data.genome import (ReadSimConfig, simulate_reads,
                                         synth_genome)
    from repro_torch.mapper import ReadMapper

    genome = synth_genome(30_000, seed=3)
    rs = simulate_reads(genome, 4, ReadSimConfig(read_len=200,
                                                 error_rate=0.05, seed=4))
    kw = dict(W=32, O=12, k=8, rescue_rounds=1, batch_lanes=8)
    with ReadMapper(genome, backend="plain", device="cpu", **kw) as m:
        b1 = m.map_batch(rs.reads[:2])
        b2 = m.map_batch(rs.reads[2:])
        snap = m.obs.snapshot()
        for key, name in ReadMapper.FUNNEL_METRICS.items():
            assert b1.stats[key] + b2.stats[key] == snap[name], (key, name)
        assert snap["mapper_batches_total"] == 2
        assert b1.stats["n_reads"] == 2 and b2.stats["n_reads"] == 2
        for b in (b1, b2):
            assert b.stats["kill_rate"] == \
                b.stats["n_killed"] / max(1, b.stats["n_candidates"])
        # funnel spans nested under the batch span
        recs = m.obs.tracer.records()
        batches = [r for r in recs if r["name"] == "mapper.map_batch"]
        assert len(batches) == 2
        for stage in ("index.lookup", "chain", "prefilter", "align"):
            stage_recs = [r for r in recs if r["name"] == stage]
            assert len(stage_recs) == 2, stage
            assert {r["parent"] for r in stage_recs} == \
                {b["sid"] for b in batches}
    with RefReadMapper(genome, backend="jnp", **kw) as rm:
        rm.map_batch(rs.reads[:2])
        rm.map_batch(rs.reads[2:])
        ref_snap = rm.obs.snapshot()
    family = lambda sn: {k: v for k, v in sn.items()
                         if k.startswith("mapper")}
    assert family(snap) == family(ref_snap)


class _Boom(BaseException):
    """Not an Exception: a client hook's BaseException must be recorded,
    never unwind into the retire path."""


@pytest.mark.parametrize("executor", ["sync", "thread"])
def test_raising_done_callback_is_recorded_not_poisoning(executor):
    reads, refs = _corpus()
    with port_plan(executor=executor) as s:
        futs = [s.submit(r, f) for r, f in zip(reads[:4], refs[:4])]

        def boom(_fut):
            raise _Boom("client hook blew up")

        seen = []
        futs[0].add_done_callback(boom)
        futs[1].add_done_callback(seen.append)
        s.flush()
        recs = [f.result(timeout=60) for f in futs]
        assert [r["ok"] for r in recs] == [True, True, True, False]
        assert seen == [futs[1]]
        assert s.stats["callback_errors"] == 1
        assert not s.align(reads[:3], refs[:3]).failed.any()
        fut = s.submit(reads[0], refs[0])
        s.flush()
        assert fut.result(timeout=60)["ok"]
        fut.add_done_callback(boom)         # already done: runs now, guarded
        assert s.stats["callback_errors"] == 2
