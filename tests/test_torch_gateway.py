"""The port's multi-tenant gateway (``repro_torch.api.Gateway``) on the CPU,
mirroring the reference's tests/test_gateway.py test for test, then held
against the reference gateway:

* deterministically — every scheduling decision is a pure function of
  (queues, now): a fake clock plus scripted arrival traces pin exact
  shed/expire/preempt decisions, with no time.sleep (the only waiting is
  on real completion events);
* under real threads — 8 concurrent clients hammer one gateway over the
  differential corpus (bucket rescue exercised) and every record is
  bit-identical to a serial session run, including a close()-while-
  submitting race;
* against the reference — one scripted trace (submits, advance, pump,
  cancel) through ``repro.api.Gateway`` and the port's gateway, each on a
  fake clock, gives the same ``dispatch_log``, ``gateway_stats()``,
  ``tenant_stats`` and records.

Every thread join and result wait is bounded, so no test can hang.
"""
import dataclasses
import threading

import numpy as np
import pytest

from repro.api import Gateway as RefGateway
from repro.api import GatewayPolicy as RefPolicy
from repro.api import plan as ref_plan
from repro_torch.api import (DeadlineExceeded, Gateway, GatewayClosedError,
                             GatewayPolicy, RequestCancelled, ShedError, plan)
from repro_torch.convert import config_from_reference, policy_from_reference
from repro_torch.core.aligner import AlignResult
from repro_torch.core.config import AlignerConfig
from tests.test_differential import CFG as REF_DCFG, ROUNDS

DCFG = AlignerConfig(W=16, O=6, k=4)     # = test_differential.CFG, fused
RECORD_FIELDS = ("ok", "dist", "cigar", "k_used", "read_consumed",
                 "ref_consumed")


class FakeClock:
    """Injectable time source: advances only when told to."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def cpu_plan(cfg=DCFG, **kw):
    return plan(cfg, device="cpu", **kw)


def _pair(rng, n, exact=True):
    ref = rng.integers(0, 4, n).astype(np.uint8)
    read = ref.copy()
    if not exact:
        read[::9] = (read[::9] + 1) % 4
    return read, ref


def _join(threads, timeout=120):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def assert_records_equal(got, want):
    for field in RECORD_FIELDS:
        assert got[field] == want[field], field
    np.testing.assert_array_equal(got["ops"], want["ops"])


@pytest.fixture
def gw():
    """A sync-executor session + manual-pump gateway on a fake clock —
    the deterministic harness every scheduling test drives."""
    clk = FakeClock()
    s = cpu_plan(rescue_rounds=0, batch_lanes=4, clock=clk)
    g = Gateway(s, GatewayPolicy(capacity=64, linger_s=0.05), clock=clk,
                auto_pump=False)
    yield g, clk
    g.close()
    s.close()


# --------------------------------------------------------------------------
# deterministic scheduling: priorities, deadlines, linger, margin
# --------------------------------------------------------------------------

def test_priority_zero_full_bucket_preempts_older_bulk(gw, rng):
    """A full latency-lane (priority 0) bucket dispatches BEFORE an older
    but partial bulk (priority 1) bucket; the bulk batch follows only
    once its linger age makes it urgent.  Exact dispatch_log assertion."""
    g, clk = gw
    bulk = g.tenant("bulk", priority=1)
    lat = g.tenant("lat", priority=0)
    bf = [bulk.submit(*_pair(rng, 200)) for _ in range(2)]   # older, partial
    clk.advance(0.01)
    lf = [lat.submit(*_pair(rng, 24)) for _ in range(4)]     # full class
    assert g.pump(clk()) == 1                 # ONLY the full latency bucket
    assert list(g.dispatch_log) == [(0, (32, 32), 4)]
    clk.advance(0.05)                         # bulk's linger age reached
    assert g.pump(clk()) == 1
    assert list(g.dispatch_log)[1] == (1, (256, 256), 2)
    assert all(f.result(timeout=30)["ok"] for f in lf + bf)
    assert [f.deadline_met for f in lf] == [True] * 4        # no deadline


def test_equal_priority_dispatches_oldest_arrival_first(gw, rng):
    """Within one priority, bucket batches go out in oldest-head order."""
    g, clk = gw
    t = g.tenant("t", priority=1)
    a = [t.submit(*_pair(rng, 24)) for _ in range(4)]        # full at t=0
    clk.advance(0.001)
    b = [t.submit(*_pair(rng, 100)) for _ in range(4)]       # full at t+
    assert g.pump(clk()) == 2
    assert list(g.dispatch_log) == [(1, (32, 32), 4), (1, (128, 128), 4)]
    for f in a + b:
        f.result(timeout=30)


def test_deadline_sweep_expires_exactly_the_due_requests(gw, rng):
    """The sweep fails QUEUED requests with now >= deadline — exactly
    those — freeing their slots; the survivor still dispatches."""
    g, clk = gw
    g.policy = GatewayPolicy(capacity=64, linger_s=10.0)   # expiry only
    t = g.tenant("t", priority=0)
    f_tight = t.submit(*_pair(rng, 24), deadline_s=0.10)
    f_loose = t.submit(*_pair(rng, 24), deadline_s=10.0)
    clk.advance(0.09)
    g.pump(clk())                             # 0.09 < 0.10: nothing expires
    assert not f_tight.done() and g.stats["dispatched"] == 0
    clk.advance(0.02)
    g.pump(clk())                             # now past deadline: expire
    with pytest.raises(DeadlineExceeded):
        f_tight.result()
    assert f_tight.cancelled() and f_tight.deadline_met is False
    assert g.stats["expired"] == 1
    assert f_loose.result(timeout=30)["ok"]   # result() force-dispatches
    assert f_loose.deadline_met is True
    assert g.stats["deadline_hits"] == 1 and g.stats["completed"] == 1


def test_expired_request_is_never_dispatched(gw, rng):
    """Expiry frees the queue slot BEFORE dispatch: the session never
    sees the request."""
    g, clk = gw
    t = g.tenant("t", priority=0)
    f = t.submit(*_pair(rng, 24), deadline_s=0.01)
    clk.advance(1.0)
    g.pump(clk())
    assert f.done() and g.stats["dispatched"] == 0
    assert g.session.stats["dispatches"] == 0


def test_service_margin_dispatches_partial_before_expiry(gw, rng):
    """With service_margin_s, a queued deadline within the margin makes
    its PARTIAL batch urgent now."""
    g, clk = gw
    g.policy = GatewayPolicy(capacity=64, linger_s=10.0,
                             service_margin_s=0.05)
    t = g.tenant("t", priority=0)
    f = t.submit(*_pair(rng, 24), deadline_s=0.10)
    g.pump(clk())                             # t=0: 0.10 - 0.05 > 0 — wait
    assert not f.done() and g.stats["dispatched"] == 0
    clk.advance(0.06)                         # deadline within the margin
    assert g.pump(clk()) == 1
    assert g.stats["partial_dispatches"] == 1
    assert f.result(timeout=30)["ok"] and f.deadline_met is True


def test_deadline_scored_at_completion_for_dispatched_requests(gw, rng):
    """A request that dispatches in time but RETIRES late is completed
    (never expired) yet scored as a deadline miss."""
    g, clk = gw
    t = g.tenant("t", priority=0)
    futs = [t.submit(*_pair(rng, 24), deadline_s=0.5) for _ in range(4)]
    assert g.pump(clk()) == 1                 # full bucket: dispatched at t=0
    clk.advance(1.0)                          # ...but retires past deadline
    recs = [f.result(timeout=30) for f in futs]
    assert all(r["ok"] for r in recs)
    assert [f.deadline_met for f in futs] == [False] * 4
    assert g.stats["expired"] == 0
    assert g.stats["deadline_misses"] == 4 and g.stats["deadline_hits"] == 0


# --------------------------------------------------------------------------
# load shedding: exact admission decisions
# --------------------------------------------------------------------------

def test_shed_thresholds_exact_per_priority(rng):
    """Admission sheds at exactly in_system >= capacity * shed_frac[p]:
    with capacity 8 and fracs (1.0, 0.5), priority 1 sheds at 4 pairs in
    the system while priority 0 admits through 7 and sheds at 8."""
    clk = FakeClock()
    s = cpu_plan(rescue_rounds=0, batch_lanes=4, clock=clk)
    g = Gateway(s, GatewayPolicy(capacity=8, shed_frac=(1.0, 0.5)),
                clock=clk, auto_pump=False)
    t0, t1 = g.tenant("a", priority=0), g.tenant("b", priority=1)
    for _ in range(3):
        t1.submit(*_pair(rng, 24))            # 0,1,2 in system: admitted
    t1.submit(*_pair(rng, 24))                # 3 < 4: the last p1 admit
    with pytest.raises(ShedError):
        t1.submit(*_pair(rng, 24))            # 4 >= 8*0.5: p1 sheds
    for _ in range(4):
        t0.submit(*_pair(rng, 24))            # 4..7 < 8: p0 still admits
    with pytest.raises(ShedError):
        t0.submit(*_pair(rng, 24))            # 8 >= 8: full — even p0
    assert g.stats["shed"] == 2 and g.stats["submitted"] == 8
    assert g.in_system() == 8                 # sheds never queued
    assert g.tenant_stats["b"]["shed"] == 1
    g.close()
    s.close()


def test_capacity_derives_from_session_inflight_signal(rng):
    """capacity=None wires admission to the session's occupancy signals:
    batch_lanes * (max_inflight + 1), moving with the adaptive bound."""
    s = cpu_plan(rescue_rounds=0, batch_lanes=4, max_inflight=2)
    g = Gateway(s, GatewayPolicy(), auto_pump=False)
    assert g.capacity() == 4 * (2 + 1)
    s._max_inflight = 5                       # the adaptive controller widens
    assert g.capacity() == 4 * (5 + 1)        # ...and admission follows
    g.close()
    s.close()


def test_completion_returns_admission_headroom(gw, rng):
    """in_system() counts queued + dispatched-but-unfinished exactly:
    forcing completion returns the headroom."""
    g, clk = gw
    g.policy = GatewayPolicy(capacity=4)
    t = g.tenant("t", priority=0)
    futs = [t.submit(*_pair(rng, 24)) for _ in range(4)]
    with pytest.raises(ShedError):
        t.submit(*_pair(rng, 24))
    g.pump(clk())                             # dispatch: still outstanding
    with pytest.raises(ShedError):
        t.submit(*_pair(rng, 24))             # dispatched != finished
    for f in futs:
        f.result(timeout=30)                  # retire -> headroom returns
    assert g.in_system() == 0
    assert t.submit(*_pair(rng, 24)).result(timeout=30)["ok"]


# --------------------------------------------------------------------------
# cancellation
# --------------------------------------------------------------------------

def test_cancel_queued_frees_admission_slot(gw, rng):
    """Cancelling a gateway-queued request frees its slot before any
    dispatch; the cancelled future fails with RequestCancelled.
    Idempotent."""
    g, clk = gw
    g.policy = GatewayPolicy(capacity=2)
    t = g.tenant("t", priority=0)
    f1 = t.submit(*_pair(rng, 24))
    f2 = t.submit(*_pair(rng, 24))
    with pytest.raises(ShedError):
        t.submit(*_pair(rng, 24))
    assert f1.cancel() is True and f1.cancel() is True
    with pytest.raises(RequestCancelled):
        f1.result()
    f3 = t.submit(*_pair(rng, 24))            # the freed slot admits again
    assert g.stats["cancelled"] == 1 and g.session.stats["dispatches"] == 0
    for f in (f2, f3):
        assert f.result(timeout=30)["ok"]


def test_cancel_after_dispatch_is_false_and_lane_completes(gw, rng):
    """Once the pump moved a request onto a lane, cancel() is False and
    the result arrives normally."""
    g, clk = gw
    t = g.tenant("t", priority=0)
    futs = [t.submit(*_pair(rng, 24)) for _ in range(4)]
    assert g.pump(clk()) == 1
    assert futs[0].cancel() is False
    assert not futs[0].cancelled()
    assert futs[0].result(timeout=30)["ok"]
    assert futs[0].cancel() is False          # done-and-uncancelled stays
    assert g.stats["cancelled"] == 0
    assert g.session.stats["dispatches"] == 1


def test_close_without_drain_fails_queued_fast(gw, rng):
    """close(drain=False) cancels everything still queued and later
    submits refuse with GatewayClosedError."""
    g, clk = gw
    t = g.tenant("t", priority=1)
    f = t.submit(*_pair(rng, 24))
    g.close(drain=False)
    with pytest.raises(RequestCancelled):
        f.result()
    with pytest.raises(GatewayClosedError):
        t.submit(*_pair(rng, 24))


def test_stats_reconcile(gw, rng):
    """Every admitted request is accounted exactly once: submitted ==
    completed + expired + cancelled + failed when idle."""
    g, clk = gw
    t0, t1 = g.tenant("a", priority=0), g.tenant("b", priority=1)
    done = [t0.submit(*_pair(rng, 24)) for _ in range(4)]
    gone = t1.submit(*_pair(rng, 24), deadline_s=0.01)
    cut = t1.submit(*_pair(rng, 24))
    cut.cancel()
    clk.advance(1.0)
    g.pump(clk())
    for f in done:
        f.result(timeout=30)
    st = g.gateway_stats()
    assert st["submitted"] == 6
    assert (st["completed"] + st["expired"] + st["cancelled"]
            + st["failed"]) == 6
    assert st["queued"] == 0 and st["outstanding"] == 0
    assert gone.done() and cut.done()


# --------------------------------------------------------------------------
# real threads: the hammer + the close race
# --------------------------------------------------------------------------

def test_gateway_hammer_bit_identical_to_serial(corpus):
    """8 concurrent client threads x mixed priority lanes push the
    differential corpus (bucket rescue exercised) through ONE gateway on a
    threaded session with the background sweeper running, and every
    per-request record is bit-identical to a serial session run of the
    same pairs."""
    reads, refs, _ = corpus
    kw = dict(rescue_rounds=ROUNDS, rescue_mode="bucket", batch_lanes=8)
    base = cpu_plan(**kw)
    serial = [base.submit(r, f_) for r, f_ in zip(reads, refs)]
    base.flush()
    want = AlignResult.from_records([f.result() for f in serial])
    base.close()

    s = cpu_plan(executor="thread", **kw)
    g = Gateway(s, GatewayPolicy(capacity=len(reads) + 8, linger_s=0.001))
    g.start_sweeper(0.002)
    nthreads = 8
    shards = [list(range(i, len(reads), nthreads)) for i in range(nthreads)]
    got = [None] * nthreads
    errs = []

    def client(i):
        try:
            ten = g.tenant(f"t{i}", priority=i % 3, deadline_s=120.0)
            futs = [ten.submit(reads[j], refs[j]) for j in shards[i]]
            got[i] = [f.result(timeout=120) for f in futs]
        except BaseException as e:             # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    _join(threads)
    assert not errs, errs
    recs = [None] * len(reads)
    for i, idxs in enumerate(shards):
        for rec, j in zip(got[i], idxs):
            recs[j] = rec
    gw_res = AlignResult.from_records(recs)
    np.testing.assert_array_equal(gw_res.failed, want.failed)
    np.testing.assert_array_equal(gw_res.dist, want.dist)
    np.testing.assert_array_equal(gw_res.k_used, want.k_used)
    assert gw_res.cigars == want.cigars
    st = g.gateway_stats()
    assert st["completed"] == len(reads)
    assert st["shed"] == 0 and st["expired"] == 0
    assert st["deadline_hits"] == len(reads)   # generous SLO: all hit
    g.close()
    s.close()


def test_gateway_close_while_submitting_race(rng):
    """close(drain=True) racing concurrent submitters: every admitted
    future resolves, refused submits see GatewayClosedError or ShedError,
    and nothing hangs or double-frees."""
    pairs = [_pair(np.random.default_rng(900 + i), 24) for i in range(16)]
    s = cpu_plan(rescue_rounds=0, batch_lanes=4, executor="thread")
    g = Gateway(s, GatewayPolicy(capacity=64, linger_s=0.001))
    start = threading.Barrier(3, timeout=60)
    admitted, errs = [], []

    def submitter(lo):
        ten = g.tenant(f"t{lo}", priority=0)
        start.wait()
        for i in range(lo, lo + 8):
            try:
                admitted.append(ten.submit(*pairs[i]))
            except (GatewayClosedError, ShedError):
                return
            except BaseException as e:         # pragma: no cover
                errs.append(e)
                return

    t1 = threading.Thread(target=submitter, args=(0,))
    t2 = threading.Thread(target=submitter, args=(8,))
    t1.start(); t2.start()
    start.wait()                               # maximise the overlap
    g.close(drain=True)
    _join([t1, t2])
    assert not errs, errs
    for f in admitted:                         # admitted => resolved
        assert f.result(timeout=30)["dist"] == 0
    st = g.gateway_stats()
    assert st["completed"] == len(admitted)
    assert st["queued"] == 0 and st["outstanding"] == 0
    g.close()                                  # idempotent
    s.close()


# --------------------------------------------------------------------------
# the port against the reference: one scripted trace through both
# --------------------------------------------------------------------------

def _scripted_trace(pkg_plan, pkg_gateway, policy, cfg, pairs):
    """Drive one gateway through a fixed trace on a fake clock: two
    tenants, a full latency bucket preempting older bulk, a linger flush,
    a deadline expiry, a cancel, a shed, a service-margin dispatch and a
    forced result.  Returns (dispatch_log, gateway_stats(), tenant_stats,
    {label: record, or the name of the error submit or result raised})."""
    clk = FakeClock()
    s = pkg_plan(cfg, rescue_rounds=ROUNDS, batch_lanes=4, clock=clk)
    g = pkg_gateway(s, policy, clock=clk, auto_pump=False)
    bulk = g.tenant("bulk", priority=1)
    lat = g.tenant("lat", priority=0, deadline_s=0.5)
    futs = {}

    def submit(label, tenant, pair, **kw):
        try:
            futs[label] = tenant.submit(*pairs[pair], **kw)
        except Exception as e:                      # a ShedError on both
            futs[label] = type(e).__name__

    for i in range(3):
        submit(f"bulk{i}", bulk, ("long", i))
    clk.advance(0.01)
    for i in range(4):
        submit(f"lat{i}", lat, ("short", i))
    g.pump(clk())                                   # the full latency bucket
    submit("doomed", bulk, ("short", 4), deadline_s=0.02)
    submit("cut", bulk, ("mid", 0))
    futs["cut"].cancel()
    clk.advance(0.03)
    g.pump(clk())                                   # expiry, bulk lingers out
    for i in range(1, 4):
        submit(f"mid{i}", bulk, ("mid", i))         # the last ones shed
    for i in range(5, 8):
        submit(f"lat_late{i}", lat, ("short", i))
    submit("urgent", lat, ("long", 3), deadline_s=0.1)
    clk.advance(0.08)
    g.pump(clk())                                   # margin 0.05: urgent goes
    clk.advance(0.2)
    records = {}
    for label, f in futs.items():
        if isinstance(f, str):
            records[label] = f
            continue
        try:
            records[label] = f.result(timeout=60)   # forces the rest
        except Exception as e:
            records[label] = type(e).__name__
    g.close()
    out = (list(g.dispatch_log), g.gateway_stats(), g.tenant_stats, records)
    s.close()
    return out


def test_scripted_trace_equals_reference_gateway():
    rng = np.random.default_rng(4040)
    pairs = {}
    for kind, n, count in (("short", 24, 8), ("mid", 90, 4),
                           ("long", 200, 4)):
        for i in range(count):
            pairs[(kind, i)] = _pair(rng, n, exact=i % 2 == 0)
    ref_policy = RefPolicy(capacity=12, shed_frac=(1.0, 0.75),
                           linger_s=0.02, service_margin_s=0.05)
    policy = policy_from_reference(dataclasses.asdict(ref_policy))
    cfg = config_from_reference(dataclasses.asdict(REF_DCFG))
    want = _scripted_trace(ref_plan, RefGateway, ref_policy, REF_DCFG, pairs)
    got = _scripted_trace(lambda c, **kw: plan(c, device="cpu", **kw),
                          Gateway, policy, cfg, pairs)
    log, stats, tenants, records = got
    assert log == want[0]
    assert stats == want[1]
    assert tenants == want[2]
    assert records.keys() == want[3].keys()
    for label, rec in records.items():
        if isinstance(rec, str):
            assert rec == want[3][label], label
        else:
            assert_records_equal(rec, want[3][label])
    assert stats["expired"] == 1 and stats["cancelled"] == 1
    assert stats["shed"] > 0 and stats["partial_dispatches"] > 0
