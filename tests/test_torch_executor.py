"""The port session's executors (``repro_torch.api``) on the CPU, mirroring
the reference's tests/test_executor.py:

* the background retire executor (executor='thread') equals the sync
  executor on the differential corpus, compacted bucket rescue running on
  the retire thread included;
* the retire queue is bounded (backpressure) and shutdown is clean;
  exceptions on either thread poison the session (the owning futures carry
  the original exception, bystanders SessionPoisonedError, later submits
  refuse), and close(drain=False) fails queued futures fast;
* the process-shared CompileCache builds each key once however many
  sessions ask, per key (no head-of-line blocking);
* adaptive lane classes and in-flight windows change shapes and
  scheduling only, never values;
* result(timeout=), cancel(), many client threads on one session, and
  close() racing submits;
* the kernel library is built once however many threads ask, and the
  launch counters lose no update under threads; a failed build raises,
  never falling back to the plain path.

Every thread join and wait is bounded, so no test can hang.
"""
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.api import (CompileCache, RequestCancelled,
                             SessionPoisonedError, plan,
                             shared_compile_cache)
from repro_torch.core.aligner import AlignResult, GenASMAligner
from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import build, genasm_dc
from repro_torch.serve.align_step import launch_plan
from tests.test_differential import ROUNDS
from tests.test_torch_aligner import assert_results_equal

CFG = AlignerConfig(W=16, O=6, k=4)     # = test_differential.CFG, fused


def cpu_plan(cfg=CFG, **kw):
    return plan(cfg, device="cpu", **kw)


def _exact_pairs(rng, n, length):
    reads = [rng.integers(0, 4, length).astype(np.uint8) for _ in range(n)]
    return reads, [r.copy() for r in reads]


def _join(threads, timeout=60):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


# --------------------------------------------------------------------------
# threaded retire equals the synchronous executor
# --------------------------------------------------------------------------

def test_threaded_retire_equal_to_sync_differential(corpus):
    """batch_lanes=8 splits the 30 pairs into several dispatches, and the
    compacted bucket rescue runs on the retire thread; the threaded
    session is a pure cache hit on the sync session's executables."""
    reads, refs, _ = corpus
    base = GenASMAligner(CFG, rescue_rounds=ROUNDS, device="cpu").align(
        reads, refs)
    store = CompileCache()
    kw = dict(rescue_rounds=ROUNDS, rescue_mode="bucket", batch_lanes=8,
              cache=store)
    res_sync = cpu_plan(**kw).align(reads, refs)
    with cpu_plan(executor="thread", **kw) as thr:
        futs = [thr.submit(r, f) for r, f in zip(reads, refs)]
        thr.flush()
        recs = [f.result(timeout=60) for f in reversed(futs)][::-1]
        st = thr.session_stats()
    assert_results_equal(res_sync, base)
    assert_results_equal(AlignResult.from_records(recs), res_sync)
    assert st["dispatches"] >= 3 and st["rescue_dispatches"] >= 1
    assert st["retire_wall_s"] > 0
    cs = thr.cache.stats()
    assert cs["lowerings"] == 0 and cs["shared_hits"] > 0
    assert thr._retire_thread is None


# --------------------------------------------------------------------------
# bounded queue, clean shutdown, poisoning
# --------------------------------------------------------------------------

def test_retire_queue_bounded_and_clean_shutdown(rng):
    reads, refs = _exact_pairs(rng, 8, 24)
    s = cpu_plan(rescue_rounds=0, batch_lanes=2, max_inflight=2,
                 executor="thread")
    futs = [s.submit(r, f) for r, f in zip(reads, refs)]
    assert s._retire_q is not None and s._retire_q.maxsize == 2
    t = s._retire_thread
    assert t is not None and t.is_alive() and t.daemon
    s.close()                             # drains, then joins the thread
    assert not t.is_alive() and s._retire_thread is None
    assert all(f.done() for f in futs)
    assert all(f.result()["dist"] == 0 for f in futs)
    with pytest.raises(RuntimeError):
        s.submit(reads[0], refs[0])       # closed sessions refuse
    s.close()                             # idempotent


@pytest.mark.parametrize("adaptive", [False, True])
def test_retire_thread_exception_propagates_and_poisons(rng, adaptive):
    (r24a, r24b), (f24a, f24b) = _exact_pairs(rng, 2, 24)
    (r100,), (f100,) = _exact_pairs(rng, 1, 100)
    kw = dict(adaptive_inflight=True, inflight_ceiling=4) if adaptive else {}
    s = cpu_plan(rescue_rounds=0, batch_lanes=2, executor="thread", **kw)

    def _boom(d):
        raise RuntimeError("decode exploded")

    s._retire = _boom
    fa = s.submit(r24a, f24a)
    fq = s.submit(r100, f100)             # another bucket: stays queued
    fb = s.submit(r24b, f24b)             # fills the 24-bucket -> dispatch
    for fut in (fa, fb):
        with pytest.raises(RuntimeError, match="decode exploded"):
            fut.result(timeout=60)
    with pytest.raises(SessionPoisonedError):
        fq.result(timeout=60)
    with pytest.raises(SessionPoisonedError):
        s.submit(r24a, f24a)
    with pytest.raises(SessionPoisonedError):
        s.results()
    s.close(drain=False)
    assert s._retire_thread is None


def test_close_without_drain_fails_queued_futures_sync(rng):
    (r,), (f,) = _exact_pairs(rng, 1, 24)
    s = cpu_plan(rescue_rounds=0, batch_lanes=4, cache="private")
    fut = s.submit(r, f)                  # queued, never dispatched
    s.close(drain=False)
    assert fut.done()
    with pytest.raises(SessionPoisonedError):
        fut.result()
    assert s.cache.lowerings == 0


def test_sync_dispatch_failure_poisons_outstanding_futures(rng):
    (r24,), (f24,) = _exact_pairs(rng, 1, 24)
    (r100a, r100b), (f100a, f100b) = _exact_pairs(rng, 2, 100)
    s = cpu_plan(rescue_rounds=0, batch_lanes=2, cache="private")
    f_other = s.submit(r24, f24)

    def _boom(*a, **k):
        raise ValueError("build failed")

    s._executable = _boom
    g1 = s.submit(r100a, f100a)
    with pytest.raises(ValueError, match="build failed"):
        s.submit(r100b, f100b)
    with pytest.raises(ValueError):
        g1.result()
    with pytest.raises(SessionPoisonedError):
        f_other.result()
    with pytest.raises(SessionPoisonedError):
        s.submit(r24, f24)
    assert s.cache.lowerings == 0


def test_cuda_build_failure_raises_never_falls_back(monkeypatch):
    """What an executable's build does on the card, without one: a
    configuration the kernels are not instantiated for raises naming W
    and k before any build; a failed library build raises as it is (a
    session poisons on it, above) and no plain version runs."""
    with pytest.raises(ValueError, match="W=256 k=12"):
        launch_plan(AlignerConfig(W=256, O=24), 1000, None, "cuda")

    def failed_build():
        raise RuntimeError("nvcc failed for tb_fused.cu")

    monkeypatch.setattr(build, "load_library", failed_build)
    genasm_dc.reset_counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        launch_plan(AlignerConfig(), 1000, 2, "cuda")
    assert set(genasm_dc.PLAIN_CALLS.values()) == {0}


# --------------------------------------------------------------------------
# the process-shared CompileCache
# --------------------------------------------------------------------------

def test_same_spec_sessions_build_each_bucket_once_total(rng):
    reads24, refs24 = _exact_pairs(rng, 2, 24)     # bucket (32, 32)
    reads40, refs40 = _exact_pairs(rng, 2, 40)     # bucket (64, 64)
    reads, refs = reads24 + reads40, refs24 + refs40
    store = CompileCache()
    kw = dict(rescue_rounds=0, batch_lanes=2, cache=store)
    a = cpu_plan(**kw)
    assert not a.align(reads, refs).failed.any()
    sa = a.cache.stats()
    assert sa["misses"] == sa["lowerings"] == sa["executables"] == 2
    b = cpu_plan(**kw)
    assert not b.align(reads, refs).failed.any()
    sb = b.cache.stats()
    assert sb["lowerings"] == sb["misses"] == 0
    assert sb["hits"] == sb["shared_hits"] == sb["executables"] == 2
    ss = store.stats()
    assert ss["lowerings"] == ss["executables"] == 2
    assert sa["hits"] + sb["hits"] == ss["hits"]
    assert sa["misses"] + sb["misses"] == ss["misses"]
    c = cpu_plan(k=6, **kw)                        # another spec
    assert not c.align(reads24, refs24).failed.any()
    assert c.cache.stats()["lowerings"] == 1
    assert not (c.cache._seen & a.cache._seen)
    a.align(reads, refs)
    assert store.stats()["lowerings"] == 3


def test_compile_cache_builds_per_key_without_head_of_line_blocking():
    store = CompileCache()
    started, release = threading.Event(), threading.Event()
    out = {}

    def slow_build():
        started.set()
        assert release.wait(10)
        return "slow-exe"

    t1 = threading.Thread(
        target=lambda: out.setdefault("slow", store.fetch("k1", slow_build)))
    t1.start()
    assert started.wait(10)
    assert store.fetch("k2", lambda: "fast-exe") == ("fast-exe", True)
    t2 = threading.Thread(
        target=lambda: out.setdefault("race", store.fetch("k1",
                                                          lambda: "never")))
    t2.start()
    time.sleep(0.05)
    assert "race" not in out              # really waiting on k1
    release.set()
    _join([t1, t2], 10)
    assert out["slow"] == ("slow-exe", True)
    assert out["race"] == ("slow-exe", False)
    assert store.lowerings == 2 and len(store) == 2

    def bad():
        raise RuntimeError("build exploded")

    with pytest.raises(RuntimeError):
        store.fetch("k3", bad)
    assert store.fetch("k3", lambda: "ok-now") == ("ok-now", True)


def test_default_cache_is_process_shared():
    s1 = cpu_plan(rescue_rounds=0, batch_lanes=2)
    s2 = cpu_plan(rescue_rounds=0, batch_lanes=2)
    assert s1.cache.store is s2.cache.store is shared_compile_cache()
    assert cpu_plan(cache="private").cache.store \
        is not shared_compile_cache()
    assert s1.spec.key() == s2.spec.key()
    assert cpu_plan(k=6).spec.key() != s1.spec.key()


# --------------------------------------------------------------------------
# adaptive lane classes and in-flight window
# --------------------------------------------------------------------------

def test_adaptive_lanes_shrink_regrow_and_stay_identical(rng):
    from tests.conftest import mutate_seq
    refs = [rng.integers(0, 4, 26).astype(np.uint8) for _ in range(26)]
    reads = [mutate_seq(f, 2, rng) for f in refs]
    kw = dict(rescue_rounds=1, batch_lanes=8)
    ada = cpu_plan(adaptive_lanes=True, occupancy_window=2, **kw)
    sta = cpu_plan(**kw)
    bucket = ada.bucket_for(26, 26)

    def drive(s):
        futs = []
        for j in range(4):                # sparse: flushed pairs
            futs += [s.submit(reads[2 * j + i], refs[2 * j + i])
                     for i in range(2)]
            s.flush()
        if s is ada:
            assert ada._current_lanes(bucket) == 2
            d0 = ada.stats["dispatches"]
        futs += [s.submit(reads[8 + i], refs[8 + i]) for i in range(2)]
        if s is ada:
            assert ada.stats["dispatches"] == d0 + 1  # fired at class 2
        futs += [s.submit(reads[10 + i], refs[10 + i]) for i in range(16)]
        s.flush()
        return [f.result() for f in futs]

    recs, srecs = drive(ada), drive(sta)
    assert ada._current_lanes(bucket) == 8         # back at the ceiling
    assert ada.stats["lane_class_steps"] >= 4
    assert ada.session_stats()["occupancy"][str(bucket)]["lane_class"] == 8
    assert sta.stats["lane_class_steps"] == 0
    assert_results_equal(AlignResult.from_records(recs),
                         AlignResult.from_records(srecs))


def test_adaptive_inflight_widens_narrows_and_stays_identical(rng):
    from tests.conftest import mutate_seq
    refs = [rng.integers(0, 4, 26).astype(np.uint8) for _ in range(16)]
    reads = [mutate_seq(f, 2, rng) for f in refs]
    kw = dict(rescue_rounds=1, batch_lanes=2)
    ada = cpu_plan(adaptive_inflight=True, inflight_ceiling=3,
                   max_inflight=1, occupancy_window=2, **kw)
    sta = cpu_plan(max_inflight=1, **kw)
    futs = [ada.submit(reads[i], refs[i]) for i in range(8)]
    assert ada._max_inflight == 3 and ada.stats["inflight_steps"] == 2
    futs += [ada.submit(reads[8 + i], refs[8 + i]) for i in range(4)]
    assert ada._max_inflight == 3                  # capped at the ceiling
    for j in range(4):
        futs.append(ada.submit(reads[12 + j], refs[12 + j]))
        ada.flush()
    assert ada._max_inflight == 1 and ada.stats["inflight_steps"] == 4
    st = ada.session_stats()["inflight"]
    assert (st["max_inflight"], st["ceiling"]) == (1, 3)
    sfuts = [sta.submit(reads[i], refs[i]) for i in range(12)]
    for j in range(4):
        sfuts.append(sta.submit(reads[12 + j], refs[12 + j]))
        sta.flush()
    assert_results_equal(AlignResult.from_records([f.result() for f in futs]),
                         AlignResult.from_records([f.result()
                                                   for f in sfuts]))
    assert sta.stats["inflight_steps"] == 0
    assert "inflight" not in sta.session_stats()


def test_adaptive_inflight_threaded_queue_at_ceiling_and_clean(rng):
    reads, refs = _exact_pairs(rng, 8, 24)
    with cpu_plan(executor="thread", rescue_rounds=0, batch_lanes=2,
                  max_inflight=1, adaptive_inflight=True, inflight_ceiling=4,
                  occupancy_window=2) as s:
        futs = [s.submit(r, f) for r, f in zip(reads, refs)]
        s.flush()
        assert s._retire_q.maxsize == 4
        recs = [f.result(timeout=60) for f in futs]
        assert s._max_inflight > 1
    assert s._retire_thread is None
    assert all(r["dist"] == 0 for r in recs)


# --------------------------------------------------------------------------
# result(timeout=), cancel(), many clients, close() racing submits
# --------------------------------------------------------------------------

def test_result_timeout_then_fulfill(rng):
    reads, refs = _exact_pairs(rng, 2, 24)
    s = cpu_plan(rescue_rounds=0, batch_lanes=2, executor="thread",
                 cache="private")
    gate = threading.Event()
    orig = s._retire

    def gated(d):
        gate.wait(30)
        orig(d)

    s._retire = gated
    futs = [s.submit(r, f) for r, f in zip(reads, refs)]
    with pytest.raises(TimeoutError, match="not ready"):
        futs[0].result(timeout=0.05)
    assert not futs[0].done()
    gate.set()
    assert futs[0].result(timeout=30)["dist"] == 0
    assert futs[1].result(timeout=30)["dist"] == 0
    s.close()


def test_cancel_queued_frees_slot_before_dispatch(rng):
    (ra, rb), (fa, fb) = _exact_pairs(rng, 2, 24)
    s = cpu_plan(rescue_rounds=0, batch_lanes=2, cache="private")
    fut = s.submit(ra, fa)
    assert fut.cancel() is True
    assert fut.cancelled() and fut.done()
    with pytest.raises(RequestCancelled):
        fut.result()
    assert fut.cancel() is True           # idempotent
    assert s.stats["cancelled"] == 1
    f2 = s.submit(rb, fb)
    s.flush()
    assert f2.result()["dist"] == 0
    assert s.stats["dispatches"] == 1
    s.close()


@pytest.mark.parametrize("executor", ["sync", "thread"])
def test_cancel_after_dispatch_never_frees_a_lane_twice(executor):
    reads, refs = _exact_pairs(np.random.default_rng(7), 2, 24)
    s = cpu_plan(rescue_rounds=0, batch_lanes=2, executor=executor,
                 cache="private")
    futs = [s.submit(r, f) for r, f in zip(reads, refs)]  # dispatched
    assert futs[0].cancel() is False
    assert not futs[0].cancelled()
    assert futs[0].result(timeout=30)["dist"] == 0
    assert futs[0].cancel() is False
    assert s.stats["cancelled"] == 0 and s.stats["dispatches"] == 1
    s.close()


def test_multi_client_submit_hammer_equal_to_serial():
    """8 client threads on ONE threaded session (mixed buckets, submit +
    flush + result each): every record equals a serial run's."""
    per_thread = []
    for t in range(8):
        trng = np.random.default_rng(500 + t)
        pairs = []
        for _ in range(6):
            ref = trng.integers(0, 4, int(trng.integers(16, 120))
                                ).astype(np.uint8)
            read = ref.copy()
            read[::9] = (read[::9] + 1) % 4
            pairs.append((read, ref))
        per_thread.append(pairs)
    kw = dict(rescue_rounds=ROUNDS, rescue_mode="bucket", batch_lanes=4)
    base = cpu_plan(**kw)
    serial = [[base.submit(r, f) for r, f in pairs] for pairs in per_thread]
    base.flush()
    want = [[sf.result() for sf in row] for row in serial]
    base.close()

    s = cpu_plan(executor="thread", **kw)
    got, errs = [None] * 8, []

    def client(i):
        try:
            futs = [s.submit(r, f) for r, f in per_thread[i]]
            s.flush()
            got[i] = [ft.result(timeout=60) for ft in futs]
        except BaseException as e:        # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    _join(threads, 120)
    assert not errs, errs
    for i in range(8):
        assert_results_equal(AlignResult.from_records(got[i]),
                             AlignResult.from_records(want[i]))
    s.close()


def test_close_while_outstanding_race(rng):
    reads, refs = _exact_pairs(rng, 16, 24)
    s = cpu_plan(rescue_rounds=0, batch_lanes=2, executor="thread",
                 cache="private")
    start = threading.Barrier(3, timeout=30)
    landed, errs = [], []

    def submitter(lo):
        start.wait()
        for i in range(lo, lo + 8):
            try:
                landed.append(s.submit(reads[i], refs[i]))
            except RuntimeError as e:
                if "closed" not in str(e):   # pragma: no cover
                    errs.append(e)
                return

    threads = [threading.Thread(target=submitter, args=(lo,))
               for lo in (0, 8)]
    for t in threads:
        t.start()
    start.wait()
    s.close(drain=True)
    _join(threads)
    assert not errs, errs
    for fut in landed:                    # landed => drained by close
        assert fut.done()
        assert fut.result(timeout=5)["dist"] == 0
    assert s._retire_thread is None


# --------------------------------------------------------------------------
# the kernel wrappers under threads
# --------------------------------------------------------------------------

def test_load_library_builds_once_under_threads(monkeypatch, tmp_path):
    """Two threads asking for the library at once: one build, one load,
    the same object to both."""
    builds, opened = [], []

    def stub_build():
        builds.append(threading.current_thread().name)
        time.sleep(0.2)                   # the other thread arrives now
        return tmp_path / "libgenasm_stub.so"

    def stub_open(path):
        opened.append(path)
        return object()

    monkeypatch.setattr(build, "_library", None)
    monkeypatch.setattr(build, "build", stub_build)
    monkeypatch.setattr(build, "_open", stub_open)
    got = []
    start = threading.Barrier(2, timeout=10)

    def ask():
        start.wait()
        got.append(build.load_library())

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    _join(threads, 10)
    assert len(builds) == 1 and len(opened) == 1
    assert len(got) == 2 and got[0] is got[1]


def test_launch_counts_exact_under_threads():
    """The wrappers' counts take a lock: 8 threads x 2,000 bumps with a
    short switch interval lose none."""
    genasm_dc.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda name=name: [
            genasm_dc._bump(genasm_dc.LAUNCHES, name) for _ in range(2000)])
            for name in ("tb_fused", "tail_banded") * 4]
        for t in threads:
            t.start()
        _join(threads, 60)
    finally:
        sys.setswitchinterval(old)
    assert genasm_dc.LAUNCHES == {"tb_fused": 8000, "tail_banded": 8000,
                                  "tail_full": 0, "dc_band": 0}
    genasm_dc.reset_counts()
    assert set(genasm_dc.LAUNCHES.values()) == {0}
