"""The concurrent multi-tenant front end with SLOs (port of
``repro/api/gateway.py``, names and semantics unchanged).

GenASM's window-independent divide-and-conquer means per-lane results are
batch-composition independent, so a scheduler is free to regroup, reorder
and preempt requests at bucket granularity without touching kernel code.
This layer does that on top of :class:`repro_torch.api.AlignSession`, on
whatever device the session runs (the card unless it was planned with
``device='cpu'``):

* **Tenants & priority lanes** — ``gateway.tenant(name, priority=...)``
  hands out submit handles.  Priority 0 is the latency lane: at every
  pump, dispatchable batches are ordered by (priority, oldest arrival),
  so a short-read latency bucket preempts a bulk long-read bucket that
  has been waiting longer.
* **Deadlines with an injectable clock** — every request may carry an
  absolute deadline (``deadline_s`` from submit time, by the gateway's
  ``clock``).  The deadline sweep expires QUEUED requests the moment
  ``now >= deadline`` (they fail fast with :class:`DeadlineExceeded` and
  their queue slot is freed — never dispatched, never wasting a lane);
  requests already dispatched complete normally and are scored against
  their deadline at COMPLETION time (``deadline_met``).  Everything is
  driven by ``pump(now)``, so the whole scheduling surface is provable
  with a fake clock and scripted arrival traces
  (tests/test_torch_gateway.py).
* **Cancellation that frees slots** — ``future.cancel()`` removes a
  queued request atomically (under the gateway lock, and under the
  session's submit lock for the mid-batch window), so the slot either
  cancels or dispatches, never both; a dispatched lane cannot be
  recalled — cancel returns False and the result simply arrives.
* **Load shedding (reject-fast)** — a request of priority p is refused
  with :class:`ShedError` when the pairs in the system (gateway-queued +
  dispatched-but-unfinished, counted exactly) reach
  ``capacity * shed_frac[p]``, so bulk lanes shed earlier than the
  latency lane.  ``capacity=None`` derives the ceiling live from the
  session's in-flight bound (``batch_lanes * (max_inflight + 1)``).

Thread model: ``submit``/``pump``/``cancel``/``close`` are safe from many
client threads (one re-entrant scheduling lock; completion callbacks from
the session's retire thread only ever take the separate stats lock, so
retire can never deadlock against a pumping client).  Results are
bit-identical to a serial AlignSession run of the same pairs — scheduling
reorders work in time, never in value.

Lifecycle::

    session = plan(cfg, batch_lanes=8, executor="thread")   # device="cuda"
    gw = Gateway(session, policy=GatewayPolicy(capacity=64))
    latency = gw.tenant("short-reads", priority=0, deadline_s=0.5)
    bulk = gw.tenant("long-reads", priority=1)
    fut = latency.submit(read, ref)        # may raise ShedError
    ...
    fut.result(timeout=1.0)                # {ok, dist, cigar, ...}
    gw.close(); session.close()
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from ..obs import resolve_obs
from .session import AlignSession, RequestCancelled, SessionPoisonedError


class ShedError(RuntimeError):
    """Admission control refused this request: the system is at this
    priority's shed threshold.  Raised by submit() — reject-fast, the
    request never queued."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it was still QUEUED: the sweep
    failed it fast and freed its slot (it was never dispatched)."""


class GatewayClosedError(RuntimeError):
    """The gateway refused the submit because close() already ran."""


@dataclasses.dataclass(frozen=True)
class GatewayPolicy:
    """The scheduling/shedding knobs, validated once at construction.

    capacity      — admission ceiling in PAIRS in the system (queued +
                    dispatched-but-unfinished).  None (default) derives it
                    live from the session: ``batch_lanes *
                    (max_inflight + 1)`` — wired to the occupancy-adaptive
                    in-flight signal, so a widened pipeline admits more.
    shed_frac     — per-priority fraction of capacity at which submits
                    shed (indexed by priority, last entry covers deeper
                    priorities).  The default sheds bulk (p>=2) at 50%,
                    standard (p=1) at 75%, and the latency lane (p=0)
                    only when the system is truly full.
    linger_s      — max age of the oldest queued request in a bucket
                    before a PARTIAL batch becomes dispatchable (the
                    latency-lane flush that keeps p99 bounded without
                    waiting for a full lane class).
    service_margin_s — dispatch a partial batch early when any queued
                    deadline is within this margin of now (a request that
                    would expire waiting for a full batch goes out now).
    """
    capacity: int | None = None
    shed_frac: tuple = (1.0, 0.75, 0.5)
    linger_s: float = 0.05
    service_margin_s: float = 0.0

    def __post_init__(self):
        assert self.capacity is None or self.capacity >= 1
        assert len(self.shed_frac) >= 1
        assert all(0.0 < f <= 1.0 for f in self.shed_frac)
        assert self.linger_s >= 0.0 and self.service_margin_s >= 0.0

    def frac_for(self, priority: int) -> float:
        return self.shed_frac[min(priority, len(self.shed_frac) - 1)]


class GatewayFuture:
    """Handle for one admitted request.  States: queued (in the gateway,
    cancellable/expirable) -> dispatched (owns an AlignFuture) -> done
    (value, error, cancelled or expired).  ``t_submit``/``t_dispatch``/
    ``t_done`` are gateway-clock timestamps; ``deadline_met`` is scored at
    completion time."""

    __slots__ = ("rid", "tenant", "priority", "bucket", "deadline",
                 "t_submit", "t_dispatch", "t_done", "_gateway", "_inner",
                 "_value", "_error", "_event", "_cancelled", "_finalized",
                 "_read", "_ref")

    def __init__(self, gateway: "Gateway", rid: int, tenant: str,
                 priority: int, bucket, deadline: float | None,
                 t_submit: float):
        self._gateway = gateway
        self.rid = rid
        self.tenant = tenant
        self.priority = priority
        self.bucket = bucket
        self.deadline = deadline
        self.t_submit = t_submit
        self.t_dispatch = None
        self.t_done = None
        self._inner = None
        self._value = None
        self._error = None
        self._event = threading.Event()
        self._cancelled = False
        self._finalized = False

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    @property
    def latency(self) -> float | None:
        """Submit-to-completion seconds (None until done)."""
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    @property
    def deadline_met(self) -> bool | None:
        """True when the request completed successfully within its
        deadline (no-deadline requests always meet); None until done."""
        if not self._event.is_set():
            return None
        if self._error is not None:
            return False
        return self.deadline is None or self.t_done <= self.deadline

    def result(self, timeout: float | None = None) -> dict:
        """Block until done and return the alignment record; raises the
        failure (DeadlineExceeded / RequestCancelled / ShedError never —
        sheds don't produce futures — or the dispatch's exception).  A
        still-queued request is force-dispatched first; ``timeout``
        bounds the wait (TimeoutError on expiry; the future stays
        collectable — timeout-then-fulfill is tested)."""
        if not self._event.is_set():
            self._gateway._force(self, timeout=timeout)
        if not self._event.is_set():
            raise TimeoutError(
                f"gateway result rid={self.rid} not ready within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._value

    def cancel(self) -> bool:
        """Cancel if still queued (gateway queue, or the session queue
        during the mid-batch window): the slot is freed before any
        dispatch and result() raises RequestCancelled.  False once the
        pair is on a dispatched lane — a committed lane is never freed
        twice, the result simply arrives.  Idempotent."""
        return self._gateway._cancel(self)


class Tenant:
    """A named submit handle: carries the tenant's default priority and
    deadline; per-request overrides allowed.  Cheap — hold one per client
    thread or share, both are safe."""

    __slots__ = ("gateway", "name", "priority", "deadline_s")

    def __init__(self, gateway: "Gateway", name: str, priority: int = 1,
                 deadline_s: float | None = None):
        assert priority >= 0, priority
        self.gateway = gateway
        self.name = name
        self.priority = priority
        self.deadline_s = deadline_s

    def submit(self, read, ref, deadline_s: float | None = None,
               priority: int | None = None) -> GatewayFuture:
        """Admit one pair (or raise ShedError / GatewayClosedError)."""
        return self.gateway.submit(
            self, read, ref,
            deadline_s=self.deadline_s if deadline_s is None else deadline_s,
            priority=self.priority if priority is None else priority)


class Gateway:
    """The scheduling layer over one AlignSession (see module docstring).

    ``auto_pump=True`` (default) pumps inline on every submit, so full
    and urgent batches dispatch immediately; ``start_sweeper()``
    additionally runs a background pump loop for deadline expiry and
    linger flushes between submits (production).  Tests drive
    ``pump(now)`` manually with a fake clock — every scheduling decision
    is a pure function of (queues, now)."""

    #: legacy stats key -> registry metric name
    STAT_METRICS = {
        "submitted": "gateway_submitted_total",
        "shed": "gateway_shed_total",
        "expired": "gateway_expired_total",
        "cancelled": "gateway_cancelled_total",
        "dispatched": "gateway_dispatched_total",
        "completed": "gateway_completed_total",
        "failed": "gateway_failed_total",
        "deadline_hits": "gateway_deadline_hits_total",
        "deadline_misses": "gateway_deadline_misses_total",
        "pumps": "gateway_pumps_total",
        "partial_dispatches": "gateway_partial_dispatches_total",
    }
    #: per-tenant counter families, labelled ``tenant="<name>"``
    TENANT_KEYS = ("submitted", "shed", "expired", "cancelled",
                   "completed", "deadline_hits")

    def __init__(self, session: AlignSession,
                 policy: GatewayPolicy = GatewayPolicy(), clock=None,
                 auto_pump: bool = True, obs=None):
        self.session = session
        self.policy = policy
        self._clock = clock if clock is not None else time.monotonic
        self.auto_pump = auto_pump
        # the gateway shares the session's observability domain by
        # default — one registry/trace tells the whole admission ->
        # dispatch -> retire story; pass obs= to split it out
        self.obs = session.obs if obs is None else \
            resolve_obs(obs, clock=self._clock)
        self._m = {k: self.obs.counter(name)
                   for k, name in self.STAT_METRICS.items()}
        self._tm: dict[str, dict] = {}          # tenant -> key -> counter
        # live-load gauges mirror _n_queued/_n_outstanding; the plain
        # ints stay the functional source of truth so admission control
        # keeps working under obs='off' (gauges would read 0)
        self._g_queued = self.obs.gauge("gateway_queued")
        self._g_outstanding = self.obs.gauge("gateway_outstanding")
        self._h_latency = self.obs.histogram("gateway_latency_seconds")
        # _lock: scheduling state (queues, dispatch) — client threads only.
        # _stats_lock: counters + future finalisation — ALSO taken by the
        # session's retire thread (completion callbacks), so nothing may
        # block while holding it, or retire could deadlock a pumping
        # client stuck on dispatch backpressure.
        self._lock = threading.RLock()
        self._stats_lock = threading.Lock()
        self._queues: dict[tuple, list] = {}    # (priority, bucket) -> [gf]
        self._next_rid = 0
        self._closed = False
        self._n_queued = 0
        self._n_outstanding = 0                 # dispatched, not finalized
        self._sweeper: threading.Thread | None = None
        self._sweeper_stop: threading.Event | None = None
        #: (priority, bucket, n_real) per dispatch, newest last — the
        #: observable the deterministic preemption tests assert on
        self.dispatch_log: deque = deque(maxlen=1024)

    @property
    def stats(self) -> dict:
        """Scheduling counters as the legacy dict — a view over the obs
        registry (asserted equal to registry reads in
        tests/test_torch_obs.py)."""
        return {k: m.value for k, m in self._m.items()}

    @property
    def tenant_stats(self) -> dict:
        """{tenant: {key: value}} — a view over the per-tenant labelled
        counters (``gateway_tenant_*_total{tenant=...}``)."""
        return {name: {k: c.value for k, c in tm.items()}
                for name, tm in self._tm.items()}

    def _tenant_metrics(self, name: str) -> dict:
        """The tenant's counter family, created on first touch (under the
        stats lock — callers hold it or are __init__/tenant())."""
        tm = self._tm.get(name)
        if tm is None:
            tm = self._tm[name] = {
                k: self.obs.counter(f"gateway_tenant_{k}_total",
                                    tenant=name)
                for k in self.TENANT_KEYS}
        return tm

    # ---- tenants -------------------------------------------------------

    def tenant(self, name: str, priority: int = 1,
               deadline_s: float | None = None) -> Tenant:
        with self._stats_lock:
            self._tenant_metrics(name)
        return Tenant(self, name, priority=priority, deadline_s=deadline_s)

    # ---- admission -----------------------------------------------------

    def capacity(self) -> int:
        """The live admission ceiling in pairs: the policy's, or derived
        from the session's occupancy signals (batch_lanes *
        (max_inflight + 1)) — the adaptive-inflight controller widening
        the pipeline widens admission with it."""
        if self.policy.capacity is not None:
            return self.policy.capacity
        return self.session.spec.batch_lanes * (
            self.session.load()["max_inflight"] + 1)

    def in_system(self) -> int:
        """Pairs occupying the gateway + session right now: queued here
        plus dispatched-but-unfinished (counted exactly via completion
        callbacks — this IS the inflight signal admission reads)."""
        with self._stats_lock:
            return self._n_queued + self._n_outstanding

    def submit(self, tenant: Tenant, read, ref,
               deadline_s: float | None = None,
               priority: int = 1) -> GatewayFuture:
        """Admit one request (reject-fast): sheds with ShedError when the
        system is at this priority's threshold, else queues it under
        (priority, bucket) and — with auto_pump — dispatches whatever
        became full/urgent.  Thread-safe."""
        now = self._clock()
        with self.obs.span("gateway.admit", tenant=tenant.name,
                           priority=priority):
            with self._lock:
                if self._closed:
                    raise GatewayClosedError("gateway is closed")
                n, cap = self.in_system(), self.capacity()
                if n >= cap * self.policy.frac_for(priority):
                    with self._stats_lock:
                        self._m["shed"].inc()
                        self._tenant_metrics(tenant.name)["shed"].inc()
                    raise ShedError(
                        f"priority-{priority} request shed: {n} pairs in "
                        f"system >= {self.policy.frac_for(priority):.0%} of "
                        f"capacity {cap}")
                bucket = self.session.bucket_for(len(read), len(ref))
                deadline = None if deadline_s is None else now + deadline_s
                gf = GatewayFuture(self, self._next_rid, tenant.name,
                                   priority, bucket, deadline, now)
                self._next_rid += 1
                gf._read, gf._ref = read, ref
                self._queues.setdefault((priority, bucket), []).append(gf)
                with self._stats_lock:
                    self._n_queued += 1
                    self._g_queued.add(1)
                    self._m["submitted"].inc()
                    self._tenant_metrics(tenant.name)["submitted"].inc()
            if self.auto_pump:
                self.pump(now)
        return gf

    # ---- the pump: sweep + priority-ordered dispatch -------------------

    def pump(self, now: float | None = None) -> int:
        """One scheduling step: expire queued deadlines, then dispatch
        every full or urgent batch in (priority, oldest-arrival) order —
        re-evaluated after each dispatch, so an urgent latency bucket
        that became dispatchable preempts the next bulk batch.  Returns
        the number of dispatches.  Deterministic given (queues, now):
        the fake-clock suite asserts exact decisions."""
        ndisp = 0
        with self._lock:
            if now is None:
                now = self._clock()
            self._m["pumps"].inc()
            self._sweep_deadlines(now)
            while True:
                key = self._next_dispatchable(now)
                if key is None:
                    break
                self._dispatch_from(key)
                ndisp += 1
        return ndisp

    def _sweep_deadlines(self, now: float) -> None:
        for key in list(self._queues):
            q = self._queues[key]
            keep = []
            for gf in q:
                if gf.deadline is not None and now >= gf.deadline:
                    self._finalize(gf, error=DeadlineExceeded(
                        f"rid={gf.rid} queued past its deadline "
                        f"({now - gf.deadline:.3f}s over)"), kind="expired")
                else:
                    keep.append(gf)
            if keep:
                self._queues[key] = keep
            else:
                del self._queues[key]

    def _next_dispatchable(self, now: float):
        """The (priority, bucket) queue to dispatch next: full queues and
        urgent ones (linger age or deadline margin), best (priority,
        oldest arrival) first.  None when nothing is dispatchable."""
        best = None
        for key, q in self._queues.items():
            if not q:
                continue
            full = len(q) >= self.session._current_lanes(key[1])
            urgent = (now - q[0].t_submit >= self.policy.linger_s) or any(
                gf.deadline is not None
                and gf.deadline - self.policy.service_margin_s <= now
                for gf in q)
            if not (full or urgent):
                continue
            rank = (key[0], q[0].t_submit)
            if best is None or rank < best[0]:
                best = (rank, key)
        return None if best is None else best[1]

    def _dispatch_from(self, key) -> None:
        """Move up to one lane class of requests from a gateway queue into
        the session (which fires the device dispatch when the bucket
        fills; partial batches are flushed explicitly).  Completion is
        observed via AlignFuture done-callbacks — they record the
        completion TIME under the stats lock and forget the session rid,
        keeping a long-lived gateway's memory bounded."""
        priority, bucket = key
        q = self._queues[key]
        lanes = self.session._current_lanes(bucket)
        batch, rest = q[:lanes], q[lanes:]
        if rest:
            self._queues[key] = rest
        else:
            del self._queues[key]
        with self._stats_lock:
            self._n_queued -= len(batch)
            self._n_outstanding += len(batch)
            self._g_queued.add(-len(batch))
            self._g_outstanding.add(len(batch))
            self._m["dispatched"].inc(len(batch))
            if len(batch) < lanes:
                self._m["partial_dispatches"].inc()
        self.dispatch_log.append((priority, bucket, len(batch)))
        t_disp = self._clock()
        err = None
        for i, gf in enumerate(batch):
            if err is not None:
                self._finalize(gf, error=err, kind="failed")
                continue
            try:
                af = self.session.submit(gf._read, gf._ref)
            except BaseException as e:   # poisoned/closed session
                err = e
                self._finalize(gf, error=e, kind="failed")
                continue
            gf.t_dispatch = t_disp
            gf._read = gf._ref = None          # the session owns them now
            gf._inner = af
            af.add_done_callback(
                lambda af, gf=gf: self._on_inner_done(gf, af))
        if err is None and len(batch) < lanes:
            self.session.flush()               # fire the partial batch

    # ---- completion / finalisation -------------------------------------

    def _on_inner_done(self, gf: GatewayFuture, af) -> None:
        """AlignFuture completion hook — runs on whichever thread retired
        the dispatch (the session's retire thread under
        executor='thread').  Takes ONLY the stats lock."""
        if af._error is not None:
            kind = "cancelled" if isinstance(af._error, RequestCancelled) \
                else "failed"
            self._finalize(gf, error=af._error, kind=kind,
                           outstanding=not isinstance(af._error,
                                                      RequestCancelled))
        else:
            self._finalize(gf, value=af._value, kind="completed")
        self.session._forget(af.rid)           # gateway owns collection

    def _finalize(self, gf: GatewayFuture, value=None, error=None,
                  kind: str = "completed", outstanding: bool | None = None):
        """Resolve a gateway future exactly once (idempotent under the
        stats lock) and keep the queued/outstanding counters exact.
        `kind`: completed | failed | expired | cancelled.  `outstanding`
        says which counter the request occupied (defaults by kind)."""
        if outstanding is None:
            outstanding = kind in ("completed", "failed")
        with self._stats_lock:
            if gf._finalized:
                return
            gf._finalized = True
            gf.t_done = self._clock()
            gf._value, gf._error = value, error
            ts = self._tenant_metrics(gf.tenant)
            if outstanding:
                self._n_outstanding -= 1
                self._g_outstanding.add(-1)
            else:
                self._n_queued -= 1
                self._g_queued.add(-1)
            if kind == "completed":
                self._m["completed"].inc()
                ts["completed"].inc()
                self._h_latency.observe(gf.t_done - gf.t_submit)
                if gf.deadline is None or gf.t_done <= gf.deadline:
                    self._m["deadline_hits"].inc()
                    ts["deadline_hits"].inc()
                else:
                    self._m["deadline_misses"].inc()
            elif kind == "expired":
                gf._cancelled = True
                self._m["expired"].inc()
                ts["expired"].inc()
            elif kind == "cancelled":
                gf._cancelled = True
                self._m["cancelled"].inc()
                ts["cancelled"].inc()
            else:
                self._m["failed"].inc()
        gf._event.set()

    # ---- forcing / cancellation ----------------------------------------

    def _force(self, gf: GatewayFuture, timeout: float | None = None):
        """Resolve one future: if still gateway-queued, dispatch its
        queue as a partial batch now (result() must not wait on traffic
        that may never come), then wait on the session future."""
        with self._lock:
            if gf._inner is None and not gf.done():
                key = (gf.priority, gf.bucket)
                q = self._queues.get(key)
                if q and gf in q:
                    self._dispatch_from(key)
        inner = gf._inner
        if inner is not None and not gf._event.is_set():
            try:
                inner.result(timeout=timeout)
            except TimeoutError:
                if not inner.done():
                    return                     # caller raises TimeoutError
            except BaseException:
                pass                           # the callback recorded it
            # the inner future resolved: its callback has run (callbacks
            # fire inside _fulfill/_fail before result() returns on this
            # or the retire thread) — but guard the cross-thread window
            self._on_inner_done(gf, inner)     # idempotent

    def _cancel(self, gf: GatewayFuture) -> bool:
        with self._lock:
            if gf.done():
                return gf._cancelled
            if gf._inner is None:
                key = (gf.priority, gf.bucket)
                q = self._queues.get(key)
                if q and gf in q:
                    q.remove(gf)
                    if not q:
                        del self._queues[key]
                    self._finalize(gf, error=RequestCancelled(
                        f"rid={gf.rid} cancelled while queued"),
                        kind="cancelled", outstanding=False)
                    return True
            inner = gf._inner
        if inner is None:
            return gf._cancelled               # finalized under our feet
        # mid-batch window: the pair may still sit in the SESSION queue
        # (partial batch before flush).  session._cancel is atomic under
        # the submit lock — it either frees the slot (True, our callback
        # fires with RequestCancelled) or the lane is committed (False).
        return inner.cancel()

    # ---- sweeper / shutdown --------------------------------------------

    def start_sweeper(self, interval_s: float = 0.005) -> None:
        """Run pump() on a background loop so deadline expiry and linger
        flushes fire between submits (production serving).  Idempotent;
        close() stops it.  Tests drive pump(now) manually instead."""
        if self._sweeper is not None and self._sweeper.is_alive():
            return
        self._sweeper_stop = threading.Event()

        def loop():
            while not self._sweeper_stop.wait(interval_s):
                try:
                    self.pump()
                except SessionPoisonedError:
                    return                     # futures already failed

        self._sweeper = threading.Thread(target=loop, name="gateway-sweep",
                                         daemon=True)
        self._sweeper.start()

    def flush_all(self) -> None:
        """Dispatch everything still queued, in (priority, oldest) order,
        without closing — the batch-boundary drain for callers that pace
        their own traffic.  Retirement still happens via result() /
        session.results()."""
        with self._lock:
            while self._queues:
                key = min(self._queues,
                          key=lambda k: (k[0], self._queues[k][0].t_submit))
                self._dispatch_from(key)

    def close(self, drain: bool = True) -> None:
        """Stop the sweeper and shut the gateway down.  drain=True
        (default) dispatches everything still queued (priority order) and
        retires every outstanding lane — futures resolve before close
        returns.  drain=False fails queued futures fast with
        RequestCancelled (dispatched lanes still complete via the
        session).  Idempotent; the underlying session is NOT closed (the
        caller owns it)."""
        if self._sweeper_stop is not None:
            self._sweeper_stop.set()
        if self._sweeper is not None:
            self._sweeper.join()
            self._sweeper = None
        with self._lock:
            self._closed = True
            if drain:
                self.flush_all()
            else:
                for q in list(self._queues.values()):
                    for gf in q:
                        self._finalize(gf, error=RequestCancelled(
                            "gateway closed without drain"),
                            kind="cancelled", outstanding=False)
                self._queues.clear()
        if drain:
            try:
                self.session.results()         # force-retire everything
            except SessionPoisonedError:
                pass                           # futures carry the errors

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None)

    # ---- stats ----------------------------------------------------------

    def gateway_stats(self) -> dict:
        """Counters + live load + per-tenant breakdown (benchmarks/CI)."""
        with self._stats_lock:
            out = self.stats                   # registry-backed property
            out["tenants"] = self.tenant_stats
            out["queued"] = self._n_queued
            out["outstanding"] = self._n_outstanding
        out["capacity"] = self.capacity()
        out["session_load"] = self.session.load()
        out["dispatch_log_tail"] = list(self.dispatch_log)[-16:]
        return out
