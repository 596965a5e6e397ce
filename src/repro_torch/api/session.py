"""One front door for alignment (port of ``repro/api/session.py``): plan
an ``AlignSession``, then stream.

A serving path cannot take its pad widths from each batch's ragged
``max_read_len``.  The session quantises lengths to power-of-two
**buckets** (``core.windowing.pow2_bucket``) and lane counts to lane
classes (``distributed.sharding.bucket_lanes``), prepares one executable
per (spec, bucket, lanes, rung, device) in a **process-shared**
:class:`CompileCache`, and streams requests through them:

* ``plan(cfg-like spec, device="cuda")`` resolves one validated
  :class:`AlignSpec` and returns a session; the device is CUDA unless the
  caller asks for the CPU, and it raises where there is none.
* ``warmup()`` is a *method*: it prepares executables before traffic.
* ``submit()`` routes requests to buckets and returns an
  :class:`AlignFuture`; ``executor='thread'`` retires dispatches on a
  background thread (bounded queue = backpressure), ``'sync'`` (default)
  retires inline.  Both give the same values: the executor reorders work
  in time, never in value.
* ``adaptive_lanes`` steps a bucket's lane class down/up the quantised
  ladder on its recent fill; ``adaptive_inflight`` widens/narrows the
  in-flight window the same way.
* Rescue (``rescue_mode='bucket'``, the default) compacts a dispatch's
  still-failed lanes into the next-smaller length/lane bucket per
  k-doubling rung; ``'device'`` runs the whole ladder in one executable
  (``core.windowing.align_pairs_rescued``).  Both equal
  ``GenASMAligner.align`` lane for lane.

**What a cached "executable" is here.**  The reference caches
``make_align_step(...).lower(*bucket_avals).compile()``; the port's
counterpart is an :class:`AlignExecutable`, keyed by the reference's key
plus the device: ``(spec.key(), cfg.fingerprint(), lanes, read_bucket,
ref_bucket, rescue_rounds, mesh_fingerprint, str(device))``.  Its build
does the one-time work of a shape: on CUDA it checks that the kernels are
instantiated for every rung's configuration (so an unsupported W or k
raises in ``warmup()`` or the first dispatch, never mid-ladder), loads the
kernel library (building it at first use), derives the K1 / K2 / K4 / K3
blocks the step will launch and queries each instantiation's occupancy,
which also raises its dynamic shared-memory limit
(``serve.align_step.launch_plan``).  Then, on CUDA with backend 'fused',
it captures the step into CUDA graphs over static inputs of the bucket's
shapes (``serve.graphs``): one graph in bucket mode, one a rung in
``rescue_mode='device'``, one a pair shard on a mesh; a failed capture
raises.  The build launches no kernel (a capture records its launches;
each replay counts them) and moves no transfer counter.  What stays
eager: backend 'split' (its PyTorch traceback syncs once a walk step),
backend 'plain', and every executable on ``device='cpu'`` (the same key
and plan, without the library).  The executable refuses inputs whose
shapes, dtypes or device differ from its bucket's ``bucket_avals``, as a
compiled executable would, so the hit / miss / lowering counters mean
shape stability; ``lowerings`` counts builds.

**Dispatch and retire on the card.**  Each submit writes its pair into
its bucket queue's padded batch (pinned host memory on the card), so a
dispatch uploads once and calls the executable: a captured one copies the batch
into its static inputs, replays and clones its outputs on a stream of its
own, under its lock, so in bucket mode control returns while the device
computes, whatever the bucket's window count; an eager one issues its
window loop from Python.  ``rescue_mode='device'`` syncs once per later
rung on the ladder's gate (``failed.any()``), so its dispatch blocks.
Each CUDA dispatch records an event on the dispatching thread's stream;
retire waits for that event on the session's own side stream and
downloads there, so a download waits for its own dispatch and not for
the kernels queued after it.  Compacted rescue rungs run on that side
stream too.  Downloads are synchronous, so a dispatch's outputs are read
before they are freed (no ``record_stream`` needed).  The session's
uploads, executable calls, event records and downloads run inside
``serve.graphs.device_work()``, so they never overlap a capture (an
executable's build, on any thread of the process).  On a mesh
(``spec.mesh``) each shard goes up to its own device in the dispatch's
one upload, and the session keeps one side stream and records one event
a distinct device of the mesh.

A session's mutating API (submit/flush/results/close) is safe to drive
from many client threads: a submit lock serialises queue mutation and
dispatch.  Exceptions on either thread poison the session: the owning
dispatch's futures carry the original exception, every other outstanding
future fails with :class:`SessionPoisonedError`, and later submits
refuse.
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from collections import deque

import numpy as np
import torch

from ..core import transfer
from ..core.aligner import AlignResult, check_mesh_device, resolve_device
from ..core.cigar import decode_batch, records_from_state
from ..core.config import AlignerConfig, resolve_config
from ..core.windowing import (SENTINEL_READ, SENTINEL_REF, bucket_avals,
                              pad_geometry, pow2_bucket, rescue_schedule)
from ..distributed.sharding import (bucket_lanes, lane_classes,
                                    mesh_fingerprint, n_pair_shards,
                                    pair_devices, pair_shards)
from ..obs import MetricsRegistry, default_registry, resolve_obs
from ..serve import graphs
from ..serve.align_step import launch_plan, make_align_step, on_device


class SessionPoisonedError(RuntimeError):
    """The session hit an unrecoverable dispatch/retire error: every
    outstanding future fails with this (the owning dispatch's futures
    carry the original exception) and further submits are refused."""


class RequestCancelled(RuntimeError):
    """The request was cancelled (AlignFuture.cancel) before its dispatch:
    its queue slot was freed and result() raises this instead of blocking.
    Deliberately NOT the stdlib CancelledError (BaseException since 3.8)
    so a bare ``except Exception`` in serving loops still catches it."""


# --------------------------------------------------------------------------
# spec
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AlignSpec:
    """Everything a session needs, resolved and validated ONCE at plan time.

    cfg           — the aligner geometry/backend (see core.config).
    rescue_rounds — k-doubling ladder depth past the base k.
    rescue_mode   — 'bucket' (compact failed lanes into smaller bucket
                    executables per rung; default) or 'device' (the
                    ladder on the device: 1 upload + 1 download total).
    batch_lanes   — lanes per full dispatch (quantised up to a lane class
                    at plan time); the adaptive ceiling.
    bucket_floor  — smallest power-of-two length bucket.
    max_inflight  — dispatches in flight before backpressure: the sync
                    executor retires the oldest inline (2 = double
                    buffering); the threaded executor bounds its retire
                    queue at this depth.  With adaptive_inflight this is
                    the *starting* depth.
    executor      — 'sync' (retire inline on the dispatch thread) or
                    'thread' (a background retire thread).
    adaptive_lanes / occupancy_window — track per-bucket fill over the
                    last `occupancy_window` dispatches and step the lane
                    class down/up the quantised ladder (never above
                    batch_lanes).
    adaptive_inflight / inflight_ceiling — the same fill signal,
                    session-wide, widens max_inflight by one (up to
                    inflight_ceiling) when every windowed dispatch
                    saturated its lane class, and narrows it by one (down
                    to 1) when none did.
    mesh          — a ``launch.mesh.DeviceMesh`` to shard each dispatch's
                    pair axis over (lane classes then quantise to
                    lane_tile * n_pair_shards), or None.
    """
    cfg: AlignerConfig = AlignerConfig()
    rescue_rounds: int = 2
    rescue_mode: str = "bucket"
    batch_lanes: int = 64
    bucket_floor: int = 32
    max_inflight: int = 2
    executor: str = "sync"
    adaptive_lanes: bool = False
    occupancy_window: int = 8
    adaptive_inflight: bool = False
    inflight_ceiling: int = 8
    mesh: object = None

    def __post_init__(self):
        assert self.rescue_mode in ("bucket", "device"), self.rescue_mode
        assert self.executor in ("sync", "thread"), self.executor
        assert self.rescue_rounds >= 0
        assert self.batch_lanes >= 1
        assert self.bucket_floor >= 1
        assert self.max_inflight >= 1
        assert self.occupancy_window >= 1
        assert self.inflight_ceiling >= 1
        if self.adaptive_inflight:
            assert self.inflight_ceiling >= self.max_inflight, \
                (self.inflight_ceiling, self.max_inflight)

    def key(self):
        """Hashable identity of everything that shapes an executable — the
        spec-hash component of the shared CompileCache key.  Content-hashed
        (cfg.fingerprint), so independently-planned equal specs share
        executables process-wide.  Executor/batching/inflight knobs are
        absent: they schedule work, they don't shape it."""
        return (self.cfg.fingerprint(), self.rescue_rounds, self.rescue_mode)

    def read_bucket(self, read_len: int) -> int:
        return pow2_bucket(read_len, self.bucket_floor)

    def ref_bucket(self, ref_len: int) -> int:
        return pow2_bucket(ref_len, self.bucket_floor)


def plan(cfg: AlignerConfig | None = None, *, backend: str | None = None,
         rescue_rounds: int = 2, rescue_mode: str = "bucket",
         batch_lanes: int = 64, bucket_floor: int = 32,
         max_inflight: int = 2, executor: str = "sync",
         adaptive_lanes: bool = False, occupancy_window: int = 8,
         adaptive_inflight: bool = False, inflight_ceiling: int = 8,
         mesh=None, cache: "CompileCache | str" = "shared",
         clock=None, obs=None, device="cuda",
         **cfg_overrides) -> "AlignSession":
    """Resolve a cfg-like spec into a planned :class:`AlignSession`.

    Accepts an AlignerConfig (or None for defaults) plus any AlignerConfig
    field as a keyword override (``backend=``, ``W=``, ``k=``,
    ``lane_tile='auto'``, ...) and the session knobs above.  This is the
    one validation funnel.

    ``device`` is CUDA unless the caller asks for the CPU (the kernels'
    plain PyTorch versions); it raises where there is no CUDA.  ``mesh``
    (a ``launch.mesh.DeviceMesh`` of devices of that type) shards every
    dispatch's pair axis; each dispatch still makes one upload and one
    download.
    ``cache``: ``'shared'`` (default) joins the process-wide CompileCache;
    ``'private'`` isolates this session; an explicit :class:`CompileCache`
    shares exactly with whoever else holds it.  ``clock`` injects the time
    source for the session's wall-clock stats and spans (default
    ``time.monotonic``).  ``obs``: ``None`` (default) a private enabled
    bundle on the same clock; ``'off'`` no telemetry (``session.stats``
    reads zeros); an :class:`repro_torch.obs.Obs` a caller-scoped bundle.
    """
    device = resolve_device(device)
    check_mesh_device(mesh, device)
    cfg = resolve_config(cfg, backend=backend, **cfg_overrides)
    spec = AlignSpec(cfg=cfg, rescue_rounds=rescue_rounds,
                     rescue_mode=rescue_mode,
                     batch_lanes=bucket_lanes(batch_lanes, cfg, mesh),
                     bucket_floor=bucket_floor, max_inflight=max_inflight,
                     executor=executor, adaptive_lanes=adaptive_lanes,
                     occupancy_window=occupancy_window,
                     adaptive_inflight=adaptive_inflight,
                     inflight_ceiling=inflight_ceiling, mesh=mesh)
    return AlignSession(spec, cache=cache, clock=clock, obs=obs,
                        device=device)


# --------------------------------------------------------------------------
# executables and the compile cache — process-shared store + per-session
# counter views
# --------------------------------------------------------------------------

_ARG_NAMES = ("reads", "read_len", "refs", "ref_len")


class AlignExecutable:
    """One bucket's prepared align step (see the module docstring): the
    eager step, the (shape, dtype) of each input it accepts, its device,
    the launch plan its build prepared and, where it runs captured, its
    graphs (``serve.graphs.GraphedStep``, else None).  On a mesh
    (``shards``: the device of each pair shard) each input is a tuple of
    one tensor a shard, and `avals` is one shard's.  Calling it with
    anything else raises TypeError, as a compiled executable refuses other
    avals."""

    __slots__ = ("step", "avals", "device", "launches", "shards", "graphs")

    def __init__(self, step, avals, device, launches, shards=None,
                 graphs=None):
        self.step = step
        self.avals = avals
        self.device = device
        self.launches = launches
        self.shards = shards
        self.graphs = graphs

    def __call__(self, *args):
        if len(args) != len(self.avals):
            raise TypeError(f"an align executable takes {len(self.avals)} "
                            f"inputs, got {len(args)}")
        if self.shards is None:
            per_shard, devices = [args], [self.device]
        else:
            if any(not isinstance(a, (tuple, list))
                   or len(a) != len(self.shards) for a in args):
                raise TypeError(f"this executable runs on a mesh of "
                                f"{len(self.shards)} pair shards: each "
                                f"input is a tuple of one tensor a shard")
            per_shard, devices = list(zip(*args)), self.shards
        for i, (shard, dev) in enumerate(zip(per_shard, devices)):
            where = "" if self.shards is None else f" of shard {i}"
            for name, t, (shape, dtype) in zip(_ARG_NAMES, shard,
                                               self.avals):
                if (tuple(t.shape) != shape or t.dtype != dtype
                        or not on_device(t, dev)):
                    raise TypeError(
                        f"{name}{where}: {tuple(t.shape)} {t.dtype} on "
                        f"{t.device}, but this executable was prepared for "
                        f"{shape} {dtype} on {dev}")
        if self.graphs is not None:
            return self.graphs(*args)
        return self.step(*args)


def build_executable(cfg: AlignerConfig, lanes: int, read_bucket: int,
                     ref_bucket: int, rescue_rounds: int | None,
                     device, mesh=None) -> AlignExecutable:
    """Prepare one bucket's executable: the align step at the bucket's
    read length, its launch plan (``serve.align_step.launch_plan``) and,
    where ``serve.graphs.captures``, the step captured into CUDA graphs.
    On a mesh, `lanes` (a multiple of ``pair_pad_multiple``) splits into
    equal shards."""
    step = make_align_step(cfg, read_bucket, mesh,
                           rescue_rounds=rescue_rounds, device=device)
    avals = bucket_avals(cfg, lanes // n_pair_shards(mesh), read_bucket,
                         ref_bucket, rescue_rounds or 0)
    devices = [torch.device(device)] if mesh is None else pair_devices(mesh)
    plan_ = launch_plan(cfg, read_bucket, rescue_rounds, device, mesh)
    captured = None
    if graphs.captures(cfg, device):
        captured = graphs.GraphedStep(cfg, read_bucket, rescue_rounds, avals,
                                      devices, mesh)
    return AlignExecutable(step, avals, torch.device(device), plan_,
                           None if mesh is None else tuple(devices),
                           captured)


class _Pending:
    """Placeholder for a key whose build is in progress on another thread;
    waiters block on the event instead of the store lock."""

    __slots__ = ("event",)

    def __init__(self):
        self.event = threading.Event()


class CompileCache:
    """Thread-safe executable store keyed by (spec-hash, bucket, lanes,
    rung, mesh-fingerprint, device), with process-level counters.

    ``fetch(key, build)`` returns ``(executable, was_built)``; the build
    is serialized PER KEY, not store-wide: the store lock is only held to
    reserve the key, so one session's cold bucket never waits behind
    another's build of an unrelated key, while two sessions racing on the
    SAME key still build it exactly once.  The module-level instance
    behind :func:`shared_compile_cache` sits on the port's default obs
    registry; privately-constructed caches get a private registry.  The
    ``hits`` / ``misses`` / ``lowerings`` attributes are read-only views
    over the ``compile_cache_*_total`` counters (``lowerings`` counts
    builds)."""

    def __init__(self, registry=None):
        self._lock = threading.RLock()
        self._exe: dict = {}
        self._reg = registry if registry is not None else MetricsRegistry()
        self._m_hits = self._reg.counter("compile_cache_hits_total")
        self._m_misses = self._reg.counter("compile_cache_misses_total")
        self._m_lowerings = self._reg.counter(
            "compile_cache_lowerings_total")
        self.bucket_hits: dict = {}     # key -> times served from cache

    @property
    def hits(self) -> int:
        return self._m_hits.value

    @property
    def misses(self) -> int:
        return self._m_misses.value

    @property
    def lowerings(self) -> int:
        return self._m_lowerings.value

    def fetch(self, key, build):
        while True:
            with self._lock:
                entry = self._exe.get(key)
                if entry is None:
                    pending = self._exe[key] = _Pending()
                    self._m_misses.inc()
                    self._m_lowerings.inc()
                    break                       # this thread builds
                if not isinstance(entry, _Pending):
                    self._m_hits.inc()
                    self.bucket_hits[key] = self.bucket_hits.get(key, 0) + 1
                    return entry, False
            # someone else is building this key: wait off-lock, then
            # re-read (after a failed build the key is gone and the loop
            # retries the build itself, raising its own error)
            entry.event.wait()
        try:
            exe = build()
        except BaseException:
            with self._lock:
                self._exe.pop(key, None)        # builds stay retryable
            pending.event.set()
            raise
        with self._lock:
            self._exe[key] = exe
        pending.event.set()
        return exe, True

    def get(self, key, build):
        return self.fetch(key, build)[0]

    def clear(self):
        with self._lock:
            self._exe.clear()

    def __len__(self):
        with self._lock:
            return sum(1 for v in self._exe.values()
                       if not isinstance(v, _Pending))

    def stats(self) -> dict:
        with self._lock:
            n = sum(1 for v in self._exe.values()
                    if not isinstance(v, _Pending))
            return {"hits": self.hits, "misses": self.misses,
                    "lowerings": self.lowerings, "executables": n,
                    "bucket_hits": {str(k): v
                                    for k, v in self.bucket_hits.items()}}


_PROCESS_CACHE = CompileCache(registry=default_registry())


def shared_compile_cache() -> CompileCache:
    """The process-wide executable store every ``plan(cache='shared')``
    session joins: one build per key per process, however many
    sessions."""
    return _PROCESS_CACHE


class _SessionCacheView:
    """One session's window onto a (possibly shared) CompileCache.

    Counters are per-session — ``lowerings`` counts builds performed on
    behalf of THIS session, ``hits`` fetches served from the store, and
    ``shared_hits`` the subset of hits whose executable some *other*
    session built (first-touch hits).  Summed over sessions, hits+misses
    and lowerings equal the store's.  The counters live on the owning
    session's obs registry (``session_cache_*_total``)."""

    def __init__(self, store: CompileCache, registry=None):
        self.store = store
        self._lock = threading.Lock()
        self._seen: set = set()
        reg = registry if registry is not None else MetricsRegistry()
        self._m_hits = reg.counter("session_cache_hits_total")
        self._m_misses = reg.counter("session_cache_misses_total")
        self._m_lowerings = reg.counter("session_cache_lowerings_total")
        self._m_shared_hits = reg.counter("session_cache_shared_hits_total")
        self.bucket_hits: dict = {}

    @property
    def hits(self) -> int:
        return self._m_hits.value

    @property
    def misses(self) -> int:
        return self._m_misses.value

    @property
    def lowerings(self) -> int:
        return self._m_lowerings.value

    @property
    def shared_hits(self) -> int:
        return self._m_shared_hits.value

    def get(self, key, build):
        exe, built = self.store.fetch(key, build)
        with self._lock:
            first = key not in self._seen
            self._seen.add(key)
            if built:
                self._m_misses.inc()
                self._m_lowerings.inc()
            else:
                self._m_hits.inc()
                self.bucket_hits[key] = self.bucket_hits.get(key, 0) + 1
                if first:
                    self._m_shared_hits.inc()
        return exe

    def __len__(self):
        return len(self._seen)

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "lowerings": self.lowerings, "executables": len(self._seen),
                    "shared_hits": self.shared_hits,
                    "bucket_hits": {str(k): v
                                    for k, v in self.bucket_hits.items()},
                    "process": self.store.stats()}


# --------------------------------------------------------------------------
# futures
# --------------------------------------------------------------------------

class AlignFuture:
    """Handle for one submitted pair; fulfilled (or failed) when its
    dispatch retires — on the dispatch thread (executor='sync') or the
    session's background retire thread (executor='thread')."""

    __slots__ = ("rid", "_session", "_value", "_error", "_event",
                 "_cancelled", "_callbacks")

    def __init__(self, session: "AlignSession", rid: int):
        self._session = session
        self.rid = rid
        self._value = None
        self._error = None
        self._event = threading.Event()
        self._cancelled = False
        self._callbacks: list = []

    def done(self) -> bool:
        return self._event.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def result(self, timeout: float | None = None) -> dict:
        """Block until this pair's result is available and return it:
        {ok, dist, cigar, k_used, ops, read_consumed, ref_consumed}.
        Raises the dispatch's exception (or SessionPoisonedError /
        RequestCancelled) if it will never resolve.  ``timeout`` bounds
        the WAIT in seconds — on expiry a ``TimeoutError`` is raised and
        the future stays collectable.  The sync executor retires inline on
        this thread, so its forcing work is not interruptible mid-retire;
        the bound applies to waiting on the background executor.
        Collecting here counts as collecting: the session forgets the rid
        (it will not appear in results())."""
        if not self._event.is_set():
            self._session._force(self, timeout=timeout)
        if not self._event.is_set():
            raise TimeoutError(
                f"align result rid={self.rid} not ready within {timeout}s")
        self._session._forget(self.rid)
        if self._error is not None:
            raise self._error
        return self._value

    def cancel(self) -> bool:
        """Cancel this request if it is still QUEUED (not yet dispatched):
        its bucket-queue slot is freed atomically under the submit lock,
        and result() raises RequestCancelled.  Returns True when cancelled
        (idempotently), False when the pair already dispatched or
        completed: a committed lane cannot be recalled."""
        return self._session._cancel(self)

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` when the future resolves (fulfil, fail, or
        cancel) — immediately if already done.  Callbacks fire on
        whichever thread resolves the future; exceptions from callbacks
        are swallowed and recorded on the session's ``callback_errors``
        counter (``session_callback_errors_total``)."""
        self._callbacks.append(fn)
        if self._event.is_set():
            self._run_callbacks()

    def _run_callbacks(self) -> None:
        # list.pop is atomic under the GIL: when a resolver races an
        # add_done_callback, each callback still runs exactly once
        while True:
            try:
                fn = self._callbacks.pop()
            except IndexError:
                return
            try:
                fn(self)
            except BaseException as e:  # noqa: BLE001 — callbacks NEVER
                # poison: they run on whichever thread resolves the future
                # (the retire thread under executor='thread'), so even a
                # BaseException from a client hook is recorded, not
                # allowed to unwind into the retire loop
                self._session._callback_error(e)

    # internal — called by the session (either thread)
    def _fulfill(self, value) -> None:
        self._value = value
        self._event.set()
        self._run_callbacks()

    def _fail(self, err: BaseException) -> None:
        if not self._event.is_set():
            self._error = err
            self._event.set()
        self._run_callbacks()


@dataclasses.dataclass
class _Dispatch:
    """One in-flight bucket batch: device outputs + what retiring needs."""
    futures: list          # n_real AlignFutures, lane order
    reads: list            # n_real host code arrays (for bucket rescue)
    refs: list
    out: dict              # device tensors from the executable
    ready: object = None   # CUDA events after the launch, one a device of
                           # the dispatch (None on the CPU)


_SHUTDOWN = object()       # retire-queue sentinel for close()


def _session_device(device) -> torch.device:
    """resolve_device, with an index-less CUDA device pinned to the
    current one, so equal devices key the cache equally."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# --------------------------------------------------------------------------
# session
# --------------------------------------------------------------------------

class AlignSession:
    """The planned front door: shape-stable, prepared, streaming.

    Lifecycle: ``plan(...)`` -> optional ``warmup(...)`` -> ``submit(...)``
    per request (or ``align(reads, refs)`` for a one-shot batch) ->
    ``flush()`` / ``results()`` / ``future.result()`` -> ``close()`` (a
    context manager does it for you; only required for executor='thread').
    """

    #: legacy stats key -> registry metric name: ``session.stats`` is a
    #: read-only view building this dict from the obs counters
    STAT_METRICS = {
        "dispatches": "session_dispatches_total",
        "lanes": "session_lanes_total",
        "pad_lanes": "session_pad_lanes_total",
        "requests": "session_requests_total",
        "cancelled": "session_cancelled_total",
        "rescue_dispatches": "session_rescue_dispatches_total",
        "rescue_lanes": "session_rescue_lanes_total",
        "lane_class_steps": "session_lane_class_steps_total",
        "inflight_steps": "session_inflight_steps_total",
        "callback_errors": "session_callback_errors_total",
        "wall_s": "session_wall_seconds_total",
        "retire_wall_s": "session_retire_wall_seconds_total",
    }

    def __init__(self, spec: AlignSpec, cache: CompileCache | str = "shared",
                 clock=None, obs=None, device="cuda"):
        self.spec = spec
        self.cfg = spec.cfg          # resolved; exposed for shims/stats
        self.mesh = spec.mesh
        self.device = _session_device(device)
        self._clock = clock if clock is not None else time.monotonic
        # one observability domain per session (registry + tracer on the
        # session clock); 'off' -> the null bundle, zero hot-path cost
        self.obs = resolve_obs(obs, clock=self._clock)
        # metric objects are fetched ONCE here; the hot path pays a
        # locked += per event (or a no-op call when obs='off')
        self._m = {k: self.obs.counter(name)
                   for k, name in self.STAT_METRICS.items()}
        if cache == "shared":
            store = _PROCESS_CACHE
        elif cache == "private":
            store = CompileCache()
        else:
            assert isinstance(cache, CompileCache), cache
            store = cache
        self.cache = _SessionCacheView(store, registry=self.obs.registry)
        self._mesh_fp = mesh_fingerprint(spec.mesh)
        # retire downloads (and runs rescue rungs) on these streams, one
        # a device the dispatches run on, after the dispatch's events
        # (module docstring)
        devices = ((self.device,) if spec.mesh is None
                   else tuple(dict.fromkeys(pair_devices(spec.mesh))))
        self._retire_streams = ([torch.cuda.Stream(d) for d in devices]
                                if self.device.type == "cuda" else [])
        self._queues: dict[tuple, list] = {}   # bucket -> [(future, r, f)]
        # bucket -> its queue's padded rows, written at submit: (what the
        # upload takes, numpy views to fill), ``_host_batch``
        self._staged: dict[tuple, tuple] = {}
        self._inflight: deque[_Dispatch] = deque()   # sync executor only
        self._open: dict[int, AlignFuture] = {}   # not yet handed out
        self._next_rid = 0
        self._lock = threading.Lock()          # _open + poisoning
        # serialises queue mutation + dispatch across CLIENT threads (the
        # retire thread never takes it — no deadlock with close/_drain);
        # re-entrant because flush()/close() nest dispatches under it
        self._submit_lock = threading.RLock()
        self._poisoned: BaseException | None = None
        self._closed = False
        # threaded retire executor (started lazily at first dispatch)
        self._retire_q: queue.Queue | None = None
        self._retire_thread: threading.Thread | None = None
        # occupancy-adaptive lane classes
        self._ladder = lane_classes(spec.batch_lanes, spec.cfg, spec.mesh)
        self._lane_class: dict[tuple, int] = {}    # bucket -> current class
        self._fills: dict[tuple, deque] = {}       # bucket -> recent fills
        # occupancy-adaptive in-flight window (session-wide)
        self._max_inflight = spec.max_inflight
        self._inflight_win: deque = deque(maxlen=spec.occupancy_window)

    @property
    def stats(self) -> dict:
        """Serving counters as the legacy dict — a point-in-time view over
        the obs registry.  Zeros when ``obs='off'``."""
        return {k: m.value for k, m in self._m.items()}

    def _callback_error(self, exc: BaseException) -> None:
        """Swallow-and-record for done-callbacks: must never raise."""
        self._m["callback_errors"].inc()

    # ---- context management / shutdown --------------------------------

    def __enter__(self) -> "AlignSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(drain=exc_type is None and self._poisoned is None)

    def close(self, drain: bool = True) -> None:
        """Shut the session down cleanly.  drain=True (default) dispatches
        partial queues and retires everything in flight first — already-
        obtained futures stay collectable afterwards.  drain=False
        abandons queued/in-flight work: its futures fail fast with
        SessionPoisonedError (both executors).  Always stops the
        background retire thread (sentinel + join); idempotent.  A closed
        session refuses further submits.  The closed flag flips under the
        submit lock BEFORE draining, so a racing submit either lands (and
        is drained here) or refuses."""
        with self._submit_lock:
            was_closed, self._closed = self._closed, True
            if drain and self._poisoned is None and not was_closed:
                self.flush()
        if drain and self._poisoned is None and not was_closed:
            self._drain()
        if not drain and self._poisoned is None:
            # fail-fast every outstanding future (and whatever the retire
            # queue still holds) so nothing waits on abandoned work
            self._poison(SessionPoisonedError(
                "session closed without drain"))
        self._closed = True
        t = self._retire_thread
        if t is not None and t.is_alive():
            if self._poisoned is not None:
                self._retire_q.join()     # fail-fast drain so join ends
            self._retire_q.put(_SHUTDOWN)
            t.join()
        self._retire_thread = None

    # ---- planning / warm-up -------------------------------------------

    def bucket_for(self, read_len: int, ref_len: int) -> tuple[int, int]:
        """The (read_bucket, ref_bucket) length class a pair routes to."""
        return (self.spec.read_bucket(read_len),
                self.spec.ref_bucket(ref_len))

    def warmup(self, length_classes, lanes: int | None = None) -> dict:
        """Prepare executables ahead of traffic — an explicit method, not
        a side effect of the first submit.

        length_classes: iterable of (read_len, ref_len) pairs; each is
        bucketed and prepared at the `lanes` lane class (default
        spec.batch_lanes) — for 'bucket' rescue, every k-doubling rung at
        that same bucket/lane class too.  A compacted rescue round derives
        its length bucket and lane class from however many lanes actually
        failed, so a smaller class that was never warmed is built on its
        first occurrence; the same applies to adaptive_lanes.  Returns the
        cache stats snapshot."""
        lanes = self.spec.batch_lanes if lanes is None else lanes
        for read_len, ref_len in length_classes:
            rb, fb = self.bucket_for(read_len, ref_len)
            nb = bucket_lanes(lanes, self.cfg, self.mesh)
            if self.spec.rescue_mode == "device":
                self._executable(self.cfg, nb, rb, fb,
                                 rescue_rounds=self.spec.rescue_rounds)
            else:
                self._executable(self.cfg, nb, rb, fb, rescue_rounds=None)
                for cfg_r in rescue_schedule(self.cfg,
                                             self.spec.rescue_rounds)[1:]:
                    self._executable(cfg_r, nb, rb, fb, rescue_rounds=None)
        return self.cache.stats()

    # ---- executables ---------------------------------------------------

    def _executable(self, cfg, lanes, read_bucket, ref_bucket,
                    rescue_rounds):
        """The executable for one batch shape on the session's device.
        rescue_rounds=None -> plain align step (one ladder rung); an int ->
        the whole ladder on the device.  Content-hashed keys, so equal
        specs share across sessions; safe to call from the retire thread
        (rescue rungs are built on demand)."""
        key = (self.spec.key(), cfg.fingerprint(), lanes, read_bucket,
               ref_bucket, rescue_rounds, self._mesh_fp, str(self.device))
        return self.cache.get(key, lambda: build_executable(
            cfg, lanes, read_bucket, ref_bucket, rescue_rounds, self.device,
            self.mesh))

    # ---- streaming -----------------------------------------------------

    def _check_poisoned(self):
        if self._poisoned is not None:
            raise SessionPoisonedError(
                "session is poisoned; no further dispatches") \
                from self._poisoned

    def _check_usable(self):
        self._check_poisoned()
        if self._closed:
            raise RuntimeError("session is closed")

    def submit(self, read: np.ndarray, ref: np.ndarray) -> AlignFuture:
        """Queue one encoded (read, ref) pair; dispatches fire whenever a
        bucket queue reaches its current lane class.  Callable from many
        client threads: the submit lock serialises queue mutation +
        dispatch."""
        with self._submit_lock:
            self._check_usable()
            fut = AlignFuture(self, self._next_rid)
            self._next_rid += 1
            with self._lock:
                self._open[fut.rid] = fut
            self._m["requests"].inc()
            bucket = self.bucket_for(len(read), len(ref))
            q = self._queues.setdefault(bucket, [])
            self._stage(bucket, len(q), read, ref)
            q.append((fut, read, ref))
            if len(q) >= self._current_lanes(bucket):
                self._dispatch(bucket, self._queues.pop(bucket))
            return fut

    def flush(self):
        """Dispatch every partially-filled bucket queue (thread-safe)."""
        with self._submit_lock:
            for bucket in list(self._queues):
                self._dispatch(bucket, self._queues.pop(bucket))

    def results(self) -> dict[int, dict]:
        """Flush, retire every in-flight dispatch, and return
        {rid: result dict} for every request not yet collected.  Collected
        rids are forgotten.  Raises SessionPoisonedError if the session
        was poisoned (individual futures carry the underlying errors)."""
        self.flush()
        self._drain()
        if self._poisoned is not None:
            raise SessionPoisonedError(
                "session poisoned while draining") from self._poisoned
        with self._lock:
            done = {rid: fut._value for rid, fut in self._open.items()
                    if fut.done() and fut._error is None}
            for rid in done:
                del self._open[rid]
        return done

    def align(self, reads, refs) -> AlignResult:
        """One-shot batch: submit all pairs, drain, and assemble an
        AlignResult in input order — equal to GenASMAligner.align."""
        assert len(reads) == len(refs)
        futs = [self.submit(r, f) for r, f in zip(reads, refs)]
        self.flush()
        recs = [f.result() for f in futs]   # result() collects each rid
        return AlignResult.from_records(recs)

    # ---- adaptive lane classes -----------------------------------------

    def _current_lanes(self, bucket) -> int:
        return self._lane_class.get(bucket, self.spec.batch_lanes)

    def _adapt(self, bucket, n_real: int) -> None:
        """Occupancy-driven lane-class negotiation, between batches: once
        the bucket's fill window is full, step DOWN one ladder rung when
        every recent dispatch would fit a smaller class, and back UP one
        rung when every recent dispatch saturated the current class.
        Purely a shape choice: results are lane-class invariant (pads are
        repeated real pairs)."""
        if not self.spec.adaptive_lanes or len(self._ladder) < 2:
            return
        win = self._fills.setdefault(
            bucket, deque(maxlen=self.spec.occupancy_window))
        win.append(n_real)
        if len(win) < win.maxlen:
            return
        cur = self._current_lanes(bucket)
        i = self._ladder.index(cur) if cur in self._ladder \
            else len(self._ladder) - 1
        if min(win) >= cur and i + 1 < len(self._ladder):
            self._lane_class[bucket] = self._ladder[i + 1]
        elif i > 0 and bucket_lanes(max(max(win), 1), self.cfg,
                                    self.mesh) < cur:
            self._lane_class[bucket] = self._ladder[i - 1]
        else:
            return
        win.clear()                      # fresh window for the new class
        self._m["lane_class_steps"].inc()

    # ---- adaptive in-flight window -------------------------------------

    def _adapt_inflight(self, saturated: bool) -> None:
        """Occupancy-driven in-flight depth: once the window is full, widen
        the bound by one up to spec.inflight_ceiling when every windowed
        dispatch filled its lane class, narrow by one toward 1 when none
        did.  Purely a scheduling choice.  _max_inflight is only written
        under the submit lock, so readers need no extra lock (the retire
        thread never reads it)."""
        if not self.spec.adaptive_inflight:
            return
        win = self._inflight_win
        win.append(bool(saturated))
        if len(win) < win.maxlen:
            return
        cur = self._max_inflight
        if all(win) and cur < self.spec.inflight_ceiling:
            self._max_inflight = cur + 1
        elif not any(win) and cur > 1:
            self._max_inflight = cur - 1
        else:
            return
        win.clear()                      # fresh window for the new bound
        self._m["inflight_steps"].inc()

    # ---- dispatch ------------------------------------------------------

    def _dispatch(self, bucket, items):
        """Upload one bucket batch (padded as its pairs were submitted)
        once, launch the executable,
        and hand the dispatch to the executor: the sync path retires the
        oldest inline once max_inflight is exceeded (double buffering);
        the threaded path enqueues it for the background retire thread
        (bounded queue — the backpressure).  A raising dispatch poisons
        the session and re-raises here.  Callers hold the submit lock."""
        self._check_poisoned()
        try:
            self._dispatch_inner(bucket, items)
        except BaseException as e:
            self._poison(e, owning=[it[0] for it in items])
            raise

    def _dispatch_inner(self, bucket, items):
        threaded = self.spec.executor == "thread"
        cls = self._current_lanes(bucket)   # pre-step class, for saturation
        if not threaded:
            while len(self._inflight) >= self._max_inflight:
                self._retire_guarded(self._inflight.popleft())
        t0 = self._clock()
        futs = [it[0] for it in items]
        reads = [it[1] for it in items]
        refs = [it[2] for it in items]
        rb, fb = bucket
        lanes = bucket_lanes(len(items), self.cfg, self.mesh)
        with self.obs.span("session.dispatch", bucket=f"{rb}x{fb}",
                           lanes=lanes, n_real=len(items)):
            device_mode = self.spec.rescue_mode == "device"
            rounds = self.spec.rescue_rounds if device_mode else None
            exe = self._executable(self.cfg, lanes, rb, fb,
                                   rescue_rounds=rounds)
            bufs, views = self._staged.pop(bucket)
            self._repeat_last(views, len(items), lanes)
            with graphs.device_work():
                dev = transfer.to_device(
                    tuple(b[:lanes] for b in bufs), self.device,
                    pair_shards(lanes, self.cfg, self.mesh))
                # bucket mode launches without a host sync: this span
                # covers upload + enqueue, not device occupancy
                with self.obs.span("device.execute", lanes=lanes):
                    out, _ = exe(*dev)
                    ready = None
                    if self._retire_streams:
                        ready = []
                        for stream in self._retire_streams:
                            ready.append(torch.cuda.Event())
                            ready[-1].record(
                                torch.cuda.current_stream(stream.device))
        d = _Dispatch(futs, reads, refs, out, ready)
        if threaded:
            self._enqueue_retire(d)
        else:
            self._inflight.append(d)
        self._m["dispatches"].inc()
        self._m["lanes"].inc(lanes)
        self._m["pad_lanes"].inc(lanes - len(items))
        self._m["wall_s"].inc(self._clock() - t0)
        self._adapt(bucket, len(items))
        self._adapt_inflight(len(items) >= cls)

    def _host_batch(self, lanes, Lr, Lf) -> tuple:
        """Uninitialised host rows of one batch (reads, read_len, refs,
        ref_len): (what the upload takes, numpy views to fill), pinned
        host memory for the card (``transfer.host_empty``)."""
        bufs = [transfer.host_empty(shape, dtype, self.device)
                for shape, dtype in (((lanes, Lr), np.uint8),
                                     ((lanes,), np.int32),
                                     ((lanes, Lf), np.uint8),
                                     ((lanes,), np.int32))]
        return tuple(b for b, _ in bufs), tuple(v for _, v in bufs)

    @staticmethod
    def _put_row(views, i, read, ref) -> None:
        """Lane i: the pair's codes, then sentinels to the row's end."""
        rpad, rlen, fpad, flen = views
        rpad[i, :len(read)] = read
        rpad[i, len(read):] = SENTINEL_READ
        rlen[i] = len(read)
        fpad[i, :len(ref)] = ref
        fpad[i, len(ref):] = SENTINEL_REF
        flen[i] = len(ref)

    @staticmethod
    def _repeat_last(views, n: int, lanes: int) -> None:
        """Ragged lane tails are REPEATS of the last real pair (exactly as
        alignable as its twin, so pads can't keep rescue gates open or
        skew stats)."""
        for v in views:
            v[n:lanes] = v[n - 1]

    def _stage(self, bucket, i: int, read, ref) -> None:
        """Write a submitted pair into row i of its bucket queue's padded
        batch (allocated at the queue's first pair, at the bucket's lane
        class): the padding is paid as pairs arrive, and a dispatch only
        uploads.  Callers hold the submit lock."""
        staged = self._staged.get(bucket)
        if staged is None:
            rounds = (self.spec.rescue_rounds
                      if self.spec.rescue_mode == "device" else 0)
            staged = self._staged[bucket] = self._host_batch(
                self._current_lanes(bucket),
                *pad_geometry(self.cfg, *bucket, rounds))
        self._put_row(staged[1], i, read, ref)

    def _pad_batch(self, reads, refs, lanes, Lr, Lf):
        """One batch padded at once (a rescue rung): `lanes` rows of (Lr,
        Lf), ``_put_row`` a pair, ``_repeat_last`` the tail."""
        bufs, views = self._host_batch(lanes, Lr, Lf)
        for i, (r, f) in enumerate(zip(reads, refs)):
            self._put_row(views, i, r, f)
        self._repeat_last(views, len(reads), lanes)
        return bufs

    # ---- the background retire executor --------------------------------

    def _ensure_retire_thread(self):
        if self._retire_thread is None or not self._retire_thread.is_alive():
            # allocate at the ceiling so a widened bound never needs a new
            # queue; the *current* bound is enforced in _enqueue_retire
            depth = (self.spec.inflight_ceiling
                     if self.spec.adaptive_inflight
                     else self.spec.max_inflight)
            self._retire_q = queue.Queue(maxsize=depth)
            self._retire_thread = threading.Thread(
                target=self._retire_loop, name="align-retire", daemon=True)
            self._retire_thread.start()

    def _enqueue_retire(self, d: _Dispatch):
        """Bounded-queue backpressure at the *current* in-flight bound:
        block while retire is >= _max_inflight behind.  The qsize check is
        race-free here because this (dispatch) thread is the only producer
        — the retire thread only ever shrinks the queue.  The 0.1s tick
        doubles as the liveness check: a dead retire thread with a backed-
        up queue poisons the submit instead of hanging it."""
        self._ensure_retire_thread()
        while True:
            if self._retire_q.qsize() < self._max_inflight:
                try:
                    self._retire_q.put(d, timeout=0.1)
                    return
                except queue.Full:
                    pass
            else:
                time.sleep(0.005)
            if not self._retire_thread.is_alive():
                raise SessionPoisonedError(
                    "retire thread died with its queue full")

    def _retire_loop(self):
        """The background executor: download each dispatch, decode it
        (core.cigar.decode_batch — pure numpy) and run any compacted
        rescue rounds, beside the dispatch thread.  Exceptions never die
        silently: the failing dispatch's futures get the exception, the
        session is poisoned, and the loop keeps consuming (fail-fast) so
        the bounded queue can always drain."""
        while True:
            d = self._retire_q.get()
            try:
                if d is _SHUTDOWN:
                    return
                if self._poisoned is not None:
                    for fut in d.futures:
                        fut._fail(SessionPoisonedError(
                            "dispatch abandoned: session poisoned"))
                else:
                    self._retire(d)
            except BaseException as e:      # noqa: BLE001 — must not be lost
                self._poison(e, owning=d.futures)
            finally:
                self._retire_q.task_done()

    def _drain(self):
        """Block until every launched dispatch has retired (both
        executors); errors surface on the futures / via poisoning."""
        if self._retire_thread is not None:
            self._retire_q.join()
        with self._submit_lock:
            while self._inflight:
                self._retire_guarded(self._inflight.popleft())

    def _retire_guarded(self, d: _Dispatch):
        """Sync-path retire: a raising retire poisons the session (its
        futures carry the exception) and re-raises to the caller."""
        try:
            self._retire(d)
        except BaseException as e:
            self._poison(e, owning=d.futures)
            raise

    # ---- retire / rescue (either thread) -------------------------------

    def _on_retire_stream(self, d: _Dispatch):
        """The streams retire works on: the session's side stream of each
        device, after the dispatch's event there (CUDA); nothing to switch
        on the CPU."""
        streams = contextlib.ExitStack()
        if d.ready is not None:
            with graphs.device_work():
                for stream, ready in zip(self._retire_streams, d.ready):
                    stream.wait_event(ready)
                    streams.enter_context(torch.cuda.stream(stream))
        return streams

    def _retire(self, d: _Dispatch):
        """Force one dispatch: download once, decode (core.cigar), run
        compacted bucket-rescue rounds if needed, fulfill futures."""
        t0 = self._clock()
        n = len(d.futures)
        with self.obs.span("retire.decode", n=n), self._on_retire_stream(d):
            keys = ("ops", "n_ops", "dist", "failed", "read_consumed",
                    "ref_consumed") + (("k_used",)
                                       if "k_used" in d.out else ())
            with graphs.device_work():
                host = transfer.to_host({k: d.out[k] for k in keys})
            failed, dist, k_used, rcon, fcon, all_ops = \
                decode_batch(host, n, self.cfg.k)
            if self.spec.rescue_mode == "bucket" and failed.any():
                self._rescue_compacted(d, failed, dist, k_used, rcon, fcon,
                                       all_ops)
            recs = records_from_state(failed, dist, k_used, rcon, fcon,
                                      all_ops)
            for fut, rec in zip(d.futures, recs):
                fut._fulfill(rec)
        self._m["retire_wall_s"].inc(self._clock() - t0)

    def _rescue_compacted(self, d, failed, dist, k_used, rcon, fcon,
                          all_ops):
        """Gather the still-failed lanes and compact them into the
        next-smaller length/lane bucket per k-doubling rung: solved lanes
        never recompute, shapes stay bucket-stable, and the rung
        executables live in the same CompileCache.  Equal per lane to the
        aligner's rescue.  Runs on whichever thread retires the
        dispatch."""
        todo = [i for i in range(len(d.futures)) if failed[i]]
        for cfg_r in rescue_schedule(self.cfg, self.spec.rescue_rounds)[1:]:
            if not todo:
                return
            reads = [d.reads[i] for i in todo]
            refs = [d.refs[i] for i in todo]
            rb = self.spec.read_bucket(max(len(r) for r in reads))
            fb = self.spec.ref_bucket(max(len(f) for f in refs))
            lanes = bucket_lanes(len(todo), cfg_r, self.mesh)
            with self.obs.span("rescue.rung", k=cfg_r.k, lanes=lanes,
                               n_todo=len(todo)):
                exe = self._executable(cfg_r, lanes, rb, fb,
                                       rescue_rounds=None)
                Lr, Lf = pad_geometry(cfg_r, rb, fb, 0)
                host = self._pad_batch(reads, refs, lanes, Lr, Lf)
                with graphs.device_work():
                    out, _ = exe(*transfer.to_device(
                        host, self.device,
                        pair_shards(lanes, cfg_r, self.mesh)))
                    host = transfer.to_host(
                        {k: out[k] for k in ("ops", "n_ops", "dist",
                                             "failed", "read_consumed",
                                             "ref_consumed")})
            self._m["rescue_dispatches"].inc()
            self._m["rescue_lanes"].inc(lanes)
            ok = ~np.asarray(host["failed"])
            for loc, glob in enumerate(todo):
                if ok[loc]:
                    nops = int(host["n_ops"][loc])
                    all_ops[glob] = np.asarray(
                        host["ops"])[loc, :nops].copy()
                    dist[glob] = int(host["dist"][loc])
                    k_used[glob] = cfg_r.k
                    rcon[glob] = int(host["read_consumed"][loc])
                    fcon[glob] = int(host["ref_consumed"][loc])
                    failed[glob] = False
            todo = [g for g in todo if failed[g]]

    # ---- poisoning / forcing -------------------------------------------

    def _poison(self, exc: BaseException, owning=()):
        """Unrecoverable error: remember the first cause, fail the owning
        dispatch's futures with the original exception and every other
        outstanding future with SessionPoisonedError — nothing is left to
        block forever, and further submits refuse."""
        with self._lock:
            if self._poisoned is None:
                self._poisoned = exc
        for fut in owning:
            fut._fail(exc)
        perr = SessionPoisonedError(
            f"session poisoned by {type(exc).__name__}: {exc}")
        perr.__cause__ = exc
        with self._lock:
            open_futs = list(self._open.values())
        for fut in open_futs:
            fut._fail(perr)
        self._queues.clear()
        self._staged.clear()
        self._inflight.clear()

    def _forget(self, rid: int) -> None:
        with self._lock:
            self._open.pop(rid, None)

    def _cancel(self, fut: AlignFuture) -> bool:
        """Cancel `fut` if still queued: remove its slot under the submit
        lock — atomic vs dispatch, so the slot either cancels or
        dispatches, never both — fail the future with RequestCancelled,
        and forget the rid.  True when cancelled (idempotent on repeats),
        False once dispatched or done."""
        with self._submit_lock:
            if fut.done():
                return fut._cancelled
            for bucket, q in list(self._queues.items()):
                for i, it in enumerate(q):
                    if it[0] is fut:
                        del q[i]
                        for v in self._staged[bucket][1]:
                            v[i:len(q)] = v[i + 1:len(q) + 1].copy()
                        if not q:
                            del self._queues[bucket]
                            del self._staged[bucket]
                        fut._cancelled = True
                        fut._fail(RequestCancelled(
                            f"request rid={fut.rid} cancelled before "
                            f"dispatch"))
                        self._forget(fut.rid)
                        self._m["cancelled"].inc()
                        return True
            return False                     # dispatched: lane committed

    def load(self) -> dict:
        """The occupancy/in-flight signal an admission layer reads:
        dispatches in flight (retire-queue depth under the threaded
        executor, the inline deque under sync), the current in-flight
        bound and queued-but-undispatched pairs."""
        if self._retire_q is not None:
            inflight = self._retire_q.qsize()
        else:
            inflight = len(self._inflight)
        with self._submit_lock:
            queued = sum(len(q) for q in self._queues.values())
        return {"inflight": inflight, "max_inflight": self._max_inflight,
                "queued_pairs": queued}

    def _force(self, fut: AlignFuture, timeout: float | None = None):
        """Resolve one future: dispatch its queue if still held, then
        retire until it is done — inline (sync) or by waiting on the
        background executor (threaded), with a liveness check so a dead
        retire thread can never hang the caller.  `timeout` bounds the
        threaded wait; on expiry the future is left unresolved for the
        caller to raise TimeoutError."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._submit_lock:
            for bucket, q in list(self._queues.items()):
                if any(it[0] is fut for it in q):
                    self._dispatch(bucket, self._queues.pop(bucket))
                    break
            while self._inflight and not fut.done():
                self._retire_guarded(self._inflight.popleft())
        if self._retire_thread is not None:
            while not fut._event.wait(0.05):
                if not self._retire_thread.is_alive():
                    fut._fail(SessionPoisonedError(
                        "retire thread died before this future resolved"))
                    return
                if deadline is not None and time.monotonic() >= deadline:
                    return

    def session_stats(self) -> dict:
        """Serving + compile-cache counters in one dict.  With
        adaptive_lanes, `occupancy` reports each bucket's negotiated lane
        class and recent fills; with adaptive_inflight, `inflight` the
        current bound."""
        out = self.stats                 # registry-backed property
        out["compile_cache"] = self.cache.stats()
        if self.spec.adaptive_lanes:
            out["occupancy"] = {
                str(b): {"lane_class": self._current_lanes(b),
                         "recent_fills": list(self._fills.get(b, ()))}
                for b in set(self._lane_class) | set(self._fills)}
        if self.spec.adaptive_inflight:
            out["inflight"] = {"max_inflight": self._max_inflight,
                               "ceiling": self.spec.inflight_ceiling,
                               "recent_saturated": list(self._inflight_win)}
        return out
