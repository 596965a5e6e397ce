"""A session's executables as captured CUDA graphs: the port's counterpart
of the reference's ``make_align_step(...).lower(*bucket_avals).compile()``.

Build = capture.  An executable of backend 'fused' on CUDA (``captures``)
captures its align step once, over static input tensors of its bucket's
shapes, into ``torch.cuda.CUDAGraph``s (:class:`GraphedStep`):

* bucket mode without a mesh: one graph, the whole step (every window of
  ``align_pairs``, the tail and the summary);
* bucket mode on a mesh: one graph a pair shard, on the shard's device
  (``core.windowing.shard_rung``); the level count across shards
  (``rung_levels``) and the summary stay eager after the replays, a fixed
  handful of launches;
* rescue_mode 'device': one capture a (rung, shard), the shard's pass
  merged into the ladder state (``ladder_merge``, in place: rung 0's
  outputs hold the state whichever rungs run), and one a rung of its
  totals (``levels_run_total``, ``rounds_run``, on the card).  Where every
  shard is on one device (no mesh, or a mesh of one device listed several
  times) the captures become one graph with conditional nodes
  (``kernels.ladder_graph.CondGraph``): rung 0, then a gate kernel a shard
  and an IF node holding rung 1, with rung 2's gates and IF node nested in
  that body, and so on, so the card decides which rungs run, as the
  reference's ``lax.cond(any(failed))`` does, and the dispatch does not
  wait (``gate_syncs`` 0).  A launch counts rung 0's kernel launches and
  the first gates'; the later rungs' and their gates' are counted when the
  dispatch retires, from its ``rounds_run`` (``count_rungs``).  Shards on
  several cards keep the host gate (``any_failed``, one sync a later rung,
  counted in ``gate_syncs``).

Dispatch = copy-in, replay (or the ladder graph's launch), clone-out.  The
caller uploads as before (one upload a dispatch); the executable copies
the batch into its static inputs, replays, and clones the outputs, so two
dispatches of one executable in flight (``max_inflight`` >= 2, or two
sessions sharing a compile cache) keep their own.  The three steps run under the
executable's lock on a stream of its own, which waits for the caller's
stream before and which the caller's stream waits for after: the call
returns while the card computes.  They run with the cyclic garbage
collector off: a collection inside would stall the dispatch by its pause
(0.5-1.3 ms for the young generations, 130-170 ms for the oldest, seen
beside a dispatch on the card), and the host time of a dispatch is what
its caller waits for.

Captures run one at a time in the process, on one capture stream a device,
in ``capture_error_mode="relaxed"``: under "thread_local" a device-wide
sync or a pinned allocation on another thread (a client's
``torch.cuda.synchronize()``, a retire thread's upload) is refused and
invalidates the capture (seen on the card: a gateway's sweeper thread
capturing while the main thread synchronised).  A sync on the capture
stream itself still fails, as in every mode, and so does a device-wide
``torch.cuda.synchronize()`` on any thread while a capture is underway:
while a session may build an executable (``warmup``, the first dispatch
of a shape, a rescue rung's first lane class), other threads synchronise
a stream or an event, not the device.  Nothing runs while capturing:
the kernel launches a capture issues are recorded
(``genasm_dc.recording_launches``), not counted, and every replay counts
them (``genasm_dc.add_launches``).  Each executable has one memory pool
(``torch.cuda.graph_pool_handle``), shared by its graphs, which replay one
after another under its lock in the order they were captured; no two
executables share a pool.  A session's own device work (its uploads,
calls of an executable, event records and downloads) runs inside
``device_work()``, which never overlaps a capture; cyclic garbage
collection is off while capturing.  A capture or replay that fails
raises: there is no eager fallback.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import threading
import time

import torch
from torch.utils import _pytree

from ..core.config import AlignerConfig
from ..core.windowing import (LANE_KEYS, any_failed, ladder_merge,
                              ladder_start, n_main_windows, rescue_schedule,
                              rung_levels, shard_rung, total_op_budget,
                              unshard)
from ..kernels import genasm_dc, ladder_graph
from .align_step import align_step, step_summary

_CAPTURE_STREAMS: dict = {}        # CUDA device -> its capture stream


class _CaptureGate:
    """Captures one at a time and alone: ``capture()`` waits until no
    other capture and no ``work()`` is underway, and holds back new
    ``work()`` from the moment it waits; ``work()`` (a session's
    uploads, executable calls, event records and downloads) runs beside
    other work, never beside a capture.  A thread in ``work()`` must not
    capture."""

    def __init__(self):
        self._cond = threading.Condition()
        self._workers = 0           # threads in work()
        self._captures = 0          # captures waiting or underway
        self._capturing = False

    @contextlib.contextmanager
    def work(self):
        with self._cond:
            while self._captures:
                self._cond.wait()
            self._workers += 1
        try:
            yield
        finally:
            with self._cond:
                self._workers -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def capture(self):
        with self._cond:
            self._captures += 1
            while self._workers or self._capturing:
                self._cond.wait()
            self._capturing = True
        try:
            yield
        finally:
            with self._cond:
                self._capturing = False
                self._captures -= 1
                self._cond.notify_all()


_GATE = _CaptureGate()


def device_work():
    """Context for a session's device work outside a capture (module
    docstring): it never overlaps a capture in this process."""
    return _GATE.work()


def captures(cfg: AlignerConfig, device) -> bool:
    """Whether an executable of `cfg` on `device` runs as captured graphs:
    backend 'fused' on CUDA.  'split' syncs once a walk step of its
    PyTorch traceback, 'plain' and every CPU executable run eagerly."""
    return cfg.backend == "fused" and torch.device(device).type == "cuda"


def _on_device(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _indexed(device) -> torch.device:
    """`device`, an index-less CUDA device pinned to the current one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@functools.cache
def _libcuda():
    return ctypes.CDLL("libcuda.so.1")


def _nodes(graph) -> int:
    """The nodes of a captured graph (``cuGraphGetNodes`` on its
    cudaGraph_t)."""
    n = ctypes.c_size_t(0)
    rc = _libcuda().cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                    None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


def pool_bytes(device: torch.device, pool) -> int:
    """Bytes the caching allocator holds in memory pool `pool` on
    `device`: the sum of its segments."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if seg["device"] == device.index
               and tuple(seg["segment_pool_id"]) == tuple(pool))


class CapturedGraph:
    """``fn()`` captured once into a CUDA graph on `device`, in memory
    pool `pool`: ``outputs`` are its static outputs, ``replay()`` reruns
    it on the current stream and counts the kernel launches it holds
    (``launches``).  ``stats``: its nodes (None off CUDA), capture and
    instantiate seconds, launches.  With ``instantiate=False`` the capture
    is only a part of a larger graph (``ladder_graph.CondGraph``) and is
    never replayed alone."""

    def __init__(self, fn, device: torch.device, pool,
                 instantiate: bool = True):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        with _GATE.capture(), _on_device(device), _no_cyclic_gc():
            stream = None
            if device.type == "cuda":
                if device not in _CAPTURE_STREAMS:
                    _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
                stream = _CAPTURE_STREAMS[device]
            t0 = time.perf_counter()
            with genasm_dc.recording_launches() as launches, \
                    torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                     capture_error_mode="relaxed"):
                self.outputs = fn()
            t1 = time.perf_counter()
            if instantiate:
                self.graph.instantiate()
            t2 = time.perf_counter()
            nodes = _nodes(self.graph) if device.type == "cuda" else None
        self.launches = launches
        self.stats = {"device": str(device), "nodes": nodes,
                      "capture_s": t1 - t0, "instantiate_s": t2 - t1,
                      "launches": dict(launches)}

    def replay(self) -> None:
        self.graph.replay()
        genasm_dc.add_launches(self.launches)


_GC_HOLDS = {"depth": 0, "enabled": False}    # blocks holding the GC off
_GC_LOCK = threading.Lock()


@contextlib.contextmanager
def _no_cyclic_gc():
    """No cyclic garbage collection in the block: while capturing, a
    collection frees whatever dead cycles hold (CUDA tensors, events,
    pinned buffers of finished dispatches) in the middle of the capture;
    in a dispatch it would stall the caller by its pause.  Blocks on
    several threads may overlap: the collector comes back on when the
    last ends, if it was on before the first began."""
    with _GC_LOCK:
        if _GC_HOLDS["depth"] == 0:
            _GC_HOLDS["enabled"] = gc.isenabled()
            gc.disable()
        _GC_HOLDS["depth"] += 1
    try:
        yield
    finally:
        with _GC_LOCK:
            _GC_HOLDS["depth"] -= 1
            if _GC_HOLDS["depth"] == 0 and _GC_HOLDS["enabled"]:
                gc.enable()


def _clone(tree):
    return _pytree.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


def gate_on_card(devices) -> bool:
    """Whether a device-mode ladder over the pair shards on `devices` runs
    as one graph whose gates run on the card: where every shard is on one
    device.  Shards on several cards keep the host gate."""
    return len(set(devices)) == 1


def _shard_rung_step(inputs, state, cfg_r: AlignerConfig, max_read_len: int,
                     final: bool | None, budget: int):
    """What a graph of one (rung, shard) captures: the shard's pass at
    `cfg_r` and its per-window levels; in the ladder (`final` not None)
    the pass merged into the shard's `state`: round 0 (`state` None) starts
    it, a later round writes the merge into `state` in place, so the
    ladder's state is always round 0's outputs."""
    out = shard_rung(*inputs, cfg_r, max_read_len)
    levels = out.pop("levels")
    if final is None:
        return out, levels
    if state is None:
        start = ladder_start(inputs[0].shape[0], inputs[0].device, budget)
        return ladder_merge(start, out, cfg_r, final, budget), levels
    for key, t in ladder_merge(state, out, cfg_r, final, budget).items():
        state[key].copy_(t)
    return state, levels


def _rung_totals(levels: list, totals: dict | None) -> dict:
    """What a graph of one rung's totals captures: the rung's level count
    over its shards (``rung_levels``) and one round, on the card; round 0
    (`totals` None) starts them, a later round adds in place."""
    lv = rung_levels(levels)
    if totals is None:
        return {"levels_run_total": lv,
                "rounds_run": torch.ones((), dtype=torch.int32,
                                         device=lv.device)}
    totals["levels_run_total"].add_(lv)
    totals["rounds_run"].add_(1)
    return totals


class GraphedStep:
    """One executable's align step (``serve.align_step``) as captured
    graphs (module docstring).  Called like the step, with (reads,
    read_len, refs, ref_len) of the bucket's ``avals`` on `devices` (a
    mesh: tuples of one tensor a shard), it returns (out, summary) equal
    to the eager step's, every tensor its own copy (in device mode on one
    device: ``rounds_run`` a 0-d tensor, ``gate_syncs`` 0).  ``stats``
    describe each capture; ``argument_bytes`` are the static inputs'
    bytes, ``pool_bytes`` the memory pool's after every capture (None off
    CUDA), ``compile_s`` the capture and instantiate seconds of all
    graphs; ``ladder`` the device-mode ladder's graph
    (``ladder_graph.CondGraph``, else None)."""

    def __init__(self, cfg: AlignerConfig, max_read_len: int,
                 rescue_rounds: int | None, avals, devices, mesh=None):
        self.cfg, self.mesh = cfg, mesh
        self.max_read_len, self.rescue_rounds = max_read_len, rescue_rounds
        self.devices = tuple(_indexed(d) for d in devices)
        cuda = self.devices[0].type == "cuda"
        self._lock = threading.Lock()
        self._streams = ({d: torch.cuda.Stream(d)
                          for d in dict.fromkeys(self.devices)}
                         if cuda else {})
        self.inputs = [tuple(torch.empty(shape, dtype=dtype, device=d)
                             for shape, dtype in avals)
                       for d in self.devices]
        pool = torch.cuda.graph_pool_handle()
        self.ladder, self.totals = None, []
        if rescue_rounds is None and mesh is None:
            step = functools.partial(align_step, *self.inputs[0], cfg=cfg,
                                     max_read_len=max_read_len)
            self.rungs = [[CapturedGraph(step, self.devices[0], pool)]]
        else:
            in_graph = rescue_rounds is not None and gate_on_card(
                self.devices)
            cfgs = rescue_schedule(cfg, rescue_rounds or 0)
            budget = total_op_budget(max_read_len, cfgs[-1])
            state = [None] * len(self.devices)
            totals = None
            self.rungs = []
            for rnd, cfg_r in enumerate(cfgs):
                final = None if rescue_rounds is None else \
                    rnd == len(cfgs) - 1
                row = []
                for s, dev in enumerate(self.devices):
                    row.append(CapturedGraph(functools.partial(
                        _shard_rung_step, self.inputs[s], state[s], cfg_r,
                        max_read_len, final, budget), dev, pool,
                        instantiate=not in_graph))
                    state[s] = row[-1].outputs[0]
                self.rungs.append(row)
                if in_graph:
                    self.totals.append(CapturedGraph(functools.partial(
                        _rung_totals, [g.outputs[1] for g in row], totals),
                        self.devices[0], pool, instantiate=False))
                    totals = self.totals[-1].outputs
            self.states = state
            if in_graph:
                t0 = time.perf_counter()
                self.ladder = self._ladder_graph()
                self.ladder_stats = {"nodes": self.ladder.nodes,
                                     "gates": self.ladder.gates,
                                     "instantiate_s":
                                         time.perf_counter() - t0}
        self.stats = [{"rung": r, "shard": s, **g.stats}
                      for r, row in enumerate(self.rungs)
                      for s, g in enumerate(row)] + [
            {"rung": r, "shard": "totals", **g.stats}
            for r, g in enumerate(self.totals)]
        self.argument_bytes = sum(t.nbytes for ins in self.inputs
                                  for t in ins)
        self.pool_bytes = None
        if cuda:
            with _GATE.capture():
                self.pool_bytes = sum(pool_bytes(d, pool)
                                      for d in self._streams)
        self.compile_s = sum(g["capture_s"] + g["instantiate_s"]
                             for g in self.stats)
        if self.ladder is not None:
            self.compile_s += self.ladder_stats["instantiate_s"]

    def _ladder_graph(self):
        """The ladder as one graph: rung 0's captures and totals, then a
        gate a shard (on the shards' ``failed``, rung 0's outputs, which
        every rung updates in place) and an IF node holding rung 1's
        captures and totals and, nested in it, rung 2's gates and IF node,
        and so on: a rung runs only where the one before ran and left a
        lane failed."""
        dev = self.devices[0]
        self.gate_flags = torch.zeros((len(self.rungs) - 1,
                                       len(self.devices)),
                                      dtype=torch.int32, device=dev)
        graph = ladder_graph.CondGraph(dev)
        failed = [st["failed"] for st in self.states]
        chain = graph
        for rnd, (row, tot) in enumerate(zip(self.rungs, self.totals)):
            if rnd:
                chain = chain.branch(failed, self.gate_flags[rnd - 1])
            for g in (*row, tot):
                chain.child(g.graph)
        with _GATE.capture(), _on_device(dev):
            graph.instantiate()
        return graph

    @contextlib.contextmanager
    def _own_streams(self):
        """Run on this executable's streams, after the caller's streams'
        work so far; the caller's streams then wait for it."""
        callers = {d: torch.cuda.current_stream(d) for d in self._streams}
        with contextlib.ExitStack() as stack:
            for d, stream in self._streams.items():
                stream.wait_stream(callers[d])
                stack.enter_context(torch.cuda.stream(stream))
            try:
                yield
            finally:
                for d, stream in self._streams.items():
                    callers[d].wait_stream(stream)

    def __call__(self, *args):
        shards = [args] if self.mesh is None else list(zip(*args))
        with self._lock, self._own_streams(), _no_cyclic_gc():
            for static, shard in zip(self.inputs, shards):
                for t, a in zip(static, shard):
                    t.copy_(a)
            if self.rescue_rounds is None and self.mesh is None:
                graph = self.rungs[0][0]
                graph.replay()
                return _clone(graph.outputs)
            if self.ladder is not None:
                return self._ladder_launch()
            return self._ladder()

    def _ladder_launch(self):
        """One launch of the ladder graph, no host sync: the state and
        totals cloned out, ``rounds_run`` a 0-d tensor."""
        self.ladder.launch()
        for g in self.rungs[0]:
            genasm_dc.add_launches(g.launches)
        states = [_clone(st) for st in self.states]
        out = {**unshard(states, self.mesh, LANE_KEYS + ("k_used",)),
               **_clone(self.totals[0].outputs),
               "n_rounds": len(self.rungs), "gate_syncs": 0}
        return out, step_summary(out, self.cfg, self.rescue_rounds,
                                 self.mesh)

    def count_rungs(self, rounds_run: int) -> None:
        """Count the kernel launches of the rungs after rung 0 that one
        launch of the ladder graph ran, and of the gates nested in their
        bodies, from that dispatch's ``rounds_run`` (read when it retires);
        a no-op where the host gated the rungs (each replay counted
        itself)."""
        if self.ladder is not None:
            for row in self.rungs[1:rounds_run]:
                for g in row:
                    genasm_dc.add_launches(g.launches)
            nested = min(rounds_run, len(self.rungs) - 1) - 1
            ladder_graph.add_launches(max(nested, 0) * len(self.devices))

    def _ladder(self):
        """Replay rung by rung, the host gate between rungs in the ladder,
        the cross-shard level count and the summary eager."""
        ladder = self.rescue_rounds is not None
        levels = torch.zeros((), dtype=torch.int32, device=self.devices[0])
        rounds_run = gate_syncs = 0
        for rnd, row in enumerate(self.rungs):
            if rnd > 0:
                gate_syncs += 1
                if not any_failed([st["failed"] for st in self.states]):
                    break
            for graph in row:
                graph.replay()
            levels = levels + rung_levels([g.outputs[1] for g in row])
            rounds_run += 1
        states = [_clone(st) for st in self.states]
        if ladder:
            out = {**unshard(states, self.mesh, LANE_KEYS + ("k_used",)),
                   "levels_run_total": levels, "rounds_run": rounds_run,
                   "n_rounds": len(self.rungs), "gate_syncs": gate_syncs}
        else:
            out = {**unshard(states, self.mesh, LANE_KEYS),
                   "levels_run_total": levels,
                   "n_main_windows": n_main_windows(self.max_read_len,
                                                    self.cfg)}
        return out, step_summary(out, self.cfg, self.rescue_rounds,
                                 self.mesh)
