"""The session's executables as captured CUDA graphs (``serve.graphs``),
on the CPU through a stand-in for ``torch.cuda.CUDAGraph``.

The stand-in, patched in by these tests only (``graphed`` fixture),
records the step while it is captured and replays the recording on the
same tensors: every ATen op of the glue is one node (a
``TorchDispatchMode`` records it; an op that syncs the host raises, as a
capture on the card would), and every kernel is one opaque node (its
plain twin run as a whole, as the card runs a kernel: the twins' own
syncs are their business).  A replay reruns the nodes in order: an op
that returns a new tensor writes its result into the recorded output,
an in-place op mutates its recorded operand, a view needs nothing.  So
a replay computes on the static buffers exactly what the captured graph
computes, and nothing the capture did on the host is run again.

Checked here:

* (a) the wrapper: a capture counts no launch and records what the
  card would launch (K1 once a main window, the tail once); a replay
  counts what was recorded; the batch is copied into the static inputs
  and the outputs cloned out; one executable's copy-in, replay and
  clone-out hold its lock (two threads never interleave them);
* (b) two dispatches of one executable in flight keep their own
  outputs; records equal the reference's ``AlignSession`` in bucket and
  device mode; a mesh's per-shard graphs equal ``mesh=None``;
* (c) the fused step issues no host sync inside a rung:
  ``Tensor.item``, ``__bool__``, ``tolist`` and ``cpu`` raise during the
  window loop; the plain twins of the kernels, which sync once a walk
  step on the CPU, are let through (on the card each is one kernel);
* what stays eager: split, plain and the CPU without the stand-in.
"""
import dataclasses
import gc
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp
from repro.api import AlignSession as RefAlignSession
from repro.api import AlignSpec as RefAlignSpec
from repro.core import windowing as ref_win
from repro_torch.api import AlignSession, CompileCache, plan
from repro_torch.api.session import build_executable
from repro_torch.convert import spec_from_reference
from repro_torch.core import transfer, windowing
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc, ladder_graph
from repro_torch.serve import graphs
from repro_torch.serve.align_step import make_align_step
from tests.test_differential import CFG as DCFG, ROUNDS
from tests.test_torch_aligner import assert_results_equal
from tests.test_torch_config import cfg_pair
from tests.test_torch_mesh import CPU, cpu_mesh

CFG = AlignerConfig(W=16, O=6, k=4, lane_tile=4)
_ATEN = torch.ops.aten
_SYNCS = (_ATEN._local_scalar_dense.default, _ATEN.is_nonzero.default,
          _ATEN.item.default)
_ACTIVE = threading.local()          # the recorder capturing on a thread
_KERNELS = {"tb_fused": "tb_fused_plain", "tail_banded": "tail_banded_plain",
            "tail_full": "tail_full_plain"}


class _Recorder(TorchDispatchMode):
    """Records every ATen op as a node; a host sync raises."""

    def __init__(self):
        super().__init__()
        self.nodes = []
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.paused:
            return func(*args, **kwargs)
        if func in _SYNCS:
            raise RuntimeError(f"host sync {func} while capturing")
        out = func(*args, **kwargs)
        self.nodes.append(("op", func, args, kwargs, out))
        return out


def _aliases(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)


def _write(recorded, new):
    for old, fresh in zip(_pytree.tree_leaves(recorded),
                          _pytree.tree_leaves(new)):
        if isinstance(old, torch.Tensor):
            old.copy_(fresh)


class FakeGraph:
    """The stand-in for ``torch.cuda.CUDAGraph``."""

    def __init__(self, keep_graph=False):
        self.nodes = None
        self.instantiated = False
        self.replays = 0

    def instantiate(self):
        assert self.nodes is not None
        self.instantiated = True

    def replay(self):
        assert self.instantiated
        self.replays += 1
        self.run()

    def run(self):
        """The recording once (a replay, or a child node of a larger
        graph)."""
        for kind, fn, args, kwargs, out in self.nodes:
            new = fn(*args, **kwargs)
            if kind == "kernel" or not _aliases(fn):
                _write(out, new)


class _FakeChain:
    """A stand-in graph's nodes in order: children, gates, IF nodes (a
    body is a chain of its own, which may branch again)."""

    def __init__(self, root=None):
        self.nodes = []
        self.root = root or self
        self.gates = 0

    def child(self, graph):
        assert graph.nodes is not None and not graph.instantiated
        self.nodes.append(("child", graph))

    def branch(self, failed, flags):
        handle, body = self.root.handles, _FakeChain(self.root)
        self.root.handles += 1
        for f, out in zip(failed, flags):
            self.nodes.append(("gate", f, out, handle))
            self.gates += 1
        self.nodes.append(("if", handle, body))
        return body

    def run(self, flags):
        for kind, *node in self.nodes:
            if kind == "child":
                node[0].run()
            elif kind == "gate":        # the gate's plain twin on a shard
                failed, out, handle = node
                out.copy_(ladder_graph.ladder_gate_plain(failed)[0])
                if int(out.numpy()):    # the card's own read, no host sync
                    flags[handle] = 1
            else:                       # an IF node evaluates its flag
                handle, body = node
                if flags[handle]:
                    body.run(flags)


class FakeCondGraph(_FakeChain):
    """The stand-in for ``ladder_graph.CondGraph``: a branch's gates run
    the gate's plain twin when they are reached and raise the flag of
    their IF node, which evaluates the flag; every flag starts at 0 at
    each launch, as the card's conditional handles do.  A launch counts
    the top chain's gates, as the real one does."""

    def __init__(self, device):
        super().__init__()
        self.handles = self.launches = 0
        self.instantiated = False

    def instantiate(self):
        self.instantiated = True

    def launch(self):
        assert self.instantiated
        self.launches += 1
        self.run([0] * self.handles)
        ladder_graph.add_launches(self.gates)


class _fake_graph:
    """The stand-in for the ``torch.cuda.graph`` context manager."""

    def __init__(self, graph, pool=None, stream=None,
                 capture_error_mode="global"):
        assert capture_error_mode == "relaxed"
        assert pool is not None
        self.graph, self.recorder = graph, _Recorder()

    def __enter__(self):
        _ACTIVE.recorder = self.recorder
        self.recorder.__enter__()

    def __exit__(self, *exc):
        self.recorder.__exit__(*exc)
        _ACTIVE.recorder = None
        self.graph.nodes = self.recorder.nodes


def _kernel_node(name, plain):
    """A kernel's plain twin as one opaque node while capturing: it runs
    whole (its syncs included), counts a launch as the card's wrapper
    would (recorded, since a capture is underway), and is recorded."""
    def run(*args, **kwargs):
        rec = getattr(_ACTIVE, "recorder", None)
        if rec is None:
            return plain(*args, **kwargs)
        rec.paused = True
        try:
            out = plain(*args, **kwargs)
        finally:
            rec.paused = False
        genasm_dc._count_launch(name)
        rec.nodes.append(("kernel", replay, args, kwargs, out))
        return out

    def replay(*args, **kwargs):
        """The twin as the module holds it at replay (the ``no_sync``
        fixture lets its syncs through: one kernel on the card)."""
        return getattr(genasm_dc, _KERNELS[name])(*args, **kwargs)
    return run


@pytest.fixture
def graphed(monkeypatch):
    """Executables of backend 'fused' on the CPU run as stand-in graphs."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 1))
    monkeypatch.setattr(graphs, "captures",
                        lambda cfg, device: cfg.backend == "fused")
    monkeypatch.setattr(ladder_graph, "CondGraph", FakeCondGraph)
    for name, attr in _KERNELS.items():
        monkeypatch.setattr(genasm_dc, attr,
                            _kernel_node(name, getattr(genasm_dc, attr)))


def _batch(seed, lanes, read_bucket, ref_bucket, cfg=CFG, rounds=0):
    """A padded bucket batch of exact and near copies, as torch tensors."""
    rng = np.random.default_rng(seed)
    Lr, Lf = windowing.pad_geometry(cfg, read_bucket, ref_bucket, rounds)
    reads = np.full((lanes, Lr), windowing.SENTINEL_READ, np.uint8)
    refs = np.full((lanes, Lf), windowing.SENTINEL_REF, np.uint8)
    rl = rng.integers(read_bucket // 2, read_bucket + 1, lanes)
    for i, n in enumerate(rl):
        r = rng.integers(0, 4, n).astype(np.uint8)
        f = r.copy()
        f[rng.integers(0, n, 2)] = rng.integers(0, 4, 2)
        reads[i, :n], refs[i, :n] = r, f
    return tuple(map(torch.from_numpy,
                     (reads, rl.astype(np.int32), refs, rl.astype(np.int32))))


def _assert_tree_equal(got, want):
    """Captured (out, summary) against the eager step's, field for field;
    a device-mode ladder graph gates on the card: its ``gate_syncs`` is 0
    where the eager step counts its host syncs."""
    got_out, got_sum = got
    want_out, want_sum = want
    assert set(got_out) == set(want_out) and set(got_sum) == set(want_sum)
    if "gate_syncs" in want_out:
        assert got_out["gate_syncs"] == 0
    for key in set(want_out) - {"gate_syncs"}:
        a, b = (torch.cat(v) if isinstance(v, tuple) else v
                for v in (got_out[key], want_out[key]))
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b), key
        else:
            assert a == b, key
    for key in want_sum:
        assert int(got_sum[key]) == int(want_sum[key]), key


# --------------------------------------------------------------------------
# (a) the wrapper
# --------------------------------------------------------------------------

def test_capture_counts_nothing_and_each_replay_what_it_recorded(graphed):
    genasm_dc.reset_counts()
    exe = build_executable(CFG, 4, 64, 64, None, "cpu")
    assert isinstance(exe.graphs, graphs.GraphedStep)
    assert set(genasm_dc.LAUNCHES.values()) == {0}
    nm = windowing.n_main_windows(64, CFG)
    tail = "tail_banded" if CFG.tail_banded else "tail_full"
    want = {**dict.fromkeys(genasm_dc.KERNELS, 0), "tb_fused": nm, tail: 1}
    [stats] = exe.graphs.stats
    assert stats["launches"] == want and stats["nodes"] is None
    assert (stats["rung"], stats["shard"]) == (0, 0)
    assert exe.graphs.argument_bytes == sum(
        int(np.prod(shape)) * (1 if dtype == torch.uint8 else 4)
        for shape, dtype in exe.avals)
    for n in (1, 2):
        exe(*_batch(n, 4, 64, 64))
        assert genasm_dc.LAUNCHES == {k: n * v for k, v in want.items()}
    assert exe.graphs.rungs[0][0].graph.replays == 2


def test_copy_in_and_clone_out(graphed):
    exe = build_executable(CFG, 4, 64, 64, None, "cpu")
    a, b = _batch(1, 4, 64, 64), _batch(2, 4, 64, 64)
    got_a = exe(*a)
    for static, t in zip(exe.graphs.inputs[0], a):
        assert torch.equal(static, t) and static.data_ptr() != t.data_ptr()
    statics = {t.data_ptr() for t in _pytree.tree_leaves(
        exe.graphs.rungs[0][0].outputs) if isinstance(t, torch.Tensor)}
    assert not statics & {t.data_ptr() for t in _pytree.tree_leaves(got_a)
                          if isinstance(t, torch.Tensor)}
    got_b = exe(*b)
    _assert_tree_equal(got_a, exe.step(*a))      # a second replay left
    _assert_tree_equal(got_b, exe.step(*b))      # the first's outputs
    assert not torch.equal(got_a[0]["ops"], got_b[0]["ops"])


def test_one_executable_serialises_copy_in_replay_and_clone_out(
        graphed, monkeypatch):
    """Two threads call one executable; a replay that sleeps would let
    the other thread's copy-in overwrite its static inputs if the lock did
    not hold copy-in, replay and clone-out together."""
    exe = build_executable(CFG, 4, 64, 64, None, "cpu")
    batches = [_batch(10 + i, 4, 64, 64) for i in range(2)]
    want = [exe.step(*b) for b in batches]
    replay = FakeGraph.replay
    inside, seen = [0], []

    def slow_replay(self):
        inside[0] += 1
        seen.append(inside[0])
        time.sleep(0.05)
        replay(self)
        inside[0] -= 1
    monkeypatch.setattr(FakeGraph, "replay", slow_replay)
    got, errors = [None, None], []

    def run(i):
        try:
            for _ in range(3):
                got[i] = exe(*batches[i])
                _assert_tree_equal(got[i], want[i])
        except BaseException as e:          # reported below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and seen == [1] * 6


def test_a_capture_runs_alone(graphed):
    """A capture waits for a session's device work underway, holds back
    new device work until it ends, and runs with the cyclic GC off."""
    order, release = [], threading.Event()

    def work(tag, wait=None):
        with graphs.device_work():
            order.append(f"{tag} in")
            if wait is not None:
                wait.wait(5)
            order.append(f"{tag} out")

    def fn():
        order.append(f"capture gc={gc.isenabled()}")
        late = threading.Thread(target=work, args=("late",))
        late.start()
        time.sleep(0.05)                 # the late work must not start
        order.append("capture out")
        fn.late = late
        return {"x": torch.zeros(2)}

    early = threading.Thread(target=work, args=("early", release))
    early.start()
    while not order:
        time.sleep(0.001)
    cap = threading.Thread(target=graphs.CapturedGraph, args=(fn, CPU,
                                                             (0, 1)))
    cap.start()
    time.sleep(0.05)
    assert order == ["early in"]         # the capture waits
    release.set()
    cap.join()
    fn.late.join()
    early.join()
    assert order == ["early in", "early out", "capture gc=False",
                     "capture out", "late in", "late out"]
    assert gc.isenabled()


def test_capture_raises_on_a_host_sync(graphed):
    """The stand-in refuses a sync inside a capture, as the card does; the
    executable's build raises, no eager fallback."""
    def syncing(inputs):
        return {"x": inputs + int(inputs.sum())}
    with pytest.raises(RuntimeError, match="host sync"):
        graphs.CapturedGraph(lambda: syncing(torch.zeros(3)), CPU, (0, 1))


# --------------------------------------------------------------------------
# (b) dispatches in flight, the reference, the mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rescue_mode", ["bucket", "device"])
def test_graphed_session_records_equal_reference_session(graphed, corpus,
                                                         rescue_mode):
    reads, refs, _ = corpus
    ref_spec = RefAlignSpec(cfg=dataclasses.replace(
        DCFG, backend="pallas_fused"), rescue_rounds=ROUNDS,
        rescue_mode=rescue_mode, batch_lanes=32, max_inflight=2)
    spec = spec_from_reference(dataclasses.asdict(ref_spec))
    ref = RefAlignSession(ref_spec, cache="private").align(reads, refs)
    genasm_dc.reset_counts()
    transfer.reset()
    s = AlignSession(spec, cache="private", device="cpu")
    got = s.align(reads, refs)
    assert_results_equal(got, ref)
    assert got.failed.any() and (got.k_used > DCFG.k).any()
    exes = list(s.cache.store._exe.values())
    assert exes and all(e.graphs is not None for e in exes)
    rungs = {len(e.graphs.rungs) for e in exes}
    assert rungs == ({ROUNDS + 1} if rescue_mode == "device" else {1})
    n = s.stats["dispatches"] + s.stats["rescue_dispatches"]
    moved = transfer.stats()
    assert (moved.h2d_calls, moved.d2h_calls) == (n, n)
    assert genasm_dc.LAUNCHES["tb_fused"] > 0


def test_two_dispatches_in_flight_keep_their_outputs(graphed, corpus):
    """max_inflight=2 on one bucket, and a second session sharing the
    compile cache: each dispatch's outputs survive the next replay of the
    same executable until it retires."""
    reads, refs, _ = corpus
    want = GenASMAligner(CFG, rescue_rounds=ROUNDS, device="cpu").align(
        reads, refs)
    store = CompileCache()
    s1, s2 = (plan(CFG, rescue_rounds=ROUNDS, batch_lanes=4,
                   max_inflight=2, cache=store, device="cpu")
              for _ in range(2))
    futs = []
    for i, (r, f) in enumerate(zip(reads, refs)):
        futs.append((s1 if i % 8 < 4 else s2).submit(r, f))
    assert len(s1._inflight) == 2 and len(s2._inflight) == 2
    for s in (s1, s2):
        s.flush()
    recs = [f.result() for f in futs]
    assert [r["cigar"] for r in recs] == want.cigars
    assert [r["dist"] for r in recs] == want.dist.tolist()
    assert s2.cache.shared_hits > 0


@pytest.mark.parametrize("rescue_rounds", [None, ROUNDS])
def test_graphed_mesh_equals_unsharded(graphed, rescue_rounds):
    """One graph a pair shard (a rung and a shard in the ladder), the
    levels across shards and the summary eager: equal to the eager step
    with mesh=None, levels_run_total and the summary included."""
    mesh = cpu_mesh((2,), ("data",))
    lanes, cfgs = 8, windowing.rescue_schedule(CFG, rescue_rounds or 0)
    exe = build_executable(CFG, lanes, 64, 64, rescue_rounds, "cpu", mesh)
    assert [len(row) for row in exe.graphs.rungs] == [2] * len(cfgs)
    batch = _batch(5, lanes, 64, 64, rounds=rescue_rounds or 0)
    sharded = [tuple(t[i * 4:(i + 1) * 4] for i in range(2)) for t in batch]
    got = exe(*sharded)
    want = make_align_step(CFG, 64, rescue_rounds=rescue_rounds,
                           device="cpu")(*batch)
    _assert_tree_equal(got, want)


# --------------------------------------------------------------------------
# (c) no host sync inside a rung
# --------------------------------------------------------------------------

def _refuse(name):
    def refused(*args, **kwargs):
        raise AssertionError(f"host sync Tensor.{name} inside a rung")
    return refused


@pytest.fixture
def no_sync(monkeypatch):
    """Tensor.item / __bool__ / tolist / cpu raise, except inside the
    kernels' plain twins (one kernel each on the card)."""
    names = ("item", "__bool__", "tolist", "cpu")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    for n in names:
        monkeypatch.setattr(torch.Tensor, n, _refuse(n))

    def allowed(plain):
        def run(*args, **kwargs):
            for n in names:
                setattr(torch.Tensor, n, saved[n])
            try:
                return plain(*args, **kwargs)
            finally:
                for n in names:
                    setattr(torch.Tensor, n, _refuse(n))
        return run
    for attr in _KERNELS.values():
        monkeypatch.setattr(genasm_dc, attr, allowed(getattr(genasm_dc,
                                                             attr)))


def test_fused_bucket_step_issues_no_host_sync(no_sync):
    batch = _batch(3, 4, 64, 64)
    out, summary = make_align_step(CFG, 64, device="cpu")(*batch)
    assert out["ops"].shape[0] == 4 and summary["n_failed"].dim() == 0


def test_each_ladder_rung_issues_no_host_sync(no_sync):
    """What one device-mode graph holds: a rung's pass and its merge."""
    batch = _batch(4, 4, 64, 64, rounds=2)
    cfgs = windowing.rescue_schedule(CFG, 2)
    budget = windowing.total_op_budget(64, cfgs[-1])
    state = None
    for rnd, cfg_r in enumerate(cfgs):
        state, levels = graphs._shard_rung_step(
            batch, state, cfg_r, 64, rnd == len(cfgs) - 1, budget)
        assert levels.shape == (windowing.n_main_windows(64, cfg_r),)
    assert state["ops"].shape == (4, budget)


# --------------------------------------------------------------------------
# what stays eager
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["fused", "split", "plain"])
def test_what_stays_eager(backend):
    """Without the stand-in: every CPU executable, and split and plain
    anywhere, run eagerly."""
    cfg = CFG.replace(backend=backend)
    assert build_executable(cfg, 4, 64, 64, None, "cpu").graphs is None
    assert graphs.captures(cfg, "cuda") == (backend == "fused")
    assert not graphs.captures(cfg, "cpu")


# --------------------------------------------------------------------------
# the upload of a dispatch: rows staged as pairs are submitted
# --------------------------------------------------------------------------

def test_staged_rows_equal_one_padding_and_survive_cancel(monkeypatch):
    """Each submit writes its pair's padded row; a cancel closes the gap;
    the dispatch uploads exactly what padding the remaining pairs at once
    gives (pad lanes repeat the last real pair), and the records equal
    GenASMAligner's."""
    rng = np.random.default_rng(21)
    reads = [rng.integers(0, 4, int(n)).astype(np.uint8)
             for n in rng.integers(40, 60, 6)]
    refs = [r.copy() for r in reads]
    s = plan(CFG, rescue_rounds=0, batch_lanes=8, cache="private",
             device="cpu")
    futs = [s.submit(r, f) for r, f in zip(reads, refs)]
    assert futs[2].cancel()
    keep = [i for i in range(6) if i != 2]
    uploaded = []
    to_device = transfer.to_device

    def spy(arrays, *a, **kw):
        uploaded.append([np.array(x) for x in arrays])
        return to_device(arrays, *a, **kw)
    monkeypatch.setattr(transfer, "to_device", spy)
    s.flush()
    Lr, Lf = windowing.pad_geometry(CFG, 64, 64)
    want = s._pad_batch([reads[i] for i in keep], [refs[i] for i in keep],
                        8, Lr, Lf)
    [got] = uploaded
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    res = GenASMAligner(CFG, rescue_rounds=0, device="cpu").align(
        [reads[i] for i in keep], [refs[i] for i in keep])
    assert [futs[i].result()["cigar"] for i in keep] == res.cigars


# --------------------------------------------------------------------------
# (d) device mode: one graph with conditional nodes a dispatch
# --------------------------------------------------------------------------

#: insertion burst of lane 1 -> rungs the ladder (k = 4, 8, 15) runs; 9
#: leaves the lane failed, its partial progress merged by the last rung
BURSTS = {0: 1, 3: 2, 6: 3, 9: 3}


def _ladder_batch(burst, lanes=4, bucket=64, seed=0):
    """Exact pairs of 48 bases, lane 1's read with `burst` random bases
    inserted mid-way, padded for the ladder's last rung."""
    rng = np.random.default_rng(seed)
    Lr, Lf = windowing.pad_geometry(CFG, bucket, bucket, 2)
    reads = np.full((lanes, Lr), windowing.SENTINEL_READ, np.uint8)
    refs = np.full((lanes, Lf), windowing.SENTINEL_REF, np.uint8)
    rl, fl = np.zeros(lanes, np.int32), np.zeros(lanes, np.int32)
    for i in range(lanes):
        f = rng.integers(0, 4, 48).astype(np.uint8)
        r = f if i != 1 else np.concatenate(
            [f[:24], rng.integers(0, 4, burst).astype(np.uint8), f[24:]])
        reads[i, :len(r)], refs[i, :len(f)] = r, f
        rl[i], fl[i] = len(r), len(f)
    return tuple(map(torch.from_numpy, (reads, rl, refs, fl)))


@pytest.mark.parametrize("burst", sorted(BURSTS))
def test_device_mode_is_one_launch_without_a_host_sync(graphed, no_sync,
                                                       burst):
    """A device-mode dispatch launches its ladder graph once, whatever
    rungs run: the gates decide on the card (the stand-in's IF nodes, rung
    2's nested in rung 1's body), the call makes no host sync and reports
    no gate sync, and rounds_run comes back as a tensor.  The launch counts
    the top gate; the retire the nested one where rung 1 ran."""
    exe = build_executable(CFG, 4, 64, 64, 2, "cpu")
    ladder = exe.graphs.ladder
    assert isinstance(ladder, FakeCondGraph) and ladder.gates == 1
    [(_, _, body)] = [n for n in ladder.nodes if n[0] == "if"]
    assert body.gates == 1 and [n[0] for n in body.nodes][-1] == "if"
    ladder_graph.reset_counts()
    out, summary = exe(*_ladder_batch(burst))
    rounds = int(out["rounds_run"].numpy())
    assert ladder.launches == 1
    assert out["gate_syncs"] == 0 and out["n_rounds"] == 3
    assert rounds == BURSTS[burst] == int(summary["rounds_run"].numpy())
    assert ladder_graph.LAUNCHES["ladder_gate"] == 1
    exe.retired(rounds)
    assert ladder_graph.LAUNCHES["ladder_gate"] == min(rounds, 2)
    assert list(exe.graphs.gate_flags[:, 0].numpy()) == \
        [int(rounds > 1), int(rounds > 2)]


@pytest.mark.parametrize("burst", sorted(BURSTS))
def test_device_mode_equals_its_eager_step_and_counts_at_retire(graphed,
                                                                burst):
    """Every output equals the eager ladder's (which gates on the host);
    a launch counts rung 0's kernels, and the retire the rungs that ran
    after it, so LAUNCHES then equal the kernels the eager step calls (on
    the CPU its plain twins, PLAIN_CALLS)."""
    exe = build_executable(CFG, 4, 64, 64, 2, "cpu")
    batch = _ladder_batch(burst)
    genasm_dc.reset_counts()
    got = exe(*batch)
    rung0 = dict(genasm_dc.LAUNCHES)
    exe.retired(int(got[0]["rounds_run"]))
    launched = dict(genasm_dc.LAUNCHES)
    genasm_dc.reset_counts()
    want = exe.step(*batch)
    assert want[0]["gate_syncs"] == min(BURSTS[burst], 2)
    _assert_tree_equal(got, want)
    assert launched == genasm_dc.PLAIN_CALLS
    assert rung0 == exe.graphs.stats[0]["launches"]
    assert (launched == rung0) == (BURSTS[burst] == 1)


def test_device_mode_levels_and_rounds_equal_the_reference(graphed, corpus):
    """On the differential corpus at a bucket's shapes: the ladder graph's
    lanes, k_used, levels_run_total and rounds_run equal the reference's
    align_pairs_rescued (Pallas, interpret mode) on the same arrays."""
    reads, refs, _ = corpus
    ref_cfg, cfg = cfg_pair(W=DCFG.W, O=DCFG.O, k=DCFG.k)
    lanes, bucket = len(reads), 64
    Lr, Lf = windowing.pad_geometry(cfg, bucket, bucket, ROUNDS)
    arrays = (*GenASMAligner._pad(reads, Lr, windowing.SENTINEL_READ),
              *GenASMAligner._pad(refs, Lf, windowing.SENTINEL_REF))
    exe = build_executable(cfg, lanes, bucket, bucket, ROUNDS, "cpu")
    out, _ = exe(*map(torch.from_numpy, arrays))
    want = ref_win.align_pairs_rescued(*map(jnp.asarray, arrays), cfg=ref_cfg,
                                       max_read_len=bucket,
                                       rescue_rounds=ROUNDS)
    assert int(out["rounds_run"]) == int(want["rounds_run"]) == ROUNDS + 1
    assert int(out["levels_run_total"]) == int(want["levels_run_total"])
    for key in windowing.LANE_KEYS + ("k_used",):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


def test_device_mode_on_a_one_device_mesh_is_one_graph(graphed):
    """Shards on one device: one ladder graph holds every shard's rungs and
    a gate a shard (the gate is global: the any over every shard), and
    equals the unsharded eager ladder; the launches counted at retire
    equal the sharded eager step's."""
    mesh = cpu_mesh((2,), ("data",))
    exe = build_executable(CFG, 8, 64, 64, 2, "cpu", mesh)
    assert exe.graphs.ladder.gates == 2     # rung 1's, one a shard
    batch = tuple(torch.cat([a, b]) for a, b in zip(_ladder_batch(6),
                                                      _ladder_batch(0)))
    sharded = [tuple(t[i * 4:(i + 1) * 4] for i in range(2)) for t in batch]
    genasm_dc.reset_counts()
    got = exe(*sharded)
    exe.retired(int(got[0]["rounds_run"]))
    launched = dict(genasm_dc.LAUNCHES)
    assert int(got[0]["rounds_run"]) == 3       # shard 0's burst opens both
    assert list(exe.graphs.gate_flags.numpy().ravel()) == [1, 0, 1, 0]
    _assert_tree_equal(got, make_align_step(CFG, 64, rescue_rounds=2,
                                            device="cpu")(*batch))
    genasm_dc.reset_counts()
    exe.step(*sharded)
    assert launched == genasm_dc.PLAIN_CALLS


def test_shards_on_several_devices_keep_the_host_gate(graphed, monkeypatch):
    """Where the shards span devices the ladder's captures replay rung by
    rung behind the host gate, counted in gate_syncs, as the eager step."""
    monkeypatch.setattr(graphs, "gate_on_card", lambda devices: False)
    mesh = cpu_mesh((2,), ("data",))
    exe = build_executable(CFG, 8, 64, 64, 2, "cpu", mesh)
    assert exe.graphs.ladder is None
    batch = tuple(torch.cat([a, b]) for a, b in zip(_ladder_batch(3),
                                                      _ladder_batch(0)))
    sharded = [tuple(t[i * 4:(i + 1) * 4] for i in range(2)) for t in batch]
    got = exe(*sharded)
    want = exe.step(*sharded)
    assert got[0]["gate_syncs"] == want[0]["gate_syncs"] == 2
    assert got[0]["rounds_run"] == 2
    for key in windowing.LANE_KEYS + ("k_used", "levels_run_total"):
        a, b = got[0][key], want[0][key]
        a, b = (torch.cat(a), torch.cat(b)) if isinstance(a, tuple) else (a, b)
        assert torch.equal(a, b), key
