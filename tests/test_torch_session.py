"""The port's session front door (``repro_torch.api``) on the CPU (the
kernels' plain versions), mirroring the reference's tests/test_api.py and
held against the reference session:

* compile stability: a ragged stream prepares each (length bucket, lane
  class) executable exactly once (misses == lowerings == distinct
  buckets, every later dispatch a hit, a second pass builds nothing), an
  executable refuses inputs outside its bucket's shapes, and fused, split
  and device-rescue specs key apart;
* streaming: double buffering caps in-flight dispatches, futures resolve
  out of order, results() drains and forgets, warmup() is a method;
* the bucket and lane-class arithmetic (``pow2_bucket``, ``pad_geometry``,
  ``bucket_avals``, ``quantise_lanes``, ``bucket_lanes``,
  ``lane_classes``) equals the reference's over a grid; the Hopper
  ``plan_lane_tile`` behind ``lane_tile='auto'``;
* the port session's records equal the reference session's
  (``repro.api.plan``) field for field on the differential corpus, for
  'fused' against 'pallas_fused' and 'split' against 'pallas', in both
  rescue modes, lanes that only a rescue rung aligns included, with the
  same dispatches, lanes and builds; and lanes stay independent of batch
  composition.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import AlignSpec as RefAlignSpec
from repro.api import AlignSession as RefAlignSession
from repro.core import windowing as ref_win
from repro.distributed import sharding as ref_sharding
from repro.launch.mesh import make_test_mesh as ref_make_test_mesh
from repro.serve.align_step import make_align_step as ref_make_align_step
from repro_torch.api import AlignSession, AlignSpec, CompileCache, plan
from repro_torch.api.session import build_executable
from repro_torch.convert import spec_from_reference
from repro_torch.core import windowing
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.config import AlignerConfig, resolve_config
from repro_torch.distributed import sharding
from repro_torch.kernels import genasm_dc
from repro_torch.serve.align_step import launch_plan, make_align_step
from tests.test_differential import CFG as DCFG, ROUNDS
from tests.test_torch_aligner import assert_results_equal
from tests.test_torch_config import cfg_pair

CFG = AlignerConfig(W=16, O=6, k=4)     # = test_differential.CFG, fused

# one length class per band: read lens stay inside one pow2 bucket
_LEN_BANDS = ((24, 30), (50, 60), (100, 120))


def _ragged_stream(rng, n_batches=9, lanes=4):
    """n_batches of `lanes` exact-match pairs; batch j draws every length
    from one band, and bands rotate, so the stream is mixed-length."""
    batches = []
    for j in range(n_batches):
        lo, hi = _LEN_BANDS[j % len(_LEN_BANDS)]
        reads = [rng.integers(0, 4, int(rng.integers(lo, hi + 1)))
                 .astype(np.uint8) for _ in range(lanes)]
        batches.append((reads, [r.copy() for r in reads]))
    return batches


@pytest.fixture(scope="module")
def stream_session():
    """One session shared by the streaming tests (its cache persists, so
    later tests assert counter DELTAS); cache='private' so exact build
    counts see no other suite's executables."""
    return plan(CFG, rescue_rounds=0, batch_lanes=4, max_inflight=2,
                cache="private", device="cpu")


@pytest.fixture(scope="module")
def stream():
    return _ragged_stream(np.random.default_rng(77))


def test_ragged_stream_builds_each_bucket_exactly_once(stream_session,
                                                       stream):
    s = stream_session
    expected = set()
    for reads, refs in stream:
        expected.add((s.bucket_for(max(len(r) for r in reads),
                                   max(len(f) for f in refs)),
                      sharding.bucket_lanes(len(reads), s.cfg, s.mesh)))
        res = s.align(reads, refs)
        assert not res.failed.any()
    assert len(expected) == len(_LEN_BANDS)
    assert s.stats["dispatches"] == len(stream)
    cs = s.cache.stats()
    assert cs["misses"] == cs["lowerings"] == cs["executables"] \
        == len(expected)
    assert cs["hits"] == len(stream) - len(expected)
    for reads, refs in stream:            # a second pass builds nothing
        s.align(reads, refs)
    cs2 = s.cache.stats()
    assert cs2["lowerings"] == cs["lowerings"]
    assert cs2["hits"] == 2 * len(stream) - len(expected)
    assert sum(s.cache.bucket_hits.values()) == cs2["hits"]


def test_futures_resolve_out_of_order_and_double_buffering(stream_session,
                                                           stream):
    s = stream_session
    low0 = s.cache.lowerings
    futs = []
    for reads, refs in stream[:6]:        # 6 dispatches through 3 buckets
        futs += [s.submit(r, f) for r, f in zip(reads, refs)]
        assert len(s._inflight) <= s.spec.max_inflight
    assert any(f.done() for f in futs[:4])
    assert not all(f.done() for f in futs)
    last = futs[-1].result()              # a LATE future first
    assert last["ok"] and last["dist"] == 0
    assert all(f.done() for f in futs)
    got = s.results()
    assert set(got) == {f.rid for f in futs} - {futs[-1].rid}
    assert s.results() == {}
    assert not s._open
    assert s.cache.lowerings == low0


def test_warmup_is_a_method_not_a_side_effect(stream):
    s = plan(CFG, rescue_rounds=0, batch_lanes=4, cache="private",
             device="cpu")
    assert s.cache.lowerings == 0         # planning builds nothing
    band = [b for b in stream
            if s.bucket_for(len(b[0][0]), len(b[1][0]))
            == s.bucket_for(_LEN_BANDS[0][1], _LEN_BANDS[0][1])]
    snap = s.warmup([(max(len(r) for r in reads), max(len(f) for f in refs))
                     for reads, refs in band])
    assert snap["lowerings"] == 1
    for reads, refs in band:
        s.align(reads, refs)
    assert s.cache.lowerings == snap["lowerings"]
    # bucket rescue warms every rung of the ladder at the bucket too
    r = plan(CFG, rescue_rounds=2, batch_lanes=4, cache="private",
             device="cpu")
    assert r.warmup([(30, 30)])["lowerings"] == 3


def test_executable_refuses_inputs_outside_its_bucket():
    """An executable accepts its bucket_avals and nothing else, as a
    compiled executable would; it launches and transfers nothing when it
    is built."""
    genasm_dc.reset_counts()
    exe = build_executable(CFG, 4, 32, 32, None, "cpu")
    assert set(genasm_dc.PLAIN_CALLS.values()) == {0}
    Lr, Lf = windowing.pad_geometry(CFG, 32, 32)
    good = (torch.full((4, Lr), windowing.SENTINEL_READ, dtype=torch.uint8),
            torch.full((4,), 10, dtype=torch.int32),
            torch.full((4, Lf), windowing.SENTINEL_REF, dtype=torch.uint8),
            torch.full((4,), 10, dtype=torch.int32))
    good[0][:, :10] = 1
    good[2][:, :10] = 1
    out, summary = exe(*good)
    assert int(summary["n_failed"]) == 0 and out["dist"].tolist() == [0] * 4
    bad = [(good[0][:2], *good[1:]),                        # lanes
           (good[0][:, :-1], *good[1:]),                    # read width
           (good[0].to(torch.int32), *good[1:]),            # dtype
           (*good[:3], good[3].to(torch.int64)),
           good[:3]]                                        # arity
    for args in bad:
        with pytest.raises(TypeError):
            exe(*args)


def test_plan_resolves_and_validates_once():
    s = plan(CFG, backend="split", k=6, batch_lanes=3, device="cpu")
    assert (s.cfg.k, s.cfg.W, s.cfg.backend) == (6, CFG.W, "split")
    assert s.spec.batch_lanes == 4          # quantised to a pow2 lane class
    with pytest.raises(TypeError):
        plan(CFG, not_a_knob=1, device="cpu")
    with pytest.raises(AssertionError):
        plan(CFG, rescue_mode="teleport", device="cpu")
    with pytest.raises(ValueError, match="store"):
        resolve_config(CFG, backend="fused", store="and")
    with pytest.raises(TypeError, match="object"):
        plan(CFG, mesh=object(), device="cpu")
    assert AlignSpec(cfg=CFG).key() == AlignSpec(cfg=CFG).key()
    auto = plan(CFG, k=6, lane_tile="auto", device="cpu")
    assert auto.cfg.lane_tile == windowing.plan_lane_tile(CFG.replace(k=6))


def test_fused_split_and_device_specs_key_apart():
    """Backend and rescue mode are part of the key (fingerprint covers
    every field), and so is the device: no spec serves another's
    executables from the shared store."""
    keys = {AlignSpec(cfg=CFG.replace(backend=b), rescue_mode=m).key()
            for b in ("fused", "split", "plain") for m in ("bucket", "device")}
    assert len(keys) == 6
    assert CFG.replace(backend="split").fingerprint() == \
        resolve_config(CFG, backend="split").fingerprint()
    c = CompileCache()
    ka, kb = (AlignSpec(cfg=CFG.replace(backend=b)).key()
              for b in ("fused", "split"))
    assert c.get((ka, 64), lambda: "exe-fused") == "exe-fused"
    assert c.get((kb, 64), lambda: "exe-split") == "exe-split"
    assert c.get((ka, 64), lambda: "never") == "exe-fused"
    assert (c.hits, c.misses) == (1, 2)
    s = plan(CFG, rescue_rounds=0, batch_lanes=1, cache=c, device="cpu")
    s.align([np.zeros(20, np.uint8)], [np.zeros(20, np.uint8)])
    (key,) = s.cache._seen
    assert key[-1] == "cpu" and key[-2] == ("nomesh",)


def test_compile_cache_counters_unit():
    c = CompileCache()
    built = []
    assert c.get("a", lambda: built.append(1) or "exe-a") == "exe-a"
    assert c.get("a", lambda: built.append(1) or "never") == "exe-a"
    assert c.get("b", lambda: "exe-b") == "exe-b"
    assert (c.hits, c.misses, c.lowerings, len(c)) == (1, 2, 2, 2)
    assert built == [1]
    assert c.stats()["bucket_hits"] == {"a": 1}


# --------------------------------------------------------------------------
# the arithmetic, against the reference
# --------------------------------------------------------------------------

def test_bucket_and_lane_math_equal_reference(monkeypatch):
    ref_cfg, cfg = cfg_pair(W=16, O=6, k=4)
    for n in range(0, 300, 7):
        for floor in (1, 32, 64):
            assert windowing.pow2_bucket(n, floor) == \
                ref_win.pow2_bucket(n, floor)
        assert sharding.quantise_lanes(n, cfg, None) == \
            ref_sharding.quantise_lanes(n, ref_cfg, None)
        assert sharding.bucket_lanes(n, cfg, None) == \
            ref_sharding.bucket_lanes(n, ref_cfg, None)
        assert sharding.lane_classes(n, cfg, None) == \
            ref_sharding.lane_classes(n, ref_cfg, None)
    assert sharding.mesh_fingerprint(None) == \
        ref_sharding.mesh_fingerprint(None) == ("nomesh",)
    assert sharding.n_pair_shards(None) == 1
    assert sharding.pair_pad_multiple(cfg, None) == 1
    # a sharded quantum (lane_tile * n_devices), patched in both packages
    monkeypatch.setattr(sharding, "pair_pad_multiple", lambda c, m: 6)
    monkeypatch.setattr(ref_sharding, "pair_pad_multiple", lambda c, m: 6)
    for n in range(1, 60):
        assert sharding.bucket_lanes(n, cfg, "fake") == \
            ref_sharding.bucket_lanes(n, ref_cfg, "fake")
        assert sharding.lane_classes(n, cfg, "fake") == \
            ref_sharding.lane_classes(n, ref_cfg, "fake")
    assert sharding.lane_classes(13, cfg, "fake") == (6, 12, 18)


@pytest.mark.parametrize("W,O,k", [(16, 6, 4), (64, 24, 12), (64, 40, 48)])
def test_pad_geometry_and_bucket_avals_equal_reference(W, O, k):
    ref_cfg, cfg = cfg_pair(W=W, O=O, k=k)
    for lanes in (1, 8, 1024):
        for rb, fb in ((32, 32), (1024, 2048), (16384, 16384)):
            for rounds in (0, 2):
                assert windowing.pad_geometry(cfg, rb, fb, rounds) == \
                    ref_win.pad_geometry(ref_cfg, rb, fb, rounds)
                port = windowing.bucket_avals(cfg, lanes, rb, fb, rounds)
                ref = ref_win.bucket_avals(ref_cfg, lanes, rb, fb, rounds)
                assert [shape for shape, _ in port] == \
                    [tuple(a.shape) for a in ref]
                assert [str(dtype).removeprefix("torch.")
                        for _, dtype in port] == [str(a.dtype) for a in ref]


def test_mesh_is_refused_by_name():
    """An object that is not a ``launch.mesh.DeviceMesh`` is refused,
    naming its type; a reference spec with a mesh maps only with the
    port's mesh beside it."""
    for fn in (sharding.n_pair_shards, sharding.mesh_fingerprint,
               sharding.pair_axes):
        with pytest.raises(TypeError, match="str"):
            fn("a-mesh")
    with pytest.raises(TypeError, match="str"):
        make_align_step(CFG, 64, mesh="a-mesh", device="cpu")
    ref_mesh = ref_make_test_mesh((1,), ("data",))
    fields = {**dataclasses.asdict(RefAlignSpec(cfg=DCFG)),
              "mesh": ref_mesh}
    with pytest.raises(ValueError, match="reference spec's mesh"):
        spec_from_reference(fields)
    with pytest.raises(TypeError, match="str"):
        spec_from_reference(fields, mesh="a-mesh")


def test_plan_lane_tile_hopper_model():
    """132 SMs x K1 blocks per SM x lanes per block, the blocks from the
    shared bytes of K1's window form (what the fused loop launches; + the
    1 KB reserve) against 233,472 B and 2,048 threads an SM: 7 / 4 / 2
    blocks at k = 12 / 24 / 48, as the card's occupancy query reports for
    K1."""
    for k, blocks, lanes in ((12, 7, 8), (24, 4, 4), (48, 2, 4)):
        cfg = AlignerConfig(k=k)
        geo = genasm_dc.tb_fused_geometry(cfg, window=True)
        assert (geo.lanes, (233_472 // (geo.shared_bytes + 1024))) == \
            (lanes, blocks)
        assert windowing.plan_lane_tile(cfg) == 132 * blocks * lanes
    assert windowing.plan_lane_tile(CFG) == 132 * 16 * 8   # by threads
    assert resolve_config(AlignerConfig(), k=24,
                          lane_tile="auto").lane_tile == 2112
    with pytest.raises(ValueError, match=r"W=64 k=12.*29,728 bytes"):
        windowing.plan_lane_tile(AlignerConfig(), sm_shared_bytes=20_000)
    for W in (288, 320):              # NW >= 9: the wide family's block
        cfg = AlignerConfig(W=W, O=24, k=12)
        geo = genasm_dc.xwide_geometry(cfg, "tb_fused")
        blocks = min(233_472 // (geo.shared_bytes + 1024),
                     2048 // geo.threads, 32)
        assert windowing.plan_lane_tile(cfg) == 132 * blocks * geo.lanes


def test_launch_plan_on_the_cpu():
    """What an executable prepares: the kernels each rung launches with
    their blocks (no occupancy without the card), nothing launched."""
    genasm_dc.reset_counts()
    fused = launch_plan(AlignerConfig(), 10_000, 2, "cpu")
    assert [(e["kernel"], e["k"]) for e in fused] == [
        ("tb_fused", 12), ("tail_banded", 12), ("tb_fused", 24),
        ("tail_full", 24), ("tb_fused", 48), ("tail_full", 48)]
    assert fused[0]["geometry"] == genasm_dc.tb_fused_geometry(
        AlignerConfig(), window=True)
    assert all(e["blocks_per_sm"] is None for e in fused)
    split = launch_plan(AlignerConfig(backend="split"), 10_000, None, "cpu")
    assert [(e["kernel"], e["k"]) for e in split] == [("dc_band", 12)]
    assert launch_plan(AlignerConfig(backend="fused"), 40, None, "cpu")[0][
        "kernel"] == "tail_banded"          # no main window: no K1
    assert launch_plan(AlignerConfig(backend="plain"), 1000, 2, "cpu") == ()
    for W in (288, 320):               # NW >= 9: the wide family's blocks
        cfg = AlignerConfig(W=W, O=24, backend="split")
        wide = launch_plan(cfg, 1000, None, "cpu")
        assert [e["geometry"] for e in wide] == \
            [genasm_dc.xwide_geometry(cfg, "dc_band")]
        assert isinstance(wide[0]["geometry"], genasm_dc.XwideGeometry)
    assert set(genasm_dc.PLAIN_CALLS.values()) == {0}
    assert set(genasm_dc.LAUNCHES.values()) == {0}


def test_align_step_summary_equals_reference(corpus):
    """make_align_step's out and summary (0-d tensors) equal the
    reference's jitted step on the same padded bucket."""
    reads, refs, _ = corpus
    ref_cfg, cfg = cfg_pair(backend="jnp", W=16, O=6, k=4)
    s = plan(cfg, rescue_rounds=ROUNDS, batch_lanes=32, device="cpu")
    Lr, Lf = windowing.pad_geometry(cfg, 64, 64, ROUNDS)
    arrays = s._pad_batch(reads, refs, 32, Lr, Lf)
    ref_out, ref_sum = ref_make_align_step(ref_cfg, 64, None,
                                           rescue_rounds=ROUNDS)(
        *map(jnp.asarray, arrays))
    out, summary = make_align_step(cfg, 64, rescue_rounds=ROUNDS,
                                   device="cpu")(
        *map(torch.from_numpy, arrays))
    assert set(summary) == set(ref_sum)
    for key, v in summary.items():
        assert v.dim() == 0 and v.dtype == torch.int32
        assert int(v) == int(ref_sum[key]), key
    for key in ("ops", "n_ops", "dist", "failed", "k_used", "read_consumed",
                "ref_consumed"):
        np.testing.assert_array_equal(out[key].numpy(),
                                      np.asarray(ref_out[key]), err_msg=key)


# --------------------------------------------------------------------------
# the port session against the reference session
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rescue_mode", ["bucket", "device"])
@pytest.mark.parametrize("backend", ["pallas_fused", "pallas"])
def test_session_records_equal_reference_session(corpus, backend,
                                                 rescue_mode):
    """Both sessions planned from one reference spec: the same records,
    dispatches, lanes, rescue dispatches and builds."""
    reads, refs, _ = corpus
    ref_spec = RefAlignSpec(cfg=dataclasses.replace(DCFG, backend=backend),
                            rescue_rounds=ROUNDS, rescue_mode=rescue_mode,
                            batch_lanes=32)
    spec = spec_from_reference(dataclasses.asdict(ref_spec))
    assert spec.cfg.backend == {"pallas_fused": "fused",
                                "pallas": "split"}[backend]
    ref_s = RefAlignSession(ref_spec, cache="private")
    s = AlignSession(spec, cache="private", device="cpu")
    ref, port = ref_s.align(reads, refs), s.align(reads, refs)
    assert_results_equal(port, ref)
    assert port.failed.any() and (port.k_used > DCFG.k).any()
    keys = ("dispatches", "lanes", "pad_lanes", "rescue_dispatches",
            "rescue_lanes", "requests")
    assert {k: s.stats[k] for k in keys} == {k: ref_s.stats[k] for k in keys}
    assert s.cache.lowerings == ref_s.cache.lowerings
    assert (s.stats["rescue_dispatches"] > 0) == (rescue_mode == "bucket")


def test_lanes_independent_of_batch_composition(corpus):
    """Permuted submission through small dispatches gives the permuted
    records of one whole-batch GenASMAligner call: padding, bucketing and
    compaction never change a lane's result."""
    reads, refs, _ = corpus
    base = GenASMAligner(CFG, rescue_rounds=ROUNDS, device="cpu").align(
        reads, refs)
    perm = np.random.default_rng(9).permutation(len(reads))
    s = plan(CFG, rescue_rounds=ROUNDS, batch_lanes=8, device="cpu")
    res = s.align([reads[i] for i in perm], [refs[i] for i in perm])
    inv = np.argsort(perm)
    assert_results_equal(
        type(res)(res.dist[inv], [res.cigars[i] for i in inv],
                  [res.ops[i] for i in inv], res.failed[inv],
                  res.k_used[inv], res.read_consumed[inv],
                  res.ref_consumed[inv]), base)
    assert s.stats["dispatches"] >= 4
