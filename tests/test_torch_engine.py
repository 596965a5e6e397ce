"""The port's serving engine (``repro_torch.serve.engine.AlignmentEngine``)
on the CPU, mirroring the reference's engine tests
(tests/test_serve.py::test_alignment_engine_end_to_end and
::test_engine_ragged_batch_padding_regression, and
tests/test_api.py::test_engine_pad_to_batch_false_leans_on_session_buckets)
and held against the reference engine (``repro.serve.engine``) on the same
requests: equal ``results`` and ``stats`` (all but the host clock's
``wall_s``).  Both sides build their config from one reference value
through ``convert.config_from_reference``."""
import dataclasses

import numpy as np
import pytest

from repro.core.config import AlignerConfig as RefConfig
from repro.data.genome import ReadSimConfig, simulate_reads, synth_genome
from repro.serve.engine import AlignmentEngine as RefEngine
from repro.serve.engine import AlignRequest as RefRequest
from repro_torch.api import Gateway
from repro_torch.convert import config_from_reference
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.serve.engine import AlignmentEngine, AlignRequest
from tests.test_differential import CFG as REF_DCFG


def _engines(ref_cfg, **kw):
    """(reference engine, port engine on the CPU) for one reference
    config and the same engine knobs."""
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    return (RefEngine(ref_cfg, **kw),
            AlignmentEngine(cfg, device="cpu", **kw))


def _serve(eng, request_cls, reads, refs):
    for i, (r, s) in enumerate(zip(reads, refs)):
        eng.submit(request_cls(rid=i, read=r, ref=s))
    return eng.serve_until_empty()


def _assert_same_serving(port, ref):
    assert port.results.keys() == ref.results.keys()
    for rid, want in ref.results.items():
        assert port.results[rid] == want, rid
    drop = lambda st: {k: v for k, v in st.items() if k != "wall_s"}
    assert drop(port.stats) == drop(ref.stats)


def test_alignment_engine_end_to_end():
    g = synth_genome(40_000, seed=5)
    rs = simulate_reads(g, 6, ReadSimConfig(read_len=120, error_rate=0.06,
                                            seed=6))
    # both 4-request batches land in ONE (length bucket, lane class) ->
    # exactly one build; cache='private' so the count sees no other suite
    ref_eng, eng = _engines(RefConfig(W=32, O=12, k=8, backend="pallas_fused"),
                            batch_size=4, rescue_rounds=0, cache="private")
    assert eng.aligner.cache.stats()["lowerings"] == 0
    stats = _serve(eng, AlignRequest, rs.reads, rs.ref_segments)
    assert stats["batches"] == 2          # 4+2
    assert stats["aligned"] == 6
    assert all(eng.results[i]["ok"] for i in range(6))
    assert all(eng.results[i]["cigar"] for i in range(6))
    # the ragged 2-request tail was padded into the same 4-lane bucket
    cs = eng.aligner.cache.stats()
    assert cs["lowerings"] == 1 and cs["hits"] == 1
    _serve(ref_eng, RefRequest, rs.reads, rs.ref_segments)
    _assert_same_serving(eng, ref_eng)
    assert eng.aligner.device.type == "cpu"


def test_engine_ragged_batch_padding_regression():
    """A non-multiple-of-batch-size request stream: the ragged final batch
    is padded to batch_size with REPEATS of a real pair, and padding lanes
    neither consume extra rescue rounds nor pollute stats['failed'] or the
    per-request results."""
    g = synth_genome(30_000, seed=15)
    rs = simulate_reads(g, 6, ReadSimConfig(read_len=64, error_rate=0.05,
                                            seed=16))
    ref_eng, eng = _engines(RefConfig(W=16, O=6, k=4), batch_size=4,
                            rescue_rounds=1)
    seen_sizes = []
    orig_align = eng.aligner.align

    def spy(reads, refs):
        seen_sizes.append(len(reads))
        return orig_align(reads, refs)

    eng.aligner.align = spy
    stats = _serve(eng, AlignRequest, rs.reads, rs.ref_segments)
    assert seen_sizes == [4, 4]            # ragged tail padded, stable shape
    assert stats["batches"] == 2
    assert stats["padded_lanes"] == 2
    assert stats["aligned"] + stats["failed"] == 6   # pads never counted
    assert stats["failed"] == 0
    assert set(eng.results) == set(range(6))
    assert all(eng.results[i]["ok"] for i in range(6))
    _serve(ref_eng, RefRequest, rs.reads, rs.ref_segments)
    _assert_same_serving(eng, ref_eng)


def test_engine_pad_to_batch_false_leans_on_session_buckets(corpus):
    """pad_to_batch=False: the session's pow2 lane classes keep shapes
    stable — 7 requests become dispatches of 8 and 2 lanes, with
    engine-level padded_lanes 0."""
    reads, refs, _ = corpus
    ref_eng, eng = _engines(REF_DCFG, batch_size=5, rescue_rounds=0,
                            pad_to_batch=False)
    assert eng.batch_size == 5              # quantum 1 unsharded
    stats = _serve(eng, AlignRequest, reads[:7], refs[:7])
    assert stats["batches"] == 2 and stats["padded_lanes"] == 0
    assert stats["aligned"] + stats["failed"] == 7
    ses = eng.aligner
    assert ses.stats["dispatches"] == 2
    assert ses.stats["lanes"] == 8 + 2      # session lane classes
    assert ses.stats["pad_lanes"] == 3      # 5->8; 2->2
    assert set(eng.results) == set(range(7))
    _serve(ref_eng, RefRequest, reads[:7], refs[:7])
    _assert_same_serving(eng, ref_eng)
    assert ses.stats == {**ref_eng.aligner.stats,
                         "wall_s": ses.stats["wall_s"],
                         "retire_wall_s": ses.stats["retire_wall_s"]}


def test_engine_gateway_fronts_the_engine_session(corpus):
    """engine.gateway() is a Gateway over the engine's own session: its
    records equal the engine's on the same pairs, and closing the gateway
    leaves the session to the engine."""
    reads, refs, _ = corpus
    cfg = config_from_reference(dataclasses.asdict(REF_DCFG))
    eng = AlignmentEngine(cfg, batch_size=4, rescue_rounds=1, device="cpu")
    _serve(eng, AlignRequest, reads[:6], refs[:6])
    with eng.gateway() as gw:
        assert isinstance(gw, Gateway) and gw.session is eng.aligner
        ten = gw.tenant("t", priority=0)
        futs = [ten.submit(r, f) for r, f in zip(reads[:6], refs[:6])]
        recs = [f.result(timeout=60) for f in futs]
    for i, rec in enumerate(recs):
        want = eng.results[i]
        assert (rec["ok"], rec["dist"], rec["cigar"], rec["k_used"]) == \
            (want["ok"], want["dist"], want["cigar"], want["k_used"])
    assert eng.aligner.align(reads[:1], refs[:1]).cigars   # still open
    eng.close()


def test_engine_refuses_a_mesh():
    """A mesh is a ``launch.mesh.DeviceMesh``: any other object is refused
    by its type, and a mesh of CUDA devices under a CPU engine by its
    devices (the engine's mesh serving is tests/test_torch_mesh_serving.py)."""
    with pytest.raises(TypeError, match="str"):
        AlignmentEngine(batch_size=4, mesh="fake-mesh", device="cpu")
    cuda_mesh = make_test_mesh((2,), ("data",), devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="cuda"):
        AlignmentEngine(batch_size=4, mesh=cuda_mesh, device="cpu")
