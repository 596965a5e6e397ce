"""The port's serving layers on a mesh of repeated ``cpu`` devices,
mirroring tests/test_multidevice.py's engine, threaded-session and
step-factory checks: the engine pads ragged batches to lane_tile *
n_shards and no pad lane reaches ``results`` or ``stats``; sessions on a
mesh (threaded executor with bucket rescue, sync with device rescue)
give the records of the port's and the reference's unsharded aligners,
with one upload and one download a dispatch and lane classes that are
multiples of the pair quantum; an executable checks each shard; the step
factory's outputs and summaries equal the reference's unsharded step;
and ``convert.spec_from_reference`` maps a reference spec's mesh to the
port's.  The reference runs unsharded, in-process (tests/test_multidevice.py
holds its sharded runs equal to that)."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import AlignSpec as RefAlignSpec
from repro.core.aligner import GenASMAligner as RefAligner
from repro.launch.mesh import make_test_mesh as ref_make_test_mesh
from repro.serve.align_step import align_step as ref_align_step
from repro_torch.api import plan
from repro_torch.api.session import AlignSession, build_executable
from repro_torch.convert import spec_from_reference
from repro_torch.core import transfer
from repro_torch.core.aligner import GenASMAligner
from repro_torch.distributed import sharding
from repro_torch.serve.align_step import launch_plan, make_align_step
from repro_torch.serve.engine import AlignmentEngine, AlignRequest
from tests.test_torch_aligner import assert_results_equal
from tests.test_torch_config import cfg_pair
from tests.test_torch_mesh import (CPU, FIELDS, ROUNDS, cpu_mesh,
                                   mesh_corpus, pad_batch)  # noqa: F401


@pytest.fixture(scope="module")
def bases(mesh_corpus):
    """(the reference's unsharded AlignResult, the port's) on the corpus."""
    reads, refs = mesh_corpus
    ref_cfg, cfg = cfg_pair(backend="jnp", **FIELDS)
    ref = RefAligner(ref_cfg, rescue_rounds=ROUNDS).align(reads, refs)
    port = GenASMAligner(cfg.replace(backend="fused"), rescue_rounds=ROUNDS,
                         device="cpu").align(reads, refs)
    assert_results_equal(port, ref)
    return ref, port


def _assert_records(recs, want):
    for i, rec in enumerate(recs):
        assert rec["ok"] == (not want.failed[i]), i
        assert (rec["dist"], rec["cigar"], rec["k_used"]) == (
            int(want.dist[i]), want.cigars[i], int(want.k_used[i])), i
        np.testing.assert_array_equal(rec["ops"], want.ops[i])


def test_engine_pads_ragged_batches_to_the_mesh_quantum(mesh_corpus,
                                                        bases):
    """13 requests at batch_size=13 on 8 shards: the batch quantises to
    lane_tile * 8 = 32, one 32-lane batch (4 lanes a shard), 19 pad lanes
    that never reach results or stats."""
    reads, refs = mesh_corpus
    ref, _ = bases
    _, cfg = cfg_pair(**FIELDS)
    eng = AlignmentEngine(cfg, batch_size=13, rescue_rounds=ROUNDS,
                          mesh=cpu_mesh(), device="cpu")
    assert eng.pad_multiple == cfg.lane_tile * 8 == 32
    assert eng.batch_size == 32
    seen = []
    orig = eng.aligner.align
    eng.aligner.align = lambda r, f: (seen.append(len(r)), orig(r, f))[1]
    for i in range(13):
        eng.submit(AlignRequest(rid=i, read=reads[i], ref=refs[i]))
    stats = eng.serve_until_empty()
    eng.close()
    assert seen == [32]
    assert stats["batches"] == 1 and stats["padded_lanes"] == 19
    assert stats["aligned"] + stats["failed"] == 13
    assert stats["failed"] == int(ref.failed[:13].sum())
    assert set(eng.results) == set(range(13))
    for i in range(13):
        assert eng.results[i] == {
            "ok": not ref.failed[i], "dist": int(ref.dist[i]),
            "cigar": ref.cigars[i], "k_used": int(ref.k_used[i])}, i


@pytest.mark.parametrize("executor,rescue_mode,shape", [
    ("thread", "bucket", (8,)), ("sync", "device", (4, 2))])
def test_session_on_a_mesh_equals_unsharded(mesh_corpus, bases, executor,
                                            rescue_mode, shape):
    """A session on the mesh: spec.batch_lanes quantises to the pair
    quantum lane_tile * n_pair_shards (32 on 8 shards, 16 on the 4 data
    rows of a (4, 2) mesh), every record equals the reference's and the
    port's unsharded aligners, each dispatch and rescue-rung dispatch
    makes one upload and one download, every lane class is a multiple of
    the quantum, and a threaded session shuts down cleanly."""
    reads, refs = mesh_corpus
    ref, port = bases
    _, cfg = cfg_pair(**FIELDS)
    mesh = cpu_mesh(shape, ("data", "model")[:len(shape)])
    q = 4 * shape[0]
    assert sharding.pair_pad_multiple(cfg, mesh) == q
    transfer.reset()
    with plan(cfg, rescue_rounds=ROUNDS, rescue_mode=rescue_mode,
              batch_lanes=16, executor=executor, mesh=mesh,
              cache="private", device="cpu") as ses:
        assert ses.spec.batch_lanes == max(q, 16)
        assert all(c % q == 0 for c in ses._ladder)
        futs = [ses.submit(r, f) for r, f in zip(reads, refs)]
        ses.flush()
        recs = [f.result(timeout=120) for f in futs]
    _assert_records(recs, ref)
    _assert_records(recs, port)
    st = ses.stats
    n = st["dispatches"] + st["rescue_dispatches"]
    moved = transfer.stats()
    assert (moved.h2d_calls, moved.d2h_calls) == (n, n)
    assert st["lanes"] % q == 0 and st["rescue_lanes"] % q == 0
    assert (st["rescue_dispatches"] >= 1) == (rescue_mode == "bucket")
    assert ses._retire_thread is None


def test_executable_checks_each_shard():
    """An executable on a mesh takes one tensor a shard, each of its
    bucket's shard shape, dtype and device; its launch plan lists each
    shard's launches."""
    _, cfg = cfg_pair(**FIELDS)
    mesh = cpu_mesh((4,))
    exe = build_executable(cfg, 32, 64, 64, None, CPU, mesh)
    assert exe.shards == (CPU,) * 4
    (rshape, _), (lshape, _), (fshape, _), _ = exe.avals
    assert rshape[0] == lshape[0] == fshape[0] == 8
    launches = [(e["shard"], e["kernel"]) for e in exe.launches]
    assert launches == [(s, k) for s in range(4)
                        for k in ("tb_fused", "tail_full")]
    shard = (torch.zeros(rshape, dtype=torch.uint8),
             torch.full((8,), 40, dtype=torch.int32),
             torch.zeros(fshape, dtype=torch.uint8),
             torch.full((8,), 40, dtype=torch.int32))
    out, summary = exe(*((t,) * 4 for t in shard))
    assert [t.shape[0] for t in out["dist"]] == [8] * 4
    assert int(summary["n_failed"]) == 0
    with pytest.raises(TypeError, match="4 pair shards"):
        exe(*((t,) * 3 for t in shard))
    bad = (shard[0][:4],) + shard[1:]
    with pytest.raises(TypeError, match="reads of shard 0"):
        exe(*((t,) * 4 for t in bad))
    assert launch_plan(cfg, 64, None, CPU, mesh) == exe.launches


@pytest.mark.parametrize("rescue_rounds", [ROUNDS, None])
def test_step_factory_summaries_equal_reference(mesh_corpus, rescue_rounds):
    """make_align_step on 8 shards (the engine's padded 32-lane batch):
    per-lane outputs, joined in lane order, and the summary reduced over
    every shard equal the reference's unsharded align_step; the plain
    (no-rescue) factory too."""
    reads, refs = mesh_corpus
    b32 = list(zip(reads[:13], refs[:13])) + [(reads[12], refs[12])] * 19
    ref_cfg, cfg = cfg_pair(backend="jnp", **FIELDS)
    arrays, L = pad_batch([r for r, _ in b32], [f for _, f in b32], cfg,
                          rescue_rounds=rescue_rounds or 0)
    ref_out, ref_sum = ref_align_step(*map(jnp.asarray, arrays),
                                      cfg=ref_cfg, max_read_len=L,
                                      rescue_rounds=rescue_rounds)
    mesh = cpu_mesh()
    cfg = cfg.replace(backend="fused")
    stepf = make_align_step(cfg, L, mesh, rescue_rounds=rescue_rounds,
                            device="cpu")
    out, summary = stepf(*transfer.to_device(
        arrays, CPU, sharding.pair_shards(32, cfg, mesh)))
    keys = ["ops", "n_ops", "dist", "failed", "read_consumed",
            "ref_consumed"] + (["k_used"] if rescue_rounds else [])
    for key in keys:
        assert len(out[key]) == 8
        np.testing.assert_array_equal(
            sharding.merge_pairs([t.numpy() for t in out[key]]),
            np.asarray(ref_out[key]), err_msg=key)
    assert set(summary) == set(ref_sum)
    for key, v in summary.items():
        assert v.dim() == 0 and v.dtype == torch.int32
        assert int(v) == int(ref_sum[key]), key


def test_spec_from_reference_maps_a_mesh(mesh_corpus, bases):
    """A reference spec with a mesh maps with the port's mesh of the same
    axes and sizes (read by attribute: a JAX mesh or a stand-in), and the
    session planned from it gives the reference's records; other axes or
    sizes, a missing port mesh and a port mesh the reference lacks raise
    ValueError."""
    reads, refs = mesh_corpus
    ref, _ = bases
    ref_spec = RefAlignSpec(cfg=cfg_pair(**FIELDS)[0], rescue_rounds=ROUNDS,
                            batch_lanes=16)
    fields = dataclasses.asdict(ref_spec)
    jax_mesh = ref_make_test_mesh((1,), ("data",))
    spec = spec_from_reference({**fields, "mesh": jax_mesh}, cpu_mesh((1,)))
    assert spec.mesh == cpu_mesh((1,))
    stand_in = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": 4, "model": 2})
    mesh = cpu_mesh((4, 2), ("data", "model"))
    spec = spec_from_reference({**fields, "mesh": stand_in}, mesh)
    assert spec.mesh is mesh and spec.cfg.backend == "fused"
    with AlignSession(spec, cache="private", device="cpu") as ses:
        assert ses.spec.batch_lanes == 16
        res = ses.align(reads, refs)
    assert_results_equal(res, ref)
    for port_mesh in (cpu_mesh((8,)), cpu_mesh((2, 4), ("data", "model"))):
        with pytest.raises(ValueError, match="other axes or sizes"):
            spec_from_reference({**fields, "mesh": stand_in}, port_mesh)
    with pytest.raises(ValueError, match="reference spec's mesh"):
        spec_from_reference({**fields, "mesh": stand_in})
    with pytest.raises(ValueError, match="reference spec's mesh"):
        spec_from_reference(fields, mesh)
