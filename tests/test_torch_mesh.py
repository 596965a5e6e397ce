"""The port's multi-device path on the CPU: the aligner's pair axis
sharded over a ``repro_torch.launch.mesh.DeviceMesh`` of repeated ``cpu``
devices, held against the port with ``mesh=None`` and against the
reference, field for field, with tolerance 0 (the DP is integer
arithmetic).  tests/test_multidevice.py holds the reference's own sharded
run equal to its ``mesh=None`` run, so the reference runs here once,
unsharded, in-process: ``align_pairs_rescued`` on the fused Pallas
backend in interpret mode.

The corpus is tests/test_differential.py's, B = 30 against a pad unit
of lane_tile * 8 = 32, so the last of the 8 shards is ragged, and the
ladder fails in only some shards.  Covered: the three port backends,
both rescue modes, ``tail_store='band'``, a (4, 2) data x model mesh,
B = 3 on 8 shards (shards with no real lane are skipped),
``levels_run_total`` as the sum over windows of the batch-wide maximum
(not a sum of per-shard sums), the transfer contract (1 upload + 1
download a batch, the unsharded bytes), and the sharding arithmetic
against ``repro.distributed.sharding`` on four mesh shapes.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import windowing as ref_win
from repro.core.aligner import AlignResult as RefAlignResult
from repro.core.cigar import decode_batch as ref_decode_batch
from repro.core.cigar import records_from_state as ref_records
from repro.distributed import sharding as ref_sharding
from repro.launch import mesh as ref_mesh
from repro_torch.core import transfer, windowing
from repro_torch.core.aligner import GenASMAligner
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import DeviceMesh, batch_axes, make_test_mesh
from tests.test_differential import make_corpus
from tests.test_torch_aligner import assert_results_equal
from tests.test_torch_config import cfg_pair

ROUNDS = 1
CPU = torch.device("cpu")
FIELDS = dict(W=16, O=6, k=4, lane_tile=4)


def cpu_mesh(shape=(8,), axes=("data",)) -> DeviceMesh:
    """A mesh of `shape` over the one CPU, listed once a position."""
    return make_test_mesh(shape, axes, devices=[CPU] * int(np.prod(shape)))


MESHES = {"8": lambda: cpu_mesh(),
          "4x2": lambda: cpu_mesh((4, 2), ("data", "model"))}


@pytest.fixture(scope="module")
def mesh_corpus():
    reads, refs, _ = make_corpus(seed=20260727, n_per_profile=6)
    assert len(reads) == 30 and len(reads) % (4 * 8) != 0
    return reads, refs


def pad_batch(reads, refs, cfg, rescue_rounds=ROUNDS):
    """The aligner's padded host arrays (reads, read_len, refs, ref_len)
    and max_read_len."""
    L = max(len(r) for r in reads)
    Lr, Lf = windowing.pad_geometry(cfg, L, max(len(f) for f in refs),
                                    rescue_rounds)
    rp, rl = GenASMAligner._pad(reads, Lr, windowing.SENTINEL_READ)
    fp, fl = GenASMAligner._pad(refs, Lf, windowing.SENTINEL_REF)
    return (rp, rl, fp, fl), L


@pytest.fixture(scope="module")
def reference(mesh_corpus):
    """The reference's unsharded ladder on the corpus: its AlignResult
    and its levels_run_total."""
    reads, refs = mesh_corpus
    ref_cfg, cfg = cfg_pair(**FIELDS)
    arrays, L = pad_batch(reads, refs, cfg)
    out = ref_win.align_pairs_rescued(*map(jnp.asarray, arrays),
                                      cfg=ref_cfg, max_read_len=L,
                                      rescue_rounds=ROUNDS)
    host = {k: np.asarray(v) for k, v in out.items()}
    res = RefAlignResult.from_records(ref_records(*ref_decode_batch(
        host, len(reads), ref_cfg.k)))
    return res, int(host["levels_run_total"])


def _aligner(backend, mesh=None, rescue_mode="device", **fields):
    _, cfg = cfg_pair(**{**FIELDS, **fields})
    return GenASMAligner(cfg, rescue_rounds=ROUNDS, backend=backend,
                         rescue_mode=rescue_mode, device="cpu", mesh=mesh)


def _shards_of_lanes(lanes, n_lanes=30):
    """The pair shards (of 8, 4 lanes each) that hold any of `lanes`."""
    bounds = sharding.pair_shards(n_lanes, _aligner("fused").cfg,
                                  cpu_mesh())
    return {s for s, (_, sl) in enumerate(bounds)
            for i in lanes if sl.start <= i < sl.stop}


# --------------------------------------------------------------------------
# the aligner and the window loop on a mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("backend", ["fused", "split", "plain"])
def test_sharded_aligner_equals_unsharded_and_reference(
        mesh_corpus, reference, backend, mesh_name):
    """Device rescue on a mesh: every AlignResult field and
    levels_run_total equal the port's mesh=None run and the reference; one
    upload and one download, of the unsharded batch's bytes."""
    reads, refs = mesh_corpus
    ref, ref_levels = reference
    base_al = _aligner(backend)
    base = base_al.align(reads, refs)
    transfer.reset()
    al = _aligner(backend, MESHES[mesh_name]())
    got = al.align(reads, refs)
    moved = transfer.stats()
    assert (moved.h2d_calls, moved.d2h_calls) == (1, 1)
    assert (al.transfers.h2d_calls, al.transfers.d2h_calls) == (1, 1)
    assert (al.transfers.h2d_bytes, al.transfers.d2h_bytes) == \
        (base_al.transfers.h2d_bytes, base_al.transfers.d2h_bytes)
    assert al.transfers.gate_syncs == base_al.transfers.gate_syncs == 1
    assert_results_equal(got, base)
    assert_results_equal(got, ref)
    assert al.last_run["levels_run_total"] == ref_levels
    assert base_al.last_run["levels_run_total"] == ref_levels
    assert al.last_run["rounds_run"] == base_al.last_run["rounds_run"] == 2


def test_ladder_fails_in_only_some_shards(reference):
    """The corpus exercises the global gate: the base rung fails lanes in
    some of the 8 shards but not all, and a lane stays failed after the
    ladder in some shards only."""
    ref, _ = reference
    rescued = np.flatnonzero(ref.k_used > FIELDS["k"])
    failed = np.flatnonzero(ref.failed)
    for lanes in (rescued, failed):
        assert 0 < len(_shards_of_lanes(lanes)) < 8


@pytest.mark.parametrize("backend", ["fused", "split"])
def test_sharded_host_rescue_equals_reference(mesh_corpus, reference,
                                              backend):
    """rescue_mode='host' shards each round's failed subset the same way:
    equal to mesh=None and the reference."""
    reads, refs = mesh_corpus
    ref, _ = reference
    got = _aligner(backend, cpu_mesh(), rescue_mode="host").align(reads,
                                                                  refs)
    assert_results_equal(got, _aligner(backend, rescue_mode="host").align(
        reads, refs))
    assert_results_equal(got, ref)


def test_sharded_banded_tail_equals_reference(mesh_corpus, reference):
    """tail_store='band' at this geometry's fallback boundary (nwb == nw,
    so 'auto' would pick the full store): K2's plain version on 8
    shards, equal to the reference."""
    reads, refs = mesh_corpus
    ref, ref_levels = reference
    al = _aligner("fused", cpu_mesh(), tail_store="band")
    assert al.cfg.tail_banded
    assert_results_equal(al.align(reads, refs), ref)
    assert al.last_run["levels_run_total"] == ref_levels


@pytest.mark.parametrize("backend", ["fused", "plain"])
def test_three_pairs_on_eight_shards(mesh_corpus, backend):
    """B = 3 on 8 shards: the pad unit of 32 puts every lane in shard 0,
    the other seven hold no real lane and are skipped; equal to
    mesh=None, levels included."""
    reads, refs = (x[:3] for x in mesh_corpus)
    mesh = cpu_mesh()
    _, cfg = cfg_pair(**FIELDS)
    assert [sl for _, sl in sharding.pair_shards(3, cfg, mesh)] == \
        [slice(0, 3)]
    base_al, al = _aligner(backend), _aligner(backend, mesh)
    assert_results_equal(al.align(reads, refs), base_al.align(reads, refs))
    assert al.last_run == {**base_al.last_run,
                           "ladder_s": al.last_run["ladder_s"],
                           "decode_s": al.last_run["decode_s"]}


def test_levels_are_summed_window_maxima_not_shard_sums(mesh_corpus,
                                                        reference):
    """align_pairs on 8 shards: levels_run_total is the sum over windows
    of the batch-wide maximum, equal to the unsharded and the reference
    align_pairs; the sum of the shards' own totals is larger here, so a
    per-shard sum would be caught."""
    reads, refs = mesh_corpus
    ref_cfg, cfg = cfg_pair(**FIELDS)
    arrays, L = pad_batch(reads, refs, cfg, rescue_rounds=0)
    mesh = cpu_mesh()
    shards = sharding.pair_shards(len(reads), cfg, mesh)
    sharded = windowing.align_pairs(*transfer.to_device(arrays, CPU, shards),
                                    cfg=cfg, max_read_len=L, mesh=mesh)
    whole = windowing.align_pairs(*transfer.to_device(arrays, CPU), cfg=cfg,
                                  max_read_len=L)
    ref = ref_win.align_pairs(*map(jnp.asarray, arrays), cfg=ref_cfg,
                              max_read_len=L)
    for key in ("ops", "n_ops", "dist", "failed", "read_consumed",
                "ref_consumed"):
        assert len(sharded[key]) == 8
        merged = sharding.merge_pairs([t.numpy() for t in sharded[key]])
        np.testing.assert_array_equal(merged, whole[key].numpy(),
                                      err_msg=key)
        np.testing.assert_array_equal(merged, np.asarray(ref[key]),
                                      err_msg=key)
    total = int(sharded["levels_run_total"])
    assert total == int(whole["levels_run_total"]) == \
        int(ref["levels_run_total"])
    own = [int(windowing.align_pairs(
        *(torch.from_numpy(a[sl]) for a in arrays), cfg=cfg,
        max_read_len=L)["levels_run_total"]) for _, sl in shards]
    assert sum(own) > total >= max(own)


def test_rescued_ladder_on_a_mesh_keeps_shards_on_their_devices(
        mesh_corpus, reference):
    """align_pairs_rescued on per-shard inputs returns per-shard outputs
    (each of the shard's lanes), one gate sync for the one later rung
    however many shards it reads, and the reference's levels."""
    reads, refs = mesh_corpus
    _, ref_levels = reference
    _, cfg = cfg_pair(**FIELDS)
    arrays, L = pad_batch(reads, refs, cfg)
    mesh = cpu_mesh()
    shards = sharding.pair_shards(len(reads), cfg, mesh)
    out = windowing.align_pairs_rescued(
        *transfer.to_device(arrays, CPU, shards), cfg=cfg, max_read_len=L,
        rescue_rounds=ROUNDS, mesh=mesh)
    assert [t.shape[0] for t in out["k_used"]] == [4] * 7 + [2]
    assert (out["rounds_run"], out["gate_syncs"]) == (2, 1)
    assert int(out["levels_run_total"]) == ref_levels


def test_mesh_inputs_are_checked():
    """Per-shard inputs must match the mesh: tuples, not more shards than
    the mesh has, each shard on its device; a mesh's devices must be of
    the aligner's device type."""
    _, cfg = cfg_pair(**FIELDS)
    mesh = cpu_mesh((2,))
    t = torch.zeros((2, 40), dtype=torch.uint8)
    n = torch.full((2,), 8, dtype=torch.int32)
    with pytest.raises(TypeError, match="tuple"):
        windowing.align_pairs(t, n, t, n, cfg=cfg, max_read_len=8,
                              mesh=mesh)
    with pytest.raises(TypeError, match="2 pair shards"):
        windowing.align_pairs((t,) * 3, (n,) * 3, (t,) * 3, (n,) * 3,
                              cfg=cfg, max_read_len=8, mesh=mesh)
    meta = t.to("meta")
    with pytest.raises(ValueError, match="shard 1"):
        windowing.align_pairs((t, meta), (n, n), (t, t), (n, n), cfg=cfg,
                              max_read_len=8, mesh=mesh)
    cuda = make_test_mesh((2,), ("data",), devices=["cuda:0"] * 2)
    with pytest.raises(ValueError, match="cuda"):
        GenASMAligner(cfg, device="cpu", mesh=cuda)
    with pytest.raises(TypeError, match="tuple"):
        GenASMAligner(cfg, device="cpu", mesh=(8,))


# --------------------------------------------------------------------------
# the mesh and the sharding arithmetic
# --------------------------------------------------------------------------

SHAPES = {(1,): ("data",), (8,): ("data",), (4, 2): ("data", "model"),
          (2, 4, 2): ("pod", "data", "model")}


def _stand_in(mesh: DeviceMesh):
    """The reference's view of a port mesh: axis_names, shape and devices
    with ids, without JAX devices."""
    devices = np.empty(mesh.devices.shape, dtype=object)
    for idx, d in np.ndenumerate(mesh.devices):
        devices[idx] = types.SimpleNamespace(id=d.index or 0)
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 shape=dict(mesh.shape), devices=devices)


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
def test_sharding_arithmetic_equals_reference(shape):
    """n_pair_shards, pair_axes, pair_pad_multiple, quantise_lanes,
    bucket_lanes, lane_classes and mesh_fingerprint equal the reference's
    on a stand-in of the same mesh, on each backend; batch_axes too."""
    axes = SHAPES[shape]
    n_dev = int(np.prod(shape))
    meshes = [cpu_mesh(shape, axes), make_test_mesh(
        shape, axes, devices=[f"cuda:{i}" for i in range(n_dev)])]
    for mesh in meshes:
        ref = _stand_in(mesh)
        assert sharding.n_pair_shards(mesh) == ref_sharding.n_pair_shards(ref)
        assert sharding.pair_axes(mesh) == ref_sharding.pair_axes(ref)
        assert batch_axes(mesh) == ref_mesh.batch_axes(ref)
        assert sharding.mesh_fingerprint(mesh) == \
            ref_sharding.mesh_fingerprint(ref)
        for backend in ("pallas_fused", "pallas", "jnp"):
            ref_cfg, cfg = cfg_pair(backend=backend, **FIELDS)
            assert sharding.pair_pad_multiple(cfg, mesh) == \
                ref_sharding.pair_pad_multiple(ref_cfg, ref)
            for n in (1, 3, 30, 33, 100):
                for fn in ("quantise_lanes", "bucket_lanes"):
                    assert getattr(sharding, fn)(n, cfg, mesh) == \
                        getattr(ref_sharding, fn)(n, ref_cfg, ref), (fn, n)
                assert sharding.lane_classes(n, cfg, mesh) == \
                    ref_sharding.lane_classes(n, ref_cfg, ref)
    cpu_fp, cuda_fp = (sharding.mesh_fingerprint(m) for m in meshes)
    assert cpu_fp[2] == (0,) * n_dev and cuda_fp[2] == tuple(range(n_dev))


def test_pair_shards_take_the_reference_boundaries():
    """Shard s of a B-lane batch takes [s*B'/n, (s+1)*B'/n) with
    B' = ceil(B / unit) * unit, in pod-major shard order, on the device
    at model index 0 of its row; empty shards left out."""
    _, cfg = cfg_pair(**FIELDS)
    names = [f"cuda:{i}" for i in range(16)]
    mesh = make_test_mesh((2, 4, 2), ("pod", "data", "model"), names)
    assert sharding.pair_devices(mesh) == tuple(
        torch.device(f"cuda:{2 * s}") for s in range(8))
    shards = sharding.pair_shards(30, cfg, mesh)
    assert [(str(d), sl.start, sl.stop) for d, sl in shards] == [
        (f"cuda:{2 * s}", 4 * s, min(4 * s + 4, 30)) for s in range(8)]
    shards = sharding.pair_shards(70, cfg, mesh)       # B' = 96, 12 a shard
    assert [sl.stop - sl.start for _, sl in shards] == [12] * 5 + [10]
    assert sharding.pair_shards(30, cfg, None) is None
    model_only = cpu_mesh((4,), ("model",))
    assert [sl for _, sl in sharding.pair_shards(30, cfg, model_only)] == \
        [slice(0, 30)]


def test_make_test_mesh():
    """Shape and device count must agree; the devices are listed by the
    caller, repeats included; equal meshes hash equal."""
    mesh = cpu_mesh((4, 2), ("data", "model"))
    assert mesh.shape == {"data": 4, "model": 2}
    assert list(mesh.shape) == ["data", "model"] and mesh.size == 8
    assert mesh.devices.shape == (4, 2)
    assert all(d == CPU for d in mesh.devices.flat)
    assert mesh == cpu_mesh((4, 2), ("data", "model"))
    assert hash(mesh) == hash(cpu_mesh((4, 2), ("data", "model")))
    assert mesh != cpu_mesh((8,))
    with pytest.raises(ValueError, match="needs 8 devices, got 4"):
        make_test_mesh((4, 2), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="axis_names"):
        make_test_mesh((2,), ("rows",), devices=[CPU] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="got 0"):
            make_test_mesh((2,), ("data",))
    assert batch_axes(cpu_mesh((1, 2, 1), ("pod", "data", "model"))) == \
        ("pod", "data")
