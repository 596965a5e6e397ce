"""The port's read mapper (``repro_torch.mapper``) on the CPU, mirroring the
reference's tests/test_mapper.py test for test, then held against the
reference mapper (``repro.mapper``) in the same process:

* the minimizer index, ``kmer_hashes`` / ``minimizers`` and
  ``chain_anchors`` give the reference's arrays and candidates exactly;
* ``xdrop_extend`` (a PyTorch wavefront) gives the reference's int32
  scores exactly on random packed batches (Hypothesis: all-sentinel lanes,
  empty reads, band 4 and 16);
* ``candidate_chains`` and ``plant_decoys`` give the reference's data at
  fixed seeds;
* ``ReadMapper.map_batch`` gives the reference's ``MappedRead``s and
  funnel stats field for field, and its CIGARs are bit-identical to a
  direct session.align of the same pairs.

Small geometry (W=32 on the plain backend — the reference's ``jnp`` —
and 400 bp reads) keeps this fast.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import genome as ref_genome
from repro.mapper import MapperConfig as RefMapperConfig
from repro.mapper import ReadMapper as RefReadMapper
from repro.mapper import chain_anchors as ref_chain_anchors
from repro.mapper import index as ref_index
from repro.mapper import pack_pairs as ref_pack_pairs
from repro.mapper import xdrop_extend as ref_xdrop_extend
from repro_torch.api import plan
from repro_torch.convert import mapper_config_from_reference
from repro_torch.core import transfer
from repro_torch.data.genome import (ReadSimConfig, candidate_chains,
                                     plant_decoys, simulate_reads,
                                     synth_genome)
from repro_torch.mapper import (MapperConfig, MinimizerIndex, ReadMapper,
                                chain_anchors, minimizers, pack_pairs,
                                xdrop_extend)
from repro_torch.mapper import index as port_index
from tests._hyp import given, settings, st

SESSION_KW = dict(backend="plain", W=32, O=12, k=8, rescue_rounds=2,
                  batch_lanes=16, device="cpu")
REF_SESSION_KW = dict(SESSION_KW, backend="jnp")
del REF_SESSION_KW["device"]


@pytest.fixture(scope="module")
def world():
    """Genome with planted partial-repeat decoys + simulated reads."""
    g = synth_genome(120_000, seed=21)
    cfg = ReadSimConfig(read_len=400, error_rate=0.10, seed=22)
    rs = simulate_reads(g, 24, cfg)
    g2, decoy_pos = plant_decoys(g, rs, decoys_per_read=4, chunk=160,
                                 divergence=0.03, seed=23)
    return g2, rs, decoy_pos


@pytest.fixture(scope="module")
def mapped(world):
    g2, rs, _ = world
    with ReadMapper(g2, **SESSION_KW) as m:
        out = m.map_batch(rs.reads)
        cands = [m.candidates(r) for r in rs.reads]
    return out, cands


# -- units -----------------------------------------------------------------

def test_minimizers_shared_on_identical_stretches():
    """Two sequences sharing an error-free stretch >= w + k - 1 select at
    least one common minimizer inside it."""
    rng = np.random.default_rng(1)
    core = rng.integers(0, 4, 60).astype(np.uint8)
    a = np.concatenate([rng.integers(0, 4, 37).astype(np.uint8), core])
    b = np.concatenate([rng.integers(0, 4, 11).astype(np.uint8), core])
    ha, _ = minimizers(a, 13, 8)
    hb, _ = minimizers(b, 13, 8)
    assert len(np.intersect1d(ha, hb)) >= 1
    # sentinel-poisoned k-mers never become minimizers
    c = a.copy()
    c[45] = 255
    _, pc = minimizers(c, 13, 8)
    assert all(not (p <= 45 < p + 13) for p in pc)


def test_index_anchors_lie_on_true_diagonal():
    g = synth_genome(50_000, seed=2)
    idx = MinimizerIndex.build(g)
    read = g[7000:7400].copy()
    qpos, rpos = idx.anchors(read)
    assert len(qpos) >= 10
    assert np.all(rpos - qpos == 7000)      # exact copy: one diagonal
    st_ = idx.stats()
    assert st_["n_minimizers"] > 0 and 0.1 < st_["density"] < 0.5


def test_chain_extrapolates_candidate_window():
    # anchors on diagonal 5000 with +-2 indel drift, plus a stray cluster
    q = np.array([40, 120, 200, 290, 360, 50, 60])
    r = np.array([5040, 5121, 5198, 5292, 5360, 9050, 9061])
    cands = chain_anchors(q, r, read_len=400, min_anchors=3)
    assert len(cands) == 1                   # stray pair < min_anchors
    c = cands[0]
    assert abs(c.ref_start - 5000) <= 4
    assert abs(c.ref_end - 5400) <= 4
    assert c.score == 5


def test_xdrop_separates_true_from_decoy():
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 4, 160).astype(np.uint8)
    read = seg[:128].copy()
    read[::10] = (read[::10] + 1) % 4        # ~10% mismatches
    decoy = rng.integers(0, 4, 160).astype(np.uint8)
    reads, refs = pack_pairs([read, read], [seg, decoy], 128, 16, lanes=16)
    scores = xdrop_extend(reads, refs, band=16, x_drop=24, device="cpu")
    true_s, decoy_s = int(scores[0]), int(scores[1])
    assert true_s >= 0.25 * 128              # survives the keep threshold
    assert decoy_s < 0.25 * 128              # frozen early, killed
    assert np.all(scores[2:] == 0)           # all-sentinel pad lanes


# -- end to end ------------------------------------------------------------

def test_mapper_recall_and_precision_on_decoy_rich_reads(world, mapped):
    g2, rs, decoy_pos = world
    out, _ = mapped
    st_ = out.stats
    assert st_["n_reads"] == 24
    # decoys seeded extra candidates, and the pre-filter killed them
    assert st_["n_candidates"] > st_["n_reads"]
    assert st_["n_killed"] > 0 and st_["kill_rate"] > 0.2
    hits = sum(1 for mr, tp in zip(out.mapped, rs.true_pos)
               if mr.ok and abs(mr.ref_start - tp) <= 20)
    assert hits / st_["n_reads"] >= 0.95     # recall floor
    for mr in out.mapped:                    # precision: never a decoy
        if mr.ok:
            i = mr.read_id
            assert all(abs(mr.ref_start - dp) > 50 for dp in decoy_pos[i])
    # decoy-locus candidates were specifically the killed ones
    killed_starts = [c.ref_start for mr in out.mapped
                     for c in mr.candidates if c.killed]
    assert any(any(abs(ks - dp) < 200 for dp in decoy_pos.ravel())
               for ks in killed_starts)


def test_mapper_cigars_bit_identical_to_direct_session(world, mapped):
    """For each mapped read, aligning the SAME (read,
    genome[c.ref_start:c.ref_end]) pair through a fresh session yields the
    same cigar/dist byte for byte."""
    g2, rs, _ = world
    out, cands = mapped
    pairs = []
    for mr in out.mapped[:8]:
        if not mr.ok:
            continue
        c = next(c for c in cands[mr.read_id]
                 if c.ref_start == mr.ref_start)
        pairs.append((mr, rs.reads[mr.read_id], g2[c.ref_start:c.ref_end]))
    assert len(pairs) >= 6
    with plan(**SESSION_KW) as s:
        res = s.align([p[1] for p in pairs], [p[2] for p in pairs])
    for (mr, _, _), cig, dist in zip(pairs, res.cigars, res.dist):
        assert mr.cigar == cig
        assert mr.dist == int(dist)


def test_mapper_prefilter_off_maps_same_loci(world, mapped):
    """With the pre-filter disabled nothing is killed; decoy candidates
    just fail to align inside the k ladder, so the chosen loci match the
    filtered run."""
    g2, rs, _ = world
    out, _ = mapped
    cfg = MapperConfig(prefilter=False)
    with ReadMapper(g2, cfg, **SESSION_KW) as m:
        out2 = m.map_batch(rs.reads[:5])
    assert out2.stats["n_killed"] == 0
    assert out2.stats["n_aligned"] == out2.stats["n_candidates"]
    for a, b in zip(out.mapped[:5], out2.mapped):
        assert (a.ok, a.ref_start) == (b.ok, b.ref_start)


def test_mapper_handles_unmappable_and_string_reads(world):
    g2, _, _ = world
    with ReadMapper(g2, **SESSION_KW) as m:
        junk = "".join("ACGT"[i % 4] for i in range(200))  # low-complexity
        mr = m.map_read(junk)
        assert not mr.ok and mr.ref_start == -1 and mr.cigar == ""
        # a genuine string read maps
        real = "".join("ACGT"[c] for c in g2[11000:11300])
        mr2 = m.map_read(real)
        assert mr2.ok and abs(mr2.ref_start - 11000) <= 8


# -- the port against the reference ----------------------------------------

@pytest.mark.parametrize("k,w", [(13, 8), (5, 3), (28, 1), (15, 20)])
def test_index_arrays_equal_reference(k, w):
    g = synth_genome(60_000, seed=k)
    g[[100, 5000, 5001, 40_000]] = [9, 255, 4, 9]    # sentinels poison k-mers
    np.testing.assert_array_equal(port_index.kmer_hashes(g, k),
                                  ref_index.kmer_hashes(g, k))
    for got, want in zip(minimizers(g, k, w), ref_index.minimizers(g, k, w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    idx = MinimizerIndex.build(g, k=k, w=w, max_occ=4)
    ref = ref_index.MinimizerIndex.build(g, k=k, w=w, max_occ=4)
    np.testing.assert_array_equal(idx.hashes, ref.hashes)
    np.testing.assert_array_equal(idx.positions, ref.positions)
    assert idx.stats() == ref.stats() and idx.genome_len == ref.genome_len
    read = g[20_000:20_500].copy()
    read[::7] = (read[::7] + 1) % 4
    for got, want in zip(idx.anchors(read), ref.anchors(read)):
        np.testing.assert_array_equal(got, want)
    assert len(minimizers(g[:3], k, w)[0]) == 0 == \
        len(ref_index.minimizers(g[:3], k, w)[0])


def test_chain_anchors_equal_reference():
    rng = np.random.default_rng(9)
    found = 0
    for trial in range(20):
        n = int(rng.integers(0, 80))
        qpos = rng.integers(0, 1000, n)
        diag = rng.choice([5000, 20_000, 20_040, 90_000], n) + \
            rng.integers(-6, 7, n)
        rpos = qpos + diag
        read_len = int(rng.integers(200, 1200))
        kw = dict(min_anchors=int(rng.integers(1, 5)),
                  max_candidates=int(rng.integers(1, 9)),
                  genome_len=int(rng.choice([95_000, 10**6])))
        got = [dataclasses.astuple(c)
               for c in chain_anchors(qpos, rpos, read_len, **kw)]
        want = [dataclasses.astuple(c)
                for c in ref_chain_anchors(qpos, rpos, read_len, **kw)]
        assert got == want, trial
        found += len(got)
    assert found > 0


@settings(max_examples=12, deadline=None)
@given(st.integers(1, 24), st.integers(1, 40), st.integers(0, 1),
       st.integers(0, 10**6))
def test_xdrop_extend_equals_reference(n, seg_len, band_pick, seed):
    """Random packed batches: true-locus slices with substitutions and
    indels, random decoys, empty reads and all-sentinel pad lanes."""
    band = (4, 16)[band_pick]
    rng = np.random.default_rng(seed)
    reads, refs = [], []
    for _ in range(n):
        read = rng.integers(0, 4, int(rng.integers(0, seg_len + 1)))
        kind = rng.integers(0, 3)
        if kind == 0:
            ref = rng.integers(0, 4, seg_len + band)
        else:
            ref = np.concatenate([read, rng.integers(0, 4, band)])
            ref[rng.random(len(ref)) < 0.1] = rng.integers(0, 4)
            if kind == 2 and len(ref) > 4:
                ref = np.delete(ref, rng.integers(0, len(ref), 2))
        reads.append(read.astype(np.uint8))
        refs.append(ref.astype(np.uint8))
    lanes = n + int(rng.integers(0, 4))
    pr, pf = pack_pairs(reads, refs, seg_len, band, lanes=lanes)
    rr, rf = ref_pack_pairs(reads, refs, seg_len, band, lanes=lanes)
    np.testing.assert_array_equal(pr, rr)
    np.testing.assert_array_equal(pf, rf)
    x_drop = int(rng.choice([3, 24]))
    got = xdrop_extend(pr, pf, band=band, x_drop=x_drop, device="cpu")
    want = np.asarray(ref_xdrop_extend(rr, rf, band=band, x_drop=x_drop))
    assert got.dtype == np.int32 and got.shape == (lanes,)
    np.testing.assert_array_equal(got, want)
    assert np.all(got[n:] == 0)              # all-sentinel pad lanes


def test_xdrop_extend_moves_once_each_way_and_refuses_absent_cuda(
        monkeypatch):
    pr, pf = pack_pairs([np.zeros(8, np.uint8)], [np.zeros(12, np.uint8)],
                        8, 4, lanes=2)
    transfer.reset()
    assert xdrop_extend(pr, pf, band=4, device="cpu").tolist() == [8, 0]
    moved = transfer.stats()
    assert (moved.h2d_calls, moved.d2h_calls) == (1, 1)
    assert moved.h2d_bytes == pr.nbytes + pf.nbytes
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        xdrop_extend(pr, pf, band=4)


def test_world_data_equals_reference(world):
    """candidate_chains and plant_decoys: the reference's data at the same
    seeds (the world fixture's genome, reads and planted decoys)."""
    g2, rs, decoy_pos = world
    g = ref_genome.synth_genome(120_000, seed=21)
    ref_rs = ref_genome.simulate_reads(g, 24, ref_genome.ReadSimConfig(
        read_len=400, error_rate=0.10, seed=22))
    ref_g2, ref_pos = ref_genome.plant_decoys(g, ref_rs, decoys_per_read=4,
                                              chunk=160, divergence=0.03,
                                              seed=23)
    np.testing.assert_array_equal(g2, ref_g2)
    np.testing.assert_array_equal(decoy_pos, ref_pos)
    for kw in (dict(), dict(decoys_per_read=3, seed=5)):
        got = candidate_chains(g2, rs, **kw)
        want = ref_genome.candidate_chains(ref_g2, ref_rs, **kw)
        assert [i for i, _ in got] == [i for i, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    small, small_pos = plant_decoys(g, rs, decoys_per_read=2, seed=3)
    ref_small, ref_small_pos = ref_genome.plant_decoys(g, ref_rs,
                                                       decoys_per_read=2,
                                                       seed=3)
    np.testing.assert_array_equal(small, ref_small)
    np.testing.assert_array_equal(small_pos, ref_small_pos)


def test_map_batch_equals_reference(world, mapped):
    """The port's MappedReads and funnel stats equal the reference
    mapper's field for field (config built from the reference's value)."""
    g2, rs, _ = world
    out, _ = mapped
    with RefReadMapper(g2, **REF_SESSION_KW) as m:
        want = m.map_batch(rs.reads)
    assert out.stats == want.stats
    assert [dataclasses.astuple(mr) for mr in out.mapped] == \
        [dataclasses.astuple(mr) for mr in want.mapped]
    ref_cfg = RefMapperConfig(max_candidates=3, x_drop=12, seg_len=96)
    cfg = mapper_config_from_reference(dataclasses.asdict(ref_cfg))
    with ReadMapper(g2, cfg, **SESSION_KW) as m, \
            RefReadMapper(g2, ref_cfg, **REF_SESSION_KW) as rm:
        got, want = m.map_batch(rs.reads[:6]), rm.map_batch(rs.reads[:6])
    assert got.stats == want.stats
    assert [dataclasses.astuple(mr) for mr in got.mapped] == \
        [dataclasses.astuple(mr) for mr in want.mapped]
