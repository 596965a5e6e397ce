"""The port's aligner (plain PyTorch path, ``device="cpu"``) against the
reference ``GenASMAligner``, field for field, each port backend against
its counterpart: 'fused' against ``pallas_fused`` and 'split' against
``pallas`` on the differential corpus (both rescue modes), 'fused' on the
300 bp readset whose read 0 needs the k = 24 rescue rung (K1 at nwb = 2
and K4 on the path), and 'plain' with each store against ``jnp`` on the
same readset.  Also the windowing helpers, the rescue ladder's level and
round counts, the transfer contract, the read simulator and the
oracle."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import windowing as ref_win
from repro.core.cigar import ops_to_string as ref_ops_to_string
from repro.core.config import AlignerConfig as RefConfig
from repro.core.oracle import levenshtein as ref_levenshtein
from repro.data import genome as ref_genome
from repro_torch.convert import config_from_reference
from repro_torch.core import windowing
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.cigar import ops_to_string
from repro_torch.core.oracle import levenshtein, validate_cigar
from repro_torch.data import genome
from tests.test_differential import CFG, ROUNDS
from tests.test_torch_config import cfg_pair


def assert_results_equal(port, ref):
    for field in ("dist", "failed", "k_used", "read_consumed",
                  "ref_consumed"):
        np.testing.assert_array_equal(getattr(port, field),
                                      getattr(ref, field), err_msg=field)
    assert port.cigars == ref.cigars
    assert len(port.ops) == len(ref.ops)
    for i, (a, b) in enumerate(zip(port.ops, ref.ops)):
        np.testing.assert_array_equal(a, b, err_msg=f"ops of lane {i}")


def _port_cfg(ref_cfg):
    return config_from_reference(dataclasses.asdict(ref_cfg))


def _corpus_equals_reference(corpus, diff_aligned, rescue_mode, backend):
    reads, refs, _ = corpus
    ref = diff_aligned(backend, rescue_mode)
    cfg = _port_cfg(dataclasses.replace(CFG, backend=backend))
    assert cfg.backend == {"pallas_fused": "fused", "pallas": "split",
                           "jnp": "plain"}[backend]
    aligner = GenASMAligner(cfg, rescue_rounds=ROUNDS,
                            rescue_mode=rescue_mode, device="cpu")
    port = aligner.align(reads, refs)
    assert_results_equal(port, ref)
    assert port.failed.any() and not port.failed.all()
    assert (port.k_used > CFG.k).any()                # the rescue rung ran
    t = aligner.transfers
    if rescue_mode == "device":
        assert (t.h2d_calls, t.d2h_calls) == (1, 1)
        assert t.gate_syncs == ROUNDS
    else:
        assert t.h2d_calls == t.d2h_calls == ROUNDS + 1
        assert t.gate_syncs == 0


@pytest.mark.parametrize("rescue_mode", ["device", "host"])
def test_differential_corpus_equals_reference(corpus, diff_aligned,
                                              rescue_mode):
    """backend='fused' against the reference's pallas_fused."""
    _corpus_equals_reference(corpus, diff_aligned, rescue_mode,
                             "pallas_fused")


@pytest.mark.parametrize("rescue_mode", ["device", "host"])
def test_differential_corpus_split_equals_reference(corpus, diff_aligned,
                                                    rescue_mode):
    """backend='split' (K3 + the PyTorch traceback) against the
    reference's split backend 'pallas'."""
    _corpus_equals_reference(corpus, diff_aligned, rescue_mode, "pallas")


@pytest.mark.parametrize("rescue_mode", ["device", "host"])
def test_differential_corpus_plain_equals_reference(corpus, diff_aligned,
                                                    rescue_mode):
    """backend='plain' (no kernel) against the reference's jnp."""
    _corpus_equals_reference(corpus, diff_aligned, rescue_mode, "jnp")


def test_readset_with_k24_rescue_equals_reference(readset, aligned):
    ref_cfg = RefConfig(backend="pallas_fused")
    ref = aligned(ref_cfg)
    port = GenASMAligner(_port_cfg(ref_cfg), rescue_rounds=1,
                         device="cpu").align(readset.reads,
                                             readset.ref_segments)
    assert_results_equal(port, ref)
    assert port.k_used[0] == 24 and not port.failed.any()


@pytest.mark.parametrize("store,early_term", [
    ("band", True), ("and", True), ("edges4", False)])
def test_readset_plain_backend_equals_reference_jnp(readset, aligned, store,
                                                    early_term):
    """backend='plain' (the PyTorch fills and traceback) with each store
    against the reference's jnp aligner, k = 24 rescue rung included."""
    ref_cfg = RefConfig(W=64, O=24, k=12, store=store, early_term=early_term)
    ref = aligned(ref_cfg)
    cfg = _port_cfg(ref_cfg)
    assert (cfg.backend, cfg.store) == ("plain", store)
    port = GenASMAligner(cfg, rescue_rounds=1, device="cpu").align(
        readset.reads, readset.ref_segments)
    assert_results_equal(port, ref)
    assert port.k_used[0] == 24 and not port.failed.any()


def test_split_equals_fused_in_the_port(corpus):
    """The port's own backends agree with each other, the level count of
    the ladder included."""
    reads, refs, _ = corpus
    runs = {}
    for backend in ("fused", "split"):
        aligner = GenASMAligner(_port_cfg(CFG), rescue_rounds=ROUNDS,
                                backend=backend, device="cpu")
        runs[backend] = (aligner.align(reads, refs), aligner.last_run)
    assert_results_equal(runs["split"][0], runs["fused"][0])
    assert runs["split"][1]["levels_run_total"] == \
        runs["fused"][1]["levels_run_total"]
    assert runs["split"][1]["rounds_run"] == runs["fused"][1]["rounds_run"]


def test_rescue_ladder_levels_and_rounds_equal_reference(corpus,
                                                         diff_aligned):
    """align_pairs_rescued's level and round counts, on the arrays the
    device-mode aligner uploads (the reference call hits the jit cache the
    aligner filled)."""
    reads, refs, _ = corpus
    diff_aligned("pallas_fused", "device")
    ref_cfg, cfg = cfg_pair(W=CFG.W, O=CFG.O, k=CFG.k)
    max_len = max(len(r) for r in reads)
    Lr, Lf = windowing.pad_geometry(cfg, max_len, max(len(f) for f in refs),
                                    ROUNDS)
    arrays = (*GenASMAligner._pad(reads, Lr, windowing.SENTINEL_READ),
              *GenASMAligner._pad(refs, Lf, windowing.SENTINEL_REF))
    ref = ref_win.align_pairs_rescued(*map(jnp.asarray, arrays), cfg=ref_cfg,
                                      max_read_len=max_len,
                                      rescue_rounds=ROUNDS)
    port = windowing.align_pairs_rescued(*map(torch.from_numpy, arrays),
                                         cfg=cfg, max_read_len=max_len,
                                         rescue_rounds=ROUNDS)
    assert int(port["levels_run_total"]) == int(ref["levels_run_total"])
    assert port["rounds_run"] == int(ref["rounds_run"]) == ROUNDS + 1
    assert port["n_rounds"] == int(ref["n_rounds"])
    for key in ("ops", "n_ops", "dist", "failed", "k_used", "read_consumed",
                "ref_consumed"):
        np.testing.assert_array_equal(port[key].numpy(),
                                      np.asarray(ref[key]), err_msg=key)


def test_windowing_geometry_equals_reference():
    for W, O, k in ((16, 6, 4), (64, 24, 12), (64, 40, 48)):
        ref_cfg, cfg = cfg_pair(W=W, O=O, k=k)
        for rounds in (0, 1, 2, 5):
            assert [c.k for c in windowing.rescue_schedule(cfg, rounds)] == \
                [c.k for c in ref_win.rescue_schedule(ref_cfg, rounds)]
            assert windowing.pad_geometry(cfg, 300, 330, rounds) == \
                ref_win.pad_geometry(ref_cfg, 300, 330, rounds)
        for L in (0, W, W + 1, 300, 10_000):
            assert windowing.n_main_windows(L, cfg) == \
                ref_win.n_main_windows(L, ref_cfg)
            assert windowing.total_op_budget(L, cfg) == \
                ref_win.total_op_budget(L, ref_cfg)
        assert windowing.self_tail_width(cfg) == \
            ref_win.self_tail_width(ref_cfg)


def test_slice_rev_equals_reference():
    rng = np.random.default_rng(3)
    seq = rng.integers(0, 4, (12, 40)).astype(np.uint8)
    width = 16
    pos = rng.integers(0, 40, 12).astype(np.int32)      # some clamp at the end
    length = rng.integers(0, width + 1, 12).astype(np.int32)
    ref = ref_win._slice_rev(jnp.asarray(seq), jnp.asarray(pos), width,
                             jnp.asarray(length))
    port = windowing._slice_rev(torch.from_numpy(seq), torch.from_numpy(pos),
                                width, torch.from_numpy(length))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_append_ops_equals_reference():
    rng = np.random.default_rng(4)
    B, width, max_w = 9, 20, 8
    buf = rng.integers(0, 4, (B, width)).astype(np.uint8)
    ops = rng.integers(0, 4, (B, max_w)).astype(np.uint8)
    off = rng.integers(0, width, B).astype(np.int32)     # some run off the end
    nops = rng.integers(0, max_w + 3, B).astype(np.int32)  # some > max_w
    active = rng.random(B) < 0.7
    ref = ref_win._append_ops(jnp.asarray(buf), jnp.asarray(off),
                              jnp.asarray(ops), jnp.asarray(nops),
                              jnp.asarray(active))
    port_buf = torch.from_numpy(np.pad(buf, ((0, 0), (0, 1))))  # drop slot
    windowing._append_ops(port_buf, torch.from_numpy(off),
                          torch.from_numpy(ops), torch.from_numpy(nops),
                          torch.from_numpy(active))
    np.testing.assert_array_equal(port_buf[:, :width].numpy(),
                                  np.asarray(ref))


def test_read_simulator_same_reads_as_reference():
    g = genome.synth_genome(30_000, seed=11)
    np.testing.assert_array_equal(g, ref_genome.synth_genome(30_000, seed=11))
    for cfg_kw in (dict(read_len=500, seed=3),
                   dict(read_len=800, error_rate=0.15, del_frac=0.6, seed=4)):
        port = genome.simulate_reads(g, 5, genome.ReadSimConfig(**cfg_kw))
        ref = ref_genome.simulate_reads(g, 5,
                                        ref_genome.ReadSimConfig(**cfg_kw))
        for a, b in zip(port.reads + port.ref_segments,
                        ref.reads + ref.ref_segments):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(port.true_pos, ref.true_pos)
        np.testing.assert_array_equal(port.spans, ref.spans)


def test_oracle_and_cigar_equal_reference():
    rng = np.random.default_rng(5)
    for _ in range(5):
        p = rng.integers(0, 4, 15)
        t = rng.integers(0, 4, int(rng.integers(10, 20)))
        assert levenshtein(p, t) == ref_levenshtein(p, t)
    ops = np.array([0, 0, 1, 3, 3, 2, 0], np.uint8)
    assert ops_to_string(ops) == ref_ops_to_string(ops) == "2=1X2D1I1="
    validate_cigar(np.array([0, 1]), np.array([0, 2]), [0, 1],
                   expected_dist=1)
    with pytest.raises(AssertionError):
        validate_cigar(np.array([0, 1]), np.array([0, 2]), [0, 0])
