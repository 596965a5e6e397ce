"""The plain versions of the kernels K1, K2, K4 and K3 against the JAX
kernels, run as the reference's own tests run them (Pallas interpret mode
on the CPU).  Every output must be equal: the DP is integer bitvector
arithmetic, so the tolerance is zero.  B = 37 is not a multiple of the
lane tile, so the batch padding is on the path too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import genasm_dc_op as ref_dc_op
from repro.kernels.ops import genasm_tail_fused_op as ref_tail_op
from repro.kernels.ops import genasm_tb_fused_op as ref_tb_op
from repro.kernels.ref import genasm_dc_ref as ref_dc_ref
from repro_torch.core.bitops import SENTINEL_TEXT
from repro_torch.kernels import genasm_dc
from repro_torch.kernels.ops import (genasm_dc_op, genasm_tail_fused_op,
                                     genasm_tb_fused_op)
from repro_torch.kernels.ref import genasm_dc_ref
from tests.conftest import mutate_seq
from tests.test_torch_config import cfg_pair

B = 37
FIELDS = ("ops", "n_ops", "read_adv", "ref_adv", "cost", "ok", "d_final",
          "dist", "solved", "levels")


def _assert_equal(port, ref):
    for key in FIELDS:
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
        assert port[key].numpy().dtype == np.asarray(ref[key]).dtype, key


def _n_edits(rng, b, k):
    """Mostly within k (solved lanes), every fifth lane far past it."""
    return 2 * k + 4 if b % 5 == 4 else int(rng.integers(0, k + 3))


def _square_batch(rng, W, k):
    """Mutated windows; where k >= W/2 even random windows lie within k,
    so the far lanes get an all-sentinel text (W substitutions > k)."""
    pats, txts = [], []
    for b in range(B):
        p = rng.integers(0, 4, W).astype(np.uint8)
        pats.append(p)
        t = mutate_seq(p, _n_edits(rng, b, k), rng, extend_to=W)
        if b % 5 == 4 and 2 * k >= W:
            t = np.full(W, SENTINEL_TEXT, np.uint8)
        txts.append(t)
    return np.stack(pats), np.stack(txts)


def _tail_batch(rng, W, k):
    """Ragged tails: m_len in [0, W], texts a few edits away (or far past
    k), a few cut short, sentinel-padded."""
    n_text = W + 4 * k
    pats = np.full((B, W), 255, np.uint8)
    txts = np.full((B, n_text), 9, np.uint8)
    m_len = np.zeros(B, np.int32)
    n_len = np.zeros(B, np.int32)
    for b in range(B):
        m = int(rng.integers(0, W + 1))
        p = rng.integers(0, 4, m).astype(np.uint8)
        t = mutate_seq(p, _n_edits(rng, b, k), rng)[:n_text]
        if rng.random() < 0.2:
            t = t[:max(0, len(t) - int(rng.integers(1, 6)))]
        pats[b, :m], txts[b, :len(t)] = p, t
        m_len[b], n_len[b] = m, len(t)
    return pats, txts, m_len, n_len


@pytest.mark.parametrize("W,O,k", [(16, 6, 4), (32, 12, 20), (64, 24, 12),
                                   (64, 24, 24), (64, 24, 48), (96, 36, 24)])
def test_k1_tb_fused_equals_reference(W, O, k):
    ref_cfg, cfg = cfg_pair(W=W, O=O, k=k)
    pat, txt = _square_batch(np.random.default_rng(W + k), W, k)
    kw = dict(commit_limit=cfg.stride, max_ops=cfg.tb_max_ops,
              max_steps=cfg.tb_max_steps)
    ref = ref_tb_op(jnp.asarray(pat), jnp.asarray(txt), cfg=ref_cfg, **kw)
    before = dict(genasm_dc.PLAIN_CALLS)
    port = genasm_tb_fused_op(torch.from_numpy(pat), torch.from_numpy(txt),
                              cfg=cfg, **kw)
    assert genasm_dc.PLAIN_CALLS["tb_fused"] == before["tb_fused"] + 1
    _assert_equal(port, ref)
    assert 0 < int(port["solved"].sum()) < B       # both outcomes covered


@pytest.mark.parametrize("W,O,k,tail_store,kernel", [
    (64, 24, 12, "auto", "tail_banded"),
    (16, 6, 4, "auto", "tail_full"),
    (64, 24, 24, "auto", "tail_full"),
    (64, 24, 12, "full", "tail_full"),
    (64, 24, 48, "auto", "tail_full"),
    (40, 16, 12, "auto", "tail_banded"),      # m_pad > W
    (48, 16, 12, "auto", "tail_banded"),
    (96, 36, 24, "auto", "tail_banded"),      # NW = 3
])
def test_k2_k4_tail_equals_reference(W, O, k, tail_store, kernel):
    ref_cfg, cfg = cfg_pair(W=W, O=O, k=k, tail_store=tail_store)
    assert (kernel == "tail_banded") == cfg.tail_banded == ref_cfg.tail_banded
    pat, txt, m_len, n_len = _tail_batch(np.random.default_rng(3 * k + W),
                                         W, k)
    n_text = W + 4 * k
    kw = dict(n_text=n_text, commit_limit=2 * (W + n_text),
              max_ops=W + n_text, max_steps=W + n_text + 4)
    ref = ref_tail_op(jnp.asarray(pat), jnp.asarray(txt),
                      jnp.asarray(m_len), jnp.asarray(n_len), cfg=ref_cfg,
                      **kw)
    before = dict(genasm_dc.PLAIN_CALLS)
    port = genasm_tail_fused_op(torch.from_numpy(pat), torch.from_numpy(txt),
                                torch.from_numpy(m_len),
                                torch.from_numpy(n_len), cfg=cfg, **kw)
    assert genasm_dc.PLAIN_CALLS[kernel] == before[kernel] + 1
    _assert_equal(port, ref)
    assert 0 < int(port["solved"].sum()) < B


@pytest.mark.parametrize("W,k,tile,n_pairs", [
    (16, 3, 4, 4), (32, 7, 8, 8), (32, 15, 8, 8), (64, 12, 8, 8),
    (96, 9, 4, 4), (32, 7, 4, 5), (64, 40, 4, 4), (128, 12, 4, 4)])
def test_k3_dc_op_equals_reference(W, k, tile, n_pairs):
    """The grid of tests/test_kernels.py plus a batch that is not a lane
    tile multiple, KP = 64 with its top levels idle (k = 40) and NW = 4
    (W = 128).  K3 and the reference's Pallas kernel fill every level,
    so the whole band is equal; dc_dmajor (``genasm_dc_ref``) leaves the
    levels from the level count up at zero, so it is held on the band
    below it."""
    ref_cfg, cfg = cfg_pair(backend="pallas", W=W, O=max(1, W // 3), k=k,
                            lane_tile=tile)
    rng = np.random.default_rng(W * k + n_pairs)
    pat = rng.integers(0, 4, (n_pairs, W)).astype(np.uint8)
    txt = np.stack([mutate_seq(p, int(rng.integers(0, k + 2)), rng,
                               extend_to=W) for p in pat])
    d_ref, band_ref, lvl_ref = ref_dc_op(jnp.asarray(pat), jnp.asarray(txt),
                                         cfg=ref_cfg, tile=tile,
                                         interpret=True)
    before = dict(genasm_dc.PLAIN_CALLS)
    dist, band, levels = genasm_dc_op(torch.from_numpy(pat),
                                      torch.from_numpy(txt), cfg=cfg)
    assert genasm_dc.PLAIN_CALLS["dc_band"] == before["dc_band"] + 1
    np.testing.assert_array_equal(dist.numpy(), np.asarray(d_ref))
    assert dist.dtype == torch.int32
    assert band.shape == (k + 1, cfg.ncols_band, n_pairs, cfg.nwb)
    np.testing.assert_array_equal(band.numpy(),
                                  np.asarray(band_ref).astype(np.int64))
    assert int(levels) == int(lvl_ref)
    d_o, band_o, lvl_o = ref_dc_ref(jnp.asarray(pat), jnp.asarray(txt),
                                    cfg=ref_cfg)
    p_d, p_band, p_lvl = genasm_dc_ref(torch.from_numpy(pat),
                                       torch.from_numpy(txt), cfg=cfg)
    L = int(lvl_o)
    assert int(p_lvl) == int(levels) == L
    np.testing.assert_array_equal(p_d.numpy(), np.asarray(d_o))
    np.testing.assert_array_equal(p_band.numpy(),
                                  np.asarray(band_o).astype(np.int64))
    np.testing.assert_array_equal(band.permute(0, 1, 3, 2)[:L].numpy(),
                                  p_band[:L].numpy())

