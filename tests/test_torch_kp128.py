"""The level capacity KP = 128 (k >= 64 at W = 96 and 128): the plain
versions of K1, K4 (and K2 with the whole vector as its band) and K3
against the JAX reference, B = 5 lanes: three within k, one past it, one
exact or cut short.

The reference's Pallas kernels take 41.7 s (K1, K3) at W = 96, k = 64 in
interpret mode on a CPU and 152 s (K1) at W = 128, k = 127, so K1 and
K3 are held to the reference's jnp path, which its own tests hold equal
to the kernels (``tests/test_kernel_fused.py``, ``tests/test_kernels.py``):
the square window's ``dc_dmajor`` + band ``traceback`` for K1,
``dc_dmajor``'s band below its level count for K3, the tail's
``dc_jmajor`` + 'and' ``traceback`` for K2 / K4.  About 50 s on one idle
worker (each case 2–16 s)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.genasm import dc_dmajor, dc_jmajor
from repro.core.traceback import traceback
from repro_torch.core.bitops import SENTINEL_TEXT
from repro_torch.kernels import genasm_dc
from repro_torch.kernels.ops import (genasm_dc_op, genasm_tail_fused_op,
                                     genasm_tb_fused_op)
from tests.conftest import mutate_seq
from tests.test_torch_config import cfg_pair

B = 5
GEOMETRIES = [(96, 36, 64), (96, 36, 95), (128, 48, 127)]
TB_FIELDS = ("ops", "n_ops", "read_adv", "ref_adv", "cost", "d_final")


def _square(rng, W, k):
    """Windows within k (lanes 0-2), far past it (3: an all-sentinel text),
    and exact (4)."""
    pats = rng.integers(0, 4, (B, W)).astype(np.uint8)
    txts = []
    for b, p in enumerate(pats):
        t = mutate_seq(p, int(rng.integers(1, k + 1)), rng, extend_to=W)
        txts.append(np.full(W, SENTINEL_TEXT, np.uint8) if b == 3 else
                    p.copy() if b == 4 else t)
    return pats, np.stack(txts)


def _tails(rng, W, k):
    """Ragged tails: m_len in (W/2, W], texts within k (lanes 0-2), one of
    W sentinels against W pattern chars (3: W > k edits), one cut short
    (4); sentinel-padded to n_text = W + 4k."""
    n_text = W + 4 * k
    pats = np.full((B, W), 255, np.uint8)
    txts = np.full((B, n_text), 9, np.uint8)
    m_len, n_len = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for b in range(B):
        m = W if b == 3 else int(rng.integers(W // 2 + 1, W + 1))
        p = rng.integers(0, 4, m).astype(np.uint8)
        t = mutate_seq(p, int(rng.integers(0, k // 4)), rng)[:n_text]
        if b == 3:
            t = np.full(W, 9, np.uint8)
        if b == 4:
            t = t[:len(t) - 5]
        pats[b, :m], txts[b, :len(t)] = p, t
        m_len[b], n_len[b] = m, len(t)
    return pats, txts, m_len, n_len


def _count_plain(name):
    before = genasm_dc.PLAIN_CALLS[name]
    return lambda: genasm_dc.PLAIN_CALLS[name] - before


@pytest.mark.parametrize("W,O,k", GEOMETRIES)
def test_k1_plain_equals_reference_jnp_band_path(W, O, k):
    ref_cfg, cfg = cfg_pair(W=W, O=O, k=k)
    assert genasm_dc.levels_bucket(k) == 128
    pat, txt = _square(np.random.default_rng(W + k), W, k)
    kw = dict(max_ops=cfg.tb_max_ops, max_steps=cfg.tb_max_steps)
    res = dc_dmajor(jnp.asarray(pat), jnp.asarray(txt), cfg=ref_cfg)
    wl = jnp.full((B,), W, jnp.int32)
    ref = traceback(res.store, jnp.asarray(pat), jnp.asarray(txt), wl, wl,
                    res.dist, jnp.int32(cfg.stride), cfg=ref_cfg, mode="band",
                    **kw)
    calls = _count_plain("tb_fused")
    port = genasm_tb_fused_op(torch.from_numpy(pat), torch.from_numpy(txt),
                              cfg=cfg, commit_limit=cfg.stride, **kw)
    assert calls() == 1
    np.testing.assert_array_equal(port["dist"].numpy(), np.asarray(res.dist))
    assert int(port["levels"]) == int(res.levels_run)
    for key in TB_FIELDS:
        np.testing.assert_array_equal(port[key].numpy(), np.asarray(ref[key]),
                                      err_msg=key)
    solved = port["solved"].numpy()
    assert solved[4] and not solved[3]


@pytest.mark.parametrize("W,O,k", GEOMETRIES)
def test_k3_plain_equals_reference_dc_dmajor(W, O, k):
    """K3's band equals dc_dmajor's below its level count (dc_dmajor
    leaves the levels above at zero); dist and the level count equal."""
    ref_cfg, cfg = cfg_pair(backend="pallas", W=W, O=O, k=k)
    pat, txt = _square(np.random.default_rng(2 * W + k), W, k)
    res = dc_dmajor(jnp.asarray(pat), jnp.asarray(txt), cfg=ref_cfg)
    calls = _count_plain("dc_band")
    dist, band, levels = genasm_dc_op(torch.from_numpy(pat),
                                      torch.from_numpy(txt), cfg=cfg)
    assert calls() == 1
    L = int(res.levels_run)
    assert int(levels) == L
    np.testing.assert_array_equal(dist.numpy(), np.asarray(res.dist))
    assert band.shape == (k + 1, cfg.ncols_band, B, cfg.nwb)
    np.testing.assert_array_equal(
        band[:L].numpy(), np.asarray(res.store["Rb"])[:L].astype(np.int64))


def test_k4_and_k2_plain_equal_reference_tail():
    """At W = 96, k = 64 'auto' resolves to K4 and 'band' to K2 with the
    whole vector as its band; both equal the reference's tail on its jnp
    path (``dc_jmajor`` + the 'and' traceback, 9 s).  Its tail kernel in
    interpret mode takes 143 s on these lanes (138 s of it the lane past
    k); at W = 128 the tails at KP = 128 are held to the reference
    through the aligner (``test_torch_kp128_ladder.py``, k = 120)."""
    W, O, k = 96, 36, 64
    pat, txt, m_len, n_len = _tails(np.random.default_rng(3 * k + W), W, k)
    n_text = W + 4 * k
    kw = dict(commit_limit=2 * (W + n_text), max_ops=W + n_text,
              max_steps=W + n_text + 4)
    ref_cfg, _ = cfg_pair(W=W, O=O, k=k)
    res = dc_jmajor(jnp.asarray(pat), jnp.asarray(txt), jnp.asarray(m_len),
                    jnp.asarray(n_len), k=k, n=n_text, nw=ref_cfg.nw,
                    store="and")
    ref = traceback(res.store, jnp.asarray(pat), jnp.asarray(txt),
                    jnp.asarray(m_len), jnp.asarray(n_len), res.dist,
                    jnp.int32(kw["commit_limit"]), cfg=ref_cfg, mode="and",
                    max_ops=kw["max_ops"], max_steps=kw["max_steps"])
    ref = {**ref, "dist": res.dist, "solved": res.solved}
    for tail_store, kernel in (("auto", "tail_full"), ("band", "tail_banded")):
        ref_cfg, cfg = cfg_pair(W=W, O=O, k=k, tail_store=tail_store)
        assert cfg.tail_banded == (kernel == "tail_banded") == \
            ref_cfg.tail_banded
        calls = _count_plain(kernel)
        port = genasm_tail_fused_op(
            torch.from_numpy(pat), torch.from_numpy(txt),
            torch.from_numpy(m_len), torch.from_numpy(n_len), cfg=cfg,
            n_text=n_text, **kw)
        assert calls() == 1
        for key in TB_FIELDS + ("dist", "solved"):
            np.testing.assert_array_equal(port[key].numpy(),
                                          np.asarray(ref[key]),
                                          err_msg=f"{kernel} {key}")
        solved = port["solved"].numpy()
        assert solved[:3].all() and not solved[3]
