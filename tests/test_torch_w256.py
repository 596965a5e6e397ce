"""Windows wider than 128 (NW = 5..8 words a bitvector, W = 129..256) and
the level capacity KP = 256 (k >= 128): the plain versions of K1, K3, K2
and K4 against the JAX reference's jnp paths, B = 5 lanes: three within
k, one past it, one exact or cut short (the helpers of
``test_torch_kp128.py``).  One geometry for each new NW and each KP at
NW >= 5: (160, 48, 63) NW 5 / KP 64, (192, 64, 100) NW 6 / KP 128,
(224, 80, 40) NW 7 / KP 64, (256, 96, 140) NW 8 / KP 256, (144, 48, 12)
NW 5 / KP 16 and (208, 72, 24) NW 7 / KP 32.

As at KP = 128 the reference's interpret-mode kernels are too slow here,
so K1 and K3 are held to its square-window ``dc_dmajor`` (+ the band
``traceback`` for K1) and K2 / K4 to its tail's ``dc_jmajor`` + 'and'
``traceback``, which its own tests hold equal to the kernels.  The
reference runs once, in a subprocess whose XLA skips its ``fusion``
pass (``test_torch_kp128.REF_XLA_FLAGS``): with it, compiling
``dc_jmajor``'s scan (k levels unrolled in its body) grows steeply with
k, to minutes at
k >= 140; without it, seconds; the integer results are the same.  The
port pads to 8 lanes, not 128.  About 55 s on one idle worker, most of
it the reference's subprocess."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import genasm_dc
from repro_torch.kernels.ops import (genasm_dc_op, genasm_tail_fused_op,
                                     genasm_tb_fused_op)
from tests.test_torch_config import cfg_pair
from tests.test_torch_kp128 import (B, LANE_TILE, TB_FIELDS, _count_plain,
                                    _square, _tail_case,
                                    few_torch_threads,  # noqa: F401
                                    run_reference, square_reference,
                                    tail_reference)

SQUARE = [(160, 48, 63), (192, 64, 100), (224, 80, 40), (256, 96, 140),
          (144, 48, 12), (208, 72, 24)]
TAILS = [(160, 48, 63), (192, 64, 100), (224, 80, 40), (256, 96, 140)]


def _square_case(W, k):
    return _square(np.random.default_rng(W + k), W, k)


def reference_outputs(out: str) -> None:
    """Every reference output of this module's cases, into the npz `out`
    (run in the subprocess of the ``ref`` fixture)."""
    arrays = {}
    for W, O, k in SQUARE:
        ref_cfg, cfg = cfg_pair(W=W, O=O, k=k)
        square_reference(arrays, f"sq{W}_{k}", *_square_case(W, k), ref_cfg,
                         cfg)
    for W, O, k in TAILS:
        pat, txt, m_len, n_len, n_text, kw = _tail_case(W, k)
        tail_reference(arrays, f"tail{W}_{k}", pat, txt, m_len, n_len,
                       n_text, kw, cfg_pair(W=W, O=O, k=k)[0])
    np.savez(out, **arrays)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("w256") / "ref.npz"
    run_reference("tests.test_torch_w256.reference_outputs", out)
    with np.load(out) as f:
        return dict(f)


def test_geometries_cover_each_new_nw_and_kp():
    got = {(cfg_pair(W=W, O=O, k=k)[1].nw, genasm_dc.levels_bucket(k))
           for W, O, k in SQUARE}
    assert {nw for nw, _ in got} == {5, 6, 7, 8}
    assert {kp for _, kp in got} == {16, 32, 64, 128, 256}
    assert {cfg_pair(W=W, O=O, k=k)[1].nw for W, O, k in TAILS} == \
        {5, 6, 7, 8}


@pytest.mark.parametrize("W,O,k", SQUARE)
def test_k1_plain_equals_reference_jnp_band_path(W, O, k, ref):
    _, cfg = cfg_pair(W=W, O=O, k=k, lane_tile=LANE_TILE)
    assert cfg.nw >= 5
    pat, txt = _square_case(W, k)
    calls = _count_plain("tb_fused")
    port = genasm_tb_fused_op(torch.from_numpy(pat), torch.from_numpy(txt),
                              cfg=cfg, commit_limit=cfg.stride,
                              max_ops=cfg.tb_max_ops,
                              max_steps=cfg.tb_max_steps)
    assert calls() == 1
    tag = f"sq{W}_{k}"
    np.testing.assert_array_equal(port["dist"].numpy(), ref[f"{tag}_dist"])
    assert int(port["levels"]) == int(ref[f"{tag}_levels"])
    for key in TB_FIELDS:
        np.testing.assert_array_equal(port[key].numpy(), ref[f"{tag}_{key}"],
                                      err_msg=key)
    solved = port["solved"].numpy()
    assert solved[4] and not solved[3]


@pytest.mark.parametrize("W,O,k", SQUARE)
def test_k3_plain_equals_reference_dc_dmajor(W, O, k, ref):
    """K3's band equals dc_dmajor's below its level count (dc_dmajor
    leaves the levels above at zero); dist and the level count equal."""
    _, cfg = cfg_pair(backend="pallas", W=W, O=O, k=k, lane_tile=LANE_TILE)
    pat, txt = _square_case(W, k)
    calls = _count_plain("dc_band")
    dist, band, levels = genasm_dc_op(torch.from_numpy(pat),
                                      torch.from_numpy(txt), cfg=cfg)
    assert calls() == 1
    tag = f"sq{W}_{k}"
    L = int(ref[f"{tag}_levels"])
    assert int(levels) == L
    np.testing.assert_array_equal(dist.numpy(), ref[f"{tag}_dist"])
    assert band.shape == (k + 1, cfg.ncols_band, B, cfg.nwb)
    np.testing.assert_array_equal(band[:L].numpy(), ref[f"{tag}_band"])


@pytest.mark.parametrize("W,O,k", TAILS)
def test_k2_and_k4_plain_equal_reference_tail(W, O, k, ref):
    """K2 (tail_store='band': the diagonal band of nwb words, the whole
    vector where nwb = nw) and K4 ('full') on the same ragged tails, each
    equal to the reference's tail on its jnp path (``dc_jmajor`` + the
    'and' traceback)."""
    pat, txt, m_len, n_len, n_text, kw = _tail_case(W, k)
    for tail_store, kernel in (("band", "tail_banded"), ("full", "tail_full")):
        ref_cfg, cfg = cfg_pair(W=W, O=O, k=k, tail_store=tail_store,
                                lane_tile=LANE_TILE)
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
                                          ref[f"tail{W}_{k}_{key}"],
                                          err_msg=f"{kernel} {key}")
        solved = port["solved"].numpy()
        assert solved[:3].all() and not solved[3]
