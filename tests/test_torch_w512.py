"""Windows wider than 256 (NW >= 9 words a bitvector: the wide family of
K1, K2/K4 and K3, ``csrc/genasm_xwide.cuh``): the plain versions, which
the card's kernels are held to (``chip_smoke.py``), against the JAX
reference's jnp paths, B = 5 lanes: three within k, one past it, one
exact or cut short (the helpers of ``test_torch_kp128.py``).

Every level capacity KP up to 512 and the band widths of each class
(nwb = 1, a few words, the whole vector): K1 and K3 at (288, 96, 20) NW 9
/ KP 32 / nwb 2, (288, 96, 100) NW 9 / KP 128 / nwb 7, (320, 96, 12) NW
10 / KP 16 / nwb 1, (320, 96, 200) NW 10 / KP 256 / nwb 10, (512, 192, 40)
NW 16 / KP 64 / nwb 3, (512, 192, 300) NW 16 / KP 512 / nwb 16 and
(1024, 300, 40) NW 32 / KP 64; K2 and K4 at W = 288 (KP 32), 320 (KP
256), 512 (KP 128, 512) and 1024 (KP 64).  k = 300, not 480, at KP =
512: the reference's tail at k = 480 takes twice as long (20 s), and the
ladder below runs k = 480 through the aligner.  KP = 1024 (W = 1024, k >= 512)
is held on the card against the plain versions (phases ``k1_grid``,
``k3_grid``): the reference's tail there takes minutes on a CPU.

Then the slice as a whole: the aligner's W = 512 ladder k = 60 -> 120 ->
240 -> 480 (O = 192, ``rescue_rounds=3``) on four reads of 1,000 bp, one
carrying a 256-base insertion that only k = 480 aligns (``rounds_run ==
4``), every ``AlignResult`` field and ``levels_run_total`` equal to the
reference's jnp backend (its Pallas kernels in interpret mode would take
tens of minutes at these widths; its own tests hold the backends equal).
The ladder lives in this file, not one of its own: pytest-xdist hands out
files with the most tests first, and a one-test file of this cost would
start last and lengthen the run's tail.

The reference runs in subprocesses whose XLA skips its ``fusion`` pass
(``test_torch_kp128.run_reference``): the kernels' cases one npz a case,
started by the module's first test and running beside the port's plain
versions (``BackgroundReference``), then the ladder beside the port's
(``test_torch_w256_ladder.assert_ladder_equals_reference``), the port
on ``PORT_THREADS`` torch threads.  About 110 s and 350 CPU-s on an idle
8-core host, the ladder 50 s of it; most of the reference's time is
XLA's compile (the ladder's ~40 s of ~60)."""
import numpy as np
import pytest
import torch

from repro_torch.data.genome import ReadSimConfig, simulate_reads, synth_genome
from repro_torch.kernels import genasm_dc
from repro_torch.kernels.ops import (genasm_dc_op, genasm_tail_fused_op,
                                     genasm_tb_fused_op)
from tests.test_torch_config import cfg_pair
from tests.test_torch_kp128 import (B, LANE_TILE, TB_FIELDS,
                                    BackgroundReference, _count_plain,
                                    _square, _tail_case,
                                    few_torch_threads,  # noqa: F401
                                    save_case, square_reference,
                                    tail_reference)
from tests.test_torch_w256_ladder import (assert_ladder_equals_reference,
                                          ladder_reference)

SQUARE = [(288, 96, 20), (288, 96, 100), (320, 96, 12), (320, 96, 200),
          (512, 192, 40), (512, 192, 300), (1024, 300, 40)]
TAILS = [(288, 96, 20), (320, 96, 200), (512, 192, 120), (512, 192, 300),
         (1024, 300, 40)]
LADDER_ROUNDS = 3


def _square_case(W, k):
    return _square(np.random.default_rng(W + k), W, k)


def reference_outputs(out_dir: str) -> None:
    """Every reference output of this module's cases, one npz a case in
    `out_dir`, in the tests' order (run in the subprocess of the ``ref``
    fixture)."""
    for W, O, k in SQUARE:
        ref_cfg, cfg = cfg_pair(W=W, O=O, k=k)
        arrays, tag = {}, f"sq{W}_{k}"
        square_reference(arrays, tag, *_square_case(W, k), ref_cfg, cfg)
        save_case(out_dir, tag, arrays)
    for W, O, k in TAILS:
        pat, txt, m_len, n_len, n_text, kw = _tail_case(W, k)
        arrays, tag = {}, f"tail{W}_{k}"
        tail_reference(arrays, tag, pat, txt, m_len, n_len, n_text, kw,
                       cfg_pair(W=W, O=O, k=k)[0])
        save_case(out_dir, tag, arrays)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return BackgroundReference("tests.test_torch_w512.reference_outputs",
                               tmp_path_factory.mktemp("w512"))


def test_cases_cover_each_kp_to_512_and_each_band_class():
    cfgs = [cfg_pair(W=W, O=O, k=k)[1] for W, O, k in SQUARE]
    assert all(c.nw > genasm_dc.TEMPLATE_NW for c in cfgs)
    assert {c.nw for c in cfgs} == {9, 10, 16, 32}
    assert {genasm_dc.levels_bucket(c.k) for c in cfgs} == \
        {16, 32, 64, 128, 256, 512}
    widths = {(c.nwb == 1, 1 < c.nwb < c.nw, c.nwb == c.nw) for c in cfgs}
    assert widths == {(True, False, False), (False, True, False),
                      (False, False, True)}
    tails = [cfg_pair(W=W, O=O, k=k)[1] for W, O, k in TAILS]
    assert {genasm_dc.levels_bucket(c.k) for c in tails} == \
        {32, 64, 128, 256, 512}


@pytest.mark.parametrize("W,O,k", SQUARE)
def test_k1_plain_equals_reference_jnp_band_path(W, O, k, ref):
    _, cfg = cfg_pair(W=W, O=O, k=k, lane_tile=LANE_TILE)
    pat, txt = _square_case(W, k)
    calls = _count_plain("tb_fused")
    port = genasm_tb_fused_op(torch.from_numpy(pat), torch.from_numpy(txt),
                              cfg=cfg, commit_limit=cfg.stride,
                              max_ops=cfg.tb_max_ops,
                              max_steps=cfg.tb_max_steps)
    assert calls() == 1
    tag = f"sq{W}_{k}"
    want = ref.get(tag)
    np.testing.assert_array_equal(port["dist"].numpy(), want[f"{tag}_dist"])
    assert int(port["levels"]) == int(want[f"{tag}_levels"])
    for key in TB_FIELDS:
        np.testing.assert_array_equal(port[key].numpy(),
                                      want[f"{tag}_{key}"], err_msg=key)
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
    want = ref.get(tag)
    L = int(want[f"{tag}_levels"])
    assert int(levels) == L
    np.testing.assert_array_equal(dist.numpy(), want[f"{tag}_dist"])
    assert band.shape == (k + 1, cfg.ncols_band, B, cfg.nwb)
    np.testing.assert_array_equal(band[:L].numpy(), want[f"{tag}_band"])


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
        want = ref.get(f"tail{W}_{k}")
        for key in TB_FIELDS + ("dist", "solved"):
            np.testing.assert_array_equal(port[key].numpy(),
                                          want[f"tail{W}_{k}_{key}"],
                                          err_msg=f"{kernel} {key}")
        solved = port["solved"].numpy()
        assert solved[:3].all() and not solved[3]


def _ladder_pairs():
    """4 reads of 1,000 bp; read 1 with a 256-base insertion."""
    rs = simulate_reads(synth_genome(200_000, seed=7), 4,
                        ReadSimConfig(read_len=1_000, seed=12))
    reads, refs = list(rs.reads), list(rs.ref_segments)
    burst = np.random.default_rng(5).integers(0, 4, 256).astype(np.uint8)
    mid = len(reads[1]) // 2
    reads[1] = np.concatenate([reads[1][:mid], burst, reads[1][mid:]])
    return reads, refs


def _ladder_cfgs():
    return cfg_pair(W=512, O=192, k=60, backend="jnp", lane_tile=4)


def reference_ladder(out: str) -> None:
    """``ladder_reference`` of the W = 512 ladder's pairs and
    configuration (run in a subprocess)."""
    ladder_reference(out, *_ladder_pairs(), _ladder_cfgs()[0],
                     LADDER_ROUNDS)


def test_w512_ladder_to_k480_equals_reference(tmp_path):
    assert_ladder_equals_reference(
        "tests.test_torch_w512.reference_ladder", tmp_path / "ref.npz",
        *_ladder_pairs(), _ladder_cfgs()[1], LADDER_ROUNDS, 1, 480)
