"""The port's footprint / access model (``repro_torch.core.counting``):
the paper's formulas equal to the reference's number for number and key
for key, the claims of tests/test_counting.py on the port, and the GPU
store functions held against the blocks ``kernels.genasm_dc`` derives
for the Hopper kernels, each difference from the reference's Triton model
asserted by name."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import counting as ref
from repro.core.config import AlignerConfig as RefConfig
from repro_torch.core import counting as port
from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc
from repro_torch.kernels.ops import _to_kernel_layout

CONFIGS = [(64, 24, 12), (64, 24, 16), (128, 48, 15), (32, 8, 4),
           (96, 32, 24)]
TILES = (1, 7, 128, 512)


def _cfgs(W, O, k):
    return RefConfig(W=W, O=O, k=k), AlignerConfig(W=W, O=O, k=k)


def _half_bank_pad(words):
    return words + (16 - words % 32) % 32


@pytest.mark.parametrize("W,O,k", CONFIGS)
def test_formulas_equal_reference(W, O, k):
    rc, pc = _cfgs(W, O, k)
    for tb in (10, 40.5, 0):
        assert dataclasses.astuple(port.baseline_counts(pc, tb)) == \
            dataclasses.astuple(ref.baseline_counts(rc, tb))
        assert dataclasses.astuple(port.sene_only_counts(pc, tb)) == \
            dataclasses.astuple(ref.sene_only_counts(rc, tb))
        for lv in (1, 3.5, 7, k + 1):
            assert dataclasses.astuple(port.improved_counts(pc, tb, lv)) \
                == dataclasses.astuple(ref.improved_counts(rc, tb, lv))
    for tile in TILES:
        assert port.kernel_scratch_words(pc, tile) == \
            ref.kernel_scratch_words(rc, tile)
        for n_text in (None, W + 2 * k, W):
            for banded in (None, True, False):
                assert port.tail_scratch_words(pc, tile, n_text, banded) == \
                    ref.tail_scratch_words(rc, tile, n_text, banded)
    for avg in (1.0, 5.0, 7.0, k + 1.0):
        for tb in (None, 30):
            want = ref.reduction_report(rc, avg, tb)
            got = port.reduction_report(pc, avg, tb)
            assert list(got) == list(want)
            assert got == want


def test_counter_formulas_match_empirical():
    for W, O, k in ((64, 24, 12), (64, 24, 16), (128, 48, 15)):
        cfg = AlignerConfig(W=W, O=O, k=k)
        assert port.baseline_counts(cfg, 10).dc_writes == \
            W * (k + 1) * 4 * cfg.nw
        for lv in (3, 7, k + 1):
            assert port.improved_counts(cfg, 10, lv).dc_writes == \
                cfg.ncols_band * lv * cfg.nwb


def test_paper_magnitude_claims():
    """24x footprint, 12x fewer accesses (paper): at the default geometry
    and ~7 levels a window the port's report lands in that regime, and
    SENE alone is exactly 4x on writes."""
    cfg = AlignerConfig(W=64, O=24, k=12)
    rep = port.reduction_report(cfg, avg_levels=7.0)
    assert rep["footprint_reduction_touched"] > 15.0
    assert rep["access_reduction"] > 8.0
    assert port.baseline_counts(cfg, 40).dc_writes \
        / port.sene_only_counts(cfg, 40).dc_writes == 4.0
    assert rep["vmem_bytes_per_problem"] * 512 < 16 * 2 ** 20


def test_reductions_monotone_in_k():
    r_small = port.reduction_report(AlignerConfig(W=64, O=24, k=8), 5.0)
    r_big = port.reduction_report(AlignerConfig(W=64, O=24, k=24), 5.0)
    assert r_big["footprint_reduction_touched"] > \
        r_small["footprint_reduction_touched"] * 0.9


@pytest.mark.parametrize("W,O,k", CONFIGS)
def test_gpu_store_words_is_k1_band_in_shared_memory(W, O, k):
    """K1's band is in the block's shared memory with row and bank pads;
    the reference's Triton model is the unpadded band in device memory."""
    rc, pc = _cfgs(W, O, k)
    geo = genasm_dc.tb_fused_geometry(pc)
    lane = port.gpu_store_words(pc, 1)
    others = _half_bank_pad(W) + pc.tb_max_ops + 1
    assert geo.shared_bytes == 4 * geo.lanes * (lane + others)
    for tile in TILES:
        assert port.gpu_store_words(pc, tile) == lane * tile
        assert ref.gpu_store_words(rc, tile) == \
            ref.kernel_scratch_words(rc, tile)
    pads = lane - ref.gpu_store_words(rc, 1)
    assert lane % 32 == 16 and 0 <= pads < 32 + (k + 1)


@pytest.mark.parametrize("W,O,k", [(96, 36, 64), (128, 42, 120),
                                   (128, 48, 127)])
def test_gpu_store_words_is_k1_band_in_device_memory_at_kp_128(W, O, k):
    """At KP = 128 K1's band is in device memory, in the skewed
    (ncb + rows0 - 1) x L x nwb x rows0 layout: at least the reference's
    unpadded band, and nothing of it in the block's shared memory."""
    rc, pc = _cfgs(W, O, k)
    geo = genasm_dc.tb_fused_geometry(pc)
    rows0 = -(-(k + 1) // 4)
    lane = port.gpu_store_words(pc, 1)
    assert geo.placement == "global" and geo.store_words == lane
    assert lane == (pc.ncols_band + rows0 - 1) * 4 * pc.nwb * rows0
    assert lane >= ref.kernel_scratch_words(rc, 1)
    assert geo.shared_bytes == 4 * geo.lanes * (
        _half_bank_pad(W) + pc.tb_max_ops + 1)
    for tile in TILES:
        assert port.gpu_store_words(pc, tile) == lane * tile


#: NW = 5..8 (W = 129..256): KP = 16, 64, 128, 256
WIDE = [(144, 48, 12), (160, 48, 63), (192, 64, 100), (256, 96, 240)]


@pytest.mark.parametrize("W,O,k", CONFIGS + [(64, 24, 24), (64, 24, 48),
                                             (96, 36, 64), (128, 48, 127)]
                         + WIDE)
@pytest.mark.parametrize("banded", [None, True, False])
def test_gpu_tail_store_words_follow_the_placement(W, O, k, banded):
    """K2 / K4: in shared memory padded rows of n_text x nwb words (K4:
    nw); in device memory the skewed (n_text + rows0 - 1) x L x nwb x
    rows0 layout; where the tails run the wide family (``WIDE``,
    ``genasm_dc.kernel_family``) (k+1) x n_text rows of 8 slots (one
    sector: nwbr raw words and pads)
    (nwb, plus one where the window is narrower than the vector) in its
    block's scratch; where the reference's model keeps (k+1) x n_text x
    nwb (K4: (k+1) x (n_text+1) x nw) words."""
    rc, pc = _cfgs(W, O, k)
    wide = genasm_dc.kernel_family(pc, "tail") == "xwide"
    for n_text in (None, W + 2 * k):
        nt = W + 4 * k if n_text is None else n_text
        is_banded = pc.tail_banded if banded is None else banded
        nwb = pc.nwb if is_banded else pc.nw
        lane = port.gpu_tail_store_words(pc, 1, n_text, banded)
        assert port.gpu_tail_store_words(pc, 512, n_text, banded) == \
            512 * lane
        if wide:
            geo = genasm_dc.xwide_geometry(
                pc, "tail_banded" if is_banded else "tail_full", nt)
            assert lane == geo.store_words == (k + 1) * nt * 8
            assert ref.gpu_tail_store_words(rc, 1, n_text, banded) == \
                (k + 1) * (nt if is_banded else nt + 1) * nwb
            continue
        geo = genasm_dc.tail_geometry(pc, nt, W + nt, banded=banded)
        common = _half_bank_pad(nt) + W + nt + 1   # text, ops, dist
        if geo.placement == "shared":
            row = nt * nwb + (1 if nwb * (nt - 1) % 2 == 0 else 0)
            assert lane == _half_bank_pad((k + 1) * row)
            assert geo.store_words == 0
            assert geo.shared_bytes == 4 * (geo.lanes * (lane + common) + 1)
        else:
            L = geo.levels_per_thread
            rows0 = -(-(k + 1) // L)
            assert lane == geo.store_words == (nt + rows0 - 1) * L * nwb * rows0
            assert geo.shared_bytes == 4 * (geo.lanes * common + 1)
        assert ref.gpu_tail_store_words(rc, 1, n_text, banded) == \
            ref.tail_scratch_words(rc, 1, n_text, banded) == \
            (k + 1) * (nt if is_banded else nt + 1) * nwb
    assert wide or genasm_dc.TAIL_PLACEMENT[
        (pc.nw, genasm_dc.levels_bucket(k))] in ("shared", "global")


@pytest.mark.parametrize("W,O,k", CONFIGS)
def test_gpu_split_store_words_is_k3_band_output(W, O, k):
    """K3's band leaves the kernel: its output tensor has exactly these
    words (B lanes), in device memory; the block's shared memory holds
    only the texts and, staged, the ring."""
    rc, pc = _cfgs(W, O, k)
    B = 5
    pm, text = _to_kernel_layout(torch.zeros((B, W), dtype=torch.uint8),
                                 torch.zeros((B, W), dtype=torch.uint8), pc)
    _, band, _ = genasm_dc.genasm_dc(pm, text, cfg=pc)
    assert band.numel() == port.gpu_split_store_words(pc, B)
    assert port.gpu_split_store_words(pc, B) == \
        ref.gpu_store_words(rc, B) == ref.kernel_scratch_words(rc, B)
    geo = genasm_dc.dc_band_geometry(pc)
    ring = 2 * geo.chunk * geo.lanes * geo.lane_stride
    assert geo.shared_bytes == 4 * (geo.lanes * _half_bank_pad(W) + ring)
    assert (ring == 0) == (geo.placement == "direct")


@pytest.mark.parametrize("W,O,k", CONFIGS + [(64, 24, 48), (128, 48, 63),
                                             (128, 48, 127)] + WIDE)
def test_gpu_lane_state_words_are_a_threads_levels(W, O, k):
    """A fill thread carries L = KP / G levels and the shuffled level below
    (nw words each); where K1 runs the wide family (``WIDE``), one word of
    ``XR_LEVELS`` levels and of the level below for two steps; the
    reference's model carried 2 x (k+1) levels."""
    rc, pc = _cfgs(W, O, k)
    kp = genasm_dc.levels_bucket(k)
    L = kp // min(kp, 32)
    assert port.gpu_lane_state_words(pc) == (
        2 * (genasm_dc.XR_LEVELS + 1)
        if genasm_dc.kernel_family(pc, "tb_fused") == "xwide"
        else (L + 1) * pc.nw)
    assert ref.gpu_lane_state_words(rc) == 2 * (k + 1) * rc.nw
    assert port.gpu_lane_state_words(pc) < ref.gpu_lane_state_words(rc)


@pytest.mark.parametrize("W,O,k", WIDE)
def test_gpu_store_words_at_nw_5_to_8_are_k1_band_in_device_memory(W, O, k):
    """At NW = 5..8 K1's band is in device memory at every KP: where K1
    runs the wide family (``genasm_dc.kernel_family``), (k+1) x ncb rows
    of 8 slots (one sector: nwbr raw words and pads) a lane in its
    block's scratch; a template's, the
    skewed (ncb + rows0 - 1) x L x nwb x rows0 layout; either at least
    the reference's unpadded band.  K3's band output equals the
    reference's scratch model."""
    rc, pc = _cfgs(W, O, k)
    lane = port.gpu_store_words(pc, 1)
    if genasm_dc.kernel_family(pc, "tb_fused") == "xwide":
        geo = genasm_dc.xwide_geometry(pc, "tb_fused")
        assert lane == geo.store_words == (k + 1) * pc.ncols_band * 8
    else:
        geo = genasm_dc.tb_fused_geometry(pc)
        L = geo.levels_per_thread
        rows0 = -(-(k + 1) // L)
        assert geo.placement == "global" and geo.store_words == lane
        assert lane == (pc.ncols_band + rows0 - 1) * L * pc.nwb * rows0
    assert lane >= ref.kernel_scratch_words(rc, 1)
    for tile in TILES:
        assert port.gpu_store_words(pc, tile) == lane * tile
        assert port.gpu_split_store_words(pc, tile) == \
            ref.kernel_scratch_words(rc, tile)


def test_gpu_functions_refuse_configs_without_kernels():
    """Every W has kernels now: at NW >= 9 (W = 288, 320) the gpu_*
    models give the wide family's layout, unpadded stores a lane in its
    blocks' scratch (the register fill's raw window words: nwb + 1 where
    the window is narrower than the vector) and a fill thread's state as
    one word of its levels and the level below, for two steps."""
    for W in (288, 320):
        cfg = AlignerConfig(W=W, O=64, k=64)
        n_text = W + 4 * 64
        assert cfg.nwb < cfg.nw
        assert port.gpu_store_words(cfg, 3) == \
            3 * 65 * cfg.ncols_band * (cfg.nwb + 1)
        assert port.gpu_tail_store_words(cfg, 3) == \
            3 * 65 * n_text * (cfg.nwb + 1)
        assert port.gpu_tail_store_words(cfg, 3, banded=False) == \
            3 * 65 * n_text * cfg.nw
        assert port.gpu_split_store_words(cfg, 3) == \
            port.kernel_scratch_words(cfg, 3)
        cfg = AlignerConfig(W=W, O=48, k=12)
        assert port.gpu_lane_state_words(cfg) == \
            2 * (genasm_dc.XR_LEVELS + 1)
    assert np.isfinite(port.reduction_report(
        AlignerConfig(W=160, O=48, k=70), 9.0)["access_reduction"])
