"""The wide family's blocks (``csrc/genasm_xwide_reg.cuh``: K1 and the
tails at W >= 129, K3 at W >= 257, ``genasm_dc.kernel_family``) on the
CPU: the register fill of K1, the tails and K3 (one warp a lane, word
threads and level groups, level strips and word strips, shared bytes and
scratch words a lane, held to C's
``xr_layout`` / ``xr_k3_layout``; K3's lanes, staging buffer and chunk),
the scratch a lane, a block and in flight, the persistent grid, the one
refusal (a lane's scratch over the card's free memory, naming W, k and
the bytes), and what the session, the counting model, the dry run and
the roofline report for it.  The kernels themselves run on the card
(``chip_smoke.py``); their plain versions are held to the reference in
``test_torch_w512.py``, the register fill's schedule to the plain fill in
``test_torch_xwide_schedule.py``."""
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from repro_torch.analysis import roofline
from repro_torch.core import counting, windowing
from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc
from repro_torch.launch import dryrun_aligner
from repro_torch.serve.align_step import launch_plan

XW = genasm_dc.XwideGeometry
CASES = [(288, 96, 20), (288, 96, 100), (320, 96, 40), (320, 96, 200),
         (512, 192, 60), (512, 192, 480), (1024, 300, 40), (1024, 300, 700),
         (1100, 300, 40)]
#: NW = 5, 6 and 8, where K1 and the tails run the register fill (8 word
#: threads a level group; at W = 160, k = 120 K1 only: the tails keep
#: their template there, ``TEMPLATE_KEPT``) and K3 its templates
NARROW = [(160, 48, 120), (192, 64, 100), (256, 96, 60), (256, 96, 240)]
#: NW = 3 and 4 at KP = 128, where K1 and the tails run their templates
#: (``TEMPLATE_NW``): the fill's layout there held to C's all the same
KP128 = [(65, 24, 64), (96, 36, 95), (128, 48, 96)]
CSRC = Path(genasm_dc.__file__).resolve().parent / "csrc"


def _xr_mirror(nw, k, nwb, cols, jlo, last_max):
    """C's xr_layout written out again: word threads, level groups of
    XR_LEVELS, strips, shared bytes a warp (5 x 32 mask words, the text
    chunk of XR_TEXT_CHUNK + H u16), a stored row's words and slots (at
    nw <= 8 eight: one sector) and a lane's scratch words (at nw <= 8
    whole sectors)."""
    wt = 8 if nw <= 8 else 16 if nw <= 16 else 32
    height = 32 // wt * genasm_dc.XR_LEVELS
    strips = -(-(k + 1) // height)
    nwbr = nwb + (nwb < nw)
    nwbs = 8 if nw <= 8 else nwbr
    store = (k + 1) * cols * nwbs
    below = last_max * nw if strips > 1 and not (
        cols and nwb == nw and jlo <= 1) else 0
    carry = 2 * (last_max + height - 1) if nw > wt else 0
    lane = store + below + carry
    return dict(wt=wt, gw=32 // wt, height=height, strips=strips,
                word_strips=-(-nw // wt), nwbr=nwbr, nwbs=nwbs, store=store,
                lane=lane + (-lane % 8 if nw <= 8 else 0),
                warp_bytes=4 * 5 * 32 + 2 * (genasm_dc.XR_TEXT_CHUNK
                                              + height))


def _k3_mirror(cfg, lanes, chunk):
    """C's xr_k3_layout written out again: the fill with no store (the
    level below a strip always in the lane's buffer), two buffers of raw
    top words where there are word strips, and two staging buffers of
    chunk x H rows of `lanes` lane strides (the odd multiple of 32 / lanes
    above nwb: a window's nwb + 1 raw words), a row padded to 16 mod 32
    words."""
    x = _xr_mirror(cfg.nw, cfg.k, cfg.nwb, 0, cfg.W + 1 - cfg.ncols_band,
                   cfg.W)
    r = 32 // lanes
    stride = (-(-(cfg.nwb + 1) // r) | 1) * r
    row = lanes * stride + (16 - lanes * stride % 32) % 32
    raw = 2 * (cfg.W + x["height"] - 1) * genasm_dc.XR_LEVELS \
        if x["word_strips"] > 1 else 0
    return dict(x, stride=stride, row=row, raw=raw, lane=x["lane"] + raw,
                smem=lanes * x["warp_bytes"] + 8 * chunk * x["height"] * row)


def _geometries(cfg):
    return {name: genasm_dc.xwide_geometry(cfg, name)
            for name in genasm_dc.KERNELS}


@pytest.mark.parametrize("W,O,k", CASES)
def test_wide_block_follows_the_layout(W, O, k):
    """K1, K2 and K4: XR_LANES warps a block within the registers' cap, one
    lane a warp, WT word threads x GW level groups of XR_LEVELS levels,
    threads <= 1,024 and within max_threads, the shared bytes and scratch
    of C's xr_layout.  K3: XR_K3_LANES warps (16: a band row word of the
    block's lanes is two 32 B sectors), its staging buffer flushed every
    XR_K3_CHUNK steps, halved (down to 2) while the block exceeds its
    share of an SM (one block: its registers); the shared bytes and
    scratch of C's xr_k3_layout, no store."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    n_text = W + 4 * k
    col0 = W + 1 - cfg.ncols_band
    mirrors = {"tb_fused": _xr_mirror(cfg.nw, k, cfg.nwb, cfg.ncols_band,
                                      col0, W),
               "tail_banded": _xr_mirror(cfg.nw, k, cfg.nwb, n_text, 1,
                                         n_text),
               "tail_full": _xr_mirror(cfg.nw, k, cfg.nw, n_text, 1,
                                       n_text)}
    for name, geo in _geometries(cfg).items():
        assert isinstance(geo, XW)
        family = "tail" if name.startswith("tail") else name
        cap = genasm_dc.max_threads(family, cfg)
        assert (geo.words, geo.depth, geo.levels) == \
            (16 if cfg.nw <= 16 else 32, 2 if cfg.nw <= 16 else 1,
             genasm_dc.XR_LEVELS)
        if name != "dc_band":
            x = mirrors[name]
            assert geo.chunk == 0
            assert geo.lanes == min(genasm_dc.XR_LANES, cap // 32)
            assert geo.threads == 32 * geo.lanes <= min(cap, 1024)
            assert (geo.words, geo.depth, geo.levels) == \
                (x["wt"], x["gw"], genasm_dc.XR_LEVELS)
            assert (geo.strips, geo.word_strips) == (x["strips"],
                                                     x["word_strips"])
            assert geo.shared_bytes == geo.lanes * x["warp_bytes"]
            assert geo.store_words == x["store"]
            assert geo.lane_words == x["lane"]
            assert geo.block_words == x["lane"] * geo.lanes
            continue
        assert geo.lanes == genasm_dc.XR_K3_LANES == 16
        assert geo.threads == 32 * geo.lanes <= cap
        assert geo.chunk in (2, 4, 8) and (
            geo.chunk == genasm_dc.XR_K3_CHUNK
            or _k3_mirror(cfg, 16, 2 * geo.chunk)["smem"]
            > genasm_dc.MAX_SHARED_BYTES)
        y = _k3_mirror(cfg, geo.lanes, geo.chunk)
        assert geo.shared_bytes == y["smem"] <= genasm_dc.MAX_SHARED_BYTES
        assert (geo.strips, geo.word_strips) == (y["strips"],
                                                 y["word_strips"])
        assert geo.store_words == 0
        assert geo.lane_words == y["lane"]
        assert geo.block_words == y["lane"] * geo.lanes


@pytest.mark.parametrize("W,O,k,stride,chunk", [
    (288, 96, 20, 6, 8), (512, 192, 60, 6, 8), (512, 192, 480, 18, 4),
    (1024, 300, 700, 34, 4), (1100, 300, 40, 6, 8)])
def test_k3_block_stages_its_band_a_sector_a_row_word(W, O, k, stride,
                                                      chunk):
    """K3's block: 16 lane warps, so a flush writes a row word of the
    block's lanes as two whole 32 B sectors (8 lanes, one sector, is the
    floor); a lane's staged row holds the nwb + 1 raw words a window
    spans, in the odd multiple of 2 words above nwb (a flush's warp, 16
    lanes x 2 words, reads 32 banks), the chunk the most steps (of 8)
    whose two buffers fit the one block an SM's registers hold.  No
    store: the scratch a lane is the level below a strip (W x NW words
    past one strip) and, past 32 words, the word strips' carries and raw
    top words."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    geo = genasm_dc.xwide_geometry(cfg, "dc_band")
    y = genasm_dc.xr_k3_layout(cfg.nw, k, cfg.nwb, W, cfg.ncols_band,
                               geo.lanes, geo.chunk)
    assert (geo.lanes, geo.threads) == (16, 512)
    assert 4 * geo.lanes >= 32
    assert (y["lane_stride"], geo.chunk) == (stride, chunk)
    assert y["lane_stride"] > cfg.nwb and (y["lane_stride"] // 2) % 2 == 1
    assert y["row_stride"] % 32 == 16
    assert geo.shared_bytes <= genasm_dc.MAX_SHARED_BYTES
    height = y["height"]
    below = W * cfg.nw if -(-(k + 1) // height) > 1 else 0
    words = -(-cfg.nw // 32) if cfg.nw > 16 else 1
    extra = (2 * (W + height - 1) * (1 + genasm_dc.XR_LEVELS)
             if words > 1 else 0)
    assert geo.store_words == 0
    assert geo.lane_words == below + extra


def test_k3_lanes_and_chunk_give_way_to_shared_memory():
    """The chunk halves (to 2) while the block exceeds its share of an SM,
    then the lanes while it exceeds 232,448 B: W = 4096 (NW 128, k =
    2000, nwb 126) at 16 lanes stages 7 rows of 2,128 words a step, past
    a block at any chunk, so the lanes halve to 8 (rows of 1,072 words,
    chunk 2, 127,344 B: two blocks' registers fit an SM, not their shared
    memory); at W = 8192 (NW 256) two steps of 8 lanes exceed a block and
    the lanes halve to 4."""
    big = genasm_dc.xwide_geometry(AlignerConfig(W=4096, O=1536, k=2000),
                                   "dc_band")
    assert (big.lanes, big.chunk) == (8, 2)
    assert genasm_dc.MAX_SHARED_BYTES // 2 < big.shared_bytes \
        <= genasm_dc.MAX_SHARED_BYTES
    huge = genasm_dc.xwide_geometry(AlignerConfig(W=8192, O=3072, k=4000),
                                    "dc_band")
    assert (huge.lanes, huge.chunk) == (4, 2)
    assert huge.shared_bytes <= genasm_dc.MAX_SHARED_BYTES


def test_persistent_grid_is_sized_by_blocks_in_flight():
    """K4 at W = 512, k = 480: a block of XR_LANES lanes of one 74.9 MB
    store each; with 4 GB free the blocks that fit half of it are fewer
    than the card's SMs at any width, so the lanes halve to one a block,
    and 26 blocks fit."""
    cfg = AlignerConfig(W=512, O=192, k=480)
    geo = genasm_dc.xwide_geometry(cfg, "tail_full", 2432)
    assert (geo.lanes, geo.store_words) == (genasm_dc.XR_LANES,
                                            481 * 2432 * 16)
    assert genasm_dc.xwide_blocks(geo, 2048, 264) == 264
    assert genasm_dc.xwide_blocks(geo, 37, 264) == -(-37 // geo.lanes)
    tight = genasm_dc.xwide_geometry(cfg, "tail_full", 2432, 4 * 10 ** 9)
    assert tight.lanes == 1
    # 4 GB free: half of it holds 26 blocks of one 74,866,688 B store
    assert genasm_dc.xwide_blocks(tight, 2048, 264, 4 * 10 ** 9) == 26
    k3 = genasm_dc.xwide_geometry(cfg, "dc_band")
    # K3's scratch is the level below a strip, 512 x 16 words a lane: 8
    # blocks of 16 lanes fit half of 8 MB
    assert k3.block_words == 512 * 16 * 16
    assert genasm_dc.xwide_blocks(k3, 2048, 264) == 128
    assert genasm_dc.xwide_blocks(k3, 2048, 264, 8 * 2 ** 20) == 8


def test_one_refusal_names_w_k_and_the_bytes():
    """Lanes halve while the blocks that fit half the free memory are fewer
    than the SMs; a lane that does not fit raises, naming W, k and the
    bytes."""
    cfg = AlignerConfig(W=512, O=192, k=120)
    full = genasm_dc.xwide_geometry(cfg, "tb_fused")
    lane = 4 * full.lane_words
    sms = genasm_dc.SMS
    assert full.lanes == genasm_dc.XR_LANES == 4
    assert genasm_dc.xwide_geometry(
        cfg, "tb_fused", free_bytes=2 * sms * 4 * lane).lanes == 4
    assert genasm_dc.xwide_geometry(
        cfg, "tb_fused", free_bytes=2 * sms * 2 * lane).lanes == 2
    assert genasm_dc.xwide_geometry(cfg, "tb_fused",
                                    free_bytes=2 * lane).lanes == 1
    with pytest.raises(ValueError, match=rf"W=512 k=120: one block of the "
                       rf"wide K1 needs {lane:,} B of scratch"):
        genasm_dc.xwide_geometry(cfg, "tb_fused", free_bytes=lane)
    big = AlignerConfig(W=512, O=192, k=480)
    with pytest.raises(ValueError, match=r"W=512 k=480: .* wide K4 needs "
                       r"74,866,688 B .* 100,000,000 B free"):
        genasm_dc.check_scratch_fits(big, 10 ** 8)
    # K3: a lane's 32,768 B buffer of the level below a strip
    assert genasm_dc.xwide_geometry(big, "dc_band",
                                    free_bytes=2 * 32_768).lanes == 1
    with pytest.raises(ValueError, match=r"W=512 k=480: one block of the "
                       r"wide K3 needs 32,768 B of scratch, more than 0.5 "
                       r"of the card's 65,535 B free"):
        genasm_dc.xwide_geometry(big, "dc_band", free_bytes=65_535)
    genasm_dc.check_scratch_fits(big, 80 * 10 ** 9)
    # W = 256: K1 and the tails run the wide family, K3 its templates (a
    # lane's band each, not checked); W = 128 runs only templates
    w256 = AlignerConfig(W=256, O=96, k=240)
    k1 = 4 * genasm_dc.xwide_geometry(w256, "tb_fused").lane_words
    with pytest.raises(ValueError, match=rf"W=256 k=240: one block of the "
                       rf"wide K1 needs {k1:,} B of scratch"):
        genasm_dc.check_scratch_fits(w256, 2 * k1 - 1)
    genasm_dc.check_scratch_fits(AlignerConfig(W=128, O=48, k=120), 1)


@pytest.mark.parametrize("name", ["tb_fused", "tail_banded", "tail_full",
                                  "dc_band"])
def test_templates_and_wide_family_split_at_nw_8(name):
    """One family runs a kernel at a configuration
    (``genasm_dc.kernel_family``), and only its geometry serves it: K3
    splits at NW 8 (its templates to W = 256, the wide family from 288),
    K1 and the tails at NW 4 but where ``TEMPLATE_KEPT`` names the (NW, KP)
    (W = 160, NW 5 at KP = 64 here: a template; W = 256: the wide family).
    A template's geometry refuses a wide configuration, naming the wide
    family (past NW = 8: that the templates stop there), and
    ``xwide_geometry`` a template's."""
    template = {"tb_fused": lambda c: genasm_dc.tb_fused_geometry(c),
                "tail_banded": lambda c: genasm_dc.tail_geometry(
                    c, c.W + 4 * c.k, 2 * c.W + 4 * c.k, banded=True),
                "tail_full": lambda c: genasm_dc.tail_geometry(
                    c, c.W + 4 * c.k, 2 * c.W + 4 * c.k, banded=False),
                "dc_band": lambda c: genasm_dc.dc_band_geometry(c)}[name]
    split = 256 if name == "dc_band" else 128
    kept = genasm_dc.TEMPLATE_KEPT.get(genasm_dc._XW_FAMILY[name], ())
    for W, O in ((128, 48), (160, 48), (256, 96), (288, 96)):
        cfg = AlignerConfig(W=W, O=O, k=40)
        family = genasm_dc.kernel_family(cfg, name)
        assert family == ("template" if W <= split or (cfg.nw, 64) in kept
                          else "xwide")
        if family == "template":
            assert not isinstance(template(cfg), XW)
            with pytest.raises(ValueError, match=rf"W={W} k=40: .* runs its "
                               rf"template at NW = {cfg.nw}, KP = 64, not "
                               rf"the wide family"):
                genasm_dc.xwide_geometry(cfg, name)
            continue
        assert isinstance(genasm_dc.xwide_geometry(cfg, name), XW)
        want = (r"templates stop at NW = 8; NW = 9 runs the wide family"
                if W == 288 else rf"runs the wide family at NW = {cfg.nw}, "
                rf"KP = 64 \(xwide_geometry\)")
        with pytest.raises(ValueError, match=rf"W={W} k=40: .*{want}"):
            template(cfg)
    with pytest.raises(ValueError, match="no kernel 'k5'"):
        genasm_dc.kernel_family(AlignerConfig(), "k5")


@pytest.mark.parametrize("unit,family,macro", [
    ("tb_fused_wide.cu", "tb_fused", "K1_WIDE"),
    ("tail_fused_wide.cu", "tail", "TAIL_WIDE")])
def test_nw_5_to_8_instantiations_are_the_template_routes(unit, family,
                                                          macro):
    """K1's and the tails' instantiations at NW = 5..8 are exactly the
    (NW, KP, NWB) that some W = 129..256 and k < W route to a template
    (``kernel_family``: the (NW, KP) of ``TEMPLATE_KEPT``; NWB = nwb, and
    for the tails also NW: K4, and K2 whose band is the whole vector): no
    route lacks its kernel, and no kernel is built that no route
    reaches."""
    built = {tuple(map(int, m)) for m in re.findall(
        rf"{macro}\((\d+), (\d+), (\d+)\)", (CSRC / unit).read_text())}
    reached = set()
    for W in range(129, 257):
        for k in range(1, W):
            cfg = AlignerConfig(W=W, O=W // 3, k=k)
            if genasm_dc.kernel_family(cfg, family) == "template":
                kp = genasm_dc.levels_bucket(k)
                reached.add((cfg.nw, kp, cfg.nwb))
                if family == "tail":
                    reached.add((cfg.nw, kp, cfg.nw))
    assert built == reached
    assert {(nw, kp) for nw, kp, _ in built} == \
        genasm_dc.TEMPLATE_KEPT[family]
    registers = genasm_dc.REGISTERS[family]
    assert {key for key in registers if key != "xwide" and key[0] > 4} == \
        genasm_dc.TEMPLATE_KEPT[family]


@pytest.mark.parametrize("unit,family,macro", [
    ("tb_fused.cu", "tb_fused", "K1_(?:SHARED|CASE)"),
    ("tail_fused.cu", "tail", "TAIL_CASE")])
def test_nw_1_to_4_instantiations_are_the_template_routes(unit, family,
                                                          macro):
    """K1's and the tails' instantiations at NW = 1..4 are exactly the
    (NW, KP, NWB) that W = 8..128 and k < W route to (``kernel_family``:
    a template at every NW <= ``NARROW_NW``; NWB = nwb, and for the tails
    also NW: K4, and K2 whose band is the whole vector), and
    ``REGISTERS`` counts those (NW, KP) and no other at NW <= 4."""
    text = (CSRC / unit).read_text()
    built = {tuple(map(int, m)) for m in re.findall(
        rf"{macro}\((\d+), (\d+), (\d+)[,)]", text) + re.findall(
        r"_kernel<(\d+), (\d+), (\d+), PLACE_GLOBAL>", text)}
    reached = set()
    for W in range(8, 129):
        for k in range(1, W):
            cfg = AlignerConfig(W=W, O=W // 3, k=k)
            assert genasm_dc.kernel_family(cfg, family) == "template"
            kp = genasm_dc.levels_bucket(k)
            reached.add((cfg.nw, kp, cfg.nwb))
            if family == "tail":
                reached.add((cfg.nw, kp, cfg.nw))
    assert built == reached
    registers = genasm_dc.REGISTERS[family]
    assert {key for key in registers if key != "xwide" and key[0] <= 4} == \
        {(nw, kp) for nw, kp, _ in built}


@pytest.mark.parametrize("k,kp", [(480, 512), (511, 512), (512, 1024),
                                  (700, 1024), (1500, 2048)])
def test_levels_bucket_extends_to_powers_of_two(k, kp):
    assert genasm_dc.levels_bucket(k) == kp


def test_registers_of_the_wide_family_allow_its_blocks():
    """The register fill's blocks of XR_LANES warps (K1, the tails) and of
    XR_K3_LANES (K3) fit their registers; K1's kernels are bound to four
    blocks an SM (128 registers a thread), the tails' to three, K3's to
    one of 512 threads."""
    cfg = AlignerConfig(W=512, O=192, k=60)
    for family, want in (("tb_fused", 32 * genasm_dc.XR_LANES),
                         ("tail", 32 * genasm_dc.XR_LANES),
                         ("dc_band", 32 * genasm_dc.XR_K3_LANES)):
        regs = genasm_dc.REGISTERS[family]["xwide"]
        assert genasm_dc.registers(family, cfg) == regs
        assert genasm_dc.max_threads(family, cfg) >= want
    assert genasm_dc.REGISTERS["tb_fused"]["xwide"] <= 65_536 // (128 * 4)
    assert genasm_dc.REGISTERS["tail"]["xwide"] <= 65_536 // (128 * 3)
    assert genasm_dc.REGISTERS["dc_band"]["xwide"] <= 65_536 // 512


def test_occupancy_queries_the_wide_kernel(monkeypatch):
    asked = []
    monkeypatch.setattr(genasm_dc, "_occupancy",
                        lambda query, *args: asked.append((query, args))
                        or (2, 232_448))
    cfg = AlignerConfig(W=320, O=96, k=40)
    geos = _geometries(cfg)
    for name in ("tb_fused", "tail_full", "dc_band"):
        genasm_dc.xwide_occupancy(name, geos[name])
    assert asked == [(f"{kernel}_xwide", (geos[name].threads,
                                          geos[name].shared_bytes))
                     for kernel, name in (("tb_fused", "tb_fused"),
                                          ("tail", "tail_full"),
                                          ("dc_band", "dc_band"))]


def test_launch_plan_of_the_w512_ladder():
    """Every rung of the W = 512 ladder (k = 60 -> 480) launches the
    wide family: K1 and K2 at k = 60, 120, K1 and K4 at 240, 480."""
    cfg = AlignerConfig(W=512, O=192, k=60)
    plan_ = launch_plan(cfg, 1000, 3, "cpu")
    assert [(e["kernel"], e["k"]) for e in plan_] == [
        ("tb_fused", 60), ("tail_banded", 60), ("tb_fused", 120),
        ("tail_banded", 120), ("tb_fused", 240), ("tail_full", 240),
        ("tb_fused", 480), ("tail_full", 480)]
    assert all(isinstance(e["geometry"], XW) for e in plan_)
    geo = genasm_dc.xwide_geometry(cfg, "tb_fused")     # 4 warps, 3,640 B
    blocks = min(233_472 // (geo.shared_bytes + 1024), 2048 // geo.threads,
                 32)
    assert windowing.plan_lane_tile(cfg) == 132 * blocks * geo.lanes == 8448


@pytest.mark.parametrize("k", [60, 480])
def test_counting_scratch_in_flight(k):
    cfg = AlignerConfig(W=512, O=192, k=k)
    row = counting.gpu_scratch_in_flight(cfg, "tail_full")
    geo = genasm_dc.xwide_geometry(cfg, "tail_full", 512 + 4 * k)
    blocks = 132 * windowing.sm_blocks(geo.shared_bytes, geo.threads)
    assert row["store_bytes_per_lane"] == 4 * (k + 1) * (512 + 4 * k) * 16
    assert row["scratch_bytes_per_block"] == \
        row["store_bytes_per_lane"] * geo.lanes
    assert row["blocks_in_flight"] == blocks
    assert row["scratch_bytes_in_flight"] == \
        blocks * row["scratch_bytes_per_block"]
    tight = counting.gpu_scratch_in_flight(cfg, "tail_full",
                                           free_bytes=10 ** 10)
    assert tight["scratch_bytes_in_flight"] <= 5 * 10 ** 9
    k3 = counting.gpu_scratch_in_flight(cfg, "dc_band")
    k3_geo = genasm_dc.xwide_geometry(cfg, "dc_band")
    assert k3["store_bytes_per_lane"] == 0 and k3["chunk"] == k3_geo.chunk
    assert k3["scratch_bytes_per_block"] == 4 * 512 * 16 * 16
    assert k3["blocks_in_flight"] == 132 * windowing.sm_blocks(
        k3_geo.shared_bytes, 512)
    assert counting.gpu_scratch_in_flight(AlignerConfig(), "tb_fused") \
        is None


def test_dry_run_reports_the_wide_family_at_w512():
    cfg = AlignerConfig(W=512, O=192, k=480)
    rows = dryrun_aligner.kernel_rows(64, 2000, cfg, 80 * 10 ** 9)
    assert [r["kernel"] for r in rows] == ["tb_fused", "tail_full"]
    k4 = rows[1]
    assert k4["block"]["placement"] == "xwide"
    assert k4["store_bytes_per_lane"] == 74_866_688
    assert k4["store_write_s"] == roofline.store_write_s(74_866_688, 64) \
        == 74_866_688 * 64 / roofline.HBM_BW
    # 133 blocks of 4 lanes, 299.5 MB each, fit half of 80 GB
    assert k4["scratch"]["lanes_in_flight"] == 532
    narrow = dryrun_aligner.kernel_rows(64, 2000, AlignerConfig())
    assert all(r["scratch"] is None for r in narrow)


def test_free_bytes_counts_only_memory_the_launch_can_use(monkeypatch):
    """The wide family's budget: cudaMemGetInfo's free (``genasm_mem_free``,
    read in relaxed capture mode) plus, outside a capture, the free bytes
    of the caching allocator's default pool on the current stream; the
    pools of captured graphs and other streams' blocks are not counted,
    and during a capture nothing but the card's free bytes is."""
    import contextlib

    import torch

    class Lib:
        def genasm_mem_free(self, ref):
            ref._obj.value = 1_000
            return 0

    capturing = []
    segments = [
        dict(device=0, stream=7, segment_pool_id=(0, 0), total_size=500,
             active_size=200),                       # 300 B free: counted
        dict(device=0, stream=7, segment_pool_id=(1, 3), total_size=900,
             active_size=0),                         # a graph's pool
        dict(device=0, stream=9, segment_pool_id=(0, 0), total_size=400,
             active_size=0),                         # another stream's
        dict(device=1, stream=7, segment_pool_id=(0, 0), total_size=800,
             active_size=0)]                         # another card's
    monkeypatch.setattr(genasm_dc, "_library", Lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: bool(capturing))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)
    assert genasm_dc.free_bytes("cuda:0") == 1_300
    capturing.append(True)
    assert genasm_dc.free_bytes("cuda:0") == 1_000


#: a host stand-in for the CUDA header, enough to compile the wide
#: family's headers with a C++ compiler
HOST_CUDA_H = r"""
#pragma once
#include <algorithm>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline dim3 threadIdx, blockIdx, blockDim, gridDim;
using std::max;
using std::min;
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes { int maxDynamicSharedSizeBytes; };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute,
                                                    int) { return 0; }
template <class K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*,
                                                     K) { return 0; }
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int*, K, int, size_t) { return 0; }
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0) {}
template <class T> T __shfl_up_sync(unsigned, T v, unsigned, int = 32) {
  return v;
}
template <class T> T __shfl_down_sync(unsigned, T v, unsigned, int = 32) {
  return v;
}
inline unsigned __ballot_sync(unsigned, int) { return 0; }
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
  return (hi << s) | (lo >> (32 - s));
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned s) {
  return (lo >> s) | (hi << (32 - s));
}
inline int atomicMin(int* p, int v) { int o = *p; *p = min(o, v); return o; }
inline int atomicMax(int* p, int v) { int o = *p; *p = max(o, v); return o; }
"""
LAYOUT_MAIN = r"""
#include <cstdio>
#include "genasm_xwide_reg.cuh"
int main() {
  int kind, nw, k, nwb, cols, jlo, last_max, lanes, threads, smem;
  long long store, lane;
  // kind 0: K1 / the tails (cols jlo last_max ... store lane); kind 1: K3
  // (W ncb chunk ... 0 lane)
  while (std::scanf("%d %d %d %d %d %d %d %d %d %d %lld %lld", &kind, &nw,
                    &k, &nwb, &cols, &jlo, &last_max, &lanes, &threads,
                    &smem, &store, &lane) == 12) {
    if (kind == 1) {
      const XrK3Layout y =
          xr_k3_layout(nw, k, nwb, cols, jlo, lanes, last_max);
      std::printf("%d %d %d %d %d %lld %lld %lld %d %d\n", y.x.strips,
                  y.x.word_strips, y.lane_stride, y.row_stride, y.chunk,
                  y.buf_words, y.raw_words, y.x.lane_words, y.smem,
                  xr_k3_block_ok(y, nw, k, nwb, lanes, threads, smem,
                                 last_max, lane, 1) ? 1 : 0);
      continue;
    }
    const XrLayout x = xr_layout(nw, k, nwb, cols, jlo, last_max, lanes);
    std::printf("%d %d %d %d %d %d %d %lld %lld %lld %lld %lld %lld %d\n",
                x.wt, x.gw, x.height, x.strips, x.word_strips, x.warp_bytes,
                x.smem, x.nwbr, x.nwbs, x.store_words, x.below_words,
                x.carry_words, x.lane_words, xr_block_ok(x, nw, k, nwb, lanes, threads, smem,
                                          store, lane, 1) ? 1 : 0);
  }
}
"""


def test_c_layout_equals_the_python_layout(tmp_path):
    """C's xr_layout and xr_block_ok, and K3's xr_k3_layout and
    xr_k3_block_ok (csrc/genasm_xwide_reg.cuh, compiled for the host with
    a stand-in for the CUDA header) against ``genasm_dc.xr_layout`` /
    ``xr_k3_layout`` and the block ``xwide_geometry`` derives, at every
    case's K1, K2, K4 and K3 (and K3 at 16 lanes and a chunk of 2), and
    at NW = 5, 6 and 8 (``NARROW``, 8 word threads a level group) those
    of K1, K2 and K4 that run the wide family: the same sizes, and a block
    the C launchers accept.  At NW = 3, 4 (``KP128``, templates only) the
    same for K1's, K2's and K4's layout with a block of ``XR_LANES``."""
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        pytest.skip("no host C++ compiler")
    (tmp_path / "cuda_runtime.h").write_text(HOST_CUDA_H)
    (tmp_path / "layout.cpp").write_text(LAYOUT_MAIN)
    subprocess.run([gxx, "-std=c++17", "-w", "-I", str(tmp_path), "-I",
                    str(CSRC), "-o", str(tmp_path / "layout"),
                    str(tmp_path / "layout.cpp")], check=True, timeout=120)
    rows, want = [], []
    for W, O, k in CASES + NARROW + KP128:
        cfg = AlignerConfig(W=W, O=O, k=k)
        n_text = W + 4 * k
        col0 = W + 1 - cfg.ncols_band
        for name, args in (
                ("tb_fused", (cfg.nwb, cfg.ncols_band, col0, W)),
                ("tail_banded", (cfg.nwb, n_text, 1, n_text)),
                ("tail_full", (cfg.nw, n_text, 1, n_text))):
            x = genasm_dc.xr_layout(cfg.nw, k, *args)
            if genasm_dc.kernel_family(cfg, name) == "xwide":
                geo = genasm_dc.xwide_geometry(cfg, name, n_text)
                block = (geo.lanes, geo.threads, geo.shared_bytes,
                         geo.store_words, geo.lane_words)
            elif cfg.nw <= genasm_dc.NARROW_NW:
                lanes = genasm_dc.XR_LANES
                block = (lanes, 32 * lanes, lanes * x["warp_bytes"],
                         x["store_words"], x["lane_words"])
            else:
                assert cfg.nw == 5 and name != "tb_fused"
                continue
            rows.append(" ".join(map(str, (0, cfg.nw, k, *args, *block))))
            want.append([x["wt"], x["gw"], x["height"], x["strips"],
                         x["word_strips"], x["warp_bytes"], block[2],
                         x["nwbr"], x["nwbs"], x["store_words"],
                         x["below_words"], x["carry_words"],
                         x["lane_words"], 1])
        if cfg.nw <= genasm_dc.TEMPLATE_NW:
            assert (x["wt"], x["gw"], x["height"]) == (8, 4, 28)
            continue
        geo = genasm_dc.xwide_geometry(cfg, "dc_band")
        for lanes, chunk in ((geo.lanes, geo.chunk), (16, 2)):
            y = genasm_dc.xr_k3_layout(cfg.nw, k, cfg.nwb, W,
                                       cfg.ncols_band, lanes, chunk)
            rows.append(" ".join(map(str, (
                1, cfg.nw, k, cfg.nwb, W, cfg.ncols_band, chunk, lanes,
                32 * lanes, y["smem"], 0, y["lane_words"]))))
            want.append([y["strips"], y["word_strips"], y["lane_stride"],
                         y["row_stride"], chunk, y["buf_words"],
                         y["raw_words"], y["lane_words"], y["smem"], 1])
        assert (geo.shared_bytes, geo.lane_words) == \
            (genasm_dc.xr_k3_layout(cfg.nw, k, cfg.nwb, W, cfg.ncols_band,
                                    geo.lanes, geo.chunk)["smem"],
             geo.lane_words)
    out = subprocess.run([str(tmp_path / "layout")], input="\n".join(rows),
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split("\n")
    assert [[int(v) for v in line.split()] for line in out if line] == want
