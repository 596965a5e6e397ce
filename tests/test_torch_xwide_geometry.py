"""The wide family's blocks (NW >= 9, W >= 257: ``csrc/genasm_xwide.cuh``)
on the CPU: lanes, threads and shared bytes of a block, where its ring of
three wavefront steps lies, the scratch a lane, a block and in flight,
the persistent grid, the one refusal (a block's scratch over the card's
free memory, naming W, k and the bytes), and what the session, the
counting model, the dry run and the roofline report for it.  The kernels
themselves run on the card (``chip_smoke.py``); their plain versions are
held to the reference in ``test_torch_w512.py``."""
import pytest

from repro_torch.analysis import roofline
from repro_torch.core import counting, windowing
from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc
from repro_torch.launch import dryrun_aligner
from repro_torch.serve.align_step import launch_plan

XW = genasm_dc.XwideGeometry
CASES = [(288, 96, 20), (288, 96, 100), (320, 96, 40), (320, 96, 200),
         (512, 192, 60), (512, 192, 480), (1024, 300, 40)]


def _geometries(cfg):
    return {name: genasm_dc.xwide_geometry(cfg, name)
            for name in genasm_dc.KERNELS}


@pytest.mark.parametrize("W,O,k", CASES)
def test_wide_block_follows_the_layout(W, O, k):
    """Lanes a power of two <= 16, halved while the block with its ring
    exceeds half a block's shared memory; every lane x WT word roles x DG
    level roles within the registers' cap; the shared bytes of the C
    twin xw_layout (masks, four words a lane, the ring)."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    n_text = W + 4 * k
    stores = {"tb_fused": (k + 1) * cfg.ncols_band * cfg.nwb,
              "tail_banded": (k + 1) * n_text * cfg.nwb,
              "tail_full": (k + 1) * n_text * cfg.nw, "dc_band": 0}
    for name, geo in _geometries(cfg).items():
        assert isinstance(geo, XW)
        assert geo.lanes in (1, 2, 4, 8, 16) and geo.ring == "shared"
        ring = 3 * (k + 1) * cfg.nw * geo.lanes
        assert geo.ring_words == ring
        assert geo.shared_bytes == 4 * (4 * cfg.nw * geo.lanes
                                        + 4 * geo.lanes + ring)
        assert geo.shared_bytes <= genasm_dc.MAX_SHARED_BYTES // 2 \
            or geo.lanes == 1
        if geo.lanes < 16:
            assert genasm_dc._xw_shared(cfg.nw, k, 2 * geo.lanes,
                                        "shared")[1] > \
                genasm_dc.MAX_SHARED_BYTES // 2
        family = "tail" if name.startswith("tail") else name
        cap = genasm_dc.max_threads(family, cfg)
        assert geo.words == min(cfg.nw, cap // geo.lanes)
        assert geo.threads == geo.lanes * geo.words * geo.depth <= cap
        assert geo.depth == max(1, min(k + 1, 512 // (geo.lanes * geo.words)))
        assert geo.store_words == stores[name]
        assert geo.block_words == geo.store_words * geo.lanes


def test_ring_goes_to_device_memory_where_one_lane_fits_no_block():
    """W = 1024, k = 1000: one lane's ring, 3 x 1,001 x 32 words, is
    384,384 B, past a block's 232,448: the ring goes to the block's
    scratch, ``XW_GLOBAL_LANES`` lanes a block, its words in the block's
    scratch after the lanes' stores."""
    cfg = AlignerConfig(W=1024, O=300, k=1000)
    geo = genasm_dc.xwide_geometry(cfg, "tb_fused")
    assert geo.ring == "global" and geo.lanes == genasm_dc.XW_GLOBAL_LANES
    assert geo.ring_words == 3 * 1001 * 32 * geo.lanes
    assert geo.shared_bytes == 4 * (4 * 32 + 4) * geo.lanes
    assert geo.block_words == geo.store_words * geo.lanes + geo.ring_words
    assert genasm_dc.xwide_geometry(cfg, "dc_band").block_words == \
        geo.ring_words


def test_persistent_grid_is_sized_by_blocks_in_flight():
    cfg = AlignerConfig(W=512, O=192, k=480)
    geo = genasm_dc.xwide_geometry(cfg, "tail_full", 2432)
    assert (geo.lanes, geo.store_words) == (1, 481 * 2432 * 16)
    assert genasm_dc.xwide_blocks(geo, 2048, 264) == 264
    assert genasm_dc.xwide_blocks(geo, 37, 264) == 37
    # 4 GB free: half of it holds 26 blocks of one 74,866,688 B store
    assert genasm_dc.xwide_blocks(geo, 2048, 264, 4 * 10 ** 9) == 26
    k3 = genasm_dc.xwide_geometry(cfg, "dc_band")
    assert k3.block_words == 0
    assert genasm_dc.xwide_blocks(k3, 2048, 264, 1) == 264


def test_one_refusal_names_w_k_and_the_bytes():
    """Lanes halve while a block's scratch exceeds half the free memory;
    a block of one lane that still does not fit raises, naming W, k and
    the bytes."""
    cfg = AlignerConfig(W=512, O=192, k=120)
    full = genasm_dc.xwide_geometry(cfg, "tb_fused")
    lane = 4 * full.store_words
    assert full.lanes == 4
    assert genasm_dc.xwide_geometry(cfg, "tb_fused",
                                    free_bytes=5 * lane).lanes == 2
    assert genasm_dc.xwide_geometry(cfg, "tb_fused",
                                    free_bytes=2 * lane).lanes == 1
    with pytest.raises(ValueError, match=rf"W=512 k=120: one block of the "
                       rf"wide K1 needs {lane:,} B of scratch"):
        genasm_dc.xwide_geometry(cfg, "tb_fused", free_bytes=lane)
    big = AlignerConfig(W=512, O=192, k=480)
    with pytest.raises(ValueError, match=r"W=512 k=480: .* wide K4 needs "
                       r"74,866,688 B .* 100,000,000 B free"):
        genasm_dc.check_scratch_fits(big, 10 ** 8)
    genasm_dc.check_scratch_fits(big, 80 * 10 ** 9)
    genasm_dc.check_scratch_fits(AlignerConfig(W=256, O=96, k=240), 1)


@pytest.mark.parametrize("name", ["tb_fused", "tail_banded", "tail_full",
                                  "dc_band"])
def test_templates_and_wide_family_split_at_nw_8(name):
    """Each family has its own geometry: the templates' refuse NW >= 9,
    naming the wide family, and the wide family's refuses NW <= 8."""
    wide, narrow = AlignerConfig(W=288, O=96, k=40), \
        AlignerConfig(W=256, O=96, k=40)
    template = {"tb_fused": lambda c: genasm_dc.tb_fused_geometry(c),
                "tail_banded": lambda c: genasm_dc.tail_geometry(
                    c, c.W + 4 * c.k, 2 * c.W + 4 * c.k, banded=True),
                "tail_full": lambda c: genasm_dc.tail_geometry(
                    c, c.W + 4 * c.k, 2 * c.W + 4 * c.k, banded=False),
                "dc_band": lambda c: genasm_dc.dc_band_geometry(c)}[name]
    with pytest.raises(ValueError, match=r"W=288 k=40: .* templates stop "
                       r"at NW = 8; NW = 9 runs the wide family"):
        template(wide)
    assert not isinstance(template(narrow), XW)
    assert isinstance(genasm_dc.xwide_geometry(wide, name), XW)
    with pytest.raises(ValueError, match="wide family runs NW >= 9, not 8"):
        genasm_dc.xwide_geometry(narrow, name)


@pytest.mark.parametrize("k,kp", [(480, 512), (511, 512), (512, 1024),
                                  (700, 1024), (1500, 2048)])
def test_levels_bucket_extends_to_powers_of_two(k, kp):
    assert genasm_dc.levels_bucket(k) == kp


def test_registers_of_the_wide_family_allow_its_blocks():
    for family in ("tb_fused", "tail", "dc_band"):
        regs = genasm_dc.REGISTERS[family]["xwide"]
        cfg = AlignerConfig(W=512, O=192, k=60)
        assert genasm_dc.registers(family, cfg) == regs
        assert genasm_dc.max_threads(family, cfg) >= genasm_dc.XW_THREADS


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
    assert windowing.plan_lane_tile(cfg) == 132 * 2 * 8


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
    assert counting.gpu_scratch_in_flight(cfg, "dc_band")[
        "scratch_bytes_in_flight"] == 0
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
    assert k4["scratch"]["lanes_in_flight"] == 264
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
