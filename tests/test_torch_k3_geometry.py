"""K3's block geometry (``genasm_dc.dc_band_geometry``) over every (W, k)
the CUDA kernels take: W <= 128, 1 <= k < W (KP up to 128), in both band
placements; W = 129..256 (NW = 5..8, KP up to 256) in the one placement
instantiated there; and the block capped by its registers.  The geometry is computed on the host, so it is checked here;
the CUDA side recomputes the shared bytes (``k3_layout``) and refuses any
other (``chip_smoke.py`` phase ``k3_grid`` launches it)."""
import pytest

from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc

MAX = genasm_dc.MAX_SHARED_BYTES
WIDTHS = [(16, 6), (32, 12), (40, 16), (64, 24), (96, 36), (128, 48)]


def _hand_bytes(cfg, lanes, placement, chunk):
    """Shared bytes worked out from the layout: per lane the text (W codes
    padded to 16 mod 32 words); staged, 2 x chunk ring slots of lanes x
    lane_stride words, lane_stride the smallest odd multiple of
    32 / min(lanes, 32) >= KP * nwb."""
    text = cfg.W + (16 - cfg.W % 32) % 32
    if placement == "direct":
        return 4 * lanes * text, 0
    r = 32 // min(lanes, 32)
    stride = r * next(m for m in range(1, 1000)
                      if m % 2 and m * r >= genasm_dc.levels_bucket(cfg.k)
                      * cfg.nwb)
    return 4 * (lanes * text + 2 * chunk * lanes * stride), stride


@pytest.mark.parametrize("placement", genasm_dc.K3_PLACEMENTS)
@pytest.mark.parametrize("W,O", WIDTHS)
def test_dc_band_geometry_over_every_k(W, O, placement):
    """Whole warps of G = min(KP, 32) threads a lane, the layout's shared
    bytes within the card's limit; staged, a band row leaves the block as
    one 32 B sector or more."""
    for k in range(1, W):
        cfg = AlignerConfig(W=W, O=O, k=k)
        geo = genasm_dc.dc_band_geometry(cfg, placement=placement)
        kp = genasm_dc.levels_bucket(k)
        assert geo.group == min(kp, 32)
        assert geo.group * geo.levels_per_thread == kp >= k + 1
        assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
        assert geo.lanes * geo.group == geo.threads
        assert geo.placement == placement
        assert geo.chunk == genasm_dc.K3_CHUNK[kp]
        assert geo.shared_bytes <= MAX
        assert (geo.shared_bytes, geo.lane_stride) == _hand_bytes(
            cfg, geo.lanes, placement, geo.chunk)
        if placement == "staged":
            assert 4 * geo.lanes >= 32
            assert geo.lane_stride >= kp * cfg.nwb


# (k) -> (G, L, lanes, threads, placement, shared bytes) at W=64, O=24,
# 16 lanes a block: text 80 words a lane (64 padded to 16 mod 32);
# staged, a ring of 2 x chunk steps x 16 lanes x lane_stride, lane_stride
# = KP * nwb up to an odd multiple of 2
LADDER = {12: (16, 1, 16, 256, "direct", 4 * 16 * 80),
          24: (32, 1, 16, 512, "staged",
               4 * (16 * 80 + 2 * 8 * 16 * 66)),      # 64 -> 66, chunk 8
          48: (32, 2, 16, 512, "staged",
               4 * (16 * 80 + 2 * 4 * 16 * 130))}     # 128 -> 130, chunk 4


@pytest.mark.parametrize("k", sorted(LADDER))
def test_dc_band_geometry_of_the_ladder(k):
    geo = genasm_dc.dc_band_geometry(AlignerConfig(k=k))
    assert (geo.group, geo.levels_per_thread, geo.lanes, geo.threads,
            geo.placement, geo.shared_bytes) == LADDER[k]


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("k", [5, 12, 24, 48])
def test_dc_band_geometry_honours_threads(k, threads):
    cfg = AlignerConfig(W=64, O=24, k=k)
    geo = genasm_dc.dc_band_geometry(cfg, threads, placement="direct")
    assert geo.threads == threads == geo.lanes * geo.group
    if geo.lanes >= 8 and _hand_bytes(cfg, geo.lanes, "staged",
                                      geo.chunk)[0] > MAX:
        with pytest.raises(ValueError, match="shared memory"):
            genasm_dc.dc_band_geometry(cfg, threads, placement="staged")
    elif geo.lanes >= 8:
        staged = genasm_dc.dc_band_geometry(cfg, threads, placement="staged")
        assert staged.threads == threads and staged.lanes == geo.lanes
    else:       # a staged row would be narrower than a 32 B sector
        with pytest.raises(ValueError, match="32 B"):
            genasm_dc.dc_band_geometry(cfg, threads, placement="staged")


@pytest.mark.parametrize("threads", [0, 16, 48, 2048])
def test_dc_band_geometry_refuses_partial_warps(threads):
    with pytest.raises(ValueError, match="whole warps"):
        genasm_dc.dc_band_geometry(AlignerConfig(), threads)


@pytest.mark.parametrize("chunk", [0, 3, 12, 128])
def test_dc_band_geometry_refuses_a_ring_chunk_that_is_no_power_of_two(chunk):
    with pytest.raises(ValueError, match="power of two"):
        genasm_dc.dc_band_geometry(AlignerConfig(), chunk=chunk)


def test_dc_band_geometry_refuses_what_does_not_fit_or_exist():
    # 32 lanes of KP=64 x nwb=4 words, 16 steps of ring: far past a block
    with pytest.raises(ValueError, match="shared memory"):
        genasm_dc.dc_band_geometry(AlignerConfig(W=128, O=48, k=48), 1024,
                                   placement="staged", chunk=16)
    # the wide family (NW >= 9): one lane's buffer of the level below a
    # strip, 1,024 x 32 words = 131,072 B, against half of 200,000 B free
    with pytest.raises(ValueError, match="W=1024 k=1000: .* 131,072 B"):
        genasm_dc.xwide_geometry(AlignerConfig(W=1024, O=300, k=1000),
                                 "dc_band", free_bytes=200_000)
    with pytest.raises(ValueError, match="placement"):
        genasm_dc.dc_band_geometry(AlignerConfig(), placement="shared")


def test_k3_takes_no_block_from_lane_tile():
    base = genasm_dc.dc_band_geometry(AlignerConfig())
    assert genasm_dc.dc_band_geometry(AlignerConfig(lane_tile=2816)) == base


WIDE_WIDTHS = [(144, 48), (160, 48), (192, 64), (208, 72), (224, 80),
               (256, 96)]


@pytest.mark.parametrize("W,O", WIDE_WIDTHS)
def test_dc_band_geometry_at_nw_5_to_8(W, O):
    """Every k < W at NW = 5..8: the placement ``K3_PLACEMENT`` names
    (the other one is not instantiated: ValueError), a power of two lanes
    a block (at most ``K3_LANES``), within the registers' cap and the
    shared memory, 8 lanes or more staged, and the layout's bytes."""
    for k in range(1, W):
        cfg = AlignerConfig(W=W, O=O, k=k)
        kp = genasm_dc.levels_bucket(k)
        geo = genasm_dc.dc_band_geometry(cfg)
        assert geo.placement == genasm_dc.K3_PLACEMENT[kp]
        assert geo.chunk == genasm_dc.K3_CHUNK[kp]
        assert geo.group == min(kp, 32) and geo.lanes * geo.group == \
            geo.threads <= genasm_dc.max_threads("dc_band", cfg)
        assert geo.lanes & (geo.lanes - 1) == 0 and \
            geo.lanes <= genasm_dc.K3_LANES
        assert geo.shared_bytes <= MAX
        assert (geo.shared_bytes, geo.lane_stride) == _hand_bytes(
            cfg, geo.lanes, geo.placement, geo.chunk)
        if geo.placement == "staged":
            assert geo.lanes >= 8
        other = next(p for p in genasm_dc.K3_PLACEMENTS
                     if p != geo.placement)
        with pytest.raises(ValueError, match="instantiated"):
            genasm_dc.dc_band_geometry(cfg, placement=other)


@pytest.mark.parametrize("W,O,k,lanes,stride,shared,why", [
    # NW = 8: a slot of 2,048 words a lane -> 2,052 (an odd multiple of 4
    # at 8 lanes); two slots of one step for 8 lanes + 8 texts of 272; 16
    # lanes would need 262 KB of shared memory
    (256, 96, 240, 8, 2052, 4 * (8 * 272 + 2 * 8 * 2052), "shared memory"),
    (256, 96, 128, 8, 2052, 4 * (8 * 272 + 2 * 8 * 2052), "shared memory"),
    # NW = 5: 1,280 -> 1,284; 16 lanes would fit the shared memory (173
    # KB) but not the registers (149: 416 threads a block)
    (144, 48, 128, 8, 1284, 4 * (8 * 144 + 2 * 8 * 1284), "registers")])
def test_dc_band_geometry_at_kp_256_takes_8_lanes_and_chunk_1(
        W, O, k, lanes, stride, shared, why):
    cfg = AlignerConfig(W=W, O=O, k=k)
    geo = genasm_dc.dc_band_geometry(cfg)
    assert (geo.group, geo.levels_per_thread) == (32, 8)
    assert (geo.placement, geo.chunk, geo.lanes, geo.threads) == \
        ("staged", 1, lanes, 32 * lanes)
    assert (geo.lane_stride, geo.shared_bytes) == (stride, shared)
    with pytest.raises(ValueError, match=why):      # K3_LANES' 16 lanes
        genasm_dc.dc_band_geometry(cfg, 512)
    with pytest.raises(ValueError, match="shared memory"):
        genasm_dc.dc_band_geometry(cfg, 256, chunk=2 if W == 256 else 8)


@pytest.mark.parametrize("W,O,k,lanes", [
    (128, 48, 96, 16),       # 80 registers: 800 threads, 16 lanes
    (192, 64, 100, 16),      # 112: 576
    (208, 72, 100, 8),       # 122: 512 -- the ring (197 KB) halves it
    (256, 96, 120, 8),       # 142: 448
    (256, 96, 30, 16)])      # 89: 704
def test_dc_band_geometry_caps_lanes_by_registers(W, O, k, lanes):
    """``K3_LANES`` (16) is a 512-thread block at G = 32; the lanes halve
    while the block's threads exceed what its registers allow (65,536 a
    block, 8 a thread at a time) or its ring the shared memory."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    geo = genasm_dc.dc_band_geometry(cfg)
    cap = genasm_dc.max_threads("dc_band", cfg)
    assert geo.lanes == lanes and geo.threads <= cap < 1024
    # one warp past the cap, its ring one step a slot so that the shared
    # memory fits: refused for its registers
    with pytest.raises(ValueError, match="registers"):
        genasm_dc.dc_band_geometry(cfg, cap + 32, chunk=1)
    assert genasm_dc.dc_band_geometry(cfg, cap, chunk=1).threads == cap
