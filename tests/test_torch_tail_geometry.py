"""The blocks of the warp-cooperative kernels, computed on the host: the
tails' ``genasm_dc.tail_geometry`` against bytes worked out by hand for
the rescue ladder's configurations, K1's ``tb_fused_geometry`` lowering
its lanes per block where W > 64 makes a lane's band large, the tails'
store going to device memory wherever one lane's does not fit a block,
and ``lane_tile`` setting no block.  The CUDA side recomputes the same
sizes and refuses any other (``chip_smoke.py`` phases ``k1_grid`` and
``tail_grid`` launch them)."""
import pytest

from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc

MAX = genasm_dc.MAX_SHARED_BYTES


def _tail(cfg, banded, placement=None):
    n_text = cfg.W + 4 * cfg.k
    return genasm_dc.tail_geometry(cfg, n_text, cfg.W + n_text,
                                   banded=banded, placement=placement)


# (k, kernel, placement) -> (G, L, lanes, shared bytes, store words a lane)
# at W=64, O=24, n_text = W + 4k, max_ops = W + n_text:
#   shared: 4 * (lanes * (store + text + max_ops + 1) + 1) with the store
#   k+1 rows of n_text*nwb words (+1 where that makes the stride minus nwb
#   even) padded to 16 mod 32, the text n_text padded the same way
#   global: store (n_text + rows0 - 1) * L * nwb * rows0 words in device
#   memory, rows0 = ceil((k+1)/L); shared: 4 * (lanes * (text + max_ops
#   + 1) + 1)
LADDER = {
    # k=12, K2: 13 x 112 = 1,456 words (16 mod 32); text 112; ops 176
    (12, "tail_banded", "shared"): (16, 1, 8, 4 * (8 * 1745 + 1), 0),
    (12, "tail_banded", "global"): (16, 1, 8, 4 * (8 * 289 + 1), 124 * 13),
    # k=24, K4: 25 x 321 = 8,025 -> 8,048 words; text 160 -> 176; ops 224;
    # four lanes (135,188 B) fit one block
    (24, "tail_full", "shared"): (32, 1, 4, 4 * (4 * 8449 + 1), 0),
    (24, "tail_full", "global"): (32, 1, 4, 4 * (4 * 401 + 1),
                                  184 * 2 * 25),
    # k=48, K4: 49 x 513 = 25,137 -> 25,168 words; text 256 -> 272; ops
    # 320; four lanes need 412,180 B, so two (206,092 B)
    (48, "tail_full", "shared"): (32, 2, 2, 4 * (2 * 25761 + 1), 0),
    (48, "tail_full", "global"): (32, 2, 4, 4 * (4 * 593 + 1),
                                  280 * 2 * 2 * 25),
}


@pytest.mark.parametrize("key", sorted(LADDER), ids=str)
def test_tail_geometry_of_the_ladder(key):
    k, kernel, placement = key
    cfg = AlignerConfig(k=k)
    assert cfg.tail_banded == (kernel == "tail_banded")
    geo = _tail(cfg, kernel == "tail_banded", placement)
    group, levels, lanes, shared, store = LADDER[key]
    assert (geo.group, geo.levels_per_thread, geo.lanes, geo.shared_bytes,
            geo.store_words) == (group, levels, lanes, shared, store)
    assert geo.placement == placement and geo.threads == lanes * group
    assert geo.shared_bytes <= MAX


@pytest.mark.parametrize("W,O", [(16, 6), (32, 12), (40, 16), (64, 24),
                                 (96, 36), (128, 48)])
@pytest.mark.parametrize("banded", [True, False])
def test_tail_store_goes_global_where_a_lane_does_not_fit(W, O, banded):
    """Every k of the width: the default geometry always launches (whole
    warps, within the shared limit); asked for shared memory it either
    fits or raises naming W, k and the bytes, and then the default puts
    the store in device memory."""
    for k in range(1, W):
        cfg = AlignerConfig(W=W, O=O, k=k)
        geo = _tail(cfg, banded)
        assert geo.threads % 32 == 0 and 32 <= geo.threads <= 1024
        assert geo.lanes * geo.group == geo.threads
        assert geo.shared_bytes <= MAX
        assert (geo.store_words > 0) == (geo.placement == "global")
        try:
            shared = _tail(cfg, banded, "shared")
        except ValueError as exc:
            assert f"W={W} k={k}" in str(exc) and " B " in str(exc)
            assert geo.placement == "global"
            continue
        assert shared.placement == "shared" and shared.shared_bytes <= MAX
        if genasm_dc.TAIL_PLACEMENT[(cfg.nw, genasm_dc.levels_bucket(k))] \
                == "shared":
            assert geo == shared


@pytest.mark.parametrize("W,O,k", [(96, 36, 64), (96, 36, 95),
                                   (128, 48, 127)])
def test_tail_store_at_kp_128(W, O, k):
    """What tail_store resolves to at KP = 128, where the band (2k+3 bits)
    is the whole vector: 'auto' and 'full' take K4, 'band' K2 with nwb =
    nw; each the (NW, 128, NW) instantiation, G = 32 threads of L = 4
    levels, its store in device memory (a lane's fits no block)."""
    for tail_store, banded in (("auto", False), ("full", False),
                               ("band", True)):
        cfg = AlignerConfig(W=W, O=O, k=k, tail_store=tail_store)
        assert cfg.tail_banded == banded and cfg.nwb == cfg.nw
        geo = _tail(cfg, None)
        assert (geo.group, geo.levels_per_thread) == (32, 4)
        assert geo.placement == "global" == \
            genasm_dc.TAIL_PLACEMENT[(cfg.nw, 128)]
        rows0 = -(-(k + 1) // 4)
        assert geo.store_words == (W + 4 * k + rows0 - 1) * 4 * cfg.nw * \
            rows0
        assert geo == _tail(cfg, not banded)     # the same instantiation
        with pytest.raises(ValueError, match=f"W={W} k={k}"):
            _tail(cfg, None, "shared")


@pytest.mark.parametrize("W,O,k,lanes", [
    (64, 24, 48, 4), (96, 36, 24, 4), (96, 36, 48, 2), (128, 48, 24, 4),
    (128, 48, 48, 2), (128, 48, 63, 1)])
def test_tb_fused_geometry_lowers_lanes_per_block(W, O, k, lanes):
    """K1 at NW = 3 and 4: the lanes per block halve while the block's
    shared bytes exceed the card's, down to one lane (one warp)."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    geo = genasm_dc.tb_fused_geometry(cfg)
    assert geo.lanes == lanes and geo.threads == lanes * geo.group
    assert geo.shared_bytes <= MAX
    if lanes < genasm_dc.K1_THREADS // geo.group:
        wider = genasm_dc.tb_fused_geometry(cfg, threads=2 * geo.threads)
        assert wider.shared_bytes > MAX


@pytest.mark.parametrize("W", [96, 128])
def test_tb_fused_geometry_fits_every_k_at_nw_3_and_4(W):
    for k in range(1, W):
        geo = genasm_dc.tb_fused_geometry(AlignerConfig(W=W, O=W // 3, k=k))
        assert geo.threads % 32 == 0 and geo.shared_bytes <= MAX


@pytest.mark.parametrize("fields", [dict(W=288, O=96, k=64),
                                    dict(W=320, O=48, k=12)])
def test_uninstantiated_configs_raise_naming_w_and_k(fields):
    """Every W has a kernel (at NW >= 9 the wide family); what is refused
    is a block whose scratch exceeds the card's free memory (here 1,000
    B), naming W, k and the bytes."""
    cfg = AlignerConfig(**fields)
    want = f"W={cfg.W} k={cfg.k}: one block of the wide .* B of scratch"
    n_text = cfg.W + 4 * cfg.k
    with pytest.raises(ValueError, match=want):
        genasm_dc.xwide_geometry(cfg, "tb_fused", free_bytes=1_000)
    with pytest.raises(ValueError, match=want):
        genasm_dc.xwide_geometry(cfg, "tail_banded", n_text, 1_000)
    with pytest.raises(ValueError, match=want):
        genasm_dc.check_scratch_fits(cfg, 1_000)
    genasm_dc.check_scratch_fits(cfg, 80 * 10 ** 9)
    with pytest.raises(ValueError, match="the tail's templates stop"):
        _tail(cfg, True)


@pytest.mark.parametrize("k", [12, 24, 48])
def test_no_block_comes_from_lane_tile(k):
    """The reference's lane_tile='auto' (2,816) is the batch pad unit
    only: every kernel's block is the same as at lane_tile=128."""
    cfg, tiled = AlignerConfig(k=k), AlignerConfig(k=k, lane_tile=2816)
    assert genasm_dc.tb_fused_geometry(tiled) == \
        genasm_dc.tb_fused_geometry(cfg)
    for banded in (True, False):
        for placement in genasm_dc.PLACEMENTS:
            try:
                want = _tail(cfg, banded, placement)
            except ValueError:
                continue
            got = _tail(tiled, banded, placement)
            assert got == want and got.threads <= 1024


WIDE_WIDTHS = [(144, 48), (160, 48), (192, 64), (208, 72), (224, 80),
               (256, 96)]


def _xr_tail(cfg, banded):
    """The wide tail's block at the aligner's n_text = W + 4k: one lane
    warp of 8 word threads x 4 level groups, ``XR_LANES`` a block within
    the registers' cap, its store (k+1) x n_text rows of nwbr raw words
    (nwb, plus one where the window is narrower than the vector; K4: nw)
    in rows of 8 slots (one sector) in the block's scratch (device
    memory), whole sectors a lane; the templates' geometry refuses the
    configuration, naming the wide family."""
    n_text = cfg.W + 4 * cfg.k
    nwb = cfg.nwb if banded else cfg.nw
    geo = genasm_dc.xwide_geometry(
        cfg, "tail_banded" if banded else "tail_full", n_text)
    assert (geo.words, geo.depth, geo.nwb) == (8, 4, nwb)
    assert geo.lanes == genasm_dc.XR_LANES and geo.threads == \
        32 * geo.lanes <= genasm_dc.max_threads("tail", cfg)
    assert geo.shared_bytes <= MAX
    assert geo.store_words == (cfg.k + 1) * n_text * 8
    assert geo.lane_words % 8 == 0
    with pytest.raises(ValueError, match=f"W={cfg.W} k={cfg.k}: the tail "
                       f"runs the wide family"):
        _tail(cfg, banded)
    return geo


@pytest.mark.parametrize("W,O", WIDE_WIDTHS)
@pytest.mark.parametrize("banded", [True, False])
def test_tail_store_at_nw_5_to_8_is_global_only(W, O, banded):
    """Every k < W at NW = 5..8: the store in device memory, in the family
    ``kernel_family`` names: the wide family's block scratch
    (``_xr_tail``), or a template's (``TEMPLATE_KEPT``; the only placement
    instantiated there, asked for shared memory a ValueError naming W and
    k), whole warps within the registers' cap and the shared memory, the
    skewed layout's words a lane."""
    for k in range(1, W):
        cfg = AlignerConfig(W=W, O=O, k=k)
        if genasm_dc.kernel_family(cfg, "tail") == "xwide":
            _xr_tail(cfg, banded)
            continue
        geo = _tail(cfg, banded)
        kp = genasm_dc.levels_bucket(k)
        assert geo.placement == "global" == \
            genasm_dc.TAIL_PLACEMENT[(cfg.nw, kp)]
        assert geo.threads % 32 == 0 and geo.lanes * geo.group == \
            geo.threads <= genasm_dc.max_threads("tail", cfg)
        assert geo.shared_bytes <= MAX
        L, nwb = geo.levels_per_thread, cfg.nwb if banded else cfg.nw
        rows0 = -(-(k + 1) // L)
        assert geo.store_words == (W + 4 * k + rows0 - 1) * L * nwb * rows0
        with pytest.raises(ValueError, match=f"W={W} k={k}: .*instantiated"):
            _tail(cfg, banded, "shared")


@pytest.mark.parametrize("W,O,k", [(144, 48, 128), (256, 96, 240)])
def test_tail_store_at_kp_256(W, O, k):
    """KP = 256 (k >= 128): the band (2k+3 bits) is the whole vector, so
    'auto' and 'full' take K4 and 'band' K2 with nwb = nw, one kernel and
    one block.  At W = 144 (NW 5) the template (``TEMPLATE_KEPT``): G = 32
    threads of L = 8 levels, the skewed layout in device memory.  At W =
    256 the wide family (``_xr_tail``): a lane's store (k+1) x n_text x
    nw words, 9.4 MB at k = 240 (n_text = 1,216; the template's skewed
    layout took 9.9 MB), in nine strips of 28 levels."""
    for tail_store, banded in (("auto", False), ("full", False),
                               ("band", True)):
        cfg = AlignerConfig(W=W, O=O, k=k, tail_store=tail_store)
        assert cfg.tail_banded == banded and cfg.nwb == cfg.nw
        if W == 144:
            assert genasm_dc.kernel_family(cfg, "tail") == "template"
            geo = _tail(cfg, None)
            assert (geo.group, geo.levels_per_thread) == (32, 8)
            rows0 = -(-(k + 1) // 8)
            assert geo.store_words == (W + 4 * k + rows0 - 1) * 8 * \
                cfg.nw * rows0
            assert geo == _tail(cfg, not banded)
            continue
        assert genasm_dc.kernel_family(cfg, "tail") == "xwide"
        geo = _xr_tail(cfg, banded)
        assert geo == _xr_tail(cfg, not banded)
        assert geo.strips == -(-(k + 1) // 28) == 9
        assert 4 * geo.store_words == 9_377_792
