"""K1's block geometry (``genasm_dc.tb_fused_geometry``) over every (W, k)
the CUDA kernels take: W in {16, 32, 64}, 1 <= k < W, with the band in
shared memory; at KP = 128 (k >= 64, W = 96 and 128) with the band in
device memory, in the skewed layout of ``tb_fused.cuh`` (emulated here
word for word); at NW = 5..8 (W = 129..256, every k, KP up to 256) the
block of the family ``genasm_dc.kernel_family`` names (the wide family's
register fill, its band in the block's scratch as rows of raw window
words, emulated as ``XrTile`` writes and ``XrBand`` reads them; a
template where ``TEMPLATE_KEPT`` keeps one); and the block's threads
capped by the kernel's registers.  The geometry is computed on the host,
so it is checked here; the CUDA side refuses anything else
(``chip_smoke.py`` phase ``k1_grid`` launches it)."""
import pytest

from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc

CASES = [(W, k) for W in (16, 32, 64) for k in range(1, W) if k + 1 <= 64]


@pytest.mark.parametrize("W,k", CASES)
def test_tb_fused_geometry(W, k):
    cfg = AlignerConfig(W=W, O=W // 3, k=k)
    geo = genasm_dc.tb_fused_geometry(cfg)
    kp = genasm_dc.levels_bucket(k)
    assert geo.group == min(kp, 32)
    assert geo.group * geo.levels_per_thread == kp >= k + 1
    assert geo.threads % 32 == 0 and 0 < geo.threads <= 1024
    assert geo.lanes * geo.group == geo.threads
    assert geo.shared_bytes <= genasm_dc.MAX_SHARED_BYTES
    # the block's lanes' bands, texts and staged ops fit its shared memory
    need = (cfg.ncols_band * cfg.nwb * (k + 1) + W + cfg.tb_max_ops) * 4
    assert geo.shared_bytes >= geo.lanes * need


@pytest.mark.parametrize("W,k", [(288, 12), (320, 100)])
def test_tb_fused_geometry_refuses_w_over_128(W, k):
    """Since the wide family (NW >= 9) no width is refused: the templates'
    geometry points to the wide family's, and what is refused is a block
    whose band exceeds the card's free memory (here 10,000 B)."""
    cfg = AlignerConfig(W=W, O=W // 3, k=k)
    with pytest.raises(ValueError, match=f"W={W} k={k}: K1's templates "
                       f"stop at NW = 8"):
        genasm_dc.tb_fused_geometry(cfg)
    assert isinstance(genasm_dc.xwide_geometry(cfg, "tb_fused"),
                      genasm_dc.XwideGeometry)
    with pytest.raises(ValueError, match=f"W={W} k={k}: .* B of scratch"):
        genasm_dc.xwide_geometry(cfg, "tb_fused", free_bytes=10_000)


KP128 = [(96, 36, 64), (96, 36, 95), (128, 42, 64), (128, 42, 120),
         (128, 48, 127)]


def _half_bank_pad(words):
    return words + (16 - words % 32) % 32


@pytest.mark.parametrize("W,O,k", KP128)
def test_tb_fused_geometry_at_kp_128_keeps_the_band_in_device_memory(W, O,
                                                                      k):
    """G = 32 threads of L = 4 levels; the band is one lane's
    (ncb + rows0 - 1) x L x nwb x rows0 words of device memory, and the
    block's shared memory holds only texts, staged ops and dists."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    geo = genasm_dc.tb_fused_geometry(cfg)
    assert genasm_dc.levels_bucket(k) == 128
    assert (geo.group, geo.levels_per_thread) == (32, 4)
    assert geo.placement == genasm_dc.K1_PLACEMENT[(cfg.nw, 128)] == \
        "global"
    rows0 = -(-(k + 1) // 4)
    assert geo.band_words == 0
    assert geo.store_words == (cfg.ncols_band + rows0 - 1) * 4 * cfg.nwb * \
        rows0 >= (k + 1) * cfg.ncols_band * cfg.nwb
    assert geo.lanes == genasm_dc.K1_THREADS // 32
    assert geo.shared_bytes == 4 * geo.lanes * (
        _half_bank_pad(W) + cfg.tb_max_ops + 1)
    # the band would not fit a block: why it lives in device memory
    assert (k < 110) or 4 * (k + 1) * cfg.ncols_band * cfg.nwb > \
        genasm_dc.MAX_SHARED_BYTES


#: NW = 5..8: L = 1 (KP = 32), 2 (KP = 64) and 8 (KP = 256, W = 256)
WIDE_BAND = [(160, 48, 30), (192, 64, 63), (256, 96, 240)]


def _xr_band_layout(cfg):
    """The wide K1's band, emulated: the word w of cell (d, j) of a stored
    column (j >= col0) lands at row (d, j - col0) slot w - base(j) / 32,
    base(j) = clamp(j - 2 - k, 0, band_hi), wherever the slot lies in the
    row's nwbr raw words, rows of 8 slots (one 32 B sector, which the
    group's 8 word threads write whole, slot (w - w0) mod 8, the slots
    past the window pads) (``XrTile::step``); every word is distinct and
    inside the lane's store_words, every row holds the words of the
    vector its window spans, and ``XrBand::zero`` finds each window bit
    (offset 0 .. 32 nwb - 1 from base) in the row's slot of its word."""
    geo = genasm_dc.xwide_geometry(cfg, "tb_fused")
    k, nw, nwb, ncb, W = cfg.k, cfg.nw, cfg.nwb, cfg.ncols_band, cfg.W
    col0, band_hi = W + 1 - ncb, 32 * (nw - nwb)
    nwbr = nwb + (nwb < nw)
    assert geo.store_words == (k + 1) * ncb * 8
    seen = {}
    for d in range(k + 1):
        for j in range(col0, W + 1):
            w0 = min(max(j - 2 - k, 0), band_hi) >> 5
            for w in range(w0, min(w0 + nwbr, nw)):
                at = (d * ncb + j - col0) * 8 + w - w0
                assert at not in seen and 0 <= at < geo.store_words
                seen[at] = (d, j, w)
            base = min(max(j - 2 - k, 0), band_hi)
            for off in (0, 31, 32 * nwb - 1):
                pos = base + off
                at = (d * ncb + j - col0) * 8 + (pos >> 5) - (base >> 5)
                assert seen[at] == (d, j, pos >> 5)


@pytest.mark.parametrize("W,O,k", KP128 + WIDE_BAND)
def test_k1_device_band_layout_is_one_to_one_and_the_walk_reads_it(W, O, k):
    """tb_fused.cu's PLACE_GLOBAL, emulated: thread g's level c of band
    column q, word b, lands at ((q + g) * L + c) * nwb * rows0 + g + b *
    rows0; every stored word is distinct and inside the lane's
    store_words, a wavefront step's threads (q + g fixed) write one
    contiguous row of each (level slot, word), and K1Band::word_at finds
    what the fill stored.  Where K1 runs the wide family (``WIDE_BAND``,
    NW = 5..8), its band's rows of raw window words (``_xr_band_layout``)."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    if genasm_dc.kernel_family(cfg, "tb_fused") == "xwide":
        _xr_band_layout(cfg)
        return
    geo = genasm_dc.tb_fused_geometry(cfg)
    L, nwb, ncb = geo.levels_per_thread, cfg.nwb, cfg.ncols_band
    rows0 = -(-(k + 1) // L)
    seen = {}
    for g in range(rows0):
        for c in range(L):
            d = g * L + c
            if d > k:
                break
            for q in range(ncb):
                for b in range(nwb):
                    at = ((q + g) * L + c) * nwb * rows0 + g + b * rows0
                    assert at not in seen and 0 <= at < geo.store_words
                    seen[at] = (d, q, b)
                    word_at = ((q + d // L) * L + d % L) * nwb * rows0 + \
                        d // L
                    assert word_at + b * rows0 == at
    for s in range(ncb + rows0 - 1):        # one step: q + g = s
        row = sorted(at for at, (d, q, b) in seen.items()
                     if q + d // L == s and d % L == 0 and b == 0)
        assert row == list(range(row[0], row[0] + len(row)))


@pytest.mark.parametrize("threads", [32, 64, 256, 512, 1024])
@pytest.mark.parametrize("k", [5, 12, 24, 48])
def test_tb_fused_geometry_block_sizes(k, threads):
    cfg = AlignerConfig(W=64, O=24, k=k)
    geo = genasm_dc.tb_fused_geometry(cfg, threads=threads)
    base = genasm_dc.tb_fused_geometry(cfg)
    assert geo.threads == threads == geo.lanes * geo.group
    assert (geo.group, geo.levels_per_thread) == (base.group,
                                                  base.levels_per_thread)
    # shared memory is per lane: it scales with the block's lanes
    assert geo.shared_bytes * base.lanes == base.shared_bytes * geo.lanes


@pytest.mark.parametrize("threads", [0, 16, 48, 2048])
def test_tb_fused_geometry_refuses_partial_warps(threads):
    with pytest.raises(ValueError, match="whole warps"):
        genasm_dc.tb_fused_geometry(AlignerConfig(), threads=threads)


WIDE_WIDTHS = [(144, 48), (160, 48), (192, 64), (208, 72), (224, 80),
               (256, 96)]


@pytest.mark.parametrize("W,O", WIDE_WIDTHS)
def test_tb_fused_geometry_at_nw_5_to_8(W, O):
    """Every k < W at NW = 5..8, in the family ``kernel_family`` names.
    The wide family: ``XR_LANES`` lane warps a block of 8 word threads x 4
    level groups of ``XR_LEVELS`` (H = 28 levels a strip), within the
    registers' cap; a lane's band (k+1) x ncb rows of 8 slots (one
    sector: nwbr raw words and pads) in the block's scratch, whole sectors
    a lane; shared memory the warps' masks and text; the
    template's geometry refuses it, naming the wide family.  A template
    (``TEMPLATE_KEPT``): the band in device memory (``K1_PLACEMENT``),
    (ncb + rows0 - 1) x L x nwb x rows0 words a lane; G = min(KP, 32)
    threads of L = KP / G levels; ``K1_THREADS`` threads a block, within
    the registers' cap; the block's shared memory holds only texts, staged
    ops and dists."""
    for k in range(1, W):
        cfg = AlignerConfig(W=W, O=O, k=k)
        kp = genasm_dc.levels_bucket(k)
        assert 5 <= cfg.nw <= 8 and kp <= 256
        if genasm_dc.kernel_family(cfg, "tb_fused") == "xwide":
            geo = genasm_dc.xwide_geometry(cfg, "tb_fused")
            assert (geo.words, geo.depth, geo.levels) == (
                8, 4, genasm_dc.XR_LEVELS)
            assert geo.strips == -(-(k + 1) // 28) and geo.word_strips == 1
            assert geo.store_words == (k + 1) * cfg.ncols_band * 8
            assert geo.lane_words % 8 == 0
            assert geo.lanes == genasm_dc.XR_LANES and geo.threads == \
                32 * geo.lanes <= genasm_dc.max_threads("tb_fused", cfg)
            assert geo.shared_bytes == geo.lanes * (
                4 * 5 * 32 + 2 * (genasm_dc.XR_TEXT_CHUNK + 28))
            with pytest.raises(ValueError, match=f"W={W} k={k}: K1 runs "
                               f"the wide family"):
                genasm_dc.tb_fused_geometry(cfg)
            continue
        geo = genasm_dc.tb_fused_geometry(cfg)
        assert geo.placement == "global" == \
            genasm_dc.K1_PLACEMENT[(cfg.nw, kp)]
        assert (geo.group, geo.levels_per_thread) == (min(kp, 32),
                                                      kp // min(kp, 32))
        L = geo.levels_per_thread
        rows0 = -(-(k + 1) // L)
        assert geo.band_words == 0
        assert geo.store_words == (cfg.ncols_band + rows0 - 1) * L * \
            cfg.nwb * rows0 >= (k + 1) * cfg.ncols_band * cfg.nwb
        assert geo.threads == genasm_dc.K1_THREADS <= \
            genasm_dc.max_threads("tb_fused", cfg)
        assert geo.shared_bytes == 4 * geo.lanes * (
            _half_bank_pad(W) + cfg.tb_max_ops + 1) <= \
            genasm_dc.MAX_SHARED_BYTES


@pytest.mark.parametrize("W,O,k,regs,cap", [
    (64, 24, 12, 48, 1024), (128, 48, 96, 112, 576), (192, 64, 100, 128, 512),
    (256, 96, 120, 128, 512), (256, 96, 240, 128, 512)])
def test_k1_threads_are_capped_by_registers(W, O, k, regs, cap):
    """A warp's registers are allocated 8 a thread at a time, a block holds
    65,536: 112 registers (K1 at NW = 4, KP = 128) allow 576 threads, the
    wide family's 128 (K1 from W = 129) 512.  A block past the cap is
    refused naming the registers; the default block (128 threads) is
    within it everywhere."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    assert genasm_dc.registers("tb_fused", cfg) == regs
    assert genasm_dc.max_threads("tb_fused", cfg) == cap
    per_warp = 32 * -(-regs // 8) * 8
    assert cap == min(1024, 65_536 // per_warp * 32)
    if genasm_dc.kernel_family(cfg, "tb_fused") == "xwide":
        assert regs == genasm_dc.REGISTERS["tb_fused"]["xwide"]
        assert genasm_dc.xwide_geometry(cfg, "tb_fused").threads <= cap
        return
    assert genasm_dc.tb_fused_geometry(cfg, threads=cap).threads == cap
    if cap < 1024:
        with pytest.raises(ValueError, match="registers"):
            genasm_dc.tb_fused_geometry(cfg, threads=cap + 32)


@pytest.mark.parametrize("W,O", [(16, 6), (64, 24), (128, 48), (256, 96)])
def test_k1_window_form_block(W, O):
    """K1's window form (``window_step.genasm_tb_window``) adds each
    lane's pattern masks and commit, ``k1_window_words(nw)`` = 4 nw + 2
    words, to the standalone block's shared memory; its threads a lane,
    band and store are the standalone form's, and at every k < W the block
    still fits (halving its lanes where it must).  Where K1 runs the wide
    family (W = 256) both forms take its one block (the window form's
    kernel, ``tb_window_xwide_kernel``, reads its masks and text from
    the slices in the same shared memory), and the template's geometry
    refuses either form."""
    for k in range(1, W):
        cfg = AlignerConfig(W=W, O=O, k=k)
        if genasm_dc.kernel_family(cfg, "tb_fused") == "xwide":
            geo = genasm_dc.xwide_geometry(cfg, "tb_fused")
            assert geo.shared_bytes <= genasm_dc.MAX_SHARED_BYTES
            for window in (False, True):
                with pytest.raises(ValueError, match="runs the wide"):
                    genasm_dc.tb_fused_geometry(cfg, window=window)
            continue
        alone = genasm_dc.tb_fused_geometry(cfg)
        win = genasm_dc.tb_fused_geometry(cfg, window=True)
        assert genasm_dc.k1_window_words(cfg.nw) == 4 * cfg.nw + 2
        assert (win.group, win.levels_per_thread, win.placement,
                win.band_words, win.store_words) == (
            alone.group, alone.levels_per_thread, alone.placement,
            alone.band_words, alone.store_words)
        assert win.shared_bytes == win.lanes * (
            alone.shared_bytes // alone.lanes
            + 4 * genasm_dc.k1_window_words(cfg.nw)) <= \
            genasm_dc.MAX_SHARED_BYTES
        assert win.lanes in (alone.lanes, alone.lanes // 2)
        assert win.threads == win.lanes * win.group
