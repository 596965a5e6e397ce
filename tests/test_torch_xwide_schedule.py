"""The wide family's register fill (K1, K2 / K4 at NW >= 5 and K3 at NW
>= 9, ``csrc/genasm_xwide_reg.cuh``) as a numpy model that runs the kernel's
schedule step by step: one warp a lane, WT word threads x GW level groups
of L = ``XR_LEVELS`` levels each holding one word of its levels for steps
s-1 and s-2, the level skew (level d at column s - d + 1), word w-1's
carries by a shift along the word threads (word 0's from the virtual word
-1, s > 2d, or from the word strip below's packed carry words), the level
below a group from the group below and a strip's from the strip before
(the store, or the lane's buffer), level strips up to the one that holds
the lane's dist and word strips of 32 words past NW = 32.  Every (level,
column) word the model computes equals the plain fill's
(``genasm_dc._fill``), its dist the plain dist, and the raw window words
it stores (``xr_layout``'s rows of nwbr raw words, nwbs apart) equal the
plain K1 band
(``dc_band_plain``, the windows funnelled out of the raw words as
``XrBand`` reads them) and the plain K2 / K4 stores.  K3's schedule runs
every strip and puts each stored cell's raw word into the block's staging
buffer where its window spans it (and, past a word strip's bottom, the
raw top words the strip below kept), flushed every chunk steps, each
window word funnelled out of two raw words: its band and dist equal
``dc_band_plain``'s.  W = 288 (NW 9), 320 and 512 at k = 20, 60 and 200
(WT = 16, GW = 2: strips at k >= 14), and W = 1100 (two word strips);
K1 and the tails also at W = 144 (NW 5), 192 and 256 (NW 8) at k = 20,
60 and 140 / 188 / 200 (WT = 8, GW = 4: strips at k >= 28, a lane's
level below a strip in its buffer where nwb < NW).  About 40 s on one
CPU."""
import numpy as np
import pytest
import torch

from repro_torch.core.bitops import extract_window
from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc
from repro_torch.kernels.ops import _to_kernel_layout
from tests.test_torch_kp128 import _square, _tails
from tests.test_torch_kp128 import few_torch_threads  # noqa: F401

L = genasm_dc.XR_LEVELS
ONES = np.uint32(0xFFFFFFFF)
TOP = np.uint32(31)


def ones_below_word(d, w):
    """Word w of ~0 << d (d may be -1: all ones)."""
    lo = np.clip(np.asarray(d) - 32 * np.asarray(w), 0, 32)
    return np.where(lo >= 32, np.uint32(0),
                    (np.uint64(0xFFFFFFFF) << lo.astype(np.uint64))
                    .astype(np.uint32))


def funnel(lo, hi):
    """(hi << 1) | the top bit of lo: __funnelshift_l(lo, hi, 1)."""
    return (hi << np.uint32(1)) | (lo >> TOP)


def model_lane(masks, text, last, k, nw, nwb, cols, jlo, boff, last_max,
               tgt, k3=None):
    """One lane through the register fill.  masks (4, nw) uint32, text
    (n_text,) codes.  Returns (computed, store, dist): every word the
    model computed, (words, where set) of shape (k+1, last+1, nw), the
    raw store rows (words, where written) and the lane's dist.  With `k3`
    (``K3Out``: K3's staging and band; `cols` 0, no store) every strip
    runs and the stored columns' windows go out through it."""
    x = genasm_dc.xr_layout(nw, k, nwb, cols, jlo, last_max)
    WT, GW, H, nwbr = x["wt"], x["gw"], x["height"], x["nwbr"]
    nwbs = x["nwbs"]
    band_hi = 32 * (nw - nwb)
    text = np.asarray(text)
    n_text = len(text)
    table = np.full((5, x["word_strips"] * WT), ONES, np.uint32)
    table[:4, :nw] = masks
    store = np.zeros((k + 1) * cols * nwbs, np.uint32)
    written = np.zeros(store.shape, bool)
    below_buf = np.zeros((max(last_max, 1), nw), np.uint32)
    carry = [np.zeros(last_max + H - 1, np.uint32) for _ in range(2)]
    computed = np.zeros((k + 1, last + 1, x["word_strips"] * WT), np.uint32)
    done = np.zeros(computed.shape, bool)
    g = np.arange(GW)[:, None, None]
    lv = np.arange(L)[None, :, None]
    d = np.broadcast_to(g * L + lv, (GW, L, WT))       # + a
    skew = np.ascontiguousarray(np.broadcast_to(-(g * L + lv), d.shape))
    steps = last + H - 1 if last > 0 else 0
    dist = k + 1
    for a in range(0, k + 1, H):
        if dist <= k and k3 is None:
            break
        below_in = None if a == 0 else "store" if x["below_in_store"] \
            else "buf"
        below_out = a + H <= k and not x["below_in_store"]
        for b in range(x["word_strips"]):
            w = np.broadcast_to(b * WT + np.arange(WT)[None, None, :],
                                (GW, L, WT))
            dd = a + d
            d0 = a + g[:, 0, 0] * L                      # (GW,)
            cin = carry[(b - 1) & 1] if b > 0 else None
            cout = carry[b & 1] if b + 1 < x["word_strips"] else None
            w1 = w[:, 0, :]                              # (GW, WT)

            def virtual(s):
                """wt 0's carry bits of the virtual word -1 at step s:
                (GW, L) for the levels, (GW,) for the level below."""
                return s > 2 * dd[:, :, 0], s > 2 * (d0 - 1)

            def carries(u):
                if cin is None:
                    return virtual(a + u)
                e = int(cin[u])
                lev = np.array([(e >> ll) & 1 for ll in range(L)], bool)
                return lev[None].repeat(GW, 0), \
                    np.full(GW, (e >> L) & 1, bool)

            def below_word(j):
                if below_in is None:
                    return np.full(WT, ONES, np.uint32)
                jj = min(j, last)
                out = np.full(WT, ONES, np.uint32)
                ok = w1[0] < nw
                if below_in == "store":
                    row = (a - 1) * cols + jj - jlo
                    out[ok] = store[row * nwbs + w1[0][ok]]
                else:
                    out[ok] = below_buf[jj - 1, w1[0][ok]]
                return out

            cur = ones_below_word(dd, w)
            prv = cur.copy()
            bwp = ones_below_word(d0[:, None] - 1, w1)
            # step -1's shuffles of column 0
            lev, bel = virtual(a - 1)
            spp = np.concatenate([np.zeros((GW, L, 1), np.uint32),
                                  cur[:, :, :-1]], 2)
            blp = np.concatenate([np.zeros((GW, 1), np.uint32),
                                  bwp[:, :-1]], 1)
            if b == 0:
                spp[:, :, 0] = lev.astype(np.uint32) << TOP
                blp[:, 0] = bel.astype(np.uint32) << TOP
            else:
                spp[:, :, 0] = ones_below_word(dd[:, :, 0], w[:, :, 0] - 1)
                blp[:, 0] = ones_below_word(d0 - 1, w1[:, 0] - 1)
            if k3 is not None:
                k3.tile(b, WT, GW)
            elif jlo == 0:                               # K1's column 0
                put(store, written, dd, 0, cur, w, k, nw, cols, jlo,
                    boff, band_hi, nwbr, nwbs, np.ones(cur.shape, bool))
            for u in range(steps):
                s = a + u
                bwn = np.empty((GW, WT), np.uint32)
                bwn[0] = below_word(u + 1)
                bwn[1:] = cur[:-1, L - 1]                # the group below
                lev, bel = carries(u)
                bln = np.concatenate([np.zeros((GW, 1), np.uint32),
                                      bwn[:, :-1]], 1)
                bln[:, 0] = bel.astype(np.uint32) << TOP
                spc = np.concatenate([np.zeros((GW, L, 1), np.uint32),
                                      cur[:, :, :-1]], 2)
                spc[:, :, 0] = lev.astype(np.uint32) << TOP
                if cout is not None:
                    top = cur[0, :, WT - 1] >> TOP
                    cout[u] = sum(int(t) << ll for ll, t in enumerate(top)) \
                        | (int(bwn[0, WT - 1] >> TOP) << L)
                bn = np.concatenate([bwn[:, None], cur[:, :-1]], 1)
                bnl = np.concatenate([bln[:, None], spc[:, :-1]], 1)
                bo = np.concatenate([bwp[:, None], prv[:, :-1]], 1)
                bol = np.concatenate([blp[:, None], spp[:, :-1]], 1)
                t = u + skew                             # s - d
                code = text[np.clip(t, 0, n_text - 1)]
                row = np.where((code >= 0) & (code < 4), code, 4)
                pm = table[row, w]
                v = (funnel(spc, cur) | pm) & funnel(bol, bo) & bo & \
                    funnel(bnl, bn)
                j = t + 1
                on = (j >= 1) & (j <= last)
                new = np.where(on, v, cur)
                if k3 is None:
                    keep = on & (dd <= k)
                    computed[dd[keep], j[keep], w[keep]] = new[keep]
                    done[dd[keep], j[keep], w[keep]] = True
                if k3 is None:
                    put(store, written, dd, j, new, w, k, nw, cols, jlo,
                        boff, band_hi, nwbr, nwbs, on, wrap=nw <= 8)
                else:
                    k3.stage(u, j, new, w, on)
                    if (u + 1) % k3.chunk == 0 or u + 1 == steps:
                        k3.flush(u - u % k3.chunk, u % k3.chunk + 1, a, b,
                                 H)
                if below_out:
                    jt = u - H + 2
                    if 1 <= jt <= last:
                        ok = w1[GW - 1] < nw
                        below_buf[jt - 1, w1[GW - 1][ok]] = \
                            new[GW - 1, L - 1][ok]
                prv, cur, spp, bwp, blp = cur, new, spc, bwn, bln
            if (tgt >> 5) // WT == b:                    # the ballot
                hit = (w == tgt >> 5) & (dd <= k) & \
                    (((cur >> np.uint32(tgt & 31)) & 1) == 0)
                if hit.any():
                    dist = min(dist, int(dd[hit].min()))
    return (computed[..., :nw], done[..., :nw]), (store, written), dist


class K3Out:
    """K3's way out of a lane's tiles (``XrK3Out``): the block's two
    staging buffers, rows (step of the chunk, level of the strip) x lanes
    x lane_stride raw words (``xr_k3_layout``), this lane at `ll`; the raw
    top words a word strip keeps for the next; the flush of a chunk's rows
    to the lane's band (k+1, ncb, nwb), each window word b funnelled out of
    raw words b and b + 1 by the tile whose word strip holds its upper raw
    word (its lower at the vector's top, where the upper is not read)."""

    def __init__(self, W, k, nw, nwb, ncb, lanes, ll, chunk):
        y = genasm_dc.xr_k3_layout(nw, k, nwb, W, ncb, lanes, chunk)
        self.W, self.k, self.nw, self.nwb, self.ncb = W, k, nw, nwb, ncb
        self.col0, self.band_hi = W + 1 - ncb, 32 * (nw - nwb)
        self.chunk, self.ll, self.stride = chunk, ll, y["lane_stride"]
        self.buf = np.full((2, chunk, y["height"], lanes, y["lane_stride"]),
                           0xDEADBEEF, np.uint32)
        self.par = 0
        self.raw = np.zeros((2, W + y["height"] - 1, L), np.uint32)
        self.band = np.full((k + 1, ncb, nwb), 0x5A5A5A5A, np.uint32)
        self.flushed = np.zeros(self.band.shape, np.int64)
        if self.col0 == 0:                       # the analytic column 0
            d = np.arange(k + 1)[:, None]
            self.band[:, 0] = ones_below_word(d, np.arange(nwb)[None])
            self.flushed[:, 0] = 1

    def tile(self, b, WT, GW):
        """Word strip b's raw top words in and out (GW is 1 past 16
        words: one level group), and the tile's word threads."""
        self.bs, self.WT = b, WT
        strips = -(-self.nw // WT)
        assert strips == 1 or GW == 1
        self.raw_in = self.raw[(b - 1) & 1] if b > 0 else None
        self.raw_out = self.raw[b & 1] if b + 1 < strips else None
        self.h = (np.arange(GW)[:, None, None] * L +
                  np.arange(L)[None, :, None])           # g L + l

    def stage(self, u, j, new, w, on):
        """Step u's cells (GW, L, WT) into row (u mod chunk, g L + l): the
        raw word w at slot w - w0 where the window from w0 = base / 32
        spans it (nwb + 1 words); at a strip's bottom the first word
        thread also stages the raw word below, kept by the strip below's
        top word thread (raw_out), at slot w - 1 - w0.  A step whose newest
        column (u + 1) is before col0 stages nothing."""
        if u + 1 < self.col0:
            return
        on = on & (j >= self.col0)
        slot = w - (np.clip(j - 2 - self.k, 0, self.band_hi) >> 5)
        row = self.buf[self.par, u % self.chunk, :, self.ll]   # (H, S)
        ok = on & (slot >= 0) & (slot <= self.nwb)
        row[np.broadcast_to(self.h, slot.shape)[ok], slot[ok]] = new[ok]
        if self.raw_out is not None:
            self.raw_out[u] = new[0, :, self.WT - 1]
        if self.raw_in is not None:
            s0 = slot[0, :, 0] - 1
            ok = on[0, :, 0] & (s0 >= 0) & (s0 <= self.nwb)
            row[np.arange(L)[ok], s0[ok]] = self.raw_in[u][ok]

    def flush(self, u0, n, a, bs, H):
        """Rows of steps [u0, u0 + n) to the band; the buffers swap."""
        c, h = np.divmod(np.arange(n * H), H)
        d, j = a + h, u0 + c - h + 1
        ok = (d <= self.k) & (j >= max(self.col0, 1)) & (j <= self.W)
        base = np.clip(j - 2 - self.k, 0, self.band_hi)
        lw = (base >> 5)[:, None] + np.arange(self.nwb)
        own = ok[:, None] & ((lw + (lw + 1 < self.nw)) // self.WT == bs)
        r_, b_ = np.nonzero(own)
        raw = self.buf[self.par, c[r_], h[r_], self.ll]         # (n, S)
        at = (d[r_], j[r_] - self.col0, b_)
        self.band[at] = funnel_r(raw[np.arange(len(r_)), b_],
                                 raw[np.arange(len(r_)), b_ + 1],
                                 (base[r_] & 31).astype(np.uint64))
        np.add.at(self.flushed, at, 1)
        self.par ^= 1


def funnel_r(lo, hi, sh):
    """__funnelshift_r(lo, hi, sh): (hi:lo) >> sh, its low word."""
    both = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)
    return ((both >> sh) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def put(store, written, dd, j, v, w, k, nw, cols, jlo, boff, band_hi, nwbr,
        nwbs, on, wrap=False):
    """The cells' raw window words into their rows, nwbr slots of rows
    nwbs words apart (XrTile::put); with `wrap` (a step's stores at NW <=
    8, ``XrTile::step``) every word thread of a group writes slot (w - w0)
    mod 8 of its row's 8, its word's or a pad, so the row leaves whole."""
    j = np.broadcast_to(j, dd.shape)
    base = np.clip(j + boff, 0, band_hi)
    slot = w - (base >> 5)
    if wrap:
        slot, ok = slot & 7, on & (dd <= k) & (j >= jlo)
    else:
        ok = on & (dd <= k) & (j >= jlo) & (w < nw) & (slot >= 0) & \
            (slot < nwbr)
    idx = ((dd * cols + j - jlo) * nwbs + slot)[ok]
    store[idx] = v[ok]
    written[idx] = True


def windows(raw, bases, nwb):
    """Window words b = 0..nwb-1 from bit base of each column, out of its
    rows of raw words, (..., ncols, nwbr), which start at word base // 32:
    the funnel of XrBand::zero's reader, word b from raw words b and b+1."""
    sh = (np.asarray(bases) & 31).astype(np.uint64)[:, None]
    lo = raw[..., :nwb].astype(np.uint64)
    hi = np.concatenate([raw, raw[..., -1:]], -1)[..., 1:nwb + 1] \
        .astype(np.uint64)
    out = ((lo >> sh) | (hi << (np.uint64(32) - sh))) & np.uint64(0xFFFFFFFF)
    return np.where(sh == 0, lo, out).astype(np.uint32)


def _inputs(pats, txts, cfg):
    pm, text = _to_kernel_layout(torch.from_numpy(pats.astype(np.int64)),
                                 torch.from_numpy(txts.astype(np.int64)),
                                 cfg)
    masks = genasm_dc._pm_words(pm).numpy().astype(np.uint32)[:, :4]
    return pm, text, masks


SQUARE = [(W, O, k) for W, O in ((288, 96), (320, 96), (512, 192))
          for k in (20, 60, 200)] + [(1100, 300, 40)]
#: NW = 5..8, where K1 and the tails run the register fill at 8 word
#: threads a level group (4 level groups, H = 28 levels a strip); k < W
NARROW = [(W, O, k) for W, O in ((144, 48), (192, 64), (256, 96))
          for k in (20, 60, min(200, W - 4))]


@pytest.mark.parametrize("W,O,k", SQUARE + NARROW)
def test_k1_schedule_equals_the_plain_fill_and_band(W, O, k):
    cfg = AlignerConfig(W=W, O=O, k=k)
    pats, txts = _square(np.random.default_rng(W + k), W, k)
    lanes = (0, 3) if W < 1100 else (0,)
    pats, txts = pats[list(lanes)], txts[list(lanes)]
    pm, text, masks = _inputs(pats, txts, cfg)
    R = genasm_dc._fill(genasm_dc._pm_words(pm), text,
                        torch.full((len(lanes),), W), k)
    ncb, nwb, nw = cfg.ncols_band, cfg.nwb, cfg.nw
    col0 = W + 1 - ncb
    # dc_band_plain's dist and band, from the same fill
    dist_p = genasm_dc._dist(R[W], torch.full((len(lanes),), W), k)
    bases = torch.tensor([cfg.band_base(j) for j in range(col0, W + 1)])
    band = extract_window(R[col0:], bases[:, None, None], nwb)
    band = band.permute(2, 0, 3, 1).numpy().astype(np.uint32)
    x = genasm_dc.xr_layout(nw, k, nwb, ncb, col0, W)
    for lane in range(len(lanes)):
        computed, (store, written), dist = model_lane(
            masks[lane], text[:, lane].numpy(), W, k, nw, nwb, ncb, col0,
            -2 - k, W, W - 1)
        assert dist == int(dist_p[lane])
        top = min(k, (dist // x["height"] + 1) * x["height"] - 1)
        words, done = computed
        assert done[:top + 1, 1:].all() and not done[top + 1:].any()
        np.testing.assert_array_equal(
            words[:top + 1, 1:],
            R[1:, lane, :top + 1].numpy().astype(np.uint32).transpose(1, 0, 2))
        bases = np.array([cfg.band_base(col0 + q) for q in range(ncb)])
        rows = store.reshape(k + 1, ncb, x["nwbs"])[:top + 1, :, :x["nwbr"]]
        real = np.arange(x["nwbr"])[None, :] < \
            (nw - (bases >> 5))[:, None]                 # words < nw
        assert written.reshape(k + 1, ncb, x["nwbs"])[
            :top + 1, :, :x["nwbr"]][:, real].all()
        # at NW <= 8 every row a step stores leaves as one whole sector:
        # its 8 slots written
        assert nw > 8 or written.reshape(k + 1, ncb, 8)[
            :top + 1, max(1 - col0, 0):].all()
        np.testing.assert_array_equal(windows(rows, bases, nwb),
                                      band[:top + 1, :, :, lane])


@pytest.mark.parametrize("W,O,k", SQUARE)
def test_k3_schedule_equals_the_plain_band(W, O, k):
    """K3's schedule: every strip, each stored cell's window word staged
    at its row, lane and word of the block's buffer (lanes 0 and 3 of the
    block) and flushed every chunk steps; the band's every level, each
    word written once, and the dist equal ``dc_band_plain``'s."""
    cfg = AlignerConfig(W=W, O=O, k=k)
    pats, txts = _square(np.random.default_rng(W + k), W, k)
    lanes = (0, 3) if W < 1100 else (0,)
    pats, txts = pats[list(lanes)], txts[list(lanes)]
    pm, text, masks = _inputs(pats, txts, cfg)
    dist_p, band_p, _ = genasm_dc.dc_band_plain(pm, text, cfg=cfg)
    geo = genasm_dc.xwide_geometry(cfg, "dc_band")
    ncb, nwb, nw = cfg.ncols_band, cfg.nwb, cfg.nw
    for i, ll in enumerate(lanes):
        out = K3Out(W, k, nw, nwb, ncb, geo.lanes, ll, geo.chunk)
        _, _, dist = model_lane(masks[i], text[:, i].numpy(), W, k, nw, nwb,
                                0, W + 1 - ncb, -2 - k, W, W - 1, k3=out)
        assert dist == int(dist_p[i])
        assert (out.flushed == 1).all()
        np.testing.assert_array_equal(
            out.band, band_p[..., i].numpy().astype(np.uint32))


TAILS = [(W, O, k, store) for W, O in ((288, 96), (320, 96), (512, 192))
         for k in (20, 60, 200) for store in ("auto",)] + \
    [(320, 96, 60, "full"), (1100, 300, 40, "auto")] + \
    [(W, O, k, "auto") for W, O, k in NARROW]


@pytest.mark.parametrize("W,O,k,tail_store", TAILS)
def test_tail_schedule_equals_the_plain_fill_and_store(W, O, k, tail_store):
    cfg = AlignerConfig(W=W, O=O, k=k, tail_store=tail_store)
    pats, txts, m_len, n_len = _tails(np.random.default_rng(3 * k + W), W, k)
    lanes = [0, 4] if W < 1100 else [0]
    pats, txts, m_len, n_len = (a[lanes] for a in (pats, txts, m_len, n_len))
    n_text = W + 4 * k
    pm, text, masks = _inputs(pats, txts, cfg)
    R = genasm_dc._fill(genasm_dc._pm_words(pm), text,
                        torch.from_numpy(n_len.astype(np.int64)), k)
    dist_p = genasm_dc._dist(R[-1], torch.from_numpy(m_len.astype(np.int64)),
                             k)
    banded = cfg.tail_banded
    nw = cfg.nw
    nwb = cfg.nwb if banded else nw
    band_hi = 32 * (nw - nwb)
    x = genasm_dc.xr_layout(nw, k, nwb, n_text, 1, n_text)
    for lane in range(len(lanes)):
        last = min(int(n_len[lane]), n_text)
        diag = int(m_len[lane]) - 1 - int(n_len[lane])
        computed, (store, written), dist = model_lane(
            masks[lane], text[:, lane].numpy(), last, k, nw, nwb, n_text, 1,
            diag - (k + 1), n_text, min(max(int(m_len[lane]) - 1, 0),
                                        32 * nw - 1))
        assert dist == int(dist_p[lane])
        top = min(k, (dist // x["height"] + 1) * x["height"] - 1)
        words, done = computed
        assert done[:top + 1, 1:].all() and not done[top + 1:].any()
        np.testing.assert_array_equal(
            words[:top + 1, 1:], R[1:last + 1, lane, :top + 1].numpy()
            .astype(np.uint32).transpose(1, 0, 2))
        j = np.arange(1, last + 1)
        w0 = np.clip(j + diag - (k + 1), 0, band_hi) >> 5
        idx = w0[:, None] + np.arange(x["nwbr"])[None, :]    # (last, nwbr)
        real = idx < nw
        rows = store.reshape(k + 1, n_text, x["nwbs"])[
            :top + 1, :last, :x["nwbr"]]
        assert written.reshape(k + 1, n_text, x["nwbs"])[
            :top + 1, :last, :x["nwbr"]][:, real].all()
        assert nw > 8 or written.reshape(k + 1, n_text, 8)[
            :top + 1, :last].all()
        want = R[1:last + 1, lane, :top + 1].numpy().astype(np.uint32)
        want = np.take_along_axis(want.transpose(1, 0, 2),
                                  np.minimum(idx, nw - 1)[None], 2)
        np.testing.assert_array_equal(rows[:, real], want[:, real])
