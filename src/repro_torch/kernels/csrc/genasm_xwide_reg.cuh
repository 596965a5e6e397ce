// The wide family's register fill, for K1 (tb_fused_xwide.cu), K2 / K4
// (tail_fused_xwide.cu) at NW >= 5 (W >= 129) and K3 (dc_band_xwide.cu) at
// NW >= 9 (W >= 257), for Hopper (sm_90a); K1 and the tails at NW = 5..8
// where genasm_dc.kernel_family names it (K3 keeps its templates there).
// NW, k and NWB are runtime arguments; the levels a thread holds,
// XR_LEVELS, are the one compile-time constant.  No width or k has a
// ceiling in the code.
//
// One warp a lane.  A lane's NW words are split over WT word threads (8
// where NW <= 8, 16 where NW <= 16, else 32), one word each; a warp holds
// GW = 32 / WT level groups of L = XR_LEVELS levels, H = GW x L levels a
// strip.  The lane's k+1 levels run as strips [a, a+H) one after another,
// and past 32 words its words as word strips of 32 (tiles (a, b) in the
// order a, then b).
// A warp shares nothing with the other warps of its block: no barrier but
// __syncwarp, and the block's warps take lanes blockIdx.x * lanes + warp,
// then gridDim.x * lanes further, reusing their slice of the scratch.
//
// The fill is a wavefront skewed by one step a level: level d computes
// column j = s - d + 1 at step s, so every input of a cell
// (R_{j-1}[d], R_j[d-1], R_{j-1}[d-1] and the shifts' carries, the top bits
// of word w-1 of each) comes from steps s-1 and s-2, and the L levels of a
// thread have no dependency inside a step.  A thread keeps its levels'
// words of steps s-1 and s-2 in registers (two arrays whose roles swap each
// step: the loop is unrolled by two, and the new column overwrites the
// step-(s-2) word top-down, after the level above has read it).  Per step
// and level one __shfl_up_sync brings word w-1 of the same level (its top
// bit is the carry); the level below's carries are the same shuffles one
// level down, this step's and last step's.  Word 0 takes the analytic
// carries of a virtual word -1 whose top bit at (level d, step s) is
// s > 2d (t > d, t >= d, t >= d-1 of level_steps, as one rule), and a word
// strip past the first takes them from the word strip below: its top word
// thread writes, each step, the top bits of its levels and of the level
// below (XR_LEVELS + 1 bits) to the lane's carry buffer.
//
// Levels cross groups by one __shfl_up_sync (width 32) of the top level
// of the group below; the strip's bottom group reads the level below its
// first, the top level of the strip before, from device memory: the lane's
// store where it holds full columns (K4, and K1 at NWB = NW with every
// column kept), else a buffer of last x NW words its top group wrote,
// two steps ahead.  The first strip's level below is all ones.
//
// Masks and text.  A warp stages the masks of its word strip in shared
// memory, 5 rows (the four symbols and all ones) x 32 words, each thread
// its own column (a thread reads only its own: no bank conflict, no
// barrier), and the text of the next XR_TEXT_CHUNK steps (plus H - 1) as
// the mask row's byte offset, u16.  A cell's mask is two shared loads.
//
// Stores.  A cell (d, j) of a stored column writes its word from registers
// where it lies in the column's window [w0, w0 + nwb] (w0 = base(j) / 32):
// the raw words, nwbr = nwb + 1 of them where nwb < NW (the reader funnels
// the window out of two words), NW where the window is the vector.  A
// lane's store is its own contiguous region, row (d, j) of nwbs words, so a
// group writes its row's words side by side.  At NW <= 8 a row is 8 words,
// one 32 B sector (a lane's scratch whole sectors), and each of a group's
// 8 word threads writes one slot of it, (w - w0) mod 8: its word's, or a
// pad no reader reads.  So every stored row leaves as one whole sector:
// rows of nwbr < 8 words, partly written sectors, made K1's stores 3.5-4.5x
// dearer at W = 160..256 (PERF.md section 6).
// XrBand / XrTail read it back for the walk, which stays one thread a lane
// (tb_walk).
//
// Early exit: the walk reads no level above dist, so once a strip holds
// the lane's dist no further strip runs (K1, K2 / K4).
//
// K3 keeps no store: its band is its output, (k+1, ncb, nwb, B) lanes
// innermost, the windows themselves, and every level of it is written (no
// early exit).  Its block is XR_K3_LANES lane warps (16: a row word of the
// block's lanes is two 32 B sectors), which run the same tiles in
// lockstep: every lane fills W columns and every strip.  A cell of a
// stored column (j >= col0) puts its raw word into the block's staging
// buffer where its window spans it (nwb + 1 words from w0 = base / 32, as
// K1's rows), rows (step, level) of the block's lanes side by side
// (XrK3Out).  Every `chunk` steps, after a barrier, the block funnels the
// windows out of the raw words and writes them, its threads on
// neighbouring lanes of one row word, four lanes a 16-byte store where B
// allows (XrK3Out::flush), while the next steps fill the other of two
// buffers.  A window word whose upper raw word lies in the next word strip
// (NW > 32) is written with that strip, whose first word thread stages the
// raw top words this strip's last word thread kept.  At W = 512 on 2,048
// lanes the fill is 55-70 % of a launch, the staging and writes the rest
// (PERF.md section 6).
//
// What bounds it on the H100: the fill's INT32 work (a shuffle, three
// funnel shifts, two LOP3, the word-0 carry merge and two shared loads a
// cell), then the band / store writes (~9 instructions a stored cell, a
// warp's words of a row side by side): at W = 512 on 2,048 lanes K1's fill
// is about half of a launch, the writes 37-40 %, the walk 6-16 % (PERF.md
// section 6).

#pragma once

#include <type_traits>

#include "genasm_common.cuh"

namespace {

constexpr int XR_LEVELS = 7;        // L: levels a thread holds
constexpr int XR_TEXT_CHUNK = 128;  // steps between two stagings of text
constexpr int XR_MASK_ROWS = 5;     // the four symbols' masks and all ones
constexpr unsigned XR_FULL = 0xFFFFFFFFu;
// A block's most threads (genasm_dc.py XR_LANES warps) and the blocks an SM
// is to hold (__launch_bounds__): K1's two kernels at 65,536 / (128 x 4) =
// 128 registers a thread, 16 warps an SM; the tails' at 3 blocks (168
// registers), where 128 spilled.  At 2 blocks of 246 registers K1 ran 1.7x
// slower (PERF.md section 6).
constexpr int XR_BLOCK_THREADS = 128;
constexpr int XR_K1_BLOCKS = 4;
constexpr int XR_TAIL_BLOCKS = 3;
// K3's block: at most 16 lane warps (genasm_dc.py XR_K3_LANES), 128
// registers a thread at most (122 in its build).
constexpr int XR_K3_THREADS = 512;
constexpr int XR_K3_BLOCKS = 1;

// The layout of a lane warp (genasm_dc.py xwide_geometry computes the same
// sizes: change both together).  cols: stored columns a level (K1 ncb,
// the tails n_text); jlo: the first stored column's j (K1 col0, tails 1);
// last_max: the most columns a lane fills (K1 W, tails n_text).
struct XrLayout {
  int wt;            // word threads a level group
  int gw;            // level groups a warp
  int height;        // H, levels a strip
  int strips;        // level strips, ceil((k+1) / H)
  int word_strips;   // ceil(nw / wt)
  int text_slots;    // u16 entries of the staged text
  int warp_bytes;    // shared bytes a warp: masks, then text
  int smem;          // shared bytes a block
  int last_max;
  bool below_in_store;   // the level below a strip read from the store
  long long nwbr;        // words of a stored column
  long long nwbs;        // a stored row's slots and stride (nwbr; 8 at
                         // NW <= 8, one sector)
  long long store_words, below_words, carry_words, lane_words;
};

// Entries of one carry buffer: the steps of a tile (last + H - 1 at most).
__host__ __device__ __forceinline__ long long xr_carry_len(const XrLayout& x) {
  return x.last_max + x.height - 1;
}

XrLayout xr_layout(int nw, int k, int nwb, int cols, int jlo, int last_max,
                   int lanes) {
  XrLayout x;
  x.wt = nw <= 8 ? 8 : nw <= 16 ? 16 : WORD;
  x.gw = WORD / x.wt;
  x.height = x.gw * XR_LEVELS;
  x.strips = (k + x.height) / x.height;
  x.word_strips = (nw + x.wt - 1) / x.wt;
  x.text_slots = XR_TEXT_CHUNK + x.height;
  x.warp_bytes = 4 * XR_MASK_ROWS * WORD + 2 * x.text_slots;
  x.smem = lanes * x.warp_bytes;
  x.last_max = last_max;
  x.nwbr = nwb + (nwb < nw ? 1 : 0);
  x.nwbs = nw <= 8 ? 8 : x.nwbr;
  x.store_words = static_cast<long long>(k + 1) * cols * x.nwbs;
  x.below_in_store = cols > 0 && nwb == nw && jlo <= 1;
  x.below_words = x.strips > 1 && !x.below_in_store
                      ? static_cast<long long>(last_max) * nw : 0;
  x.carry_words = x.word_strips > 1 ? 2LL * xr_carry_len(x) : 0;
  x.lane_words = x.store_words + x.below_words + x.carry_words;
  if (nw <= 8) x.lane_words = (x.lane_words + 7) & ~7LL;
  return x;
}

// The block xwide_geometry derives, and nothing else.
bool xr_block_ok(const XrLayout& x, int nw, int k, int nwb, int lanes,
                 int threads, int smem, long long store_words,
                 long long lane_words, int blocks) {
  return nw >= 1 && k >= 0 && nwb >= 1 && nwb <= nw && lanes >= 1 &&
         threads == WORD * lanes && threads <= XR_BLOCK_THREADS &&
         smem == x.smem &&
         smem <= MAX_SHARED_BYTES && store_words == x.store_words &&
         lane_words == x.lane_words && blocks >= 1;
}

// K3's layout (genasm_dc.py xr_k3_layout computes the same sizes: change
// both together): the fill's with no store (the level below a strip in the
// lane's buffer), the raw top words of a word strip for the next (two
// buffers, as the carries), and the block's two staging buffers of `chunk`
// steps x H levels, a row the block's lanes of lane_stride words each (an
// odd multiple of 32 / lanes, > nwb: a flush's warp reads 32 banks), the
// row padded to 16 mod 32 words (the two level groups of a warp write
// opposite halves of the banks).
struct XrK3Layout {
  XrLayout x;            // lane_words includes raw_words
  int chunk;             // steps between two flushes
  int lane_stride, row_stride;
  long long buf_words;   // one staging buffer
  long long raw_words;   // a lane's raw top words (word strips only)
  int smem;              // shared bytes a block: warps', then staging
};

XrK3Layout xr_k3_layout(int nw, int k, int nwb, int W, int ncb, int lanes,
                        int chunk) {
  XrK3Layout y;
  y.x = xr_layout(nw, k, nwb, 0, W + 1 - ncb, W, lanes);
  y.chunk = chunk;
  const int r = lanes >= 1 && lanes <= WORD ? WORD / lanes : 1;
  y.lane_stride = ((nwb + r) / r | 1) * r;
  y.row_stride = half_bank_pad(lanes * y.lane_stride);
  y.buf_words = static_cast<long long>(chunk) * y.x.height * y.row_stride;
  y.raw_words =
      y.x.word_strips > 1 ? 2LL * xr_carry_len(y.x) * XR_LEVELS : 0;
  y.x.lane_words += y.raw_words;
  y.smem = y.x.smem + static_cast<int>(8 * y.buf_words);
  return y;
}

// The block xwide_geometry derives for K3, and nothing else: lanes a power
// of two (a flush's warp covers 32 / lanes row words), chunk an even power
// of two no longer than a text chunk.
bool xr_k3_block_ok(const XrK3Layout& y, int nw, int k, int nwb, int lanes,
                    int threads, int smem, int chunk, long long lane_words,
                    int blocks) {
  return nw >= 1 && k >= 0 && nwb >= 1 && nwb <= nw && lanes >= 1 &&
         lanes <= WORD && (lanes & (lanes - 1)) == 0 &&
         threads == WORD * lanes && threads <= XR_K3_THREADS &&
         chunk >= 2 && chunk <= XR_TEXT_CHUNK && (chunk & (chunk - 1)) == 0 &&
         smem == y.smem && smem <= MAX_SHARED_BYTES &&
         lane_words == y.x.lane_words && blocks >= 1;
}

// Where a lane's stored columns go: row (d, j) = d * cols + j - jlo of
// nwbs slots, slot s the raw word base(j) / 32 + s, base(j) = clamp(j +
// boff, 0, band_hi); a step's slot is taken mod nwbs where `wrap` is nwbs -
// 1 (NW <= 8: a group's 8 word threads write the row's 8 slots), else
// slots past nwbs are not written (wrap ~0).
struct XrStoreMap {
  uint32_t* store;
  int cols, jlo, boff, band_hi;
  long long nwbs;
  int wrap;

  __device__ __forceinline__ long long row(int d, int j) const {
    return static_cast<long long>(d) * cols + (j - jlo);
  }
  __device__ __forceinline__ int base(int j) const {
    return clampi(j + boff, 0, band_hi);
  }
};

// The sources of a lane's fill: text code t (0 <= t < n_text), and the
// four mask words of word w.  XrGridText / XrGridMasks read the kernels'
// (n, B) text and (5, NW, B) masks; XrRefText / XrReadMasks K1's window
// form's reversed slices of the refs and reads.
struct XrGridText {
  const int32_t* p;
  int B, lane;
  __device__ __forceinline__ int operator()(int t) const {
    return p[at(t, B, lane)];
  }
};

struct XrRefText {
  const uint8_t* last;   // the slice's last byte: code t at last[-t]
  __device__ __forceinline__ int operator()(int t) const { return last[-t]; }
};

struct XrGridMasks {
  const uint32_t* pm;
  int nw, B, lane;
  __device__ __forceinline__ void operator()(int w, uint32_t (&m)[4]) const {
    for (int c = 0; c < 4; ++c) m[c] = pm[at(c * nw + w, B, lane)];
  }
  // P[ii] == c (ii clipped into the padded pattern), as the walk asks
  __device__ __forceinline__ bool peq(int c, int ii) const {
    const int iic = clampi(ii, 0, nw * WORD - 1);
    const uint32_t v = c >= 0 && c < 4 ? pm[at(c * nw + (iic >> 5), B, lane)]
                                       : ONES;
    return ((v >> (iic & 31)) & 1u) == 0;
  }
};

// bit i of word w of symbol c clear where base 32w + i of the reversed
// slice is c; set past W (the pattern's sentinel)
struct XrReadMasks {
  const uint8_t* last;   // window_end of the lane's read slice
  int W, nw;
  __device__ __forceinline__ int code(int i) const {
    return i < W ? last[-i] : SENTINEL_PAT;
  }
  __device__ __forceinline__ void operator()(int w, uint32_t (&m)[4]) const {
    for (int c = 0; c < 4; ++c) m[c] = 0u;
    for (int i = 0; i < WORD; ++i) {
      const int x = code(w * WORD + i);
      for (int c = 0; c < 4; ++c) m[c] |= static_cast<uint32_t>(x != c) << i;
    }
  }
  __device__ __forceinline__ bool peq(int c, int ii) const {
    return c >= 0 && c < 4 && code(clampi(ii, 0, nw * WORD - 1)) == c;
  }
};

// f(0), f(1), ..., f(N - 1), each index a compile-time constant
// (std::integral_constant), whatever the compiler's unroller decides.
template <int N, class F>
__device__ __forceinline__ void xr_unroll(const F& f) {
  if constexpr (N > 0) {
    xr_unroll<N - 1>(f);
    f(std::integral_constant<int, N - 1>{});
  }
}

// K3's way out of a block's tiles: the staged windows and their flush.
struct XrK3Out {
  uint32_t* stage;        // two buffers of buf_words
  uint32_t* cur;          // the one this chunk's steps fill
  uint32_t* band;         // (k+1, ncb, nwb, B)
  const uint32_t* raw_in;   // the word strip below's raw top words, or null
  uint32_t* raw_out;        // this tile's for the word strip above, or null
  long long buf_words;
  int chunk, lane_stride, row_stride, lanes;
  int B, lane0, W, k, nw, nwb, ncb, col0, band_hi, word_strips;
  int lane_shift, wt_shift;   // log2 of lanes and of the word threads

  // Steps [u0, u0 + n) of tile (a, bs) to the band, after a barrier: warp
  // r of the block takes staged rows r, r + lanes, ... (step u0 + c,
  // level a + h, row c H + h), its threads row words of `lanes`
  // neighbouring lanes each, so that the stores write a row word of the
  // block's lanes side by side.  Window word b is funnelled out of
  // the row's raw words b and b + 1 (from word w0 = base / 32); it lies in
  // the tile whose word strip holds its upper raw word w0 + b + 1 (its
  // lower, w0 + b, at the vector's top word, where base is band_hi and
  // the upper word is not read).  The buffers then swap.
  __device__ __forceinline__ void flush(int u0, int n, int H, int a,
                                        int bs) {
    __syncthreads();
    // a thread takes `span` neighbouring lanes of a row word (4: one
    // 16-byte store, where B and the lanes allow it and the window words
    // lie in one word strip), 32 / (lanes / span) row words a warp
    const bool quad = word_strips == 1 && lanes >= 4 && (B & 3) == 0;
    const int shift = quad ? lane_shift - 2 : lane_shift;
    const int lid = threadIdx.x & 31, span = quad ? 4 : 1;
    const int lr = (lid & ((lanes >> (lane_shift - shift)) - 1)) * span;
    const int per = WORD >> shift, b0 = lid >> shift;
    if (lane0 + lr >= B) {
      swap();
      return;
    }
    const long long row_words = static_cast<long long>(nwb) * B;
    const long long hop = static_cast<long long>(per) * B;
    uint32_t* const out = band + static_cast<long long>(b0) * B + lane0 + lr;
    const uint32_t* const in = cur + lr * lane_stride + b0;
    const int ls = lane_stride;
    // row (c, h): level d = a + h, column j = u0 + c - h + 1, its band row
    // (d ncb + j - col0) nwb = (r0 + h (ncb - 1) + c) nwb
    const int r0 = a * ncb + u0 + 1 - col0, jmin = max(col0, 1);
    int c = 0, h = threadIdx.x >> 5;      // rows c H + h, `lanes` apart
    while (h >= H) h -= H, ++c;
    while (c < n) {
      const int j = u0 + c - h + 1;
      if (a + h <= k && j >= jmin && j <= W) {
        const int base = clampi(j - 2 - k, 0, band_hi);
        const int sh = base & 31;
        const uint32_t* src = in + (c * H + h) * row_stride;
        uint32_t* dst = out + (r0 + h * (ncb - 1) + c) * row_words;
        if (quad) {
          for (int b = b0; b < nwb; b += per, src += per, dst += hop)
            *reinterpret_cast<uint4*>(dst) = make_uint4(
                __funnelshift_r(src[0], src[1], sh),
                __funnelshift_r(src[ls], src[ls + 1], sh),
                __funnelshift_r(src[2 * ls], src[2 * ls + 1], sh),
                __funnelshift_r(src[3 * ls], src[3 * ls + 1], sh));
        } else if (word_strips == 1) {
#pragma unroll 2
          for (int b = b0; b < nwb; b += per, src += per, dst += hop)
            *dst = __funnelshift_r(src[0], src[1], sh);
        } else {
          for (int lw = (base >> 5) + b0; lw < (base >> 5) + nwb;
               lw += per, src += per, dst += hop)
            if ((lw + (lw + 1 < nw)) >> wt_shift == bs)
              *dst = __funnelshift_r(src[0], src[1], sh);
        }
      }
      h += lanes;
      while (h >= H) h -= H, ++c;
    }
    swap();
  }

  __device__ __forceinline__ void swap() {
    cur = cur == stage ? stage + buf_words : stage;
  }
};

// K3's analytic column 0 (col0 = 0) of the block's lanes, by the whole
// block, lanes side by side: window word b of level d is word b of ~0 << d
// (base 0).
__device__ void xr_k3_column0(uint32_t* band, int k, int nwb, int ncb, int B,
                              int lane0, int lanes) {
  const int n = (k + 1) * nwb * lanes;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int lr = e % lanes, row = e / lanes, b = row % nwb, d = row / nwb;
    if (lane0 + lr < B)
      band[(static_cast<long long>(d) * ncb * nwb + b) * B + lane0 + lr] =
          ones_below_word(d, b);
  }
}

// The carries of word 0 at step s of levels d0 .. d0 + L - 1 (bit l) and of
// the level below (bit L): the virtual word -1's top bit, s > 2d.
__device__ __forceinline__ uint32_t xr_virtual_carries(int s, int d0) {
  const int n = clampi((s - 2 * d0 + 1) >> 1, 0, WORD - 1);
  const uint32_t below = s > 2 * (d0 - 1) ? 1u << XR_LEVELS : 0u;
  return (n >= XR_LEVELS ? (1u << XR_LEVELS) - 1u : (1u << n) - 1u) | below;
}

// One tile (levels of strip a, words of word strip b) of a lane, one warp;
// K3: its windows staged (out), no store.
template <int L, class Text, bool K3 = false>
struct XrTile {
  static_assert(L == XR_LEVELS, "the carry words pack XR_LEVELS levels");
  const XrLayout& x;
  const XrStoreMap& sm;
  const uint32_t* masks;    // the warp's mask rows + its own column
  uint16_t* text_s;         // the warp's staged text
  const Text& text;
  const uint32_t* below_in;   // the level below: store or buffer; null: ones
  uint32_t* below_out;        // the top level out (buffer), or null
  const uint32_t* carry_in;   // the word strip below's carries, or null
  uint32_t* carry_out;        // this tile's for the word strip above
  int nw, k, last, n_text, a, b, g, wt, d0, w, H, u0;

  uint32_t A[L], Bv[L], SA[L], SB[L];
  uint32_t bwp, blp, pf0, pf1;
  // K3: its way out, a copy in the tile's registers for its steps
  std::conditional_t<K3, XrK3Out, uint8_t> out;

  // the level below's word w at column j (1 <= j), held past last
  __device__ __forceinline__ uint32_t below_at(int j) const {
    if (below_in == nullptr || w >= nw) return ONES;
    const int jj = min(j, last);
    return x.below_in_store
               ? below_in[sm.row(a - 1, jj) * sm.nwbs + w]
               : below_in[static_cast<long long>(jj - 1) * nw + w];
  }

  // one cell's store outside the step loop (K1's analytic column 0)
  __device__ __forceinline__ void put(int d, int j, uint32_t v) const {
    if (d > k || j < sm.jlo || w >= nw) return;
    const int slot = w - (sm.base(j) >> 5);
    if (slot < 0 || slot >= sm.nwbs) return;
    sm.store[sm.row(d, j) * sm.nwbs + slot] = v;
  }

  // The stored cells of a step: level l's column jt - l keeps the raw
  // words from word clamp(jt - l + boff, 0, band_hi) >> 5, which for the
  // L <= 32 levels of a thread is one of two words (l <= lb or not); its
  // row is level 0's plus l rows of a level less one column.  Threads past
  // nw, and at NW <= 8 threads below the window (their slot taken mod 8),
  // write only slots of words past the vector or pads, which no reader
  // reads.
  struct StepRows {
    uint32_t* row0;       // level 0's row (outside the store when unused)
    long long step;       // (cols - 1) x nwbs words: one level up, one
                          // column back
    int slot_a, slot_b, lb;
  };

  __device__ __forceinline__ StepRows rows(int jt) const {
    const int q = jt + sm.boff, whi = sm.band_hi >> 5;
    return StepRows{sm.store + sm.row(d0, jt) * sm.nwbs,
                static_cast<long long>(sm.cols - 1) * sm.nwbs,
                (w - clampi(q >> 5, 0, whi)) & sm.wrap,
                (w - clampi((q >> 5) - 1, 0, whi)) & sm.wrap, q & 31};
  }

  // Step u (s = a + u) of the tile: P the roles of the arrays, ON every
  // level's column in 1..last.
  template <int P, bool ON>
  __device__ __forceinline__ void step(int u) {
    uint32_t(&cur)[L] = P ? Bv : A;
    uint32_t(&nxt)[L] = P ? A : Bv;
    uint32_t(&spc)[L] = P ? SB : SA;
    const uint32_t(&spp)[L] = P ? SA : SB;
    const int s = a + u;
    // the level below this step: R_j[d0 - 1], j = u + 1 - g L
    uint32_t bwn = __shfl_up_sync(XR_FULL, cur[L - 1], x.wt);
    uint32_t pref = P ? pf1 : pf0;
    if (g == 0) bwn = pref;
    if (g == 0 && below_in != nullptr) {
      if (P) pf1 = below_at(u + 3); else pf0 = below_at(u + 3);
    }
    // the word strip below's carries of step u (word strips only: W >
    // 1024), else the virtual word -1's
    const uint32_t cw = carry_in != nullptr ? carry_in[u]
                                            : xr_virtual_carries(s, d0);
    uint32_t bln = __shfl_up_sync(XR_FULL, bwn, 1, x.wt);
    if (wt == 0) bln = (cw >> L) << (WORD - 1);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const uint32_t v = __shfl_up_sync(XR_FULL, cur[l], 1, x.wt);
      spc[l] = wt == 0 ? cw << (WORD - 1 - l) : v;
    }
    if (carry_out != nullptr && wt == x.wt - 1) {
      uint32_t pack = (bwn >> (WORD - 1)) << L;
#pragma unroll
      for (int l = 0; l < L; ++l) pack |= (cur[l] >> (WORD - 1)) << l;
      carry_out[u] = pack;
    }
    const uint16_t* tp = text_s + (u - u0 + H - 1) - g * L;
    const int jt = u - g * L + 1;       // level l's column: jt - l
    if constexpr (K3) {
      // K3 stores nothing here; the levels by its template (as a plain
      // loop its instance was not unrolled, and the tile's words went to
      // local memory), then the step's windows staged
      xr_unroll<L>([&](auto i) {
        constexpr int l = L - 1 - decltype(i)::value;
        const uint32_t p = cur[l], pl = spc[l];
        const uint32_t bn = l ? cur[l - 1] : bwn, bnl = l ? spc[l - 1] : bln;
        const uint32_t bo = l ? nxt[l - 1] : bwp, bol = l ? spp[l - 1] : blp;
        const uint32_t v =
            (__funnelshift_l(pl, p, 1) |
             *reinterpret_cast<const uint32_t*>(
                 reinterpret_cast<const char*>(masks) + tp[-l])) &
            __funnelshift_l(bol, bo, 1) & bo & __funnelshift_l(bnl, bn, 1);
        const int j = jt - l;
        nxt[l] = ON || (j >= 1 && j <= last) ? v : p;
      });
      stage<ON>(u, jt, nxt);
    } else {
      const StepRows r = rows(jt);
#pragma unroll
      for (int l = L - 1; l >= 0; --l) {
        const uint32_t p = cur[l], pl = spc[l];
        const uint32_t bn = l ? cur[l - 1] : bwn, bnl = l ? spc[l - 1] : bln;
        const uint32_t bo = l ? nxt[l - 1] : bwp, bol = l ? spp[l - 1] : blp;
        const uint32_t M = __funnelshift_l(pl, p, 1);
        const uint32_t S = __funnelshift_l(bol, bo, 1);
        const uint32_t I = __funnelshift_l(bnl, bn, 1);
        uint32_t v = (M | *reinterpret_cast<const uint32_t*>(
                              reinterpret_cast<const char*>(masks) + tp[-l])) &
                     S & bo & I;
        const int j = jt - l;
        const bool on = ON || (j >= 1 && j <= last);
        if (!ON) v = on ? v : p;
        nxt[l] = v;
        const int slot = l <= r.lb ? r.slot_a : r.slot_b;
        if (on && d0 + l <= k && j >= sm.jlo &&
            static_cast<unsigned>(slot) < static_cast<unsigned>(sm.nwbs))
          r.row0[l * r.step + slot] = v;
      }
    }
    if (below_out != nullptr && g == x.gw - 1 && w < nw) {
      const int j = jt - (L - 1);
      if (j >= 1 && j <= last)
        below_out[static_cast<long long>(j - 1) * nw + w] = nxt[L - 1];
    }
    bwp = bwn;
    blp = bln;
  }

  // K3: the raw words of step u's stored cells (column jt - l of level
  // d0 + l) that its window, from bit base = clamp(jt - l - 2 - k, 0,
  // band_hi), spans (nwb + 1 words from w0 = base / 32, as K1's rows) into
  // row (u mod chunk, g L + l) of the staging buffer, slot w - w0; the
  // flush funnels the windows out of them.  With word strips, a strip's
  // top word thread keeps its raw words (raw_out) and the next strip's
  // first word thread stages them at slot w - 1 - w0: a window word lies
  // in the strip of its upper raw word.  No stored column in the step
  // (its newest, u + 1, before col0): nothing to stage.
  template <bool ON>
  __device__ __forceinline__ void stage(int u, int jt,
                                        const uint32_t (&nv)[L]) const {
    const XrK3Out& o = out;
    if (u + 1 < sm.jlo) return;
    uint32_t* row = o.cur +
                    ((u & (o.chunk - 1)) * H + g * L) * o.row_stride +
                    (threadIdx.x >> 5) * o.lane_stride;
    const int q = jt + sm.boff, whi = sm.band_hi >> 5;
    const int slot_a = w - clampi(q >> 5, 0, whi);
    const int slot_b = w - clampi((q >> 5) - 1, 0, whi), lb = q & 31;
    xr_unroll<L>([&](auto i) {
      constexpr int l = decltype(i)::value;
      const int j = jt - l, slot = l <= lb ? slot_a : slot_b;
      if ((ON || (j >= 1 && j <= last)) && j >= sm.jlo &&
          static_cast<unsigned>(slot) <= static_cast<unsigned>(o.nwb))
        row[l * o.row_stride + slot] = nv[l];
    });
    if (o.raw_out != nullptr && wt == x.wt - 1)
      xr_unroll<L>([&](auto i) {
        o.raw_out[u * L + decltype(i)::value] = nv[decltype(i)::value];
      });
    if (o.raw_in != nullptr && wt == 0) {
      xr_unroll<L>([&](auto i) {
        constexpr int l = decltype(i)::value;
        const int j = jt - l, slot = (l <= lb ? slot_a : slot_b) - 1;
        if ((ON || (j >= 1 && j <= last)) && j >= sm.jlo &&
            static_cast<unsigned>(slot) <= static_cast<unsigned>(o.nwb))
          row[l * o.row_stride + slot] = o.raw_in[u * L + l];
      });
    }
  }

  // text codes of steps [u0, u0 + XR_TEXT_CHUNK) as mask-row offsets
  __device__ __forceinline__ void stage_text(int lid) {
    __syncwarp();
    for (int e = lid; e < XR_TEXT_CHUNK + H - 1; e += WORD) {
      const int c = text(clampi(u0 - (H - 1) + e, 0, n_text - 1));
      text_s[e] =
          static_cast<uint16_t>((c >= 0 && c < 4 ? c : 4) * 4 * WORD);
    }
    __syncwarp();
  }

  // The tile's steps; returns with every level's last column in A.
  __device__ __forceinline__ void run(int lid) {
#pragma unroll
    for (int l = 0; l < L; ++l) A[l] = Bv[l] = ones_below_word(d0 + l, w);
    bwp = ones_below_word(d0 - 1, w);
    // step -1's carries: the shuffles of column 0
    {
      const uint32_t cw = xr_virtual_carries(a - 1, d0);
      const uint32_t bl = __shfl_up_sync(XR_FULL, bwp, 1, x.wt);
      blp = wt == 0 ? (b == 0 ? (cw >> L) << (WORD - 1)
                              : ones_below_word(d0 - 1, w - 1))
                    : bl;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const uint32_t v = __shfl_up_sync(XR_FULL, A[l], 1, x.wt);
        SB[l] = wt == 0 ? (b == 0 ? cw << (WORD - 1 - l)
                                  : ones_below_word(d0 + l, w - 1))
                        : v;
      }
    }
    if (!K3 && sm.jlo == 0) {   // K1's analytic column 0
#pragma unroll
      for (int l = 0; l < L; ++l) put(d0 + l, 0, A[l]);
    }
    const int steps = last > 0 ? last + H - 1 : 0;
    pf0 = pf1 = ONES;
    if (steps > 0 && g == 0 && below_in != nullptr) {
      pf0 = below_at(1);
      pf1 = below_at(2);
    }
    for (u0 = 0; u0 < steps; u0 += XR_TEXT_CHUNK) {
      stage_text(lid);
      const int end = min(steps, u0 + XR_TEXT_CHUNK);
      for (int u = u0; u < end; u += 2) {
        const bool on0 = u >= H - 1 && u + 1 <= last;
        if (on0) step<0, true>(u); else step<0, false>(u);
        if (u + 1 < end) {
          const bool on1 = u + 1 >= H - 1 && u + 2 <= last;
          if (on1) step<1, true>(u + 1); else step<1, false>(u + 1);
        }
        if constexpr (K3) {     // every chunk steps, and the tile's last
          const int done = min(u + 2, end);
          if ((done & (out.chunk - 1)) == 0 || done == steps) {
            const int first = (done - 1) & ~(out.chunk - 1);
            out.flush(first, done - first, H, a, b);
          }
        }
      }
    }
    if (steps & 1) {
#pragma unroll
      for (int l = 0; l < L; ++l) A[l] = Bv[l];
    }
    __syncwarp();
  }

  // the lowest level of this strip <= k whose bit tgt of its last column
  // is 0, else k + 1 (the tile that holds word tgt >> 5)
  __device__ __forceinline__ int dist(int tgt) const {
    int best = k + 1;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const bool hit = w == (tgt >> 5) && d0 + l <= k &&
                       ((A[l] >> (tgt & 31)) & 1u) == 0;
      const unsigned m = __ballot_sync(XR_FULL, hit);
      if (m) best = min(best, a + (__ffs(m) - 1) / x.wt * L + l);
    }
    return best;
  }
};

// A lane's fill, by one warp: every level strip up to the one that holds
// the lane's dist (K3: every strip, its windows through `out`), each word
// strip of it; the stored columns to sm, and the lane's dist (lowest
// level whose bit tgt of its column `last` is 0, else k + 1).  masks_s:
// the warp's 5 x 32 words; text_s: its text_slots; raw: K3's raw top
// words (word strips only).
template <bool K3 = false, class Text, class Masks>
__device__ __forceinline__ int xr_fill(
    const XrLayout& x, const XrStoreMap& sm, uint32_t* below, uint32_t* carry,
    uint32_t* masks_s, uint16_t* text_s, const Text& text, const Masks& masks,
    int nw, int k, int last, int n_text, int tgt, XrK3Out* out = nullptr,
    uint32_t* raw = nullptr) {
  constexpr int L = XR_LEVELS;
  const int lid = threadIdx.x & 31;
  const int g = lid / x.wt, wt = lid % x.wt;
  const long long carry_len = xr_carry_len(x);
  int dist = k + 1;
  for (int a = 0; a <= k && (K3 || dist > k); a += x.height) {
    for (int b = 0; b < x.word_strips; ++b) {
      const int w = b * x.wt + wt;
      uint32_t m[4] = {ONES, ONES, ONES, ONES};
      if (w < nw) masks(w, m);
      for (int c = 0; c < 4; ++c) masks_s[c * WORD + lid] = m[c];
      masks_s[4 * WORD + lid] = ONES;
      const uint32_t* below_in =
          a == 0 ? nullptr : x.below_in_store ? sm.store : below;
      uint32_t* below_out =
          a + x.height <= k && !x.below_in_store ? below : nullptr;
      XrTile<L, Text, K3> t{
          x, sm, masks_s + lid, text_s, text, below_in, below_out,
          b > 0 ? carry + ((b - 1) & 1) * carry_len : nullptr,
          b + 1 < x.word_strips ? carry + (b & 1) * carry_len : nullptr,
          nw, k, last, n_text, a, b, g, wt, a + g * L, w, x.height, 0};
      if constexpr (K3) {
        const long long raw_len = carry_len * L;
        t.out = *out;
        t.out.raw_in = b > 0 ? raw + ((b - 1) & 1) * raw_len : nullptr;
        t.out.raw_out = b + 1 < x.word_strips ? raw + (b & 1) * raw_len
                                              : nullptr;
      }
      t.run(lid);
      if constexpr (K3) out->cur = t.out.cur;
      if ((tgt >> 5) / x.wt == b) dist = min(dist, t.dist(tgt));
    }
  }
  return dist;
}

// K1's band of one lane as the walk reads it: row (d, q = j - col0) of
// raw words from word base(j) / 32, nwbs words a row; tests() is K1Band's.
struct XrBand {
  const uint32_t* band;   // the lane's band
  int k, ncb, col0, band_hi, nwb;
  long long nwbs;

  // bit `off` of the window from `base` in row `row`: its raw word
  __device__ __forceinline__ bool zero(long long row, int base,
                                       int offc) const {
    const int pos = base + offc;
    const uint32_t v = band[row * nwbs + ((pos >> 5) - (base >> 5))];
    return ((v >> (pos & 31)) & 1u) == 0;
  }

  __device__ __forceinline__ bool bit(long long row, int base, int off,
                                      int ii, bool first) const {
    const int offc = clampi(off, 0, nwb * WORD - 1);
    return ((ii < 0) & first) |
           ((ii >= 0) & (off == offc) & zero(row, base, offc));
  }

  __device__ __forceinline__ void tests(int d, int j, int i,
                                        bool (&z)[4]) const {
    const int dc = clampi(d, 0, k), dm = clampi(d - 1, 0, k);
    const int q_l = clampi(j - 1 - col0, 0, ncb - 1);   // column j-1
    const int q_j = clampi(j - col0, 0, ncb - 1);       // column j
    const int base_l = clampi(j - 3 - k, 0, band_hi);
    const int base_j = clampi(j - 2 - k, 0, band_hi);
    const long long r_dl = static_cast<long long>(dc) * ncb + q_l,
                    r_ml = static_cast<long long>(dm) * ncb + q_l,
                    r_mj = static_cast<long long>(dm) * ncb + q_j;
    z[0] = bit(r_dl, base_l, i - 1 - base_l, i - 1, j - 1 <= d);
    z[1] = bit(r_ml, base_l, i - 1 - base_l, i - 1, j - 1 <= d - 1);
    z[2] = bit(r_ml, base_l, i - base_l, i, j - 1 <= d - 1);
    z[3] = bit(r_mj, base_j, i - 1 - base_j, i - 1, j <= d - 1);
  }
};

// The tails' store of one lane: row (d, jc = j - 1) of raw words from word
// base / 32, base = clamp(j + diag - (k+1), 0, band_hi) (K4: 0), nwbs
// words a row; tests() is TailStore's (K2 `banded`, K4 not).
struct XrTail {
  const uint32_t* store;  // the lane's store
  int k, n_text, diag, band_hi, nwb;
  long long nwbs;
  bool banded;

  __device__ __forceinline__ bool bit(long long row, int base, int off,
                                      int ii, int jj, int dd) const {
    const int offc = clampi(off, 0, nwb * WORD - 1);
    const int pos = base + offc;
    const uint32_t v = store[row * nwbs + ((pos >> 5) - (base >> 5))];
    const bool zero = ((v >> (pos & 31)) & 1u) == 0;
    const bool in_window = !banded | (off == offc);
    return ((ii < 0) & (jj <= dd)) | ((ii >= 0) & (jj <= 0) & (ii < dd)) |
           ((ii >= 0) & (jj > 0) & in_window & zero);
  }

  __device__ __forceinline__ void tests(int d, int j, int i,
                                        bool (&z)[4]) const {
    const int dc = clampi(d, 0, k), dm = clampi(d - 1, 0, k);
    const int jl = clampi(j - 2, 0, n_text - 1);     // column j-1
    const int jr = clampi(j - 1, 0, n_text - 1);     // column j
    const long long r_dl = static_cast<long long>(dc) * n_text + jl,
                    r_ml = static_cast<long long>(dm) * n_text + jl,
                    r_mj = static_cast<long long>(dm) * n_text + jr;
    const int base_l = clampi(j - 1 + diag - (k + 1), 0, band_hi);
    const int base_j = clampi(j + diag - (k + 1), 0, band_hi);
    z[0] = bit(r_dl, base_l, i - 1 - base_l, i - 1, j - 1, d);
    z[1] = bit(r_ml, base_l, i - 1 - base_l, i - 1, j - 1, d - 1);
    z[2] = bit(r_ml, base_l, i - base_l, i, j - 1, d - 1);
    z[3] = bit(r_mj, base_j, i - 1 - base_j, i - 1, j, d - 1);
  }
};

// A lane warp's shared memory: its mask rows, then its text.
__device__ __forceinline__ uint32_t* xr_warp_masks(uint32_t* smem,
                                                   const XrLayout& x) {
  return smem + (threadIdx.x >> 5) * (x.warp_bytes / 4);
}

__device__ __forceinline__ uint16_t* xr_warp_text(uint32_t* masks) {
  return reinterpret_cast<uint16_t*>(masks + XR_MASK_ROWS * WORD);
}

// The lane's scratch: lane_words words, its store first.
__device__ __forceinline__ uint32_t* xr_lane_scratch(uint32_t* scratch,
                                                     const XrLayout& x,
                                                     int lanes) {
  return scratch + (static_cast<long long>(blockIdx.x) * lanes +
                    (threadIdx.x >> 5)) * x.lane_words;
}

// ops rows 0..max_ops-1 of one lane to OP_NONE (tb_walk writes its ops over
// them), by the lane's warp
__device__ __forceinline__ void xr_clear_ops(int32_t* ops, int max_ops,
                                             int B, int lane) {
  for (int r = threadIdx.x & 31; r < max_ops; r += WORD)
    ops[at(r, B, lane)] = OP_NONE;
}

}  // namespace
