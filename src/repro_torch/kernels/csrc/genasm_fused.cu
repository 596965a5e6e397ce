// Fused GenASM-DC+TB kernels for Hopper (sm_90a).
//
// Ports of the four Pallas TPU kernels of repro/kernels/genasm_dc.py:
//   K1 tb_fused     <- _kernel_fused        (square W x W window)
//   K2 tail_banded  <- _kernel_tail_banded  (ragged tail, diagonal band store)
//   K4 tail_full    <- _kernel_tail_fused   (ragged tail, full SENE store)
//   K3 dc_band      <- _kernel              (square window, DC only: the
//                                            band is the output)
// Plain PyTorch versions of the same functions live in
// repro_torch/kernels/genasm_dc.py; the outputs must be equal bit for bit.
//
// Layout: every array is lane-innermost, element (r, lane) at r * B + lane,
// so the threads of a warp touch neighbouring addresses.  Bitvector words
// are uint32_t (the wrapper hands int32 tensors over; the bits are the
// same).  pm is (5, NW, B) (rows 0..3 are the 0-active pattern masks),
// text (n, B), m_len / n_len (1, B); ops (max_ops, B) front-first padded
// with OP_NONE; meta (8, B) rows DIST/LVL/NOPS/RD/RF/DFIN/OK/0.
//
// K1 spreads the levels of one lane over a group of threads and runs the
// fill as a wavefront over (column, level), with the DENT band in shared
// memory (see the note above tb_fused_kernel).  K2, K3 and K4 run one
// thread per lane: a column-major SENE fill (R_j[d] = M & S & D & I over
// levels d = 0..k) with the live column of all k+1 levels in a
// thread-local array, updated in place, and (K2, K4) the GenASM-TB walk
// (=,X,D,I preference, tail drain, commit limit) reading the store back
// one word per bit test from per-lane global scratch that the wrapper
// allocates.  The TPU kernels' one-hot masked sums over the whole store
// become single indexed loads, clamped exactly as the reference clips its
// indices.  K3's band (k+1, ncb, nwb, B) is its output, with dist (B) and
// the level count (B).
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry without an instantiation); they never
// synchronise and allocate nothing.

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int WORD = 32;
constexpr uint32_t ONES = 0xFFFFFFFFu;
constexpr int32_t OP_MATCH = 0, OP_SUBST = 1, OP_INS = 2, OP_DEL = 3;
constexpr int32_t OP_NONE = 255;
constexpr int META_DIST = 0, META_LVL = 1, META_NOPS = 2, META_RD = 3,
              META_RF = 4, META_DFIN = 5, META_OK = 6, META_ZERO = 7;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ size_t at(long long row, int B, int lane) {
  return static_cast<size_t>(row) * B + lane;
}

// One lane's rows of a row-major array: row r at p[r * stride] (global
// arrays pass p = base + lane and stride B; K1's shared staging its own).
template <class T>
struct Rows {
  T* p;
  int stride;
  __device__ __forceinline__ T& operator[](int r) const {
    return p[static_cast<size_t>(r) * stride];
  }
};

// ---- shared device helpers ------------------------------------------------

// The lane's four pattern masks, held in registers for the whole kernel.
template <int NW>
struct PatternMasks {
  uint32_t w[4][NW];

  __device__ void load(const uint32_t* __restrict__ pm, int B, int lane) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int w_ = 0; w_ < NW; ++w_) w[c][w_] = pm[at(c * NW + w_, B, lane)];
  }

  // _pm_lookup: mask word `w_` of text char c; any code outside the
  // alphabet (the ref sentinel) selects all ones.
  __device__ __forceinline__ uint32_t word(int c, int w_) const {
    uint32_t v = ONES;
#pragma unroll
    for (int s = 0; s < 4; ++s) v = (c == s) ? w[s][w_] : v;
    return v;
  }

  // P[ii] == text char c (ii clipped into the padded pattern); selects
  // only, no branch
  __device__ __forceinline__ bool peq(int c, int ii) const {
    const int iic = clampi(ii, 0, NW * WORD - 1), wi = iic >> 5;
    uint32_t v = ONES;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t m = w[s][0];
#pragma unroll
      for (int w_ = 1; w_ < NW; ++w_) m = wi == w_ ? w[s][w_] : m;
      v = c == s ? m : v;
    }
    return ((v >> (iic & 31)) & 1u) == 0;
  }
};

// _ones_below_words: word w_ of ~0 << d.  lo == 32 must not shift by 32.
__device__ __forceinline__ uint32_t ones_below_word(int d, int w_) {
  const int lo = clampi(d - w_ * WORD, 0, WORD);
  return lo >= WORD ? 0u : (ONES << lo);
}

// _shift1_words: shift left by one bit, carry_in entering at bit 0.
template <int NW>
__device__ __forceinline__ void shift1(const uint32_t (&in)[NW],
                                       uint32_t carry, uint32_t (&out)[NW]) {
#pragma unroll
  for (int w_ = 0; w_ < NW; ++w_) {
    const uint32_t v = in[w_];
    out[w_] = (v << 1) | carry;
    carry = v >> (WORD - 1);
  }
}

template <int NW, int KP>
__device__ __forceinline__ void init_column(uint32_t (&col)[KP][NW], int k) {
#pragma unroll
  for (int d = 0; d < KP; ++d) {
    if (d > k) break;
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) col[d][w_] = ones_below_word(d, w_);
  }
}

// _next_column: all levels of column j from column j-1, in place (t = j-1
// is the text index).  Level d reads R_{j-1}[d], R_{j-1}[d-1] (kept in
// `below_old` before it is overwritten) and the new R_j[d-1].
template <int NW, int KP>
__device__ __forceinline__ void next_column(uint32_t (&col)[KP][NW],
                                            const uint32_t (&pmj)[NW], int t,
                                            int k) {
  uint32_t below_old[NW], tmp[NW];
#pragma unroll
  for (int w_ = 0; w_ < NW; ++w_) below_old[w_] = col[0][w_];
  shift1<NW>(col[0], t > 0 ? 1u : 0u, tmp);
#pragma unroll
  for (int w_ = 0; w_ < NW; ++w_) col[0][w_] = tmp[w_] | pmj[w_];
#pragma unroll
  for (int d = 1; d < KP; ++d) {
    if (d > k) break;
    uint32_t prev[NW], M[NW], S[NW], I[NW];
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) prev[w_] = col[d][w_];
    shift1<NW>(prev, t > d ? 1u : 0u, M);
    shift1<NW>(below_old, t >= d ? 1u : 0u, S);
    shift1<NW>(col[d - 1], t >= d - 1 ? 1u : 0u, I);
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) {
      col[d][w_] = (M[w_] | pmj[w_]) & S[w_] & below_old[w_] & I[w_];
      below_old[w_] = prev[w_];
    }
  }
}

// Funnel-shift extract of the 32-bit word starting at bit 32*w0b + s of a
// column vector; words past the top read as ones.  s == 0 must not shift
// by 32, so it selects explicitly.
template <int NW>
__device__ __forceinline__ uint32_t funnel_word(const uint32_t (&v)[NW],
                                                int w0b, int s) {
  uint32_t lo = v[0], hi = ONES;
#pragma unroll
  for (int w_ = 0; w_ < NW; ++w_) {
    if (w_ == w0b) lo = v[w_];
    if (w_ == w0b + 1) hi = v[w_];
  }
  return s == 0 ? lo : ((lo >> s) | (hi << (WORD - s)));
}

// Store the band windows (nwb words from bit `base`) of levels 0..k.
template <int NW, int KP>
__device__ __forceinline__ void store_band(const uint32_t (&col)[KP][NW],
                                           int base, int k, int nwb,
                                           uint32_t* __restrict__ band,
                                           long long col_row, int ncols, int B,
                                           int lane) {
  const int w0 = base >> 5, s = base & 31;
#pragma unroll
  for (int d = 0; d < KP; ++d) {
    if (d > k) break;
#pragma unroll
    for (int b = 0; b < NW; ++b)
      if (b < nwb)
        band[at((d * static_cast<long long>(ncols) + col_row) * nwb + b, B,
                lane)] = funnel_word<NW>(col[d], w0 + b, s);
  }
}

// dist = lowest level whose bit `tgt` is 0 (when `guard`), else k+1.
template <int NW, int KP>
__device__ __forceinline__ int first_hit(const uint32_t (&col)[KP][NW],
                                         int tgt, bool guard, int k) {
  int dist = k + 1;
#pragma unroll
  for (int d = KP - 1; d >= 0; --d) {
    if (d > k) continue;
    uint32_t v = col[d][0];
#pragma unroll
    for (int w_ = 1; w_ < NW; ++w_)
      if ((tgt >> 5) == w_) v = col[d][w_];
    if (guard && ((v >> (tgt & 31)) & 1u) == 0) dist = d;
  }
  return dist;
}

// ---- the three stores, as the walk sees them ---------------------------
// zbit(dd, jj, ii): bit ii of the stored R_jj[dd] is 0, with the same
// clamps and analytic edges as the reference's band_words / r_words + zbit.

// K1: the lane's band in shared memory, column jj at the static base
// clip(jj - 2 - k); level dd in row (dd % L) * rows0 + dd / L, L levels a
// fill thread (tb_fused_kernel).  tests() is zbit's four calls of one walk
// step with their clamps shared, branch-free: each word is loaded at
// clamped indices whatever the edge cases say, so the four loads issue
// together.
template <int L, int NWB>
struct SharedBand {
  const uint32_t* band;
  int k, ncb, col0, band_hi, row_words, rows0;

  // zbit of the window word at `at` + offset `off` (ii >= 0), else of the
  // first column, `first` = ED(0, jj) <= dd; outside the window: 1
  __device__ __forceinline__ bool bit(int at, int off, int ii,
                                      bool first) const {
    const int offc = clampi(off, 0, NWB * WORD - 1);
    const bool zero = ((band[at + (offc >> 5)] >> (offc & 31)) & 1u) == 0;
    return ((ii < 0) & first) | ((ii >= 0) & (off == offc) & zero);
  }

  __device__ __forceinline__ void tests(int d, int j, int i,
                                        bool (&z)[4]) const {
    const int dc = clampi(d, 0, k), dm = clampi(d - 1, 0, k);
    const int row_d = ((dc % L) * rows0 + dc / L) * row_words;
    const int row_m = ((dm % L) * rows0 + dm / L) * row_words;
    const int col_l = clampi(j - 1 - col0, 0, ncb - 1) * NWB;   // column j-1
    const int col_j = clampi(j - col0, 0, ncb - 1) * NWB;       // column j
    const int base_l = clampi(j - 3 - k, 0, band_hi);
    const int base_j = clampi(j - 2 - k, 0, band_hi);
    z[0] = bit(row_d + col_l, i - 1 - base_l, i - 1, j - 1 <= d);
    z[1] = bit(row_m + col_l, i - 1 - base_l, i - 1, j - 1 <= d - 1);
    z[2] = bit(row_m + col_l, i - base_l, i, j - 1 <= d - 1);
    z[3] = bit(row_m + col_j, i - 1 - base_j, i - 1, j <= d - 1);
  }
};

// K2: band of column jj (1..n_text) at the lane's diagonal base; column 0
// and the first row are analytic.
struct DiagonalBand {
  const uint32_t* band;
  int B, lane, k, nwb, n_text, diag, band_hi;

  __device__ __forceinline__ bool zbit(int dd, int jj, int ii) const {
    if (ii < 0) return jj <= dd;
    if (jj <= 0) return ii < dd;        // R_0[d] = ones_below(d)
    const int off = ii - clampi(jj + diag - (k + 1), 0, band_hi);
    if (off < 0 || off >= nwb * WORD) return false;
    const long long row = (clampi(dd, 0, k) * static_cast<long long>(n_text) +
                           (clampi(jj, 1, n_text) - 1)) * nwb + (off >> 5);
    return ((band[at(row, B, lane)] >> (off & 31)) & 1u) == 0;
  }
};

// K4: the full vector of column jj (0..n_text).
template <int NW>
struct FullStore {
  const uint32_t* store;
  int B, lane, k, n_text;

  __device__ __forceinline__ bool zbit(int dd, int jj, int ii) const {
    if (ii < 0) return jj <= dd;
    const int iic = clampi(ii, 0, NW * WORD - 1);
    const long long row = (clampi(dd, 0, k) * static_cast<long long>(n_text + 1) +
                           clampi(jj, 0, n_text)) * NW + (iic >> 5);
    return ((store[at(row, B, lane)] >> (iic & 31)) & 1u) == 0;
  }
};

// The walk's four bit tests at cursor (d, j, i): R_{j-1}[d] at i-1
// (match), R_{j-1}[d-1] at i-1 (substitution) and at i (deletion), R_j[d-1]
// at i-1 (insertion).  Any store: four zbit calls; K1's band shares their
// terms.
template <class Store>
__device__ __forceinline__ void four_tests(const Store& st, int d, int j,
                                           int i, bool (&z)[4]) {
  z[0] = st.zbit(d, j - 1, i - 1);
  z[1] = st.zbit(d - 1, j - 1, i - 1);
  z[2] = st.zbit(d - 1, j - 1, i);
  z[3] = st.zbit(d - 1, j, i - 1);
}

template <int L, int NWB>
__device__ __forceinline__ void four_tests(const SharedBand<L, NWB>& st,
                                           int d, int j, int i,
                                           bool (&z)[4]) {
  st.tests(d, j, i, z);
}

// _tb_walk for one lane, then the meta rows.  The TPU's whole-tile early
// exit is a per-thread exit here: a done lane's state never changes again.
// `ops` must hold OP_NONE in rows 0..max_ops-1 already; the walk writes
// the ops it emits over them.
template <int NW, class Store>
__device__ void tb_walk(const Store& st, const PatternMasks<NW>& pm,
                        Rows<const int32_t> text, int n_text, int k, int dist,
                        int d_end, int init_i, int init_j, int commit_limit,
                        int max_ops, int max_steps, Rows<int32_t> ops,
                        Rows<int32_t> meta) {
  int i = init_i, j = init_j, d = dist, nops = 0, rd = 0, rf = 0;
  bool done = dist > k, ok = true;
  for (int step = 0; step < max_steps && !done; ++step) {
    if (rd >= commit_limit) break;      // stopped: nothing changes any more
    const bool tail = i < 0;
    // Every test is evaluated (each store reader clamps its indices) and
    // combined with non-short-circuit &, so a step has no branch between
    // its loads; in the tail drain the tests are masked off.
    const int cj = text[clampi(j - 1, 0, n_text - 1)];
    bool z[4];
    four_tests(st, d, j, i, z);
    const bool edge = !tail, left = edge & (j > 0), lvl = d > 0;
    const bool mA = left & pm.peq(cj, i) & z[0];
    const bool sA = left & lvl & z[1];
    const bool dA = left & lvl & z[2];
    const bool iA = edge & lvl & z[3];
    const bool tail_emit = tail && j > 0;
    const bool any_edge = mA || sA || dA || iA || tail_emit;
    const bool cM = mA, cS = !mA && sA, cD = !mA && !sA && dA,
               cI = !mA && !sA && !dA && iA;
    const int32_t op = cM ? OP_MATCH : cS ? OP_SUBST : cD ? OP_DEL
                     : cI ? OP_INS : OP_DEL;
    const int takes_read = (cM || cS || cI) ? 1 : 0;
    const int takes_ref = (cM || cS || cD || tail_emit) ? 1 : 0;
    const int costs = (cS || cD || cI || tail_emit) ? 1 : 0;
    if (any_edge) {
      if (nops < max_ops) ops[nops] = op;
      ++nops;                           // counts past max_ops, as on the TPU
    }
    const int ni = i - takes_read, nj = j - takes_ref;
    const bool finished = ni < 0 && nj <= 0;
    if (!finished) ok = ok && (any_edge || (i < 0 && j <= 0));
    i = ni;
    j = nj;
    d -= costs;
    rd += takes_read;
    rf += takes_ref;
    done = finished;
  }
  meta[META_DIST] = dist;
  meta[META_LVL] = d_end;
  meta[META_NOPS] = nops;
  meta[META_RD] = rd;
  meta[META_RF] = rf;
  meta[META_DFIN] = d;
  meta[META_OK] = ok ? 1 : 0;
  meta[META_ZERO] = 0;
}

// tb_walk over a one-thread-per-lane kernel's global outputs (K2, K4).
template <int NW, class Store>
__device__ void tb_walk_global(const Store& st, const PatternMasks<NW>& pm,
                               const int32_t* __restrict__ text, int n_text,
                               int B, int lane, int k, int dist, int d_end,
                               int init_i, int init_j, int commit_limit,
                               int max_ops, int max_steps,
                               int32_t* __restrict__ ops,
                               int32_t* __restrict__ meta) {
  const Rows<int32_t> ops_rows{ops + lane, B};
  for (int s = 0; s < max_ops; ++s) ops_rows[s] = OP_NONE;
  tb_walk<NW>(st, pm, Rows<const int32_t>{text + lane, B}, n_text, k, dist,
              d_end, init_i, init_j, commit_limit, max_ops, max_steps,
              ops_rows, Rows<int32_t>{meta + lane, B});
}

// The level count of the reference's whole-tile early termination, per
// lane: only its maximum over the batch is read.
__device__ __forceinline__ int level_count(int dist, int k, int early_term) {
  return early_term ? min(dist, k) + 1 : k + 1;
}

// K3's fill of the square window: column-major SENE over the W text
// columns with the live column in registers, storing the DENT band windows
// of the last ncb columns at the static base clip(j - 2 - k); returns dist
// (bit W-1 of the last column).
template <int NW, int KP>
__device__ __forceinline__ int square_dc(const PatternMasks<NW>& pm,
                                         const int32_t* __restrict__ text,
                                         uint32_t* __restrict__ band, int B,
                                         int lane, int W, int k, int nwb,
                                         int ncb) {
  const int col0 = W + 1 - ncb;
  const int band_hi = NW * WORD - WORD * nwb;
  uint32_t col[KP][NW];
  init_column<NW, KP>(col, k);
  if (col0 == 0)
    store_band<NW, KP>(col, clampi(-2 - k, 0, band_hi), k, nwb, band, 0, ncb,
                       B, lane);
  for (int j = 1; j <= W; ++j) {
    const int c = text[at(j - 1, B, lane)];
    uint32_t pmj[NW];
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) pmj[w_] = pm.word(c, w_);
    next_column<NW, KP>(col, pmj, j - 1, k);
    if (j >= col0)
      store_band<NW, KP>(col, clampi(j - 2 - k, 0, band_hi), k, nwb, band,
                         j - col0, ncb, B, lane);
  }
  return first_hit<NW, KP>(col, W - 1, true, k);
}

// One thread's levels d0 .. d0+L-1 of column j (t = j-1) from column j-1,
// in place: next_column's recurrence for a slice of the levels.  below_old
// and below_new are R_{j-1}[d0-1] and R_j[d0-1] (all ones below level 0,
// which turns the general cell into level 0's shift | pm).
template <int NW, int L>
__device__ __forceinline__ void level_steps(uint32_t (&col)[L][NW],
                                            const uint32_t (&old_in)[NW],
                                            const uint32_t (&new_in)[NW],
                                            const uint32_t (&pmj)[NW], int t,
                                            int d0) {
  uint32_t below_old[NW], below_new[NW];
#pragma unroll
  for (int w_ = 0; w_ < NW; ++w_) {
    below_old[w_] = old_in[w_];
    below_new[w_] = new_in[w_];
  }
#pragma unroll
  for (int c = 0; c < L; ++c) {
    const int d = d0 + c;
    uint32_t prev[NW], M[NW], S[NW], I[NW];
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) prev[w_] = col[c][w_];
    shift1<NW>(prev, t > d ? 1u : 0u, M);
    shift1<NW>(below_old, t >= d ? 1u : 0u, S);
    shift1<NW>(below_new, t >= d - 1 ? 1u : 0u, I);
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) {
      col[c][w_] = (M[w_] | pmj[w_]) & S[w_] & below_old[w_] & I[w_];
      below_old[w_] = prev[w_];
      below_new[w_] = col[c][w_];
    }
  }
}

// ---- K1 ---------------------------------------------------------------
// Replaces repro/kernels/genasm_dc.py:_kernel_fused (TPU).
//
// Bound on the H100: neither bytes nor operations but the latency of two
// serial chains per lane.  A lane reads and writes a few hundred bytes and
// its DP is a few ten thousand integer operations; what it cannot shorten
// is the fill's dependence (level d of column j needs level d-1 of column
// j) and the walk's (each step's bit tests need the cursor of the step
// before).
//
// The first port ran one thread per lane, and was latency-bound for three
// reasons: a thread's fill was W x (k+1) dependent level updates (832 at
// k = 12, 1,600 at k = 24); each walk step was a chain of global loads from
// a band in per-lane scratch; and at 128 lanes a block, a 2,048-lane batch
// filled 16 of 132 SMs with 4 warps each, so nothing hid that latency.
//
// This design is GenASM-DC's own systolic array.  A group of G = min(KP,
// 32) threads holds one lane, thread g its L = KP / G levels g*L .. g*L+L-1.
// The fill is a wavefront over (column, level): at step s thread g
// computes column j = s - g + 1 of its levels, taking R_j[g*L-1] from
// thread g-1 with one __shfl_up_sync of NW words and keeping it one step
// as R_{j-1}[g*L-1]; so the fill takes W + ceil((k+1)/L) - 1 steps, not
// W x (k+1) level updates, and a thread holds L x NW live words (no spill
// at KP = 64).  A step has no branch: every thread computes a column and
// keeps it only where j is one of its columns.  The text of the block's
// lanes is staged in shared memory once.  The DENT band lives in dynamic
// shared memory: each thread writes its levels' windows of its column
// (the whole vector where the window is as wide).  Then one thread per
// lane walks it with the walk K2 and K4 share; a walk step loads its four
// band words together (SharedBand::tests) and combines the tests without
// branches.  The walkers of a block are its first threads, so the walk
// issues from one warp.  The ops are staged in shared memory and the
// whole block writes them, with the OP_NONE padding, lane-innermost.
// Several lanes fill a 128-thread block (8 at KP = 16, 4 at KP = 32 and
// 64), so a 2,048-lane batch gives 256 or 512 blocks; the band's shared
// bytes, not the block size, cap the lanes an SM holds (56 at k = 12, 16
// at k = 24, 8 at k = 48).  What is left is the two chains: the walk, one
// thread per lane, is about 40 % of a launch at 2,048 lanes (PERF.md).
//
// Shared layout of a block (32-bit words; tb_fused_geometry in
// kernels/genasm_dc.py computes the same sizes): per lane, the band of
// k+1 rows of row_words words, row (d % L) * ceil((k+1)/L) + d / L for
// level d, column jj at (jj - col0) * nwb; then per lane text_stride text
// codes; then ops (max_ops, lanes); then dist (lanes).  row_words is
// ncb * nwb, plus one where that makes row_words - nwb even: a step's
// threads write words (row_words - nwb) apart, an odd stride, so they fall
// in distinct banks.  The lane and text strides are 16 mod 32 words, so
// the two lanes of a warp at G = 16 fall in opposite halves of the banks.
struct K1Layout {
  int row_words, lane_words, text_stride, smem_bytes;
};

int half_bank_pad(int words) { return words + ((16 - words % 32) + 32) % 32; }

K1Layout k1_layout(int W, int k, int nwb, int ncb, int max_ops, int lanes) {
  K1Layout g;
  g.row_words = ncb * nwb + ((nwb * (ncb - 1)) % 2 == 0 ? 1 : 0);
  g.lane_words = half_bank_pad((k + 1) * g.row_words);
  g.text_stride = half_bank_pad(W);
  g.smem_bytes = 4 * lanes * (g.lane_words + g.text_stride + max_ops + 1);
  return g;
}

template <int NW, int KP, int NWB>
__global__ void tb_fused_kernel(const uint32_t* __restrict__ pm_g,
                                const int32_t* __restrict__ text_g,
                                int32_t* __restrict__ ops,
                                int32_t* __restrict__ meta, int B, int W,
                                int k, int ncb, int early_term,
                                int commit_limit, int max_ops, int max_steps,
                                int row_words, int lane_words,
                                int text_stride) {
  constexpr int G = KP < WORD ? KP : WORD;   // threads per lane
  constexpr int L = KP / G;                  // levels per thread
  constexpr unsigned FULL = 0xFFFFFFFFu;
  extern __shared__ uint32_t smem[];
  const int lanes = blockDim.x / G;
  const int l = threadIdx.x / G, g = threadIdx.x % G;
  const int lane0 = blockIdx.x * lanes, lane = lane0 + l;
  const bool live = lane < B;      // a masked lane still takes part in the
                                   // shuffles, ballots and barriers
  uint32_t* band = smem + l * lane_words;
  int32_t* text_s = reinterpret_cast<int32_t*>(smem + lanes * lane_words);
  int32_t* ops_s = text_s + lanes * text_stride;
  int32_t* dist_s = ops_s + max_ops * lanes;
  // thread w < lanes walks lane lane0 + w after the fill
  const int wlane = lane0 + static_cast<int>(threadIdx.x);
  const bool walker = static_cast<int>(threadIdx.x) < lanes && wlane < B;
  PatternMasks<NW> wpm{};
  if (walker) wpm.load(pm_g, B, wlane);

  for (int x = threadIdx.x; x < W * lanes; x += blockDim.x) {
    const int j = x / lanes, ll = x % lanes;
    text_s[ll * text_stride + j] =
        lane0 + ll < B ? text_g[at(j, B, lane0 + ll)] : 0;
  }
  for (int x = threadIdx.x; x < max_ops * lanes; x += blockDim.x)
    ops_s[x] = OP_NONE;
  PatternMasks<NW> pm{};
  if (live) pm.load(pm_g, B, lane);
  __syncthreads();

  // ---- fill: the wavefront ----
  constexpr int band_hi = NW * WORD - WORD * NWB;
  const int col0 = W + 1 - ncb;
  const int rows0 = (k + L) / L;   // threads holding a level <= k
  const int d0 = g * L;
  const int32_t* text_l = text_s + l * text_stride;
  uint32_t col[L][NW], below_old[NW];
#pragma unroll
  for (int c = 0; c < L; ++c)
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) col[c][w_] = ones_below_word(d0 + c, w_);
#pragma unroll
  for (int w_ = 0; w_ < NW; ++w_) below_old[w_] = ONES;
  auto store = [&](int j) {      // the band windows of column j
    const int base = clampi(j - 2 - k, 0, band_hi);
    const int w0 = base >> 5, sh = base & 31;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      if (c > 0 && d0 + c > k) break;
      uint32_t* dst = band + (c * rows0 + g) * row_words + (j - col0) * NWB;
#pragma unroll
      for (int b = 0; b < NWB; ++b) {
        if constexpr (NWB == NW)         // the window is the whole vector
          dst[b] = col[c][b];
        else                             // NW = 2, NWB = 1
          dst[b] = funnel_word<NW>(col[c], w0 + b, sh);
      }
    }
  };
  if (col0 == 0 && d0 <= k) store(0);
  for (int s = 0; s < W + rows0 - 1; ++s) {
    uint32_t below_new[NW];
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) {
      below_new[w_] = __shfl_up_sync(FULL, col[L - 1][w_], 1, G);
      if (g == 0) below_new[w_] = ONES;
    }
    const int j = s - g + 1;
    const bool on = j >= 1 && j <= W && d0 <= k;   // j is a column of mine
    const int c = text_l[clampi(j - 1, 0, W - 1)];
    uint32_t pmj[NW], next[L][NW];
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) pmj[w_] = pm.word(c, w_);
#pragma unroll
    for (int cc = 0; cc < L; ++cc)
#pragma unroll
      for (int w_ = 0; w_ < NW; ++w_) next[cc][w_] = col[cc][w_];
    level_steps<NW, L>(next, below_old, below_new, pmj, j - 1, d0);
#pragma unroll
    for (int cc = 0; cc < L; ++cc)
#pragma unroll
      for (int w_ = 0; w_ < NW; ++w_)
        col[cc][w_] = on ? next[cc][w_] : col[cc][w_];
    if (on && j >= col0) store(j);
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) below_old[w_] = below_new[w_];
  }

  // ---- dist: the lowest level of the group whose bit W-1 is 0 ----
  const int tgt = W - 1;
  const int shift = (threadIdx.x % WORD) / G * G;
  int dist = k + 1;
#pragma unroll
  for (int c = 0; c < L; ++c) {
    uint32_t v = col[c][0];
#pragma unroll
    for (int w_ = 1; w_ < NW; ++w_)
      if ((tgt >> 5) == w_) v = col[c][w_];
    const bool hit = d0 + c <= k && ((v >> (tgt & 31)) & 1u) == 0;
    unsigned hits = __ballot_sync(FULL, hit) >> shift;
    if constexpr (G < WORD) hits &= (1u << G) - 1;
    if (hits) dist = min(dist, (__ffs(hits) - 1) * L + c);
  }
  if (g == 0) dist_s[l] = dist;
  __syncthreads();

  // ---- walk: one thread per lane over the band in shared memory ----
  if (walker) {
    const int w = threadIdx.x, wdist = dist_s[w];
    const SharedBand<L, NWB> st{smem + w * lane_words, k, ncb, col0,
                                band_hi, row_words, rows0};
    tb_walk<NW>(st, wpm, Rows<const int32_t>{text_s + w * text_stride, 1}, W,
                k, wdist, level_count(wdist, k, early_term), W - 1, W,
                commit_limit, max_ops, max_steps,
                Rows<int32_t>{ops_s + w, lanes}, Rows<int32_t>{meta + wlane, B});
  }
  __syncthreads();
  for (int x = threadIdx.x; x < max_ops * lanes; x += blockDim.x) {
    const int r = x / lanes, ll = x % lanes;
    if (lane0 + ll < B) ops[at(r, B, lane0 + ll)] = ops_s[x];
  }
}

using K1Kernel = void (*)(const uint32_t*, const int32_t*, int32_t*,
                          int32_t*, int, int, int, int, int, int, int, int,
                          int, int, int);

// ---- K3 ---------------------------------------------------------------
// Replaces repro/kernels/genasm_dc.py:_kernel (TPU): the DC fill alone,
// the band an output in (k+1, ncb, nwb, B) for a separate traceback, plus
// dist and the level count per lane.  Bound on the H100: bytes.  Each
// lane writes its whole band ((k+1) x ncb x nwb words: 2,860 B at k = 12,
// W = 64) against ~300 B of input, and that write is what must leave the
// chip; the fill's integer work is below it.  Design: one thread per lane
// runs square_dc, lane innermost so each warp's band stores are 128 B and
// coalesced; no walk, so no read-back of the band.
template <int NW, int KP>
__global__ void dc_band_kernel(const uint32_t* __restrict__ pm_g,
                               const int32_t* __restrict__ text,
                               uint32_t* __restrict__ band,
                               int32_t* __restrict__ dist_g,
                               int32_t* __restrict__ levels_g, int B, int W,
                               int k, int nwb, int ncb, int early_term) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  PatternMasks<NW> pm;
  pm.load(pm_g, B, lane);
  const int dist = square_dc<NW, KP>(pm, text, band, B, lane, W, k, nwb, ncb);
  dist_g[lane] = dist;
  levels_g[lane] = level_count(dist, k, early_term);
}

// ---- K2 ---------------------------------------------------------------
// Replaces repro/kernels/genasm_dc.py:_kernel_tail_banded (TPU).  Bound on
// the H100: per-thread latency of a serial recurrence over n_text columns
// and the walk; it runs once per batch with as many threads as lanes.
// Design: one thread per lane, the live column in registers and the band
// in lane-innermost global scratch, its base per lane on the lane's own
// diagonal; the fill stops at the lane's n_len (later columns are frozen
// copies the walk never reads) and column 0 is analytic in zbit.
template <int NW, int KP>
__global__ void tail_banded_kernel(const uint32_t* __restrict__ pm_g,
                                   const int32_t* __restrict__ text,
                                   const int32_t* __restrict__ m_len_g,
                                   const int32_t* __restrict__ n_len_g,
                                   int32_t* __restrict__ ops,
                                   int32_t* __restrict__ meta,
                                   uint32_t* __restrict__ band, int B,
                                   int n_text, int W, int k, int nwb,
                                   int early_term, int commit_limit,
                                   int max_ops, int max_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int m_len = m_len_g[lane], n_len = n_len_g[lane];
  const int diag = m_len - 1 - n_len;
  const int band_hi = NW * WORD - WORD * nwb;
  PatternMasks<NW> pm;
  pm.load(pm_g, B, lane);
  uint32_t col[KP][NW];
  init_column<NW, KP>(col, k);
  const int last = min(n_len, n_text);
  for (int j = 1; j <= last; ++j) {
    const int c = text[at(j - 1, B, lane)];
    uint32_t pmj[NW];
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) pmj[w_] = pm.word(c, w_);
    next_column<NW, KP>(col, pmj, j - 1, k);
    store_band<NW, KP>(col, clampi(j + diag - (k + 1), 0, band_hi), k, nwb,
                       band, j - 1, n_text, B, lane);
  }
  const int dist = first_hit<NW, KP>(
      col, clampi(m_len - 1, 0, NW * WORD - 1), m_len >= 1, k);
  const DiagonalBand st{band, B, lane, k, nwb, n_text, diag, band_hi};
  tb_walk_global<NW>(st, pm, text, n_text, B, lane, k, dist,
                     level_count(dist, k, early_term), m_len - 1, n_len,
                     commit_limit, max_ops, max_steps, ops, meta);
}

// ---- K4 ---------------------------------------------------------------
// Replaces repro/kernels/genasm_dc.py:_kernel_tail_fused (TPU).  Bound on
// the H100: per-thread latency as K2, plus the store traffic: each lane
// writes (k+1) x (n_len+1) x NW words (up to 100 KB at k = 48) that no
// shared memory could hold.  Design: the TPU's level-major fill with
// whole-tile early termination and a zero-filled store becomes the same
// column-major fill as K2 writing full vectors, stopped at the lane's
// n_len; the walk never reads a level above its lane's dist or a column
// past n_len, so neither the zero fill nor the frozen columns are needed.
template <int NW, int KP>
__global__ void tail_full_kernel(const uint32_t* __restrict__ pm_g,
                                 const int32_t* __restrict__ text,
                                 const int32_t* __restrict__ m_len_g,
                                 const int32_t* __restrict__ n_len_g,
                                 int32_t* __restrict__ ops,
                                 int32_t* __restrict__ meta,
                                 uint32_t* __restrict__ store, int B,
                                 int n_text, int W, int k, int nwb,
                                 int early_term, int commit_limit, int max_ops,
                                 int max_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  const int m_len = m_len_g[lane], n_len = n_len_g[lane];
  const long long ncols = n_text + 1;
  PatternMasks<NW> pm;
  pm.load(pm_g, B, lane);
  uint32_t col[KP][NW];
  init_column<NW, KP>(col, k);
  auto keep = [&](int j) {
#pragma unroll
    for (int d = 0; d < KP; ++d) {
      if (d > k) break;
#pragma unroll
      for (int w_ = 0; w_ < NW; ++w_)
        store[at((d * ncols + j) * NW + w_, B, lane)] = col[d][w_];
    }
  };
  keep(0);
  const int last = min(n_len, n_text);
  for (int j = 1; j <= last; ++j) {
    const int c = text[at(j - 1, B, lane)];
    uint32_t pmj[NW];
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) pmj[w_] = pm.word(c, w_);
    next_column<NW, KP>(col, pmj, j - 1, k);
    keep(j);
  }
  const int dist = first_hit<NW, KP>(
      col, clampi(m_len - 1, 0, NW * WORD - 1), m_len >= 1, k);
  const FullStore<NW> st{store, B, lane, k, n_text};
  tb_walk_global<NW>(st, pm, text, n_text, B, lane, k, dist,
                     level_count(dist, k, early_term), m_len - 1, n_len,
                     commit_limit, max_ops, max_steps, ops, meta);
}

// Live-column capacity: the smallest instantiated KP >= k + 1.
int levels_bucket(int k) {
  return k + 1 <= 16 ? 16 : k + 1 <= 32 ? 32 : k + 1 <= 64 ? 64 : 0;
}

constexpr int MAX_SHARED_BYTES = 232448;   // per block on an H100

// K1's instantiation for (nw, k, nwb), or null.  nwb < nw only where the
// band is narrower than the vector: W = 64 with k <= 14.
K1Kernel k1_kernel(int nw, int k, int nwb) {
  const int kp = levels_bucket(k);
  if (nw == 1 && kp == 16 && nwb == 1) return tb_fused_kernel<1, 16, 1>;
  if (nw == 1 && kp == 32 && nwb == 1) return tb_fused_kernel<1, 32, 1>;
  if (nw == 2 && kp == 16 && nwb == 1) return tb_fused_kernel<2, 16, 1>;
  if (nw == 2 && kp == 16 && nwb == 2) return tb_fused_kernel<2, 16, 2>;
  if (nw == 2 && kp == 32 && nwb == 2) return tb_fused_kernel<2, 32, 2>;
  if (nw == 2 && kp == 64 && nwb == 2) return tb_fused_kernel<2, 64, 2>;
  return nullptr;
}

// The block geometry tb_fused_geometry derives, and nothing else: G
// threads per lane, whole warps, the shared bytes of k1_layout.
bool k1_geometry_ok(int W, int nw, int k, int nwb, int ncb, int max_ops,
                    int lanes, int threads, int smem) {
  const int kp = levels_bucket(k);
  const int G = kp < WORD ? kp : WORD;
  return kp > 0 && W >= 1 && W <= nw * WORD && nwb >= 1 && nwb <= nw &&
         ncb >= 1 && ncb <= W + 1 && max_ops >= 0 && lanes >= 1 &&
         threads == lanes * G && threads % WORD == 0 && threads <= 1024 &&
         smem <= MAX_SHARED_BYTES &&
         smem == k1_layout(W, k, nwb, ncb, max_ops, lanes).smem_bytes;
}

// Raise the dynamic shared-memory limit of `kernel` on the current device
// to at least `smem`.  The limit only grows, so cudaFuncSetAttribute runs
// once per (instantiation, device) and new maximum, not before every
// launch.
cudaError_t k1_allow_shared(K1Kernel kernel, int smem) {
  static std::mutex mu;
  static std::map<std::pair<K1Kernel, int>, int> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(mu);
  int& set = allowed[{kernel, dev}];
  if (smem <= set) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

}  // namespace

// Instantiations: NW = 1 (W <= 32, so k + 1 <= 32) and NW = 2 (W <= 64).
#define GENASM_DISPATCH(KERNEL, ARGS)                                        \
  do {                                                                       \
    const int kp = levels_bucket(k);                                         \
    const dim3 grid((B + threads - 1) / threads), block(threads);            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                      \
    if (nw == 1 && kp == 16) KERNEL<1, 16><<<grid, block, 0, s>>> ARGS;      \
    else if (nw == 1 && kp == 32) KERNEL<1, 32><<<grid, block, 0, s>>> ARGS; \
    else if (nw == 2 && kp == 16) KERNEL<2, 16><<<grid, block, 0, s>>> ARGS; \
    else if (nw == 2 && kp == 32) KERNEL<2, 32><<<grid, block, 0, s>>> ARGS; \
    else if (nw == 2 && kp == 64) KERNEL<2, 64><<<grid, block, 0, s>>> ARGS; \
    else return static_cast<int>(cudaErrorInvalidValue);                     \
    return static_cast<int>(cudaGetLastError());                             \
  } while (0)

extern "C" {

int genasm_tb_fused_launch(const void* pm, const void* text, void* ops,
                           void* meta, int B, int W, int nw, int k, int nwb,
                           int ncb, int early_term, int commit_limit,
                           int max_ops, int max_steps, int lanes, int threads,
                           int smem, void* stream) {
  const K1Kernel kernel = k1_kernel(nw, k, nwb);
  if (kernel == nullptr || B < 1 ||
      !k1_geometry_ok(W, nw, k, nwb, ncb, max_ops, lanes, threads, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const K1Layout lay = k1_layout(W, k, nwb, ncb, max_ops, lanes);
  const cudaError_t err = k1_allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + lanes - 1) / lanes, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta), B, W, k, ncb,
      early_term, commit_limit, max_ops, max_steps, lay.row_words,
      lay.lane_words, lay.text_stride);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K1's instantiation for (nw, k, nwb) that one SM holds at once
// with `threads` threads and `smem` dynamic shared bytes a block, and the
// instantiation's dynamic shared-memory limit on this device as the card
// reports it once `smem` is allowed (cudaFuncGetAttributes).
int genasm_tb_fused_occupancy(int nw, int k, int nwb, int threads, int smem,
                              int* blocks, int* smem_limit) {
  const K1Kernel kernel = k1_kernel(nw, k, nwb);
  if (kernel == nullptr || smem > MAX_SHARED_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = k1_allow_shared(kernel, smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    *smem_limit = attr.maxDynamicSharedSizeBytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        threads, smem);
  }
  return static_cast<int>(err);
}

int genasm_dc_band_launch(const void* pm, const void* text, void* band,
                          void* dist, void* levels, int B, int W, int nw,
                          int k, int nwb, int ncb, int early_term, int threads,
                          void* stream) {
  GENASM_DISPATCH(dc_band_kernel,
                  (static_cast<const uint32_t*>(pm),
                   static_cast<const int32_t*>(text),
                   static_cast<uint32_t*>(band), static_cast<int32_t*>(dist),
                   static_cast<int32_t*>(levels), B, W, k, nwb, ncb,
                   early_term));
}

int genasm_tail_banded_launch(const void* pm, const void* text,
                              const void* m_len, const void* n_len, void* ops,
                              void* meta, void* band, int B, int n_text, int W,
                              int nw, int k, int nwb, int early_term,
                              int commit_limit, int max_ops, int max_steps,
                              int threads, void* stream) {
  GENASM_DISPATCH(tail_banded_kernel,
                  (static_cast<const uint32_t*>(pm),
                   static_cast<const int32_t*>(text),
                   static_cast<const int32_t*>(m_len),
                   static_cast<const int32_t*>(n_len),
                   static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
                   static_cast<uint32_t*>(band), B, n_text, W, k, nwb,
                   early_term, commit_limit, max_ops, max_steps));
}

int genasm_tail_full_launch(const void* pm, const void* text,
                            const void* m_len, const void* n_len, void* ops,
                            void* meta, void* store, int B, int n_text, int W,
                            int nw, int k, int nwb, int early_term,
                            int commit_limit, int max_ops, int max_steps,
                            int threads, void* stream) {
  GENASM_DISPATCH(tail_full_kernel,
                  (static_cast<const uint32_t*>(pm),
                   static_cast<const int32_t*>(text),
                   static_cast<const int32_t*>(m_len),
                   static_cast<const int32_t*>(n_len),
                   static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
                   static_cast<uint32_t*>(store), B, n_text, W, k, nwb,
                   early_term, commit_limit, max_ops, max_steps));
}

const char* genasm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
