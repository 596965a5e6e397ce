// Fused GenASM-DC+TB kernels for Hopper (sm_90a), one CUDA thread per
// alignment problem ("lane").
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
// Each thread runs the whole DP of its lane: a column-major SENE fill
// (R_j[d] = M & S & D & I over levels d = 0..k) with the live column of
// all k+1 levels in a thread-local array, updated in place, then the
// GenASM-TB walk (=,X,D,I preference, tail drain, commit limit) reading
// the store back one word per bit test.  The TPU kernels' one-hot masked
// sums over the whole store become single indexed loads, clamped exactly
// as the reference clips its indices.  The store is per-lane global
// scratch that the wrapper allocates; only ops and meta are outputs.  K3
// runs the fill alone, and its band (k+1, ncb, nwb, B) is the output, with
// dist (B) and the level count (B).
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry without an instantiation); they never
// synchronise and allocate nothing.

#include <cstdint>
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

  // P[ii] == text char c (ii clipped into the padded pattern)
  __device__ __forceinline__ bool peq(int c, int ii) const {
    const int iic = clampi(ii, 0, NW * WORD - 1);
    uint32_t v = word(c, 0);
#pragma unroll
    for (int w_ = 1; w_ < NW; ++w_)
      if ((iic >> 5) == w_) v = word(c, w_);
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

// K1: band of column jj at the static base clip(jj - 2 - k).
struct SquareBand {
  const uint32_t* band;
  int B, lane, k, nwb, ncb, col0, band_hi;

  __device__ __forceinline__ bool zbit(int dd, int jj, int ii) const {
    if (ii < 0) return jj <= dd;        // first column: ED(0, jj) <= dd
    const int off = ii - clampi(jj - 2 - k, 0, band_hi);
    if (off < 0 || off >= nwb * WORD) return false;
    const int row = (clampi(dd, 0, k) * ncb + clampi(jj - col0, 0, ncb - 1)) *
                    nwb + (off >> 5);
    return ((band[at(row, B, lane)] >> (off & 31)) & 1u) == 0;
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

// _tb_walk for one lane, then the meta rows.  The TPU's whole-tile early
// exit is a per-thread exit here: a done lane's state never changes again.
template <int NW, class Store>
__device__ void tb_walk(const Store& st, const PatternMasks<NW>& pm,
                        const int32_t* __restrict__ text, int n_text, int B,
                        int lane, int k, int dist, int d_end, int init_i,
                        int init_j, int commit_limit, int max_ops,
                        int max_steps, int32_t* __restrict__ ops,
                        int32_t* __restrict__ meta) {
  int i = init_i, j = init_j, d = dist, nops = 0, rd = 0, rf = 0;
  bool done = dist > k, ok = true;
  for (int s = 0; s < max_ops; ++s) ops[at(s, B, lane)] = OP_NONE;
  for (int step = 0; step < max_steps && !done; ++step) {
    if (rd >= commit_limit) break;      // stopped: nothing changes any more
    const bool tail = i < 0;
    bool mA = false, sA = false, dA = false, iA = false;
    if (!tail) {
      const int cj = text[at(clampi(j - 1, 0, n_text - 1), B, lane)];
      mA = j > 0 && pm.peq(cj, i) && st.zbit(d, j - 1, i - 1);
      sA = j > 0 && d > 0 && st.zbit(d - 1, j - 1, i - 1);
      dA = j > 0 && d > 0 && st.zbit(d - 1, j - 1, i);
      iA = d > 0 && st.zbit(d - 1, j, i - 1);
    }
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
      if (nops < max_ops) ops[at(nops, B, lane)] = op;
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
  meta[at(META_DIST, B, lane)] = dist;
  meta[at(META_LVL, B, lane)] = d_end;
  meta[at(META_NOPS, B, lane)] = nops;
  meta[at(META_RD, B, lane)] = rd;
  meta[at(META_RF, B, lane)] = rf;
  meta[at(META_DFIN, B, lane)] = d;
  meta[at(META_OK, B, lane)] = ok ? 1 : 0;
  meta[at(META_ZERO, B, lane)] = 0;
}

// The level count of the reference's whole-tile early termination, per
// lane: only its maximum over the batch is read.
__device__ __forceinline__ int level_count(int dist, int k, int early_term) {
  return early_term ? min(dist, k) + 1 : k + 1;
}

// The square window's DC fill, shared by K1 and K3: column-major SENE
// over the W text columns with the live column in registers, storing the
// DENT band windows of the last ncb columns at the static base
// clip(j - 2 - k); returns dist (bit W-1 of the last column).
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

// ---- K1 ---------------------------------------------------------------
// Replaces repro/kernels/genasm_dc.py:_kernel_fused (TPU).  Bound on the
// H100: neither bytes nor operations.  Its inputs and outputs are a few
// hundred bytes per lane and its DP a few ten thousand integer operations,
// but each lane is one long serial recurrence (W columns x k+1 levels,
// then up to max_steps dependent walk steps, each a chain of scratch
// loads), so the time is latency per thread times too few threads to fill
// 132 SMs.  The design keeps the per-lane work off the memory system where
// it can: the live column sits in registers (spilling at large k), the
// pattern masks in registers, the band in lane-innermost global scratch
// that stays in L1/L2 between its write and its read.
template <int NW, int KP>
__global__ void tb_fused_kernel(const uint32_t* __restrict__ pm_g,
                                const int32_t* __restrict__ text,
                                int32_t* __restrict__ ops,
                                int32_t* __restrict__ meta,
                                uint32_t* __restrict__ band, int B, int W,
                                int k, int nwb, int ncb, int early_term,
                                int commit_limit, int max_ops, int max_steps) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  PatternMasks<NW> pm;
  pm.load(pm_g, B, lane);
  const int dist = square_dc<NW, KP>(pm, text, band, B, lane, W, k, nwb, ncb);
  const SquareBand st{band, B, lane, k, nwb, ncb, W + 1 - ncb,
                      NW * WORD - WORD * nwb};
  tb_walk<NW>(st, pm, text, W, B, lane, k, dist,
              level_count(dist, k, early_term), W - 1, W, commit_limit,
              max_ops, max_steps, ops, meta);
}

// ---- K3 ---------------------------------------------------------------
// Replaces repro/kernels/genasm_dc.py:_kernel (TPU): K1's DC fill alone,
// the band an output in (k+1, ncb, nwb, B) for a separate traceback, plus
// dist and the level count per lane.  Bound on the H100: bytes.  Each
// lane writes its whole band ((k+1) x ncb x nwb words: 2,860 B at k = 12,
// W = 64) against ~300 B of input, and that write is what must leave the
// chip; the fill's integer work is below it.  Design: as K1's fill, lane
// innermost so each warp's band stores are 128 B and coalesced; no walk,
// so no read-back of the band.
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
// the H100: as K1, per-thread latency of a serial recurrence over n_text
// columns and the walk; it runs once per batch with as many threads as
// lanes.  Design: as K1, with the band base per lane on the lane's own
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
  tb_walk<NW>(st, pm, text, n_text, B, lane, k, dist,
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
  tb_walk<NW>(st, pm, text, n_text, B, lane, k, dist,
              level_count(dist, k, early_term), m_len - 1, n_len,
              commit_limit, max_ops, max_steps, ops, meta);
}

// Live-column capacity: the smallest instantiated KP >= k + 1.
int levels_bucket(int k) {
  return k + 1 <= 16 ? 16 : k + 1 <= 32 ? 32 : k + 1 <= 64 ? 64 : 0;
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
                           void* meta, void* band, int B, int W, int nw, int k,
                           int nwb, int ncb, int early_term, int commit_limit,
                           int max_ops, int max_steps, int threads,
                           void* stream) {
  GENASM_DISPATCH(tb_fused_kernel,
                  (static_cast<const uint32_t*>(pm),
                   static_cast<const int32_t*>(text),
                   static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
                   static_cast<uint32_t*>(band), B, W, k, nwb, ncb, early_term,
                   commit_limit, max_ops, max_steps));
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
