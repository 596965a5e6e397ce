// K3: GenASM-DC of the square W x W window alone, for Hopper (sm_90a),
// the DENT band its output for a separate traceback (backend 'split').
// Replaces the Pallas TPU kernel _kernel of repro/kernels/genasm_dc.py; its
// plain PyTorch version is dc_band_plain in
// repro_torch/kernels/genasm_dc.py, and the outputs must be equal bit for
// bit.  One thread per lane runs a column-major SENE fill (R_j[d] = M & S &
// D & I over levels d = 0..k) with the live column of all k+1 levels in a
// thread-local array, updated in place.  The band (k+1, ncb, nwb, B) is
// its output, with dist (B) and the level count (B).  The C entry point
// returns cudaGetLastError() after the launch (or an error code for a
// geometry without an instantiation); it never synchronises and allocates
// nothing.

#include "genasm_common.cuh"

namespace {

constexpr int K3_THREADS = 128;   // threads (lanes) a block

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

// ---- K3 ---------------------------------------------------------------
// Replaces repro/kernels/genasm_dc.py:_kernel (TPU): the DC fill alone,
// the band an output in (k+1, ncb, nwb, B) for a separate traceback, plus
// dist and the level count per lane.  Bound on the H100: bytes.  Each
// lane writes its whole band ((k+1) x ncb x nwb words: 2,860 B at k = 12,
// W = 64) against ~300 B of input, and that write is what must leave the
// chip; the fill's integer work is below it.  Design: one thread per lane
// runs square_dc, lane innermost so each warp's band stores are 128 B and
// coalesced; no walk, so no read-back of the band.  At NW = 3 and 4 (W up
// to 128) it keeps this one-thread design; at KP = 64 the live column is
// more than a thread's registers hold (PERF.md: registers and spill).
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

// K3's instantiations of one NW (K3_NW, set by the build: dc_band.cu is
// compiled once per NW, the four at once, since the one-thread fill's
// unrolled KP x NW arrays make each instantiation slow to compile).
template <int NW>
int k3_launch(const void* pm, const void* text, void* band, void* dist,
              void* levels, int B, int W, int k, int nwb, int ncb,
              int early_term, void* stream) {
  const int kp = levels_bucket(k);
  const dim3 grid((B + K3_THREADS - 1) / K3_THREADS), block(K3_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define K3_CASE(KP_)                                                       \
  if (kp == KP_) {                                                         \
    dc_band_kernel<NW, KP_><<<grid, block, 0, s>>>(                        \
        static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text), \
        static_cast<uint32_t*>(band), static_cast<int32_t*>(dist),         \
        static_cast<int32_t*>(levels), B, W, k, nwb, ncb, early_term);      \
    return static_cast<int>(cudaGetLastError());                           \
  }
  K3_CASE(16) K3_CASE(32)
  if constexpr (NW > 1) K3_CASE(64)     // k < W <= 32 at NW = 1
#undef K3_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define K3_PART(NW_) k3_launch_nw##NW_
#define K3_DECLARE(NW_)                                                     \
  int K3_PART(NW_)(const void* pm, const void* text, void* band,            \
                   void* dist, void* levels, int B, int W, int k, int nwb,  \
                   int ncb, int early_term, void* stream)

#ifndef K3_NW
#define K3_NW 1
#endif

// this part's instantiations
#if K3_NW == 1
K3_DECLARE(1) { return k3_launch<1>(pm, text, band, dist, levels, B, W, k,
                                    nwb, ncb, early_term, stream); }
#elif K3_NW == 2
K3_DECLARE(2) { return k3_launch<2>(pm, text, band, dist, levels, B, W, k,
                                    nwb, ncb, early_term, stream); }
#elif K3_NW == 3
K3_DECLARE(3) { return k3_launch<3>(pm, text, band, dist, levels, B, W, k,
                                    nwb, ncb, early_term, stream); }
#elif K3_NW == 4
K3_DECLARE(4) { return k3_launch<4>(pm, text, band, dist, levels, B, W, k,
                                    nwb, ncb, early_term, stream); }
#endif

#if K3_NW == 1
K3_DECLARE(2);
K3_DECLARE(3);
K3_DECLARE(4);

extern "C" {

// The entry point lives in the NW = 1 part and calls each NW's part.
int genasm_dc_band_launch(const void* pm, const void* text, void* band,
                          void* dist, void* levels, int B, int W, int nw,
                          int k, int nwb, int ncb, int early_term,
                          void* stream) {
  if (B < 1 || W < 1 || W > nw * WORD || nwb < 1 || nwb > nw || ncb < 1 ||
      ncb > W + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  using Part = int (*)(const void*, const void*, void*, void*, void*, int,
                       int, int, int, int, int, void*);
  const Part parts[] = {K3_PART(1), K3_PART(2), K3_PART(3), K3_PART(4)};
  if (nw < 1 || nw > 4) return static_cast<int>(cudaErrorInvalidValue);
  return parts[nw - 1](pm, text, band, dist, levels, B, W, k, nwb, ncb,
                       early_term, stream);
}

}  // extern "C"
#endif
