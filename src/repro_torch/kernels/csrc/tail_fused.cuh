// K2 and K4: the fused GenASM-DC+TB kernels of the ragged rectangular tail
// (m_len <= W pattern chars against n_len <= n_text text chars, n_text =
// W + 4k), for Hopper (sm_90a).  One template, tail_fused_kernel<NW, KP,
// NWB, PLACE>, replaces two Pallas TPU kernels of
// repro/kernels/genasm_dc.py:
//   K2 tail_banded <- _kernel_tail_banded: NWB < NW words a column, the
//      lane's diagonal window based at clamp(j + diag - (k+1), 0, band_hi),
//      diag = m_len - 1 - n_len;
//   K4 tail_full   <- _kernel_tail_fused: NWB == NW, the full vector.
// Their plain PyTorch versions are tail_banded_plain and tail_full_plain in
// repro_torch/kernels/genasm_dc.py; the outputs must be equal bit for bit.
//
// Bound on the H100: as K1's, the latency of two serial chains per lane
// (the fill's level-below dependence and the walk's cursor), not bytes or
// operations; plus, where the store lives in device memory, its write
// traffic ((k+1) x n_len x NWB words a lane, 25 KB at k = 48, n_len = 64).
//
// Design, K1's (tb_fused.cu) with ragged ends.  The first port ran one
// thread per lane: a serial fill of n_text x (k+1) level updates, all KP
// levels' live words in one thread (255 registers and 14 KB of spill at
// KP = 64), and a walk whose every step was a chain of dependent global
// loads, in 16 blocks for a 2,048-lane batch.  Here a group of G =
// min(KP, 32) threads holds one lane, thread g its L = KP / G levels g*L ..
// g*L+L-1, and the fill is a wavefront over (column, level) with one
// __shfl_up_sync of NW words a step (wavefront_fill, K1's and K3's fill).  A lane's columns past
// last = min(n_len, n_text) are not computed, and the block runs as many
// steps as its longest lane needs: max(last) + ceil((k+1)/L) - 1.  dist is
// the lowest level whose bit m_len-1 of the lane's last column is 0 (m_len
// >= 1), by ballot over the group.  Column 0 and the drain (i < 0) are
// analytic, so the store holds columns 1..n_text.  Then one thread per
// lane (the block's first threads) walks the store with tb_walk, over
// TailStore::tests: four loads at clamped indices, no branch between them.
// The ops are staged in shared memory and the whole block writes them out.
//
// Where the store lives is the template's PLACE, chosen per (NW, KP) by
// tail_geometry in kernels/genasm_dc.py from tools/torch_tail_sweep.py's
// measurements (PERF.md), and global wherever one lane's store does not fit
// a block:
//   PLACE_SHARED: per lane, k+1 rows of row_words words in dynamic shared
//     memory, row (d % L) * rows0 + d / L for level d, column j at
//     (j - 1) * NWB; row_words - NWB is odd, so a step's threads (which
//     write rows g, columns s - g + 1) fall in distinct banks, and the lane
//     stride is 16 mod 32 words.  The walk is cheap; the bytes cap the
//     lanes an SM holds.
//   PLACE_GLOBAL: per lane, store_words words of device memory that the
//     wrapper allocates, skewed so that a wavefront step is one contiguous
//     row: level d = g*L + c of column j at ((s*L + c)*NWB + b)*rows0 + g,
//     s = j - 1 + g, word b.  A step's stores are coalesced, and a walk
//     step's four words lie in one or two rows.
// At NW = 5..8 (W = 129..256) only PLACE_GLOBAL is built: a lane's store is
// 0.1-10 MB there (9.9 MB for K4 at W = 256, k = 240, n_text = 1,216).
// The walkers load their lane's masks and lengths after the fill there,
// so that no fill thread holds two lanes' masks (4 x NW registers).
//
// Included by two translation units, compiled in parallel: tail_fused.cu
// (NW = 1..4, W <= 128, and the C entry points) and tail_fused_wide.cu
// (NW = 5..8, W = 129..256, device memory only), each instantiating its
// part of the template; the entry points reach the wide part through
// tail_kernel_wide.

#pragma once

#include "genasm_common.cuh"

namespace {

// The lane's store as the walk reads it: tests() is tb_walk's four bit
// tests of one step, with the reference's clamps (level to 0..k, column
// to 1..n_text) and analytic edges (column 0: R_0[d] = ones below d; row
// -1: ED(0, jj) = jj).  K2 reads a bit outside the lane's window as 1, as
// _kernel_tail_banded does; K4 clamps the bit index into the vector, as
// _kernel_tail_fused does (`banded`; the two differ only at bit indices
// >= m_pad, which no walk reaches).
template <int G, int L, int NWB, int PLACE>
struct TailStore {
  const uint32_t* store;
  int k, n_text, diag, band_hi, rows0, row_words;
  bool banded;

  // word 0 of level d (0..k), column jc + 1 (jc 0..n_text-1); word b lies
  // b * stride() further
  __device__ __forceinline__ int word_at(int d, int jc) const {
    if constexpr (PLACE == PLACE_SHARED)
      return ((d % L) * rows0 + d / L) * row_words + jc * NWB;
    else
      return ((jc + d / L) * L + d % L) * NWB * rows0 + d / L;
  }

  __device__ __forceinline__ int stride() const {
    if constexpr (PLACE == PLACE_SHARED) return 1;
    else return rows0;
  }

  __device__ __forceinline__ bool bit(int at, int off, int ii, int jj,
                                      int dd) const {
    const int offc = clampi(off, 0, NWB * WORD - 1);
    const bool zero =
        ((store[at + (offc >> 5) * stride()] >> (offc & 31)) & 1u) == 0;
    const bool in_window = !banded | (off == offc);
    return ((ii < 0) & (jj <= dd)) | ((ii >= 0) & (jj <= 0) & (ii < dd)) |
           ((ii >= 0) & (jj > 0) & in_window & zero);
  }

  __device__ __forceinline__ void tests(int d, int j, int i,
                                        bool (&z)[4]) const {
    const int dc = clampi(d, 0, k), dm = clampi(d - 1, 0, k);
    const int jl = clampi(j - 2, 0, n_text - 1);     // column j-1
    const int jr = clampi(j - 1, 0, n_text - 1);     // column j
    const int at_dl = word_at(dc, jl), at_ml = word_at(dm, jl),
              at_mj = word_at(dm, jr);
    const int base_l = clampi(j - 1 + diag - (k + 1), 0, band_hi);
    const int base_j = clampi(j + diag - (k + 1), 0, band_hi);
    z[0] = bit(at_dl, i - 1 - base_l, i - 1, j - 1, d);
    z[1] = bit(at_ml, i - 1 - base_l, i - 1, j - 1, d - 1);
    z[2] = bit(at_ml, i - base_l, i, j - 1, d - 1);
    z[3] = bit(at_mj, i - 1 - base_j, i - 1, j, d - 1);
  }
};

template <int NW, int KP, int NWB, int PLACE>
__global__ void tail_fused_kernel(const uint32_t* __restrict__ pm_g,
                                  const int32_t* __restrict__ text_g,
                                  const int32_t* __restrict__ m_len_g,
                                  const int32_t* __restrict__ n_len_g,
                                  int32_t* __restrict__ ops,
                                  int32_t* __restrict__ meta,
                                  uint32_t* store_g, int B, int n_text, int k,
                                  int banded, int early_term,
                                  int commit_limit, int max_ops,
                                  int max_steps, int row_words,
                                  int lane_words, int text_stride,
                                  int store_words) {
  constexpr int G = KP < WORD ? KP : WORD;   // threads per lane
  constexpr int L = KP / G;                  // levels per thread
  constexpr int band_hi = NW * WORD - WORD * NWB;
  extern __shared__ uint32_t smem[];
  const int lanes = blockDim.x / G;
  const int l = threadIdx.x / G, g = threadIdx.x % G;
  const int lane0 = blockIdx.x * lanes, lane = lane0 + l;
  const bool live = lane < B;      // a masked lane still takes part in the
                                   // shuffles, ballots and barriers
  int32_t* text_s = reinterpret_cast<int32_t*>(smem + lanes * lane_words);
  int32_t* ops_s = text_s + lanes * text_stride;
  int32_t* dist_s = ops_s + max_ops * lanes;
  int32_t* last_s = dist_s + lanes;
  auto lane_store = [&](int ll) {  // lane lane0 + ll's store
    if constexpr (PLACE == PLACE_SHARED) return smem + ll * lane_words;
    else return store_g + static_cast<size_t>(lane0 + ll) * store_words;
  };
  // thread w < lanes walks lane lane0 + w after the fill
  const int wlane = lane0 + static_cast<int>(threadIdx.x);
  const bool walker = static_cast<int>(threadIdx.x) < lanes && wlane < B;
  PatternMasks<NW> wpm{};
  int wm_len = 0, wn_len = 0;
  if constexpr (NW <= 4) {         // W <= 128: before the fill (as timed)
    if (walker) {
      wpm.load(pm_g, B, wlane);
      wm_len = m_len_g[wlane];
      wn_len = n_len_g[wlane];
    }
  }

  if (threadIdx.x == 0) *last_s = 0;
  stage_text(text_g, text_s, n_text, text_stride, lanes, lane0, B);
  for (int x = threadIdx.x; x < max_ops * lanes; x += blockDim.x)
    ops_s[x] = OP_NONE;
  PatternMasks<NW> pm{};
  int m_len = 0, n_len = 0;
  if (live) {
    pm.load(pm_g, B, lane);
    m_len = m_len_g[lane];
    n_len = n_len_g[lane];
  }
  const int last = min(n_len, n_text);   // the lane's last column
  __syncthreads();
  if (g == 0 && last > 0) atomicMax(last_s, last);
  __syncthreads();

  // ---- fill: the wavefront (wavefront_fill) over the lane's columns
  // 1..last, the block's steps set by its longest lane ----
  const int rows0 = (k + L) / L;   // threads holding a level <= k
  const int d0 = g * L;
  const int diag = m_len - 1 - n_len;
  uint32_t* st_l = lane_store(l);
  uint32_t col[L][NW];
  init_levels<NW, L>(col, d0);
  auto store = [&](int j) {      // the windows of column j, levels d0..
    const int base = clampi(j + diag - (k + 1), 0, band_hi);
    const int w0 = base >> 5, sh = base & 31;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      if (c > 0 && d0 + c > k) break;
      uint32_t* dst;
      int bstride;
      if constexpr (PLACE == PLACE_SHARED) {
        dst = st_l + (c * rows0 + g) * row_words + (j - 1) * NWB;
        bstride = 1;
      } else {
        dst = st_l + ((j - 1 + g) * L + c) * NWB * rows0 + g;
        bstride = rows0;
      }
#pragma unroll
      for (int b = 0; b < NWB; ++b)
        dst[b * bstride] = band_word<NW, L, NWB>(col, c, b, w0, sh);
    }
  };
  wavefront_fill<NW, L, G>(pm, text_s + l * text_stride, n_text, last,
                           *last_s + rows0 - 1, k, g, col,
                           [&](int, int j, bool on) {
    if (on) store(j);
  });

  // ---- dist: the lowest level whose bit m_len-1 of column last is 0 ----
  const int dist = group_dist<NW, L, G>(
      col, clampi(m_len - 1, 0, NW * WORD - 1), m_len >= 1, k, d0);
  if (g == 0) dist_s[l] = dist;
  __syncthreads();

  // ---- walk: one thread per lane, from (m_len - 1, n_len) ----
  if constexpr (NW > 4) {          // W > 128: after the fill
    if (walker) {
      wpm.load(pm_g, B, wlane);
      wm_len = m_len_g[wlane];
      wn_len = n_len_g[wlane];
    }
  }
  if (walker) {
    const int w = threadIdx.x, wdist = dist_s[w];
    const TailStore<G, L, NWB, PLACE> st{
        lane_store(w), k, n_text, wm_len - 1 - wn_len, band_hi, rows0,
        row_words, banded != 0};
    tb_walk(st, wpm, Rows<const int32_t>{text_s + w * text_stride, 1},
                n_text, k, wdist, level_count(wdist, k, early_term),
                wm_len - 1, wn_len, commit_limit, max_ops, max_steps,
                Rows<int32_t>{ops_s + w, lanes}, Rows<int32_t>{meta + wlane, B});
  }
  __syncthreads();
  for (int x = threadIdx.x; x < max_ops * lanes; x += blockDim.x) {
    const int r = x / lanes, ll = x % lanes;
    if (lane0 + ll < B) ops[at(r, B, lane0 + ll)] = ops_s[x];
  }
}

}  // namespace

using TailKernel = void (*)(const uint32_t*, const int32_t*, const int32_t*,
                            const int32_t*, int32_t*, int32_t*, uint32_t*,
                            int, int, int, int, int, int, int, int, int, int,
                            int, int);

// The tail instantiation at NW = 5..8 for (nw, kp, nwb, place), or null
// (tail_fused_wide.cu).
TailKernel tail_kernel_wide(int nw, int kp, int nwb, int place);
