// K1's kernel, tb_fused_kernel<NW, KP, NWB, PLACE>: the fused GenASM-DC+TB
// kernel of the square W x W window, for Hopper (sm_90a).  Replaces the
// Pallas TPU kernel _kernel_fused of repro/kernels/genasm_dc.py; its plain
// PyTorch version is tb_fused_plain in repro_torch/kernels/genasm_dc.py,
// and the outputs must be equal bit for bit.
//
// Included by two translation units, compiled in parallel: tb_fused.cu
// (NW = 1..4, W <= 128, and the C entry points) and tb_fused_wide.cu
// (NW = 5..8, W = 129..256), each instantiating its part of the template;
// the entry points reach the wide part through k1_kernel_wide.

#pragma once

#include "genasm_common.cuh"

namespace {

// K1's DENT band as the walk reads it, in shared memory (PLACE_SHARED:
// column jj at the static base clip(jj - 2 - k); level dd in row (dd % L)
// * rows0 + dd / L, L levels a fill thread) or in device memory
// (PLACE_GLOBAL: the tails' skewed layout, level d = g*L + c of band
// column q = jj - col0 at ((q + g)*L + c)*NWB*rows0 + g, word b rows0
// further, so that a wavefront step writes one contiguous row).  tests()
// is tb_walk's four bit tests of one step with their clamps shared,
// branch-free: each word is loaded at clamped indices whatever the edge
// cases say, so the four loads issue together.
template <int L, int NWB, int PLACE>
struct K1Band {
  const uint32_t* band;
  int k, ncb, col0, band_hi, row_words, rows0;

  // word 0 of level d (0..k), band column q (0..ncb-1); word b lies
  // b * stride() further
  __device__ __forceinline__ int word_at(int d, int q) const {
    if constexpr (PLACE == PLACE_SHARED)
      return ((d % L) * rows0 + d / L) * row_words + q * NWB;
    else
      return ((q + d / L) * L + d % L) * NWB * rows0 + d / L;
  }

  __device__ __forceinline__ int stride() const {
    if constexpr (PLACE == PLACE_SHARED) return 1;
    else return rows0;
  }

  // zbit of the window word at `at` + offset `off` (ii >= 0), else of the
  // first column, `first` = ED(0, jj) <= dd; outside the window: 1
  __device__ __forceinline__ bool bit(int at, int off, int ii,
                                      bool first) const {
    const int offc = clampi(off, 0, NWB * WORD - 1);
    const bool zero =
        ((band[at + (offc >> 5) * stride()] >> (offc & 31)) & 1u) == 0;
    return ((ii < 0) & first) | ((ii >= 0) & (off == offc) & zero);
  }

  __device__ __forceinline__ void tests(int d, int j, int i,
                                        bool (&z)[4]) const {
    const int dc = clampi(d, 0, k), dm = clampi(d - 1, 0, k);
    const int q_l = clampi(j - 1 - col0, 0, ncb - 1);   // column j-1
    const int q_j = clampi(j - col0, 0, ncb - 1);       // column j
    const int base_l = clampi(j - 3 - k, 0, band_hi);
    const int base_j = clampi(j - 2 - k, 0, band_hi);
    z[0] = bit(word_at(dc, q_l), i - 1 - base_l, i - 1, j - 1 <= d);
    z[1] = bit(word_at(dm, q_l), i - 1 - base_l, i - 1, j - 1 <= d - 1);
    z[2] = bit(word_at(dm, q_l), i - base_l, i, j - 1 <= d - 1);
    z[3] = bit(word_at(dm, q_j), i - 1 - base_j, i - 1, j <= d - 1);
  }
};

// K1's window form's prologue (K1Window): the block's lanes' pattern
// masks, word w of symbol c of lane ll at pm_s[(c * NW + w) * lanes + ll],
// and their text, from each lane's reversed window slices of the reads
// and refs (window_end).  One warp a (lane, word): thread t takes pattern
// position 32w + t, and one ballot a symbol makes the word (bit clear
// where the base is the symbol; set past W, where the pattern pads with a
// code no base has).  The text as stage_text lays it out, consecutive
// threads on consecutive bases of a lane.  Lanes past B: all 'A'.
template <int NW>
__device__ void stage_window(const K1Window& win, uint32_t* pm_s,
                             int32_t* text_s, int W, int stride, int lanes,
                             int lane0, int B) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  const int t = threadIdx.x % WORD;
  for (int u = threadIdx.x / WORD; u < lanes * NW;
       u += blockDim.x / WORD) {           // uniform over the warp
    const int ll = u / NW, w = u % NW, lane = lane0 + ll, i = w * WORD + t;
    int code = i < W ? 0 : SENTINEL_PAT;
    if (lane < B && i < W)
      code = window_end(win.reads, win.read_cols, lane, win.read_pos[lane],
                        W)[-i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t m = __ballot_sync(FULL, code != c);
      if (t == 0) pm_s[(c * NW + w) * lanes + ll] = m;
    }
  }
  for (int x = threadIdx.x; x < W * lanes; x += blockDim.x) {
    const int ll = x / W, j = x % W, lane = lane0 + ll;
    text_s[ll * stride + j] =
        lane < B ? window_end(win.refs, win.ref_cols, lane,
                              win.ref_pos[lane], W)[-j]
                 : 0;
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
// This design is GenASM-DC's own systolic array (wavefront_fill in
// genasm_common.cuh, the fill K2, K4 and K3 run too).  A group of G =
// min(KP, 32) threads holds one lane, thread g its L = KP / G levels g*L ..
// g*L+L-1.  The fill is a wavefront over (column, level): at step s thread
// g computes column j = s - g + 1 of its levels, taking R_j[g*L-1] from
// thread g-1 with one __shfl_up_sync of NW words and keeping it one step
// as R_{j-1}[g*L-1]; so the fill takes W + ceil((k+1)/L) - 1 steps, not
// W x (k+1) level updates, and a thread holds L x NW live words (no spill
// at KP = 64).  A step has no branch: every thread computes a column and
// keeps it only where j is one of its columns.  The text of the block's
// lanes is staged in shared memory once.  The DENT band lives in dynamic
// shared memory: each thread writes its levels' windows of its column
// (the whole vector where the window is as wide).  Then one thread per
// lane walks it with the walk K2 and K4 share (tb_walk); a step loads its
// four band words together (K1Band::tests) and combines the tests
// without branches.  The walkers of a block are its first threads, so the walk
// issues from one warp.  The ops are staged in shared memory and the
// whole block writes them, with the OP_NONE padding, lane-innermost.
// Several lanes fill a 128-thread block (8 at KP = 16, 4 at KP = 32 and
// 64), so a 2,048-lane batch gives 256 or 512 blocks; the band's shared
// bytes, not the block size, cap the lanes an SM holds (56 at k = 12, 16
// at k = 24, 8 at k = 48, W = 64).  At W > 64 tb_fused_geometry halves
// the lanes of a block while its shared bytes exceed the card's 232,448,
// down to one warp (one lane at KP >= 32, two at KP = 16).  What is left is the two chains: the walk, one
// thread per lane, is about 40 % of a launch at 2,048 lanes (PERF.md).
//
// At KP = 128 (k >= 64, W = 96 or 128; G = 32, L = 4) one lane's band,
// (k+1) x ncb x nwb words, is 134,160 B at W = 128, k = 64 and 264,192 B
// at k = 127: past a block's shared memory.  There the band lives in
// device memory (PLACE_GLOBAL, K1_PLACEMENT in kernels/genasm_dc.py), in
// the layout of the tails' global store: the wrapper allocates
// store_words words a lane, a step's threads write one contiguous row,
// and the walk reads its four words from one or two rows (K1Band).  The
// fill, the walk and the ops staging are the same code.
//
// At NW = 5..8 (W = 129..256) the band lives in device memory at every KP
// (up to 2.28 MB a lane at W = 256, k = 240; KP = 256 is G = 32 threads of
// L = 8 levels), and a fill thread holds L x NW words of its levels plus
// the pattern masks' 4 x NW: up to 64 + 32 at L = 8, NW = 8.  So the walkers load their lane's masks after the
// fill there (wpm), not before it: held through the fill they would cost
// every thread 4 x NW more registers.
//
// The window form (K1Window, a uniform runtime argument: one build serves
// both forms) is one main window of the fused loop in this one launch.
// In place of pm_g / text_g the block reads each lane's reversed W-base
// slices of the reads and refs at its positions (stage_window: the masks,
// one ballot a symbol, into pm_s, and the text into text_s), so the fill
// and walk threads load their masks from shared memory.  The fill, dist
// and walk are the standalone form's; only a lane whose window is active
// and solved walks.  Then the block commits: each walker advances its
// lane's state, the block writes each committing lane's ops from ops_s
// into its row of the op buffer as one run of bytes (no further than the
// drop column), and one atomicMax a block takes the window's level
// count.  The standalone form is the port of _kernel_fused (ops, meta
// out), which tools and the grids call alone.
template <int NW, int KP, int NWB, int PLACE>
__global__ void tb_fused_kernel(const uint32_t* __restrict__ pm_g,
                                const int32_t* __restrict__ text_g,
                                int32_t* __restrict__ ops,
                                int32_t* __restrict__ meta,
                                uint32_t* band_g, int B, int W, int k,
                                int ncb, int early_term, int commit_limit,
                                int max_ops, int max_steps, int row_words,
                                int lane_words, int text_stride,
                                int store_words, K1Window win) {
  constexpr int G = KP < WORD ? KP : WORD;   // threads per lane
  constexpr int L = KP / G;                  // levels per thread
  extern __shared__ uint32_t smem[];
  const int lanes = blockDim.x / G;
  const int l = threadIdx.x / G, g = threadIdx.x % G;
  const int lane0 = blockIdx.x * lanes, lane = lane0 + l;
  const bool live = lane < B;      // a masked lane still takes part in the
                                   // shuffles, ballots and barriers
  auto lane_band = [&](int ll) {   // lane lane0 + ll's band
    if constexpr (PLACE == PLACE_SHARED) return smem + ll * lane_words;
    else return band_g + static_cast<size_t>(lane0 + ll) * store_words;
  };
  uint32_t* band = lane_band(l);
  int32_t* text_s = reinterpret_cast<int32_t*>(smem + lanes * lane_words);
  int32_t* ops_s = text_s + lanes * text_stride;
  int32_t* dist_s = ops_s + max_ops * lanes;
  // the window form's masks (4 x NW words a lane) and each lane's commit:
  // its offset, then the ops it writes (2 words a lane)
  const bool window = win.reads != nullptr;
  uint32_t* pm_s = reinterpret_cast<uint32_t*>(dist_s + lanes);
  int32_t* commit_s = reinterpret_cast<int32_t*>(pm_s + 4 * NW * lanes);
  // thread w < lanes walks lane lane0 + w after the fill
  const int wlane = lane0 + static_cast<int>(threadIdx.x);
  const bool walker = static_cast<int>(threadIdx.x) < lanes && wlane < B;
  PatternMasks<NW> wpm{}, pm{};
  if (window) {
    stage_window<NW>(win, pm_s, text_s, W, text_stride, lanes, lane0, B);
  } else {
    if constexpr (NW <= 4)         // W <= 128: before the fill (as timed)
      if (walker) wpm.load(pm_g, B, wlane);
    stage_text(text_g, text_s, W, text_stride, lanes, lane0, B);
  }
  for (int x = threadIdx.x; x < max_ops * lanes; x += blockDim.x)
    ops_s[x] = OP_NONE;
  if (!window && live) pm.load(pm_g, B, lane);
  __syncthreads();
  if (window) {
    if (live) pm.load(pm_s, lanes, l);
    if constexpr (NW <= 4)
      if (walker) wpm.load(pm_s, lanes, threadIdx.x);
  }

  // ---- fill: the wavefront (wavefront_fill), the band to its store ----
  constexpr int band_hi = NW * WORD - WORD * NWB;
  const int col0 = W + 1 - ncb;
  const int rows0 = (k + L) / L;   // threads holding a level <= k
  const int d0 = g * L;
  uint32_t col[L][NW];
  init_levels<NW, L>(col, d0);
  auto store = [&](int j) {      // the band windows of column j
    if constexpr (PLACE == PLACE_GLOBAL)
      if (!live) return;           // a masked lane has no band
    const int base = clampi(j - 2 - k, 0, band_hi);
    const int w0 = base >> 5, sh = base & 31;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      if (c > 0 && d0 + c > k) break;
      uint32_t* dst;
      int bstride;
      if constexpr (PLACE == PLACE_SHARED) {
        dst = band + (c * rows0 + g) * row_words + (j - col0) * NWB;
        bstride = 1;
      } else {
        dst = band + ((j - col0 + g) * L + c) * NWB * rows0 + g;
        bstride = rows0;
      }
#pragma unroll
      for (int b = 0; b < NWB; ++b)
        dst[b * bstride] = band_word<NW, L, NWB>(col, c, b, w0, sh);
    }
  };
  if (col0 == 0 && d0 <= k) store(0);
  wavefront_fill<NW, L, G>(pm, text_s + l * text_stride, W, W, W + rows0 - 1,
                           k, g, col, [&](int, int j, bool on) {
    if (on && j >= col0) store(j);
  });

  // ---- dist: the lowest level of the group whose bit W-1 is 0 ----
  const int dist = group_dist<NW, L, G>(col, W - 1, true, k, d0);
  if (g == 0) dist_s[l] = dist;
  __syncthreads();

  // ---- walk: one thread per lane over the band ----
  if constexpr (NW > 4)            // W > 128: after the fill
    if (walker) {
      if (window) wpm.load(pm_s, lanes, threadIdx.x);
      else wpm.load(pm_g, B, wlane);
    }
  if (walker) {
    const int w = threadIdx.x, wdist = dist_s[w];
    const K1Band<L, NWB, PLACE> st{lane_band(w), k, ncb, col0, band_hi,
                                   row_words, rows0};
    const Rows<const int32_t> text{text_s + w * text_stride, 1};
    const Rows<int32_t> ops_w{ops_s + w, lanes};
    const int d_end = level_count(wdist, k, early_term);
    if (!window) {
      tb_walk(st, wpm, text, W, k, wdist, d_end, W - 1, W, commit_limit,
              max_ops, max_steps, ops_w, Rows<int32_t>{meta + wlane, B});
    } else {
      // only a committing lane walks: the others keep their state
      const bool active = window_active(win, wlane, W);
      int off = 0, n = 0;
      if (active && wdist <= k) {
        off = win.off[wlane];
        n = window_advance(win, wlane,
                           tb_walk_ops(st, wpm, text, W, k, wdist, d_end,
                                       W - 1, W, commit_limit, max_ops,
                                       max_steps, ops_w),
                           max_ops);
      } else if (active) {
        win.failed[wlane] = 1;
      }
      commit_s[w] = off;
      commit_s[lanes + w] = n;
    }
  }
  __syncthreads();
  if (!window) {
    for (int x = threadIdx.x; x < max_ops * lanes; x += blockDim.x) {
      const int r = x / lanes, ll = x % lanes;
      if (lane0 + ll < B) ops[at(r, B, lane0 + ll)] = ops_s[x];
    }
    return;
  }
  // the window form's commit: each committing lane's ops as one run of
  // bytes into its row of buf, the runs one after another, each spread
  // over the block's threads; the window's level count by one atomic
  for (int x = threadIdx.x; x < max_ops * lanes; x += blockDim.x) {
    const int ll = x / max_ops, i = x % max_ops;
    if (lane0 + ll < B && i < commit_s[lanes + ll])
      win.buf[static_cast<size_t>(lane0 + ll) * win.buf_cols +
              commit_s[ll] + i] = static_cast<uint8_t>(ops_s[i * lanes + ll]);
  }
  if (threadIdx.x == 0) {
    int most = level_count(dist_s[0], k, early_term);
    for (int ll = 1; ll < lanes && lane0 + ll < B; ++ll)
      most = max(most, level_count(dist_s[ll], k, early_term));
    atomicMax(win.level, most);
  }
}

}  // namespace

using K1Kernel = void (*)(const uint32_t*, const int32_t*, int32_t*,
                          int32_t*, uint32_t*, int, int, int, int, int, int,
                          int, int, int, int, int, int, K1Window);

// K1's instantiation at NW = 5..8 for (nw, kp, nwb, place), or null
// (tb_fused_wide.cu).
K1Kernel k1_kernel_wide(int nw, int kp, int nwb, int place);
