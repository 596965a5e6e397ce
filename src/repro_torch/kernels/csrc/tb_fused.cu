// K1: the fused GenASM-DC+TB kernel of the square W x W window, for
// Hopper (sm_90a).  Replaces the Pallas TPU kernel _kernel_fused of
// repro/kernels/genasm_dc.py; its plain PyTorch version is
// tb_fused_plain in repro_torch/kernels/genasm_dc.py, and the outputs must
// be equal bit for bit.  The C entry points return cudaGetLastError()
// after the launch (or an error code for a geometry without an
// instantiation); they never synchronise and allocate nothing.

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
// Shared layout of a block (32-bit words; tb_fused_geometry in
// kernels/genasm_dc.py computes the same sizes and the lanes a block:
// change both together): per lane (PLACE_SHARED), the band of k+1 rows of
// row_words words, row (d % L) * ceil((k+1)/L) + d / L for level d,
// column jj at (jj - col0) * nwb; then per lane text_stride text codes;
// then ops (max_ops, lanes); then dist (lanes).  PLACE_GLOBAL: per lane
// store_words = (ncb + rows0 - 1) * L * nwb * rows0 words of device
// memory, and no band in shared memory.  row_words is
// ncb * nwb, plus one where that makes row_words - nwb even: a step's
// threads write words (row_words - nwb) apart, an odd stride, so they fall
// in distinct banks.  The lane and text strides are 16 mod 32 words, so
// the two lanes of a warp at G = 16 fall in opposite halves of the banks.
struct K1Layout {
  int rows0, row_words, lane_words, text_stride, store_words, smem_bytes;
};

K1Layout k1_layout(int W, int k, int kp, int nwb, int ncb, int max_ops,
                   int lanes, int place) {
  const int G = kp < WORD ? kp : WORD, L = kp / G;
  K1Layout g;
  g.rows0 = (k + L) / L;
  g.row_words = ncb * nwb + ((nwb * (ncb - 1)) % 2 == 0 ? 1 : 0);
  g.lane_words = g.store_words = 0;
  if (place == PLACE_SHARED)
    g.lane_words = half_bank_pad((k + 1) * g.row_words);
  else
    g.store_words = (ncb + g.rows0 - 1) * L * nwb * g.rows0;
  g.text_stride = half_bank_pad(W);
  g.smem_bytes = 4 * lanes * (g.lane_words + g.text_stride + max_ops + 1);
  return g;
}

template <int NW, int KP, int NWB, int PLACE>
__global__ void tb_fused_kernel(const uint32_t* __restrict__ pm_g,
                                const int32_t* __restrict__ text_g,
                                int32_t* __restrict__ ops,
                                int32_t* __restrict__ meta,
                                uint32_t* band_g, int B, int W, int k,
                                int ncb, int early_term, int commit_limit,
                                int max_ops, int max_steps, int row_words,
                                int lane_words, int text_stride,
                                int store_words) {
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
  // thread w < lanes walks lane lane0 + w after the fill
  const int wlane = lane0 + static_cast<int>(threadIdx.x);
  const bool walker = static_cast<int>(threadIdx.x) < lanes && wlane < B;
  PatternMasks<NW> wpm{};
  if (walker) wpm.load(pm_g, B, wlane);

  stage_text(text_g, text_s, W, text_stride, lanes, lane0, B);
  for (int x = threadIdx.x; x < max_ops * lanes; x += blockDim.x)
    ops_s[x] = OP_NONE;
  PatternMasks<NW> pm{};
  if (live) pm.load(pm_g, B, lane);
  __syncthreads();

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
  if (walker) {
    const int w = threadIdx.x, wdist = dist_s[w];
    const K1Band<L, NWB, PLACE> st{lane_band(w), k, ncb, col0, band_hi,
                                   row_words, rows0};
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
                          int32_t*, uint32_t*, int, int, int, int, int, int,
                          int, int, int, int, int, int);

// K1's instantiation for (nw, k, nwb, place), or null: every (NW, KP, NWB)
// that some W <= 128 and k < W reach, with nwb = min(NW, ceil((2k+3)/32)),
// the band in shared memory at KP <= 64 and in device memory at KP = 128
// (K1_PLACEMENT in kernels/genasm_dc.py).
K1Kernel k1_kernel(int nw, int k, int nwb, int place) {
  const int kp = levels_bucket(k);
#define K1_CASE(NW_, KP_, NWB_, PLACE_)                                 \
  if (nw == NW_ && kp == KP_ && nwb == NWB_ && place == PLACE_)         \
    return tb_fused_kernel<NW_, KP_, NWB_, PLACE_>;
#define K1_SHARED(NW_, KP_, NWB_) K1_CASE(NW_, KP_, NWB_, PLACE_SHARED)
  K1_SHARED(1, 16, 1) K1_SHARED(1, 32, 1)
  K1_SHARED(2, 16, 1) K1_SHARED(2, 16, 2) K1_SHARED(2, 32, 2)
  K1_SHARED(2, 64, 2)
  K1_SHARED(3, 16, 1) K1_SHARED(3, 16, 2) K1_SHARED(3, 32, 2)
  K1_SHARED(3, 32, 3) K1_SHARED(3, 64, 3)
  K1_SHARED(4, 16, 1) K1_SHARED(4, 16, 2) K1_SHARED(4, 32, 2)
  K1_SHARED(4, 32, 3) K1_SHARED(4, 64, 3) K1_SHARED(4, 64, 4)
  K1_CASE(3, 128, 3, PLACE_GLOBAL) K1_CASE(4, 128, 4, PLACE_GLOBAL)
#undef K1_SHARED
#undef K1_CASE
  return nullptr;
}

// The block geometry tb_fused_geometry derives, and nothing else: G
// threads per lane, whole warps, the shared bytes of k1_layout within the
// card's limit, a band in device memory for PLACE_GLOBAL.
bool k1_geometry_ok(int W, int nw, int k, int nwb, int ncb, int max_ops,
                    int lanes, int threads, int place, int smem,
                    const void* store) {
  const int kp = levels_bucket(k);
  const int G = kp < WORD ? kp : WORD;
  return kp > 0 && W >= 1 && W <= nw * WORD && nwb >= 1 && nwb <= nw &&
         ncb >= 1 && ncb <= W + 1 && max_ops >= 0 && lanes >= 1 &&
         threads == lanes * G && threads % WORD == 0 && threads <= 1024 &&
         (place == PLACE_SHARED || (place == PLACE_GLOBAL && store)) &&
         smem <= MAX_SHARED_BYTES &&
         smem == k1_layout(W, k, kp, nwb, ncb, max_ops, lanes, place)
                     .smem_bytes;
}

}  // namespace

extern "C" {

int genasm_tb_fused_launch(const void* pm, const void* text, void* ops,
                           void* meta, void* store, int B, int W, int nw,
                           int k, int nwb, int ncb, int early_term,
                           int commit_limit, int max_ops, int max_steps,
                           int lanes, int threads, int place, int smem,
                           void* stream) {
  const K1Kernel kernel = k1_kernel(nw, k, nwb, place);
  if (kernel == nullptr || B < 1 ||
      !k1_geometry_ok(W, nw, k, nwb, ncb, max_ops, lanes, threads, place,
                      smem, store))
    return static_cast<int>(cudaErrorInvalidValue);
  const K1Layout lay = k1_layout(W, k, levels_bucket(k), nwb, ncb, max_ops,
                                 lanes, place);
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + lanes - 1) / lanes, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
      static_cast<uint32_t*>(store), B, W, k, ncb, early_term, commit_limit,
      max_ops, max_steps, lay.row_words, lay.lane_words, lay.text_stride,
      lay.store_words);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K1's instantiation for (nw, k, nwb, place) that one SM holds at
// once with `threads` threads and `smem` dynamic shared bytes a block, and
// the instantiation's dynamic shared-memory limit on this device as the
// card reports it once `smem` is allowed.
int genasm_tb_fused_occupancy(int nw, int k, int nwb, int place, int threads,
                              int smem, int* blocks, int* smem_limit) {
  return static_cast<int>(occupancy(k1_kernel(nw, k, nwb, place), threads,
                                    smem, blocks, smem_limit));
}

const char* genasm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
