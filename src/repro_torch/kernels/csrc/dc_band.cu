// K3: GenASM-DC of the square W x W window alone, for Hopper (sm_90a),
// the DENT band its output for a separate traceback (backend 'split').
// Replaces the Pallas TPU kernel _kernel of repro/kernels/genasm_dc.py; its
// plain PyTorch version is dc_band_plain in
// repro_torch/kernels/genasm_dc.py, and the outputs must be equal bit for
// bit: dist (B), the band (k+1, ncb, nwb, B) of the last ncb columns, each
// level's window of nwb words at the static base clip(j - 2 - k), lane
// innermost, and the level count (B).
//
// Bound on the H100: bytes.  A lane writes its whole band ((k+1) x ncb x
// nwb words: 2,860 B at k = 12, 25,480 B at k = 48, W = 64) against ~300 B
// of input; the fill's integer work is below that.
//
// Design.  The fill is K1's (wavefront_fill in genasm_common.cuh, the same
// code): a group of G = min(KP, 32) threads holds one lane, thread g its
// L = KP / G levels, a wavefront over (column, level) with one
// __shfl_up_sync of NW words a step; the text of the block's lanes is
// staged in shared memory; dist by ballot over the group (group_dist).  So
// a thread holds L x NW live words, not KP x NW, and a block holds several
// lanes.  What is left is the band's way out.  A thread holds levels of
// one lane, and the output is lane-innermost, so the G threads of a lane
// write G different rows.  Two placements (PLACE), chosen by KP in
// dc_band_geometry (kernels/genasm_dc.py) from tools/torch_k3_sweep.py's
// measurements (PERF.md): direct at KP = 16, staged above.
//   K3_STAGED: each step's windows go to a ring of 2 x chunk step slots in
//     shared memory; every chunk steps the block syncs once and writes the
//     chunk out lane-innermost: thread (q, ll), ll = tid % lanes, stores
//     what fill thread g = q of lane ll made, so a warp stores
//     min(lanes, 32) neighbouring lanes of each of 32 / min(lanes, 32) rows
//     (8 lanes: one full 32 B sector a row).  The fill runs on into the
//     other half of the ring while the block writes, so one barrier a
//     chunk suffices.  Slot layout: lane l at l * lane_stride, word (c *
//     NWB + b) * G + g; lane_stride = KP * NWB rounded up to an odd
//     multiple of 32 / min(lanes, 32) words, so that the write-out's reads
//     (min(lanes, 32) lanes x 32 / min(lanes, 32) neighbouring words a
//     warp) fall in distinct banks.
//   K3_DIRECT: each thread stores its windows straight from registers
//     (4 B a row, the block's lanes side by side), and L2 merges the
//     partial sectors of neighbouring lanes.
// Column 0 (stored only when ncb = W + 1) is written directly in both.
//
// Shared layout of a block (32-bit words; dc_band_geometry computes the
// same sizes: change both together): per lane text_stride text codes,
// then (K3_STAGED) the ring, 2 x chunk slots of lanes x lane_stride words.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry without an instantiation); they never
// synchronise and allocate nothing.

#include "genasm_common.cuh"

namespace {

constexpr int K3_STAGED = 0, K3_DIRECT = 1;

// The smallest odd multiple of r that is >= words.
int odd_multiple(int words, int r) { return (((words + r - 1) / r) | 1) * r; }

struct K3Layout {
  int text_stride, lane_stride, smem_bytes;
};

K3Layout k3_layout(int W, int kp, int nwb, int lanes, int chunk, int place) {
  K3Layout t;
  t.text_stride = half_bank_pad(W);
  const int r = WORD / (lanes < WORD ? lanes : WORD);
  t.lane_stride = place == K3_STAGED ? odd_multiple(kp * nwb, r) : 0;
  t.smem_bytes =
      4 * (lanes * t.text_stride + 2 * chunk * lanes * t.lane_stride);
  return t;
}

// ---- K3 ---------------------------------------------------------------
template <int NW, int KP, int NWB, int PLACE>
__global__ void dc_band_kernel(const uint32_t* __restrict__ pm_g,
                               const int32_t* __restrict__ text_g,
                               uint32_t* __restrict__ band,
                               int32_t* __restrict__ dist_g,
                               int32_t* __restrict__ levels_g, int B, int W,
                               int k, int ncb, int early_term,
                               int text_stride, int lane_stride, int chunk) {
  constexpr int G = KP < WORD ? KP : WORD;   // threads per lane
  constexpr int L = KP / G;                  // levels per thread
  constexpr int band_hi = NW * WORD - WORD * NWB;
  extern __shared__ uint32_t smem[];
  const int lanes = blockDim.x / G;
  const int l = threadIdx.x / G, g = threadIdx.x % G;
  const int lane0 = blockIdx.x * lanes, lane = lane0 + l;
  const bool live = lane < B;      // a masked lane still takes part in the
                                   // shuffles, ballots and barriers
  int32_t* text_s = reinterpret_cast<int32_t*>(smem);
  uint32_t* ring = smem + lanes * text_stride;

  stage_text(text_g, text_s, W, text_stride, lanes, lane0, B);
  PatternMasks<NW> pm{};
  if (live) pm.load(pm_g, B, lane);
  __syncthreads();

  const int col0 = W + 1 - ncb;
  const int rows0 = (k + L) / L;   // threads holding a level <= k
  const int steps = W + rows0 - 1;
  const int d0 = g * L;
  // band row of level d, column j (word 0)
  auto row = [&](int d, int j) {
    return (static_cast<long long>(d) * ncb + (j - col0)) * NWB;
  };
  uint32_t col[L][NW];
  init_levels<NW, L>(col, d0);
  auto put = [&](int j) {        // column j's windows to device memory
    const int base = clampi(j - 2 - k, 0, band_hi);
    const int w0 = base >> 5, sh = base & 31;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      if (c > 0 && d0 + c > k) break;
      const long long r = row(d0 + c, j);
#pragma unroll
      for (int b = 0; b < NWB; ++b)
        if (live)
          band[at(r + b, B, lane)] = band_word<NW, L, NWB>(col, c, b, w0, sh);
    }
  };
  if (col0 == 0 && d0 <= k) put(0);
  const int32_t* text_l = text_s + l * text_stride;

  if constexpr (PLACE == K3_DIRECT) {
    wavefront_fill<NW, L, G>(pm, text_l, W, W, steps, k, g, col,
                             [&](int, int j, bool on) {
      if (on && j >= col0) put(j);
    });
  } else {
    const int slot_words = lanes * lane_stride, mask = 2 * chunk - 1;
    // the write-out's role: lane lane0 + ll, the levels fill thread g = q
    // of that lane held
    const int q = threadIdx.x / lanes, ll = threadIdx.x % lanes;
    const int jlo = col0 > 1 ? col0 : 1;
    auto flush = [&](int s_first, int n) {
      if (lane0 + ll >= B) return;
      for (int i = 0; i < n; ++i) {
        const int s = s_first + i, j = s - q + 1;
        if (j < jlo || j > W) continue;
        const uint32_t* src = ring + (s & mask) * slot_words +
                              ll * lane_stride + q;
#pragma unroll
        for (int c = 0; c < L; ++c) {
          if (q * L + c > k) break;
          const long long r = row(q * L + c, j);
#pragma unroll
          for (int b = 0; b < NWB; ++b)
            band[at(r + b, B, lane0 + ll)] = src[(c * NWB + b) * G];
        }
      }
    };
    wavefront_fill<NW, L, G>(pm, text_l, W, W, steps, k, g, col,
                             [&](int s, int j, bool on) {
      if (on && j >= col0) {
        const int base = clampi(j - 2 - k, 0, band_hi);
        const int w0 = base >> 5, sh = base & 31;
        uint32_t* dst = ring + (s & mask) * slot_words + l * lane_stride + g;
#pragma unroll
        for (int c = 0; c < L; ++c) {
          if (c > 0 && d0 + c > k) break;
#pragma unroll
          for (int b = 0; b < NWB; ++b)
            dst[(c * NWB + b) * G] = band_word<NW, L, NWB>(col, c, b, w0, sh);
        }
      }
      if (((s + 1) & (chunk - 1)) == 0) {   // a chunk is done: write it out
        __syncthreads();
        flush(s + 1 - chunk, chunk);
      }
    });
    const int rest = steps & (chunk - 1);
    if (rest) {
      __syncthreads();
      flush(steps - rest, rest);
    }
  }

  // ---- dist: the lowest level of the group whose bit W-1 is 0 ----
  const int dist = group_dist<NW, L, G>(col, W - 1, true, k, d0);
  if (g == 0 && live) {
    dist_g[lane] = dist;
    levels_g[lane] = level_count(dist, k, early_term);
  }
}

using K3Kernel = void (*)(const uint32_t*, const int32_t*, uint32_t*,
                          int32_t*, int32_t*, int, int, int, int, int, int,
                          int, int);

// K3's instantiation for (nw, k, nwb, place), or null: every (NW, KP, NWB)
// that some W <= 128 and k < W reach (K1's), in both placements.
K3Kernel k3_kernel(int nw, int k, int nwb, int place) {
  const int kp = levels_bucket(k);
#define K3_CASE(NW_, KP_, NWB_)                                 \
  if (nw == NW_ && kp == KP_ && nwb == NWB_) {                  \
    if (place == K3_STAGED)                                     \
      return dc_band_kernel<NW_, KP_, NWB_, K3_STAGED>;         \
    return dc_band_kernel<NW_, KP_, NWB_, K3_DIRECT>;           \
  }
  K3_CASE(1, 16, 1) K3_CASE(1, 32, 1)
  K3_CASE(2, 16, 1) K3_CASE(2, 16, 2) K3_CASE(2, 32, 2) K3_CASE(2, 64, 2)
  K3_CASE(3, 16, 1) K3_CASE(3, 16, 2) K3_CASE(3, 32, 2) K3_CASE(3, 32, 3)
  K3_CASE(3, 64, 3)
  K3_CASE(4, 16, 1) K3_CASE(4, 16, 2) K3_CASE(4, 32, 2) K3_CASE(4, 32, 3)
  K3_CASE(4, 64, 3) K3_CASE(4, 64, 4)
  K3_CASE(3, 128, 3) K3_CASE(4, 128, 4)
#undef K3_CASE
  return nullptr;
}

// The block dc_band_geometry derives, and nothing else: G threads per
// lane, whole warps, a chunk that is a power of two, the shared bytes of
// k3_layout within the card's limit.
bool k3_geometry_ok(int W, int nw, int k, int nwb, int ncb, int lanes,
                    int threads, int place, int chunk, int smem) {
  const int kp = levels_bucket(k);
  const int G = kp < WORD ? kp : WORD;
  return kp > 0 && W >= 1 && W <= nw * WORD && nwb >= 1 && nwb <= nw &&
         ncb >= 1 && ncb <= W + 1 && lanes >= 1 && threads == lanes * G &&
         threads % WORD == 0 && threads <= 1024 &&
         (place == K3_STAGED || place == K3_DIRECT) && chunk >= 1 &&
         chunk <= 64 && (chunk & (chunk - 1)) == 0 &&
         smem <= MAX_SHARED_BYTES &&
         smem == k3_layout(W, kp, nwb, lanes, chunk, place).smem_bytes;
}

}  // namespace

extern "C" {

int genasm_dc_band_launch(const void* pm, const void* text, void* band,
                          void* dist, void* levels, int B, int W, int nw,
                          int k, int nwb, int ncb, int early_term, int lanes,
                          int threads, int place, int chunk, int smem,
                          void* stream) {
  const K3Kernel kernel = k3_kernel(nw, k, nwb, place);
  if (kernel == nullptr || B < 1 ||
      !k3_geometry_ok(W, nw, k, nwb, ncb, lanes, threads, place, chunk, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const K3Layout lay =
      k3_layout(W, levels_bucket(k), nwb, lanes, chunk, place);
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + lanes - 1) / lanes, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<uint32_t*>(band), static_cast<int32_t*>(dist),
      static_cast<int32_t*>(levels), B, W, k, ncb, early_term,
      lay.text_stride, lay.lane_stride, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K3's instantiation for (nw, k, nwb, place) that one SM holds at
// once with `threads` threads and `smem` dynamic shared bytes a block, and
// its dynamic shared-memory limit as the card reports it once `smem` is
// allowed.
int genasm_dc_band_occupancy(int nw, int k, int nwb, int place, int threads,
                             int smem, int* blocks, int* smem_limit) {
  return static_cast<int>(occupancy(k3_kernel(nw, k, nwb, place), threads,
                                    smem, blocks, smem_limit));
}

}  // extern "C"
