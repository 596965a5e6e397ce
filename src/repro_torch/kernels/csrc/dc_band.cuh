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
// At NW = 5..8 (W = 129..256) only the placement K3_PLACEMENT names is
// built (direct at KP = 16, staged above), and at KP = 256 (G = 32 threads
// of L = 8 levels) the ring takes one step a slot and 8 lanes a block
// (dc_band_geometry).
//
// Included by two translation units, compiled in parallel: dc_band.cu
// (NW = 1..4, W <= 128, and the C entry points) and dc_band_wide.cu
// (NW = 5..8, W = 129..256), each instantiating its part of the template;
// the entry points reach the wide part through k3_kernel_wide.

#pragma once

#include "genasm_common.cuh"

namespace {

constexpr int K3_STAGED = 0, K3_DIRECT = 1;

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

}  // namespace

using K3Kernel = void (*)(const uint32_t*, const int32_t*, uint32_t*,
                          int32_t*, int32_t*, int, int, int, int, int, int,
                          int, int);

// K3's instantiation at NW = 5..8 for (nw, kp, nwb, place), or null
// (dc_band_wide.cu).
K3Kernel k3_kernel_wide(int nw, int kp, int nwb, int place);
