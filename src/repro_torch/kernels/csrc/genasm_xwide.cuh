// The wide family of the GenASM kernels, for windows of NW >= 9 words a
// bitvector (W >= 257), for Hopper (sm_90a): K1 (tb_fused_xwide.cu), K2 /
// K4 (tail_fused_xwide.cu) and K3 (dc_band_xwide.cu).  NW, k and the band
// words NWB are runtime arguments: one kernel each serves every width, and
// no width has a ceiling in the code.
//
// This header holds what the three share (the pattern masks' layout, the
// grid text) and K3's fill, XwFill, a shared ring.  K1 and K2 / K4 run the
// register fill of genasm_xwide_reg.cuh: one warp a lane, its levels and
// words in registers over word and level threads, levels in strips.  K3
// is queued to move onto it (ROADMAP).
//
// XwFill.  Level d of column j is computed at step s = j + d - 1 (a
// wavefront skewed by one step a level, not a thread), so its three inputs,
// R_{j-1}[d] (step s-1), R_j[d-1] (step s-1) and R_{j-1}[d-1] (step s-2),
// all come from earlier steps, and so do the carries of their shifts: the
// top bit of word w-1 of each.  Every cell (lane, level, word) of a step
// is independent of the others, and one __syncthreads a step orders the
// steps.  The state is a ring of three steps, slot s % 3 holding the
// column each level computed at step s: 3 x (k+1) x NW words a lane,
// lane-innermost ((slot, d, w, lane)), so the threads of a warp (lanes
// fastest, then words) touch neighbouring words.  Column 0 and the level
// below 0 are analytic (R_0[d] = ones below bit d; ones).  A lane's
// columns past its own last are not computed; the block runs as many steps
// as its longest lane needs, last + k, plus one: the window words a store
// keeps of the column computed at step s are written at step s+1, from the
// ring slot that step leaves alone.  Six shared loads a cell and one
// barrier a step: K1 on this fill ran 27x-77x its bound at W = 512
// (PERF.md section 6).
//
// Thread roles: thread x = (dg * WT + wt) * lanes + ll takes lane ll,
// words wt, wt + WT, ... and levels dg, dg + DG, ... of the step's active
// levels; the block is lanes x WT x DG threads (xw_layout).
//
// Persistent grid: a block walks lane groups blockIdx.x, blockIdx.x +
// gridDim.x, ... and reuses its slice of the scratch (the ring where it
// lies in device memory) for each, so the scratch is sized by the blocks
// in flight, not by the batch.

#pragma once

#include "genasm_common.cuh"

namespace {

// ring placement of the wide family, in C's numbering (genasm_dc.py
// XW_RINGS): the block's dynamic shared memory, or its scratch in device
// memory
constexpr int XW_RING_SHARED = 0, XW_RING_GLOBAL = 1;
constexpr int XW_LANE_WORDS = 4;

// Shared layout of a wide block (32-bit words; xwide_geometry in
// kernels/genasm_dc.py computes the same sizes: change both together):
// the pattern masks (4 x nw x lanes), per lane its dist, last column,
// m_len and n_len (XW_LANE_WORDS), then (XW_RING_SHARED) the ring of 3 x
// (k+1) x nw x lanes words.
struct XwLayout {
  long long ring_words;
  long long smem_bytes;
};

XwLayout xw_layout(int nw, int k, int lanes, int ring) {
  XwLayout x;
  x.ring_words = 3LL * (k + 1) * nw * lanes;
  x.smem_bytes = 4LL * (4LL * nw * lanes + XW_LANE_WORDS * lanes +
                        (ring == XW_RING_SHARED ? x.ring_words : 0));
  return x;
}

// The block xwide_geometry derives, and nothing else.
bool xw_block_ok(int nw, int k, int nwb, int lanes, int wt, int dg,
                 int threads, int ring, int smem, long long ring_words,
                 int blocks) {
  const XwLayout x = xw_layout(nw, k, lanes, ring);
  return nw >= 1 && k >= 0 && nwb >= 1 && nwb <= nw && lanes >= 1 &&
         wt >= 1 && wt <= nw && dg >= 1 && threads == lanes * wt * dg &&
         threads <= 1024 && (ring == XW_RING_SHARED || ring == XW_RING_GLOBAL)
         && smem == x.smem_bytes && smem <= MAX_SHARED_BYTES &&
         ring_words == x.ring_words && blocks >= 1;
}

// The pattern masks of a block's lanes in shared memory: word w of text
// char c of lane ll at (c * nw + w) * lanes + ll.  word() and peq() are
// PatternMasks' (any code outside the alphabet selects all ones).
struct XwMasks {
  const uint32_t* s;
  int nw, lanes;

  __device__ __forceinline__ uint32_t word(int c, int w, int ll) const {
    return c >= 0 && c < 4 ? s[(c * nw + w) * lanes + ll] : ONES;
  }
};

// Window word b (from bit base = 32 * w0 + sh) of a column vector whose
// word w is get(w); words past the top read as ones (funnel_word).
template <class Get>
__device__ __forceinline__ uint32_t xw_window_word(const Get& get, int nw,
                                                   int w0, int sh, int b) {
  const uint32_t lo = get(w0 + b);
  if (sh == 0) return lo;
  const uint32_t hi = w0 + b + 1 < nw ? get(w0 + b + 1) : ONES;
  return (lo >> sh) | (hi << (WORD - sh));
}

// The text XwFill reads: code t of lane `lane` (the block's lane ll),
// (n_text, B) int32 in device memory.
struct XwGridText {
  const int32_t* p;
  __device__ __forceinline__ int operator()(int t, int B, int lane,
                                            int) const {
    return p[at(t, B, lane)];
  }
};

// A block's fill state for one lane group.
template <class Text>
struct XwFill {
  uint32_t* ring;        // 3 x (k+1) x nw x lanes, shared or device memory
  XwMasks pm;
  Text text;             // XwGridText or XwWindowText
  const int32_t* last;   // the lanes' last columns (shared)
  int nw, k, lanes, n_text, B, lane0;
  int ll, wt, WT, dg, DG;  // this thread's role

  __device__ __forceinline__ int idx(int slot, int d, int w) const {
    return ((slot * (k + 1) + d) * nw + w) * lanes + ll;
  }

  // word w of R_j[d] of lane ll once its step has run: column 0 analytic,
  // else the ring slot of step j + d - 1
  __device__ __forceinline__ uint32_t word(int d, int j, int w) const {
    return j == 0 ? ones_below_word(d, w) : ring[idx((j + d - 1) % 3, d, w)];
  }

  // this thread's first level of [lo, hi] in its stride DG
  __device__ __forceinline__ int first_level(int lo) const {
    return lo + ((dg - lo) % DG + DG) % DG;
  }

  // Step s: every word of this thread's cells (lane ll, levels d, column
  // j = s - d + 1 within 1..last) from slots (s-1) % 3 and (s-2) % 3 into
  // slot s % 3.  level_steps' recurrence, one word at a time: R_j[d] =
  // (shift1(R_{j-1}[d], t > d) | pm) & shift1(R_{j-1}[d-1], t >= d) &
  // R_{j-1}[d-1] & shift1(R_j[d-1], t >= d-1), t = j - 1, each shift's
  // carry the top bit of the word below (at word 0 the bit given).
  __device__ void step(int s, int max_last) const {
    const int lst = last[ll];
    const int s1 = (s + 2) % 3, s2 = (s + 1) % 3, s0 = s % 3;
    const int lo = max(0, s + 1 - max_last), hi = min(k, s);
    for (int d = first_level(lo); d <= hi; d += DG) {
      const int j = s - d + 1;
      if (j < 1 || j > lst) continue;
      const int t = j - 1;
      const int c = text(clampi(t, 0, n_text - 1), B, lane0 + ll, ll);
      for (int w = wt; w < nw; w += WT) {
        uint32_t p, pl, bo, bol, bn, bnl;
        if (j == 1) {
          p = ones_below_word(d, w);
          pl = w ? ones_below_word(d, w - 1) : 0u;
        } else {
          p = ring[idx(s1, d, w)];
          pl = w ? ring[idx(s1, d, w - 1)] : 0u;
        }
        if (d == 0) {
          bo = bol = bn = bnl = ONES;
        } else {
          bn = ring[idx(s1, d - 1, w)];
          bnl = w ? ring[idx(s1, d - 1, w - 1)] : 0u;
          if (j == 1) {
            bo = ones_below_word(d - 1, w);
            bol = w ? ones_below_word(d - 1, w - 1) : 0u;
          } else {
            bo = ring[idx(s2, d - 1, w)];
            bol = w ? ring[idx(s2, d - 1, w - 1)] : 0u;
          }
        }
        const uint32_t cm = w ? pl >> (WORD - 1) : (t > d ? 1u : 0u);
        const uint32_t cs = w ? bol >> (WORD - 1) : (t >= d ? 1u : 0u);
        const uint32_t ci = w ? bnl >> (WORD - 1) : (t >= d - 1 ? 1u : 0u);
        const uint32_t M = (p << 1) | cm, S = (bo << 1) | cs,
                       I = (bn << 1) | ci;
        ring[idx(s0, d, w)] = (M | pm.word(c, w, ll)) & S & bo & I;
      }
    }
  }

  // put(d, j, b, word) for window word b (0..nwb-1) of every level d of
  // this thread's whose column computed at step s is j (1..last, j >=
  // jlo): the window from bit base_of(j) of R_j[d].
  template <class Base, class Put>
  __device__ void store(int s, int max_last, int nwb, int jlo,
                        const Base& base_of, const Put& put) const {
    const int lst = last[ll];
    const int lo = max(0, s + 1 - max_last), hi = min(k, s);
    for (int d = first_level(lo); d <= hi; d += DG) {
      const int j = s - d + 1;
      if (j < max(jlo, 1) || j > lst) continue;
      const int base = base_of(j);
      const int w0 = base >> 5, sh = base & 31;
      const int slot = s % 3;
      for (int b = wt; b < nwb; b += WT)
        put(d, j, b, xw_window_word(
            [&](int w) { return ring[idx(slot, d, w)]; }, nw, w0, sh, b));
    }
  }

  // the analytic column 0's windows (base 0), levels of this thread
  template <class Put>
  __device__ void store_column0(int nwb, const Put& put) const {
    if (last[ll] < 1) return;
    for (int d = dg; d <= k; d += DG)
      for (int b = wt; b < nwb; b += WT)
        put(d, 0, b, ones_below_word(d, b));
  }

  // The lowest level of lane ll whose bit tgt of its last column is 0
  // (where guard), else k+1, into dist_s[ll] by atomicMin over the
  // threads of the lane (dist_s[ll] = k+1 on entry).
  __device__ void dist(int tgt, bool guard, int* dist_s) const {
    if (!guard || wt != 0) return;
    const int lst = last[ll];
    for (int d = dg; d <= k; d += DG)
      if (((word(d, lst, tgt >> 5) >> (tgt & 31)) & 1u) == 0)
        atomicMin(dist_s + ll, d);
  }
};

// The block's lane group `grp`: the pattern masks into shared memory, the
// lanes' dist slots at k+1; lanes past B get last column 0 (no cell).
__device__ void xw_load_masks(const uint32_t* __restrict__ pm_g,
                              uint32_t* pm_s, int nw, int lanes, int lane0,
                              int B) {
  for (int x = threadIdx.x; x < 4 * nw * lanes; x += blockDim.x) {
    const int ll = x % lanes, row = x / lanes;
    pm_s[x] = lane0 + ll < B ? pm_g[at(row, B, lane0 + ll)] : ONES;
  }
}

// The block's role split: thread x = (dg * WT + wt) * lanes + ll.
struct XwRole {
  int ll, wt, dg;
};

__device__ __forceinline__ XwRole xw_role(int lanes, int WT) {
  const int x = threadIdx.x;
  return XwRole{x % lanes, (x / lanes) % WT, x / lanes / WT};
}

// A wide block's shared memory, carved as xw_layout lays it out.
struct XwShared {
  uint32_t* pm;
  int *dist, *last, *m_len, *n_len;
  uint32_t* ring;         // XW_RING_SHARED: the ring, else unused

  __device__ explicit XwShared(uint32_t* smem, int nw, int lanes)
      : pm(smem),
        dist(reinterpret_cast<int*>(smem + 4 * nw * lanes)),
        last(dist + lanes), m_len(last + lanes), n_len(m_len + lanes),
        ring(reinterpret_cast<uint32_t*>(n_len + lanes)) {}
};

// The block's slice of the scratch (block_words words a block): the
// store of its lanes (store_words a lane) and then, XW_RING_GLOBAL, the
// ring; `ring` is the ring wherever it lies.
__device__ __forceinline__ uint32_t* xw_scratch(uint32_t* scratch,
                                                long long block_words) {
  return scratch + static_cast<long long>(blockIdx.x) * block_words;
}

__device__ __forceinline__ uint32_t* xw_ring(const XwShared& sh,
                                             uint32_t* block,
                                             long long store_words,
                                             int lanes, int ring) {
  return ring == XW_RING_SHARED ? sh.ring : block + store_words * lanes;
}

}  // namespace
