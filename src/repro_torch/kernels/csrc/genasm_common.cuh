// Device helpers shared by the GenASM kernels for Hopper (sm_90a):
// tb_fused.cuh (K1), tail_fused.cuh (K2, K4) and dc_band.cuh (K3), among
// them the wavefront fill all four run (wavefront_fill).
//
// Layout: every global array is lane-innermost, element (r, lane) at
// r * B + lane, so the threads of a warp touch neighbouring addresses.
// Bitvector words are uint32_t (the wrapper hands int32 tensors over; the
// bits are the same).  pm is (5, NW, B) (rows 0..3 are the 0-active pattern
// masks), text (n, B), m_len / n_len (1, B); ops (max_ops, B) front-first
// padded with OP_NONE; meta (8, B) rows DIST/LVL/NOPS/RD/RF/DFIN/OK/0.
//
// Each translation unit gets its own copy of these helpers (anonymous
// namespace); the library links the units' C entry points.

#pragma once

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
constexpr int SENTINEL_PAT = 255;   // pattern padding: matches no base
constexpr int META_DIST = 0, META_LVL = 1, META_NOPS = 2, META_RD = 3,
              META_RF = 4, META_DFIN = 5, META_OK = 6, META_ZERO = 7;
constexpr int MAX_SHARED_BYTES = 232448;   // per block on an H100
// where a fused kernel keeps a lane's store: the block's dynamic shared
// memory, or device memory the wrapper allocates (K1's band, the tails'
// store; kernels/genasm_dc.py PLACEMENTS)
constexpr int PLACE_SHARED = 0, PLACE_GLOBAL = 1;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ size_t at(long long row, int B, int lane) {
  return static_cast<size_t>(row) * B + lane;
}

// One lane's rows of a row-major array: row r at p[r * stride] (global
// arrays pass p = base + lane and stride B; shared staging its own).
template <class T>
struct Rows {
  T* p;
  int stride;
  __device__ __forceinline__ T& operator[](int r) const {
    return p[static_cast<size_t>(r) * stride];
  }
};

// A lane's window slice reversed, as K1's window form reads a reference:
// element r at p[-r] (p: the slice's last byte).
struct RevBytes {
  const uint8_t* p;
  __device__ __forceinline__ int operator[](int r) const { return p[-r]; }
};

}  // namespace

// K1's window form: one main window of the fused loop in K1's own launch
// (the reference's scan body, append_main in repro/core/windowing.py).
// K1 reads each lane's reversed W-base slices of `reads` and `refs` at
// clamp(pos, 0, cols - W), as _slice_rev does, and commits its walk into
// the pass's state in place: a lane is active while more than W bases of
// its read are left and it has not failed; an active lane whose window
// solved (dist <= k) writes min(n_ops, max_ops) ops at `off` into its row
// of `buf` (never into the last column, the reference's drop slot) and
// advances read_pos, ref_pos, off and dist; an active lane that did not
// solve fails; `level` takes the max of the lanes' level counts.  A null
// `reads` is the standalone form (pm, text in; ops, meta out).
struct K1Window {
  const uint8_t* reads;      // (B, read_cols) base codes
  const uint8_t* refs;       // (B, ref_cols)
  const int32_t* read_len;   // (B,)
  int32_t *read_pos, *ref_pos, *off, *dist;   // (B,), in place
  uint8_t* failed;           // (B,) bool, in place
  uint8_t* buf;              // (B, buf_cols) op buffer, in place
  int32_t* level;            // the window's entry of the level counts
  int read_cols, ref_cols, buf_cols;
};
// (outside the anonymous namespace: K1's kernels take it, and the
// translation units hand their instantiations to each other)

namespace {

// The last byte of lane `lane`'s window slice of `seq` (B, cols): its
// start clamped into the row, as the reference's dynamic_slice clamps.
__device__ __forceinline__ const uint8_t* window_end(const uint8_t* seq,
                                                     int cols, int lane,
                                                     int pos, int W) {
  return seq + static_cast<size_t>(lane) * cols +
         min(max(pos, 0), cols - W) + W - 1;
}

// Whether lane `lane`'s window is active: more than W read bases left and
// not failed.
__device__ __forceinline__ bool window_active(const K1Window& win, int lane,
                                              int W) {
  return win.read_len[lane] - win.read_pos[lane] > W && !win.failed[lane];
}

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

// One thread's levels d0 .. d0+L-1 of column j (t = j-1) from column j-1,
// in place: GenASM-DC's SENE recurrence R_j[d] = M & S & D & I for a slice
// of the levels.  below_old and below_new are R_{j-1}[d0-1] and R_j[d0-1]
// (all ones below level 0, which turns the general cell into level 0's
// shift | pm).
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

// Column 0 of a thread's levels d0 .. d0+L-1: R_0[d] = ones below bit d.
template <int NW, int L>
__device__ __forceinline__ void init_levels(uint32_t (&col)[L][NW], int d0) {
#pragma unroll
  for (int c = 0; c < L; ++c)
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) col[c][w_] = ones_below_word(d0 + c, w_);
}

// GenASM-DC's systolic array, the fill K1, K2/K4 and K3 share.  A group
// of G threads holds one lane, thread g its L levels d0 = g*L .. d0+L-1 in
// `col` (column 0 on entry, init_levels; the lane's last column on exit).
// The fill is a wavefront over (column, level): at step s thread g
// computes column j = s - g + 1 of its levels, taking R_j[d0-1] from
// thread g-1 with one __shfl_up_sync of NW words and keeping it one step
// as R_{j-1}[d0-1].  A step has no branch: every thread computes a column
// and keeps it only where j is one of its columns (`on`: 1 <= j <= last
// and a level <= k).  text_l is the lane's text, n_text codes; `steps`
// must be uniform over the block (every thread of it shuffles each step).
// After each step every thread calls step(s, j, on); a store reads `col`.
template <int NW, int L, int G, class Step>
__device__ __forceinline__ void wavefront_fill(const PatternMasks<NW>& pm,
                                               const int32_t* text_l,
                                               int n_text, int last, int steps,
                                               int k, int g,
                                               uint32_t (&col)[L][NW],
                                               Step&& step) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  const int d0 = g * L;
  uint32_t below_old[NW];
#pragma unroll
  for (int w_ = 0; w_ < NW; ++w_) below_old[w_] = ONES;
  for (int s = 0; s < steps; ++s) {
    uint32_t below_new[NW];
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) {
      below_new[w_] = __shfl_up_sync(FULL, col[L - 1][w_], 1, G);
      if (g == 0) below_new[w_] = ONES;
    }
    const int j = s - g + 1;
    const bool on = j >= 1 && j <= last && d0 <= k;   // j is a column of mine
    const int c = text_l[clampi(j - 1, 0, n_text - 1)];
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
    step(s, j, on);
#pragma unroll
    for (int w_ = 0; w_ < NW; ++w_) below_old[w_] = below_new[w_];
  }
}

// The lowest level of the lane whose bit `tgt` of `col` is 0 (where
// `guard`), else k+1, by ballot over the lane's group of G threads (a
// group lies in one warp, G-aligned); every thread of the group gets it.
template <int NW, int L, int G>
__device__ __forceinline__ int group_dist(const uint32_t (&col)[L][NW],
                                          int tgt, bool guard, int k,
                                          int d0) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  const int shift = (threadIdx.x % WORD) / G * G;
  int dist = k + 1;
#pragma unroll
  for (int c = 0; c < L; ++c) {
    uint32_t v = col[c][0];
#pragma unroll
    for (int w_ = 1; w_ < NW; ++w_)
      if ((tgt >> 5) == w_) v = col[c][w_];
    const bool hit = guard && d0 + c <= k && ((v >> (tgt & 31)) & 1u) == 0;
    unsigned hits = __ballot_sync(FULL, hit) >> shift;
    if constexpr (G < WORD) hits &= (1u << G) - 1;
    if (hits) dist = min(dist, (__ffs(hits) - 1) * L + c);
  }
  return dist;
}

// The band windows (NWB words from bit base = clip(j - 2 - k)) of column
// j, the static base of the square window: word b of level c's window.
template <int NW, int L, int NWB>
__device__ __forceinline__ uint32_t band_word(const uint32_t (&col)[L][NW],
                                              int c, int b, int w0, int sh) {
  if constexpr (NWB == NW)         // the window is the whole vector
    return col[c][b];
  else                             // NWB < NW: the band window
    return funnel_word<NW>(col[c], w0 + b, sh);
}

// Text staging of a block: lane lane0 + ll's text (n codes, (n, B) in
// device memory) to text_s[ll * stride ..]; lanes past B read 0.
__device__ __forceinline__ void stage_text(const int32_t* __restrict__ text_g,
                                           int32_t* text_s, int n, int stride,
                                           int lanes, int lane0, int B) {
  for (int x = threadIdx.x; x < n * lanes; x += blockDim.x) {
    const int j = x / lanes, ll = x % lanes;
    text_s[ll * stride + j] = lane0 + ll < B ? text_g[at(j, B, lane0 + ll)] : 0;
  }
}

// What one lane's walk leaves: the meta rows' values.
struct WalkMeta {
  int dist, d_end, nops, rd, rf, d;
  bool ok;
};

// _tb_walk for one lane.  The TPU's whole-tile early exit is a per-thread
// exit here: a done lane's state never changes again.  `ops` must hold
// OP_NONE in rows 0..max_ops-1 already (or the caller reads only the
// first min(nops, max_ops)); the walk writes the ops it emits over them.
// The store reader's tests(d, j, i, z) gives the four bit tests at cursor
// (d, j, i): R_{j-1}[d] at i-1 (match), R_{j-1}[d-1] at i-1
// (substitution) and at i (deletion), R_j[d-1] at i-1 (insertion), each
// with the reference's clamps and analytic edges.  pm.peq(c, ii) is
// P[ii] == c for the lane's pattern masks (PatternMasks in registers,
// XwMasks in shared memory); text[r] the lane's text code r (Rows, or
// RevBytes in K1's window form), ops[r] = op its op rows.
template <class Masks, class Store, class Text, class Ops>
__device__ WalkMeta tb_walk_ops(const Store& st, const Masks& pm, Text text,
                                int n_text, int k, int dist, int d_end,
                                int init_i, int init_j, int commit_limit,
                                int max_ops, int max_steps, Ops ops) {
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
    st.tests(d, j, i, z);
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
  return WalkMeta{dist, d_end, nops, rd, rf, d, ok};
}

// tb_walk_ops, then the meta rows.
template <class Masks, class Store>
__device__ __forceinline__ void tb_walk(const Store& st, const Masks& pm,
                                        Rows<const int32_t> text, int n_text,
                                        int k, int dist, int d_end,
                                        int init_i, int init_j,
                                        int commit_limit, int max_ops,
                                        int max_steps, Rows<int32_t> ops,
                                        Rows<int32_t> meta) {
  const WalkMeta r = tb_walk_ops(st, pm, text, n_text, k, dist, d_end,
                                 init_i, init_j, commit_limit, max_ops,
                                 max_steps, ops);
  meta[META_DIST] = r.dist;
  meta[META_LVL] = r.d_end;
  meta[META_NOPS] = r.nops;
  meta[META_RD] = r.rd;
  meta[META_RF] = r.rf;
  meta[META_DFIN] = r.d;
  meta[META_OK] = r.ok ? 1 : 0;
  meta[META_ZERO] = 0;
}

// K1's window form's commit of one lane's walk `r` (its window active and
// solved) into the pass's state; returns the ops it writes into the
// lane's row of `buf` at its old offset, min(n_ops, max_ops), and none
// into the drop column.
__device__ __forceinline__ int window_advance(const K1Window& win, int lane,
                                              const WalkMeta& r,
                                              int max_ops) {
  const int off = win.off[lane];
  win.read_pos[lane] += r.rd;
  win.ref_pos[lane] += r.rf;
  win.off[lane] = off + r.nops;
  win.dist[lane] += r.dist - r.d;
  return max(0, min(min(r.nops, max_ops), win.buf_cols - 1 - off));
}

// The level count of the reference's whole-tile early termination, per
// lane: only its maximum over the batch is read.
__device__ __forceinline__ int level_count(int dist, int k, int early_term) {
  return early_term ? min(dist, k) + 1 : k + 1;
}

// Live-column capacity: the smallest instantiated KP >= k + 1.
int levels_bucket(int k) {
  return k + 1 <= 16 ? 16 : k + 1 <= 32 ? 32 : k + 1 <= 64 ? 64
       : k + 1 <= 128 ? 128 : k + 1 <= 256 ? 256 : 0;
}

// The smallest count >= words that is 16 mod 32: a lane stride of 16 mod
// 32 words puts the two lanes of a warp at G = 16 in opposite halves of
// the banks.
int half_bank_pad(int words) { return words + ((16 - words % 32) + 32) % 32; }

// Raise the dynamic shared-memory limit of `kernel` on the current device
// to at least `smem`.  The limit only grows, so cudaFuncSetAttribute runs
// once per (instantiation, device) and new maximum, not before every
// launch.
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const std::lock_guard<std::mutex> hold(mu);
  int& set = allowed[{reinterpret_cast<const void*>(kernel), dev}];
  if (smem <= set) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set = smem;
  return err;
}

// Blocks of `kernel` that one SM holds at once with `threads` threads and
// `smem` dynamic shared bytes a block, and the kernel's dynamic
// shared-memory limit on this device as the card reports it once `smem`
// is allowed (cudaFuncGetAttributes).
template <class Kernel>
cudaError_t occupancy(Kernel kernel, int threads, int smem, int* blocks,
                      int* smem_limit) {
  if (kernel == nullptr || smem > MAX_SHARED_BYTES)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_shared(kernel, smem);
  cudaFuncAttributes attr{};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess) {
    *smem_limit = attr.maxDynamicSharedSizeBytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        threads, smem);
  }
  return err;
}

}  // namespace
