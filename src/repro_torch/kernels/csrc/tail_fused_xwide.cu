// K2 and K4 at NW >= 9 (W >= 257): the fused GenASM-DC+TB kernel of the
// ragged rectangular tail in the wide family (genasm_xwide.cuh), for
// Hopper (sm_90a).  Replaces, at these widths, the Pallas TPU kernels
// _kernel_tail_banded (K2, `banded`: nwb < nw words around the lane's
// diagonal) and _kernel_tail_fused (K4: the full vector, nwb = nw) of
// repro/kernels/genasm_dc.py; their plain PyTorch versions are
// tail_banded_plain and tail_full_plain in repro_torch/kernels/
// genasm_dc.py, and the outputs must be equal bit for bit.  NW, k and NWB
// are runtime arguments.
//
// A persistent block walks its lane groups; for each: the lanes' masks and
// lengths to shared memory, the fill (XwFill) over each lane's columns
// 1..min(n_len, n_text), the block's steps set by its longest lane, each
// column's windows (base clamp(j + diag - (k+1), 0, band_hi), diag = m_len
// - 1 - n_len; 0 for K4) written to the block's store in device memory
// ((k+1) x n_text x nwb words a lane, lanes innermost), dist at bit
// m_len - 1, then one thread a lane walks the store (tb_walk over XwTail).
// At W = 512, k = 480 a K4 lane's store is 74.9 MB: the grid holds as
// many blocks as fit the share of free memory the wrapper gives it.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry the Python side did not derive); they never
// synchronise and allocate nothing.

#include "genasm_xwide.cuh"

namespace {

__global__ void tail_fused_xwide_kernel(
    const uint32_t* __restrict__ pm_g, const int32_t* __restrict__ text_g,
    const int32_t* __restrict__ m_len_g, const int32_t* __restrict__ n_len_g,
    int32_t* __restrict__ ops, int32_t* __restrict__ meta, uint32_t* scratch,
    int B, int n_text, int nw, int k, int nwb, int banded, int early_term,
    int commit_limit, int max_ops, int max_steps, int lanes, int WT, int DG,
    int ring_at, long long block_words, long long store_words) {
  extern __shared__ uint32_t smem[];
  const XwShared sh(smem, nw, lanes);
  uint32_t* store = xw_scratch(scratch, block_words);
  uint32_t* ring = xw_ring(sh, store, store_words, lanes, ring_at);
  const XwRole r = xw_role(lanes, WT);
  const XwMasks masks{sh.pm, nw, lanes};
  const int band_hi = nw * WORD - WORD * nwb;
  const int groups = (B + lanes - 1) / lanes;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int lane0 = grp * lanes;
    xw_load_masks(pm_g, sh.pm, nw, lanes, lane0, B);
    xw_clear_ops(ops, max_ops, lanes, lane0, B);
    for (int x = threadIdx.x; x < lanes; x += blockDim.x) {
      const bool live = lane0 + x < B;
      sh.m_len[x] = live ? m_len_g[lane0 + x] : 0;
      sh.n_len[x] = live ? n_len_g[lane0 + x] : 0;
      sh.last[x] = live ? min(sh.n_len[x], n_text) : 0;
      sh.dist[x] = k + 1;
    }
    __syncthreads();
    const int max_last = xw_max_last(sh.last, lanes);
    const XwFill<XwGridText> f{ring, masks, XwGridText{text_g}, sh.last, nw,
                               k, lanes, n_text, B, lane0, r.ll, r.wt, WT,
                               r.dg, DG};
    const int m_len = sh.m_len[r.ll], diag = m_len - 1 - sh.n_len[r.ll];
    auto put = [&](int d, int j, int b, uint32_t v) {
      store[((static_cast<long long>(d) * n_text + (j - 1)) * nwb + b) *
                lanes + r.ll] = v;
    };
    auto base_of = [&](int j) {
      return clampi(j + diag - (k + 1), 0, band_hi);
    };
    const int steps = max_last + k;
    for (int s = 0; s <= steps; ++s) {
      if (s < steps) f.step(s, max_last);
      if (s >= 1) f.store(s - 1, max_last, nwb, 1, base_of, put);
      __syncthreads();
    }
    f.dist(clampi(m_len - 1, 0, nw * WORD - 1), m_len >= 1, sh.dist);
    __syncthreads();
    const int w = threadIdx.x, lane = lane0 + w;
    if (w < lanes && lane < B) {
      const int dist = sh.dist[w], wm = sh.m_len[w], wn = sh.n_len[w];
      const XwTail st{store + w, k, n_text, wm - 1 - wn, band_hi, nwb, lanes,
                      banded != 0};
      tb_walk(st, XwLaneMasks{masks, w},
              Rows<const int32_t>{text_g + lane, B}, n_text, k, dist,
              level_count(dist, k, early_term), wm - 1, wn, commit_limit,
              max_ops, max_steps, Rows<int32_t>{ops + lane, B},
              Rows<int32_t>{meta + lane, B});
    }
    __syncthreads();
  }
}

}  // namespace

namespace {

int tail_xwide_launch(int banded, const void* pm, const void* text,
                      const void* m_len, const void* n_len, void* ops,
                      void* meta, void* scratch, int B, int n_text, int W,
                      int nw, int k, int nwb, int early_term,
                      int commit_limit, int max_ops, int max_steps,
                      int lanes, int wt, int dg, int threads, int ring_at,
                      int smem, long long ring_words, long long store_words,
                      int blocks, void* stream) {
  const long long block_words =
      store_words * lanes + (ring_at == XW_RING_GLOBAL ? ring_words : 0);
  if (B < 1 || n_text < 1 || W < 1 || W > nw * WORD || max_ops < 0 ||
      store_words != static_cast<long long>(k + 1) * n_text * nwb ||
      scratch == nullptr ||
      !xw_block_ok(nw, k, nwb, lanes, wt, dg, threads, ring_at, smem,
                   ring_words, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared(tail_fused_xwide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_fused_xwide_kernel<<<blocks, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<const int32_t*>(m_len), static_cast<const int32_t*>(n_len),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
      static_cast<uint32_t*>(scratch), B, n_text, nw, k, nwb, banded,
      early_term, commit_limit, max_ops, max_steps, lanes, wt, dg, ring_at,
      block_words, store_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2 at NW >= 9 on a persistent grid of `blocks` blocks; `scratch` holds
// block_words words a block: its lanes' stores (store_words a lane), then
// the ring where ring_at is XW_RING_GLOBAL.
int genasm_tail_banded_xwide_launch(
    const void* pm, const void* text, const void* m_len, const void* n_len,
    void* ops, void* meta, void* scratch, int B, int n_text, int W, int nw,
    int k, int nwb, int early_term, int commit_limit, int max_ops,
    int max_steps, int lanes, int wt, int dg, int threads, int ring_at,
    int smem, long long ring_words, long long store_words, int blocks,
    void* stream) {
  return tail_xwide_launch(1, pm, text, m_len, n_len, ops, meta, scratch, B,
                           n_text, W, nw, k, nwb, early_term, commit_limit,
                           max_ops, max_steps, lanes, wt, dg, threads,
                           ring_at, smem, ring_words, store_words, blocks,
                           stream);
}

// K4 at NW >= 9: nwb must be nw (the full vector).
int genasm_tail_full_xwide_launch(
    const void* pm, const void* text, const void* m_len, const void* n_len,
    void* ops, void* meta, void* scratch, int B, int n_text, int W, int nw,
    int k, int nwb, int early_term, int commit_limit, int max_ops,
    int max_steps, int lanes, int wt, int dg, int threads, int ring_at,
    int smem, long long ring_words, long long store_words, int blocks,
    void* stream) {
  if (nwb != nw) return static_cast<int>(cudaErrorInvalidValue);
  return tail_xwide_launch(0, pm, text, m_len, n_len, ops, meta, scratch, B,
                           n_text, W, nw, k, nwb, early_term, commit_limit,
                           max_ops, max_steps, lanes, wt, dg, threads,
                           ring_at, smem, ring_words, store_words, blocks,
                           stream);
}

// genasm_tb_fused_xwide_occupancy for the tails' wide kernel.
int genasm_tail_xwide_occupancy(int threads, int smem, int* blocks,
                                int* smem_limit) {
  return static_cast<int>(occupancy(tail_fused_xwide_kernel, threads, smem,
                                    blocks, smem_limit));
}

}  // extern "C"
