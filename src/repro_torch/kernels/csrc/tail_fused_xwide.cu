// K2 and K4 in the wide family (from NW = 5, W = 129, where
// genasm_dc.kernel_family names it): the fused GenASM-DC+TB kernel of the
// ragged rectangular tail, for Hopper (sm_90a).
// Replaces, at these widths, the Pallas TPU kernels _kernel_tail_banded
// (K2, `banded`: nwb < nw words around the lane's diagonal) and
// _kernel_tail_fused (K4: the full vector, nwb = nw) of
// repro/kernels/genasm_dc.py; their plain PyTorch versions are
// tail_banded_plain and tail_full_plain in repro_torch/kernels/
// genasm_dc.py, and the outputs must be equal bit for bit.  NW, k and NWB
// are runtime arguments.
//
// One warp a lane (genasm_xwide_reg.cuh): the register fill (xr_fill) over
// the lane's columns 1..min(n_len, n_text), each column's window (base
// clamp(j + diag - (k+1), 0, band_hi), diag = m_len - 1 - n_len; 0 for K4)
// written raw to the lane's store in its block's scratch ((k+1) x n_text
// rows of nwbs words), dist at bit m_len - 1, then one thread of the warp
// walks the store (tb_walk over XrTail).  A lane with m_len = 0 has no dist
// and no fill.  At W = 512, k = 480 a K4 lane's store is 74.9 MB: the grid
// holds as many blocks as fit the share of free memory the wrapper gives
// it.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry the Python side did not derive); they never
// synchronise and allocate nothing.

#include "genasm_xwide_reg.cuh"

namespace {

__global__ void __launch_bounds__(XR_BLOCK_THREADS, XR_TAIL_BLOCKS)
tail_fused_xwide_kernel(
    const uint32_t* __restrict__ pm_g, const int32_t* __restrict__ text_g,
    const int32_t* __restrict__ m_len_g, const int32_t* __restrict__ n_len_g,
    int32_t* __restrict__ ops, int32_t* __restrict__ meta, uint32_t* scratch,
    int B, int n_text, int nw, int k, int nwb, int banded, int early_term,
    int commit_limit, int max_ops, int max_steps, int lanes, XrLayout x) {
  extern __shared__ uint32_t smem[];
  uint32_t* masks_s = xr_warp_masks(smem, x);
  uint16_t* text_s = xr_warp_text(masks_s);
  const int band_hi = nw * WORD - WORD * nwb;
  const int groups = (B + lanes - 1) / lanes;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int lane = grp * lanes + (threadIdx.x >> 5);
    if (lane >= B) continue;
    xr_clear_ops(ops, max_ops, B, lane);
    int dist = k + 1;
    {
      const int m_len = m_len_g[lane], n_len = n_len_g[lane];
      uint32_t* store = xr_lane_scratch(scratch, x, lanes);
      const XrStoreMap sm{store, n_text, 1, m_len - 1 - n_len - (k + 1),
                          band_hi, x.nwbs, nw <= 8 ? 7 : -1};
      if (m_len >= 1)
        dist = xr_fill(x, sm, store + x.store_words,
                       store + x.store_words + x.below_words, masks_s, text_s,
                       XrGridText{text_g, B, lane},
                       XrGridMasks{pm_g, nw, B, lane}, nw, k,
                       min(n_len, n_text), n_text,
                       clampi(m_len - 1, 0, nw * WORD - 1));
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      // the lane's lengths read again: nothing of the walk stays live
      // through the fill
      const int m_len = m_len_g[lane], n_len = n_len_g[lane];
      const XrTail st{xr_lane_scratch(scratch, x, lanes), k, n_text,
                      m_len - 1 - n_len, band_hi, nwb, x.nwbs, banded != 0};
      tb_walk(st, XrGridMasks{pm_g, nw, B, lane},
              Rows<const int32_t>{text_g + lane, B}, n_text, k, dist,
              level_count(dist, k, early_term), m_len - 1, n_len,
              commit_limit, max_ops, max_steps, Rows<int32_t>{ops + lane, B},
              Rows<int32_t>{meta + lane, B});
    }
    __syncwarp();
  }
}

int tail_xwide_launch(int banded, const void* pm, const void* text,
                      const void* m_len, const void* n_len, void* ops,
                      void* meta, void* scratch, int B, int n_text, int W,
                      int nw, int k, int nwb, int early_term,
                      int commit_limit, int max_ops, int max_steps,
                      int lanes, int threads, int smem, long long store_words,
                      long long lane_words, int blocks, void* stream) {
  if (B < 1 || n_text < 1 || W < 1 || W > nw * WORD || max_ops < 0 ||
      scratch == nullptr || nwb < 1 || nwb > nw || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const XrLayout x = xr_layout(nw, k, nwb, n_text, 1, n_text, lanes);
  if (!xr_block_ok(x, nw, k, nwb, lanes, threads, smem, store_words,
                   lane_words, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared(tail_fused_xwide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tail_fused_xwide_kernel<<<blocks, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<const int32_t*>(m_len), static_cast<const int32_t*>(n_len),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
      static_cast<uint32_t*>(scratch), B, n_text, nw, k, nwb, banded,
      early_term, commit_limit, max_ops, max_steps, lanes, x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The wide K2 on a persistent grid of `blocks` blocks of `lanes` warps;
// `scratch` holds lane_words words a lane (xr_layout: its store of
// store_words words first) for every lane of the grid's blocks.
int genasm_tail_banded_xwide_launch(
    const void* pm, const void* text, const void* m_len, const void* n_len,
    void* ops, void* meta, void* scratch, int B, int n_text, int W, int nw,
    int k, int nwb, int early_term, int commit_limit, int max_ops,
    int max_steps, int lanes, int threads, int smem, long long store_words,
    long long lane_words, int blocks, void* stream) {
  return tail_xwide_launch(1, pm, text, m_len, n_len, ops, meta, scratch, B,
                           n_text, W, nw, k, nwb, early_term, commit_limit,
                           max_ops, max_steps, lanes, threads, smem,
                           store_words, lane_words, blocks, stream);
}

// The wide K4: nwb must be nw (the full vector).
int genasm_tail_full_xwide_launch(
    const void* pm, const void* text, const void* m_len, const void* n_len,
    void* ops, void* meta, void* scratch, int B, int n_text, int W, int nw,
    int k, int nwb, int early_term, int commit_limit, int max_ops,
    int max_steps, int lanes, int threads, int smem, long long store_words,
    long long lane_words, int blocks, void* stream) {
  if (nwb != nw) return static_cast<int>(cudaErrorInvalidValue);
  return tail_xwide_launch(0, pm, text, m_len, n_len, ops, meta, scratch, B,
                           n_text, W, nw, k, nwb, early_term, commit_limit,
                           max_ops, max_steps, lanes, threads, smem,
                           store_words, lane_words, blocks, stream);
}

// genasm_tb_fused_xwide_occupancy for the tails' wide kernel.
int genasm_tail_xwide_occupancy(int threads, int smem, int* blocks,
                                int* smem_limit) {
  return static_cast<int>(occupancy(tail_fused_xwide_kernel, threads, smem,
                                    blocks, smem_limit));
}

}  // extern "C"
