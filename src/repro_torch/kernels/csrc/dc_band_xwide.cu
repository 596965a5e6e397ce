// K3 at NW >= 9 (W >= 257): GenASM-DC of the square W x W window alone in
// the wide family, for Hopper (sm_90a), the DENT band its output for a
// separate traceback (backend 'split').  Replaces, at these widths, the
// Pallas TPU kernel _kernel of repro/kernels/genasm_dc.py; its plain
// PyTorch version is dc_band_plain in repro_torch/kernels/genasm_dc.py,
// and the outputs must be equal bit for bit: dist (B), the band (k+1, ncb,
// nwb, B), the level count (B).  NW, k and NWB are runtime arguments.
//
// The register fill of genasm_xwide_reg.cuh (xr_fill<true>): one warp a
// lane, a block of XR_K3_LANES lanes that run every level strip of their W
// columns in lockstep.  The raw words of the windows of columns col0..W
// are staged in the block's shared memory; every `chunk` steps the whole
// block funnels the windows out of them and writes them to the band,
// neighbouring lanes of one row word side by side (64 B at 16 lanes, 16 B
// a thread where B is a multiple of 4; XrK3Out).  Column 0 (col0 = 0) is
// analytic.
// Then dist (the strip's ballot at bit W - 1) and the level count.  Lanes
// past B fill the last lane's window and write nothing.  The scratch a
// lane is the fill's: the level below a strip and the word strips'
// carries and raw top words; the band is an output sized by B, as on the
// TPU.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry the Python side did not derive); they never
// synchronise and allocate nothing.

#include "genasm_xwide_reg.cuh"

namespace {

__global__ void __launch_bounds__(XR_K3_THREADS, XR_K3_BLOCKS)
dc_band_xwide_kernel(
    const uint32_t* __restrict__ pm_g, const int32_t* __restrict__ text_g,
    uint32_t* __restrict__ band, int32_t* __restrict__ dist_g,
    int32_t* __restrict__ levels_g, uint32_t* scratch, int B, int W, int nw,
    int k, int nwb, int ncb, int early_term, int lanes, XrK3Layout y) {
  extern __shared__ uint32_t smem[];
  const XrLayout& x = y.x;
  uint32_t* masks_s = xr_warp_masks(smem, x);
  uint16_t* text_s = xr_warp_text(masks_s);
  const int col0 = W + 1 - ncb, band_hi = nw * WORD - WORD * nwb;
  uint32_t* stage = smem + lanes * (x.warp_bytes / 4);
  XrK3Out out{stage, stage, band, nullptr, nullptr, y.buf_words, y.chunk,
              y.lane_stride, y.row_stride, lanes, B, 0, W, k, nw, nwb, ncb,
              col0, band_hi, x.word_strips, __ffs(lanes) - 1,
              __ffs(x.wt) - 1};
  const XrStoreMap sm{nullptr, ncb, col0, -2 - k, band_hi, nwb, -1};
  const int groups = (B + lanes - 1) / lanes;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    out.lane0 = grp * lanes;
    const int mine = out.lane0 + (threadIdx.x >> 5);
    const int lane = min(mine, B - 1);
    if (col0 == 0) xr_k3_column0(band, k, nwb, ncb, B, out.lane0, lanes);
    uint32_t* lane_scratch = xr_lane_scratch(scratch, x, lanes);
    const int dist = xr_fill<true>(
        x, sm, lane_scratch, lane_scratch + x.below_words, masks_s, text_s,
        XrGridText{text_g, B, lane}, XrGridMasks{pm_g, nw, B, lane}, nw, k, W,
        W, W - 1, &out, lane_scratch + x.below_words + x.carry_words);
    if ((threadIdx.x & 31) == 0 && mine < B) {
      dist_g[mine] = dist;
      levels_g[mine] = level_count(dist, k, early_term);
    }
  }
}

}  // namespace

extern "C" {

// K3 at NW >= 9 on a persistent grid of `blocks` blocks of `lanes` warps,
// flushing the staged band every `chunk` steps; `scratch` holds lane_words
// words a lane (xr_k3_layout) for every lane of the grid's blocks, or is
// not read where that is 0.
int genasm_dc_band_xwide_launch(const void* pm, const void* text, void* band,
                                void* dist, void* levels, void* scratch,
                                int B, int W, int nw, int k, int nwb,
                                int ncb, int early_term, int lanes,
                                int threads, int smem, int chunk,
                                long long lane_words, int blocks,
                                void* stream) {
  if (B < 1 || W < 1 || W > nw * WORD || ncb < 1 || ncb > W + 1 ||
      nwb < 1 || nwb > nw || k < 0 || (lane_words > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const XrK3Layout y = xr_k3_layout(nw, k, nwb, W, ncb, lanes, chunk);
  if (!xr_k3_block_ok(y, nw, k, nwb, lanes, threads, smem, chunk,
                      lane_words, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared(dc_band_xwide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dc_band_xwide_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<uint32_t*>(band), static_cast<int32_t*>(dist),
      static_cast<int32_t*>(levels), static_cast<uint32_t*>(scratch), B, W,
      nw, k, nwb, ncb, early_term, lanes, y);
  return static_cast<int>(cudaGetLastError());
}

// genasm_tb_fused_xwide_occupancy for K3's wide kernel.
int genasm_dc_band_xwide_occupancy(int threads, int smem, int* blocks,
                                   int* smem_limit) {
  return static_cast<int>(occupancy(dc_band_xwide_kernel, threads, smem,
                                    blocks, smem_limit));
}

}  // extern "C"
