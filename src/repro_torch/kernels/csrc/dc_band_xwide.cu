// K3 at NW >= 9 (W >= 257): GenASM-DC of the square W x W window alone in
// the wide family (genasm_xwide.cuh), for Hopper (sm_90a), the DENT band
// its output for a separate traceback (backend 'split').  Replaces, at
// these widths, the Pallas TPU kernel _kernel of repro/kernels/
// genasm_dc.py; its plain PyTorch version is dc_band_plain in
// repro_torch/kernels/genasm_dc.py, and the outputs must be equal bit for
// bit: dist (B), the band (k+1, ncb, nwb, B), the level count (B).  NW, k
// and NWB are runtime arguments.
//
// A persistent block walks its lane groups: the fill (XwFill), each band
// window word written straight to the output, lane-innermost (the block's
// lanes are the threads' fastest index, so a warp writes neighbouring
// lanes of a row), then dist and the level count.  The band is an output
// sized by B, as on the TPU; only the ring, where it fits no block's
// shared memory, is scratch a block.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry the Python side did not derive); they never
// synchronise and allocate nothing.

#include "genasm_xwide.cuh"

namespace {

__global__ void dc_band_xwide_kernel(
    const uint32_t* __restrict__ pm_g, const int32_t* __restrict__ text_g,
    uint32_t* __restrict__ band, int32_t* __restrict__ dist_g,
    int32_t* __restrict__ levels_g, uint32_t* scratch, int B, int W, int nw,
    int k, int nwb, int ncb, int early_term, int lanes, int WT, int DG,
    int ring_at, long long ring_words) {
  extern __shared__ uint32_t smem[];
  const XwShared sh(smem, nw, lanes);
  uint32_t* ring = xw_ring(sh, xw_scratch(scratch, ring_words), 0, lanes,
                           ring_at);
  const XwRole r = xw_role(lanes, WT);
  const int col0 = W + 1 - ncb, band_hi = nw * WORD - WORD * nwb;
  const int groups = (B + lanes - 1) / lanes;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int lane0 = grp * lanes;
    xw_load_masks(pm_g, sh.pm, nw, lanes, lane0, B);
    for (int x = threadIdx.x; x < lanes; x += blockDim.x) {
      sh.dist[x] = k + 1;
      sh.last[x] = lane0 + x < B ? W : 0;
    }
    __syncthreads();
    const XwFill<XwGridText> f{ring, XwMasks{sh.pm, nw, lanes},
                               XwGridText{text_g}, sh.last, nw, k, lanes, W,
                               B, lane0, r.ll, r.wt, WT, r.dg, DG};
    auto put = [&](int d, int j, int b, uint32_t v) {
      band[((static_cast<long long>(d) * ncb + (j - col0)) * nwb + b) * B +
           lane0 + r.ll] = v;
    };
    auto base_of = [&](int j) { return clampi(j - 2 - k, 0, band_hi); };
    if (col0 == 0) f.store_column0(nwb, put);
    const int steps = W + k;
    for (int s = 0; s <= steps; ++s) {
      if (s < steps) f.step(s, W);
      if (s >= 1) f.store(s - 1, W, nwb, col0, base_of, put);
      __syncthreads();
    }
    f.dist(W - 1, true, sh.dist);
    __syncthreads();
    const int x = threadIdx.x;
    if (x < lanes && lane0 + x < B) {
      dist_g[lane0 + x] = sh.dist[x];
      levels_g[lane0 + x] = level_count(sh.dist[x], k, early_term);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// K3 at NW >= 9 on a persistent grid of `blocks` blocks; `scratch` holds
// the ring (ring_words a block) where ring_at is XW_RING_GLOBAL, else
// nothing is read from it.
int genasm_dc_band_xwide_launch(const void* pm, const void* text, void* band,
                                void* dist, void* levels, void* scratch,
                                int B, int W, int nw, int k, int nwb,
                                int ncb, int early_term, int lanes, int wt,
                                int dg, int threads, int ring_at, int smem,
                                long long ring_words, int blocks,
                                void* stream) {
  if (B < 1 || W < 1 || W > nw * WORD || ncb < 1 || ncb > W + 1 ||
      (ring_at == XW_RING_GLOBAL && scratch == nullptr) ||
      !xw_block_ok(nw, k, nwb, lanes, wt, dg, threads, ring_at, smem,
                   ring_words, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared(dc_band_xwide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dc_band_xwide_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<uint32_t*>(band), static_cast<int32_t*>(dist),
      static_cast<int32_t*>(levels), static_cast<uint32_t*>(scratch), B, W,
      nw, k, nwb, ncb, early_term, lanes, wt, dg, ring_at, ring_words);
  return static_cast<int>(cudaGetLastError());
}

// genasm_tb_fused_xwide_occupancy for K3's wide kernel.
int genasm_dc_band_xwide_occupancy(int threads, int smem, int* blocks,
                                   int* smem_limit) {
  return static_cast<int>(occupancy(dc_band_xwide_kernel, threads, smem,
                                    blocks, smem_limit));
}

}  // extern "C"
