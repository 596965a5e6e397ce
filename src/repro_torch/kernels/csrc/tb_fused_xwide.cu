// K1 at NW >= 9 (W >= 257): the fused GenASM-DC+TB kernel of the square
// W x W window in the wide family (genasm_xwide.cuh), for Hopper (sm_90a).
// Replaces, at these widths, the Pallas TPU kernel _kernel_fused of
// repro/kernels/genasm_dc.py; its plain PyTorch version is tb_fused_plain
// in repro_torch/kernels/genasm_dc.py, and the outputs must be equal bit
// for bit.  NW, k and NWB are runtime arguments.
//
// A persistent block walks its lane groups; for each: the lanes' pattern
// masks to shared memory, the fill (XwFill, one barrier a step) with the
// band windows of columns col0..W written to the block's band in device
// memory ((k+1) x ncb x nwb words a lane, lanes innermost), dist by
// atomicMin over the lane's threads, then one thread a lane walks the band
// (tb_walk over XwBand), ops straight to device memory over the OP_NONE
// the block wrote first.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry the Python side did not derive); they never
// synchronise and allocate nothing.

#include "genasm_xwide.cuh"

namespace {

__global__ void tb_fused_xwide_kernel(
    const uint32_t* __restrict__ pm_g, const int32_t* __restrict__ text_g,
    int32_t* __restrict__ ops, int32_t* __restrict__ meta, uint32_t* scratch,
    int B, int W, int nw, int k, int nwb, int ncb, int early_term,
    int commit_limit, int max_ops, int max_steps, int lanes, int WT, int DG,
    int ring_at, long long block_words, long long band_words) {
  extern __shared__ uint32_t smem[];
  const XwShared sh(smem, nw, lanes);
  uint32_t* band = xw_scratch(scratch, block_words);
  uint32_t* ring = xw_ring(sh, band, band_words, lanes, ring_at);
  const XwRole r = xw_role(lanes, WT);
  const XwMasks masks{sh.pm, nw, lanes};
  const int col0 = W + 1 - ncb, band_hi = nw * WORD - WORD * nwb;
  const int groups = (B + lanes - 1) / lanes;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int lane0 = grp * lanes;
    xw_load_masks(pm_g, sh.pm, nw, lanes, lane0, B);
    xw_clear_ops(ops, max_ops, lanes, lane0, B);
    for (int x = threadIdx.x; x < lanes; x += blockDim.x) {
      sh.dist[x] = k + 1;
      sh.last[x] = lane0 + x < B ? W : 0;
    }
    __syncthreads();
    const XwFill f{ring, masks, text_g, sh.last, nw, k, lanes, W, B, lane0,
                   r.ll, r.wt, WT, r.dg, DG};
    auto put = [&](int d, int j, int b, uint32_t v) {
      band[((static_cast<long long>(d) * ncb + (j - col0)) * nwb + b) *
               lanes + r.ll] = v;
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
    const int w = threadIdx.x, lane = lane0 + w;
    if (w < lanes && lane < B) {
      const int dist = sh.dist[w];
      const XwBand st{band + w, k, ncb, col0, band_hi, nwb, lanes};
      tb_walk(st, XwLaneMasks{masks, w}, Rows<const int32_t>{text_g + lane, B},
              W, k, dist, level_count(dist, k, early_term), W - 1, W,
              commit_limit, max_ops, max_steps, Rows<int32_t>{ops + lane, B},
              Rows<int32_t>{meta + lane, B});
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// K1 at NW >= 9 on a persistent grid of `blocks` blocks; `scratch` holds
// block_words words a block: its lanes' bands (band_words a lane), then
// the ring where ring_at is XW_RING_GLOBAL.
int genasm_tb_fused_xwide_launch(const void* pm, const void* text, void* ops,
                                 void* meta, void* scratch, int B, int W,
                                 int nw, int k, int nwb, int ncb,
                                 int early_term, int commit_limit,
                                 int max_ops, int max_steps, int lanes,
                                 int wt, int dg, int threads, int ring_at,
                                 int smem, long long ring_words,
                                 long long band_words, int blocks,
                                 void* stream) {
  const long long block_words =
      band_words * lanes + (ring_at == XW_RING_GLOBAL ? ring_words : 0);
  if (B < 1 || W < 1 || W > nw * WORD || ncb < 1 || ncb > W + 1 ||
      max_ops < 0 || band_words != static_cast<long long>(k + 1) * ncb * nwb
      || scratch == nullptr ||
      !xw_block_ok(nw, k, nwb, lanes, wt, dg, threads, ring_at, smem,
                   ring_words, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared(tb_fused_xwide_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tb_fused_xwide_kernel<<<blocks, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
      static_cast<uint32_t*>(scratch), B, W, nw, k, nwb, ncb, early_term,
      commit_limit, max_ops, max_steps, lanes, wt, dg, ring_at, block_words,
      band_words);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K1's wide kernel one SM holds at once with `threads` threads
// and `smem` dynamic shared bytes, and its shared-memory limit on this
// device once `smem` is allowed.
int genasm_tb_fused_xwide_occupancy(int threads, int smem, int* blocks,
                                    int* smem_limit) {
  return static_cast<int>(occupancy(tb_fused_xwide_kernel, threads, smem,
                                    blocks, smem_limit));
}

}  // extern "C"
