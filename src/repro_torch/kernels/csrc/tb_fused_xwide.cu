// K1 in the wide family (from NW = 5, W = 129, where
// genasm_dc.kernel_family names it): the fused GenASM-DC+TB kernel of the
// square W x W window, for Hopper (sm_90a).  Replaces, at these widths,
// the Pallas TPU kernel _kernel_fused of repro/kernels/genasm_dc.py; its
// plain PyTorch version is tb_fused_plain in repro_torch/kernels/
// genasm_dc.py, and the outputs must be equal bit for bit.  NW, k and NWB
// are runtime arguments.
//
// One warp a lane (genasm_xwide_reg.cuh): the lane's masks and text staged
// in the warp's shared memory, the register fill (xr_fill) with the band
// windows of columns col0..W written raw to the lane's band in its block's
// scratch ((k+1) x ncb rows of nwbs words), dist by ballot, then one thread
// of the warp walks the band (tb_walk over XrBand), ops straight to device
// memory over the OP_NONE the warp wrote first.
//
// K1's window form (K1Window, one main window of the fused loop in this
// launch): the masks from the lane's read slice (XrReadMasks), the text
// from the refs at its clamped start (XrRefText in the fill, RevBytes in
// the walk), one atomicMax a lane for the window's level count, and only a
// lane whose window is active and solved walks, its ops straight into its
// row of the op buffer at its offset (no further than the drop column),
// its state advanced.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry the Python side did not derive); they never
// synchronise and allocate nothing.

#include "genasm_xwide_reg.cuh"

namespace {

// K1's two forms, one body: the standalone form (pm, text in; ops, meta
// out) and the window form (K1Window).  Two kernels, not one with a
// branch: the window form's pointers and state would otherwise stay live
// through the standalone fill and cost it registers.
template <bool WINDOW>
__device__ __forceinline__ void tb_fused_xwide_body(
    const uint32_t* __restrict__ pm_g, const int32_t* __restrict__ text_g,
    int32_t* __restrict__ ops, int32_t* __restrict__ meta, uint32_t* scratch,
    int B, int W, int nw, int k, int nwb, int ncb, int early_term,
    int commit_limit, int max_ops, int max_steps, int lanes,
    const XrLayout& x, const K1Window& win) {
  extern __shared__ uint32_t smem[];
  uint32_t* masks_s = xr_warp_masks(smem, x);
  uint16_t* text_s = xr_warp_text(masks_s);
  const int col0 = W + 1 - ncb, band_hi = nw * WORD - WORD * nwb;
  const int groups = (B + lanes - 1) / lanes;
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int lane = grp * lanes + (threadIdx.x >> 5);
    if (lane >= B) continue;
    uint32_t* band = xr_lane_scratch(scratch, x, lanes);
    const XrStoreMap sm{band, ncb, col0, -2 - k, band_hi, x.nwbs,
                        nw <= 8 ? 7 : -1};
    int dist;
    if (!WINDOW) {
      xr_clear_ops(ops, max_ops, B, lane);
      dist = xr_fill(x, sm, band + x.store_words,
                     band + x.store_words + x.below_words, masks_s, text_s,
                     XrGridText{text_g, B, lane},
                     XrGridMasks{pm_g, nw, B, lane}, nw, k, W, W, W - 1);
    } else {
      const int ref0 = min(max(win.ref_pos[lane], 0), win.ref_cols - W);
      dist = xr_fill(x, sm, band + x.store_words,
                     band + x.store_words + x.below_words, masks_s, text_s,
                     XrRefText{win.refs + static_cast<size_t>(lane) *
                                              win.ref_cols + ref0 + W - 1},
                     XrReadMasks{window_end(win.reads, win.read_cols, lane,
                                            win.read_pos[lane], W), W, nw},
                     nw, k, W, W, W - 1);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const XrBand st{xr_lane_scratch(scratch, x, lanes), k, ncb, col0,
                      band_hi, nwb, x.nwbs};
      const int d_end = level_count(dist, k, early_term);
      if (!WINDOW) {
        tb_walk(st, XrGridMasks{pm_g, nw, B, lane},
                Rows<const int32_t>{text_g + lane, B}, W, k, dist, d_end,
                W - 1, W, commit_limit, max_ops, max_steps,
                Rows<int32_t>{ops + lane, B}, Rows<int32_t>{meta + lane, B});
      } else {
        atomicMax(win.level, d_end);
        // only a committing lane walks, its ops straight into its row of
        // buf at its offset, no further than the drop column
        const bool active = window_active(win, lane, W);
        if (active && dist <= k) {
          const int ref0 = min(max(win.ref_pos[lane], 0), win.ref_cols - W);
          const int off = win.off[lane];
          uint8_t* row =
              win.buf + static_cast<size_t>(lane) * win.buf_cols + off;
          window_advance(
              win, lane,
              tb_walk_ops(st,
                          XrReadMasks{window_end(win.reads, win.read_cols,
                                                 lane, win.read_pos[lane], W),
                                      W, nw},
                          RevBytes{win.refs + static_cast<size_t>(lane) *
                                                  win.ref_cols + ref0 + W - 1},
                          W, k, dist, d_end, W - 1, W, commit_limit,
                          clampi(win.buf_cols - 1 - off, 0, max_ops),
                          max_steps, Rows<uint8_t>{row, 1}),
              max_ops);
        } else if (active) {
          win.failed[lane] = 1;
        }
      }
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(XR_BLOCK_THREADS, XR_K1_BLOCKS)
tb_fused_xwide_kernel(
    const uint32_t* __restrict__ pm_g, const int32_t* __restrict__ text_g,
    int32_t* __restrict__ ops, int32_t* __restrict__ meta, uint32_t* scratch,
    int B, int W, int nw, int k, int nwb, int ncb, int early_term,
    int commit_limit, int max_ops, int max_steps, int lanes, XrLayout x) {
  tb_fused_xwide_body<false>(pm_g, text_g, ops, meta, scratch, B, W, nw, k,
                             nwb, ncb, early_term, commit_limit, max_ops,
                             max_steps, lanes, x, K1Window{});
}

__global__ void __launch_bounds__(XR_BLOCK_THREADS, XR_K1_BLOCKS)
tb_window_xwide_kernel(uint32_t* scratch, int B, int W, int nw, int k,
                       int nwb, int ncb, int early_term, int commit_limit,
                       int max_ops, int max_steps, int lanes, XrLayout x,
                       K1Window win) {
  tb_fused_xwide_body<true>(nullptr, nullptr, nullptr, nullptr, scratch, B, W,
                            nw, k, nwb, ncb, early_term, commit_limit,
                            max_ops, max_steps, lanes, x, win);
}

// The wide K1 in either form (win.reads null: the standalone form).
int launch_xwide(const void* pm, const void* text, void* ops, void* meta,
                 void* scratch, const K1Window& win, int B, int W, int nw,
                 int k, int nwb, int ncb, int early_term, int commit_limit,
                 int max_ops, int max_steps, int lanes, int threads,
                 int smem, long long store_words, long long lane_words,
                 int blocks, void* stream) {
  if (B < 1 || W < 1 || W > nw * WORD || ncb < 1 || ncb > W + 1 ||
      max_ops < 0 || scratch == nullptr || nwb < 1 || nwb > nw || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const XrLayout x = xr_layout(nw, k, nwb, ncb, W + 1 - ncb, W, lanes);
  if (!xr_block_ok(x, nw, k, nwb, lanes, threads, smem, store_words,
                   lane_words, blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  if (win.reads == nullptr) {
    const cudaError_t err = allow_shared(tb_fused_xwide_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tb_fused_xwide_kernel<<<blocks, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
        static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
        static_cast<uint32_t*>(scratch), B, W, nw, k, nwb, ncb, early_term,
        commit_limit, max_ops, max_steps, lanes, x);
  } else {
    const cudaError_t err = allow_shared(tb_window_xwide_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    tb_window_xwide_kernel<<<blocks, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<uint32_t*>(scratch), B, W, nw, k, nwb, ncb, early_term,
        commit_limit, max_ops, max_steps, lanes, x, win);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The wide K1 on a persistent grid of `blocks` blocks of `lanes` warps;
// `scratch` holds lane_words words a lane (xr_layout: its band of
// store_words words first) for every lane of the grid's blocks.
int genasm_tb_fused_xwide_launch(const void* pm, const void* text, void* ops,
                                 void* meta, void* scratch, int B, int W,
                                 int nw, int k, int nwb, int ncb,
                                 int early_term, int commit_limit,
                                 int max_ops, int max_steps, int lanes,
                                 int threads, int smem,
                                 long long store_words, long long lane_words,
                                 int blocks, void* stream) {
  return launch_xwide(pm, text, ops, meta, scratch, K1Window{}, B, W, nw, k,
                      nwb, ncb, early_term, commit_limit, max_ops, max_steps,
                      lanes, threads, smem, store_words, lane_words, blocks,
                      stream);
}

// K1's window form (K1Window, genasm_tb_window_launch's arguments) at NW
// >= 9, on the persistent grid of genasm_tb_fused_xwide_launch.
int genasm_tb_window_xwide_launch(
    const void* reads, const void* refs, const void* read_len,
    void* read_pos, void* ref_pos, void* off, void* dist, void* failed,
    void* buf, void* level, void* scratch, int B, int read_cols,
    int ref_cols, int buf_cols, int W, int nw, int k, int nwb, int ncb,
    int early_term, int commit_limit, int max_ops, int max_steps, int lanes,
    int threads, int smem, long long store_words, long long lane_words,
    int blocks, void* stream) {
  if (reads == nullptr || W > read_cols || W > ref_cols || buf_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const K1Window win{
      static_cast<const uint8_t*>(reads), static_cast<const uint8_t*>(refs),
      static_cast<const int32_t*>(read_len), static_cast<int32_t*>(read_pos),
      static_cast<int32_t*>(ref_pos), static_cast<int32_t*>(off),
      static_cast<int32_t*>(dist), static_cast<uint8_t*>(failed),
      static_cast<uint8_t*>(buf), static_cast<int32_t*>(level), read_cols,
      ref_cols, buf_cols};
  return launch_xwide(nullptr, nullptr, nullptr, nullptr, scratch, win, B, W,
                      nw, k, nwb, ncb, early_term, commit_limit, max_ops,
                      max_steps, lanes, threads, smem, store_words,
                      lane_words, blocks, stream);
}

// Blocks of K1's wide kernel (the standalone form; the window form's has
// the same launch bounds) one SM holds at once with `threads` threads and
// `smem` dynamic shared bytes, and its shared-memory limit on this device
// once `smem` is allowed.
int genasm_tb_fused_xwide_occupancy(int threads, int smem, int* blocks,
                                    int* smem_limit) {
  return static_cast<int>(occupancy(tb_fused_xwide_kernel, threads, smem,
                                    blocks, smem_limit));
}

}  // extern "C"
