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
// K1's window form (K1Window, one main window of the fused loop in this
// launch): the masks from the lanes' read slices (xw_window_masks), the
// text read from the refs at each lane's clamped start (XwWindowText in
// the fill, RevBytes in the walk), one atomicMax a group for the window's
// level count, and only a lane whose window is active and solved walks,
// its ops straight into its row of the op buffer at its offset (no
// further than the drop column), its state advanced; each group commits
// before the block takes the next.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry the Python side did not derive); they never
// synchronise and allocate nothing.

#include <type_traits>

#include "genasm_xwide.cuh"

namespace {

__global__ void tb_fused_xwide_kernel(
    const uint32_t* __restrict__ pm_g, const int32_t* __restrict__ text_g,
    int32_t* __restrict__ ops, int32_t* __restrict__ meta, uint32_t* scratch,
    int B, int W, int nw, int k, int nwb, int ncb, int early_term,
    int commit_limit, int max_ops, int max_steps, int lanes, int WT, int DG,
    int ring_at, long long block_words, long long band_words, K1Window win) {
  extern __shared__ uint32_t smem[];
  const XwShared sh(smem, nw, lanes);
  uint32_t* band = xw_scratch(scratch, block_words);
  uint32_t* ring = xw_ring(sh, band, band_words, lanes, ring_at);
  const XwRole r = xw_role(lanes, WT);
  const XwMasks masks{sh.pm, nw, lanes};
  const int col0 = W + 1 - ncb, band_hi = nw * WORD - WORD * nwb;
  const int groups = (B + lanes - 1) / lanes;
  const bool window = win.reads != nullptr;
  // K1 has no m_len: the window form keeps each lane's clamped reference
  // start there
  int* const ref0 = sh.m_len;
  // one lane group: the fill, dist, then the walk of each lane over its
  // band, reading its text through `text` (XwGridText / XwWindowText)
  // and `walk_text` (Rows / RevBytes)
  auto group = [&](int lane0, const auto& text, auto walk_text) {
    const XwFill<std::decay_t<decltype(text)>> f{
        ring, masks, text, sh.last, nw, k, lanes, W, B, lane0,
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
    if (w >= lanes || lane >= B) return;
    const int dist = sh.dist[w], d_end = level_count(dist, k, early_term);
    const XwBand st{band + w, k, ncb, col0, band_hi, nwb, lanes};
    const XwLaneMasks pm{masks, w};
    if (!window) {
      tb_walk(st, pm, Rows<const int32_t>{text_g + lane, B}, W, k, dist,
              d_end, W - 1, W, commit_limit, max_ops, max_steps,
              Rows<int32_t>{ops + lane, B}, Rows<int32_t>{meta + lane, B});
      return;
    }
    if (w == 0) {          // the group's level count
      int most = d_end;
      for (int ll = 1; ll < lanes && lane0 + ll < B; ++ll)
        most = max(most, level_count(sh.dist[ll], k, early_term));
      atomicMax(win.level, most);
    }
    // only a committing lane walks, its ops straight into its row of buf
    // at its offset, no further than the drop column
    const bool active = window_active(win, lane, W);
    if (active && dist <= k) {
      const int off = win.off[lane];
      uint8_t* row = win.buf + static_cast<size_t>(lane) * win.buf_cols + off;
      window_advance(win, lane,
                     tb_walk_ops(st, pm, walk_text(w, lane), W, k, dist,
                                 d_end, W - 1, W, commit_limit,
                                 clampi(win.buf_cols - 1 - off, 0, max_ops),
                                 max_steps, Rows<uint8_t>{row, 1}),
                     max_ops);
    } else if (active) {
      win.failed[lane] = 1;
    }
  };
  for (int grp = blockIdx.x; grp < groups; grp += gridDim.x) {
    const int lane0 = grp * lanes;
    if (window) {
      xw_window_masks(win, sh.pm, nw, W, lanes, lane0, B);
    } else {
      xw_load_masks(pm_g, sh.pm, nw, lanes, lane0, B);
      xw_clear_ops(ops, max_ops, lanes, lane0, B);
    }
    for (int x = threadIdx.x; x < lanes; x += blockDim.x) {
      const int lane = lane0 + x;
      sh.dist[x] = k + 1;
      sh.last[x] = lane < B ? W : 0;
      if (window)
        ref0[x] = lane < B ? min(max(win.ref_pos[lane], 0), win.ref_cols - W)
                           : 0;
    }
    __syncthreads();
    if (window)
      group(lane0, XwWindowText{win.refs, win.ref_cols, W, ref0},
            [&](int w, int lane) {
              return RevBytes{win.refs + static_cast<size_t>(lane) *
                                             win.ref_cols + ref0[w] + W - 1};
            });
    else
      group(lane0, XwGridText{text_g},
            [&](int, int lane) { return Rows<const int32_t>{text_g + lane, B}; });
    __syncthreads();
  }
}

// K1 at NW >= 9 in either form (win.reads null: the standalone form).
int launch_xwide(const void* pm, const void* text, void* ops, void* meta,
                 void* scratch, const K1Window& win, int B, int W, int nw,
                 int k, int nwb, int ncb, int early_term, int commit_limit,
                 int max_ops, int max_steps, int lanes, int wt, int dg,
                 int threads, int ring_at, int smem, long long ring_words,
                 long long band_words, int blocks, void* stream) {
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
      band_words, win);
  return static_cast<int>(cudaGetLastError());
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
  return launch_xwide(pm, text, ops, meta, scratch, K1Window{}, B, W, nw, k,
                      nwb, ncb, early_term, commit_limit, max_ops, max_steps,
                      lanes, wt, dg, threads, ring_at, smem, ring_words,
                      band_words, blocks, stream);
}

// K1's window form (K1Window, genasm_tb_window_launch's arguments) at NW
// >= 9, on the persistent grid of genasm_tb_fused_xwide_launch: each lane
// group committed before the block takes the next.
int genasm_tb_window_xwide_launch(
    const void* reads, const void* refs, const void* read_len,
    void* read_pos, void* ref_pos, void* off, void* dist, void* failed,
    void* buf, void* level, void* scratch, int B, int read_cols,
    int ref_cols, int buf_cols, int W, int nw, int k, int nwb, int ncb,
    int early_term, int commit_limit, int max_ops, int max_steps, int lanes,
    int wt, int dg, int threads, int ring_at, int smem, long long ring_words,
    long long band_words, int blocks, void* stream) {
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
                      max_steps, lanes, wt, dg, threads, ring_at, smem,
                      ring_words, band_words, blocks, stream);
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
