// K1: the C entry points of the fused GenASM-DC+TB kernel of the square
// W x W window (tb_fused_kernel, tb_fused.cuh), its block layout, and its
// instantiations at NW = 1..4 (W <= 128); tb_fused_wide.cu holds NW = 5..8.
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry without an instantiation); they never
// synchronise and allocate nothing.

#include "tb_fused.cuh"

namespace {

// Shared layout of a block (32-bit words; tb_fused_geometry in
// kernels/genasm_dc.py computes the same sizes and the lanes a block:
// change both together): per lane (PLACE_SHARED), the band of k+1 rows of
// row_words words, row (d % L) * ceil((k+1)/L) + d / L for level d,
// column jj at (jj - col0) * nwb; then per lane text_stride text codes;
// then ops (max_ops, lanes); then dist (lanes); then, in the window form
// (K1Window), the lanes' pattern masks (4 x nw words a lane) and their
// commits (2 words a lane).  PLACE_GLOBAL: per lane
// store_words = (ncb + rows0 - 1) * L * nwb * rows0 words of device
// memory, and no band in shared memory.  row_words is
// ncb * nwb, plus one where that makes row_words - nwb even: a step's
// threads write words (row_words - nwb) apart, an odd stride, so they fall
// in distinct banks.  The lane and text strides are 16 mod 32 words, so
// the two lanes of a warp at G = 16 fall in opposite halves of the banks.
struct K1Layout {
  int rows0, row_words, lane_words, text_stride, store_words, smem_bytes;
};

K1Layout k1_layout(int W, int nw, int k, int kp, int nwb, int ncb,
                   int max_ops, int lanes, int place, bool window) {
  const int G = kp < WORD ? kp : WORD, L = kp / G;
  K1Layout g;
  g.rows0 = (k + L) / L;
  g.row_words = ncb * nwb + ((nwb * (ncb - 1)) % 2 == 0 ? 1 : 0);
  g.lane_words = g.store_words = 0;
  if (place == PLACE_SHARED)
    g.lane_words = half_bank_pad((k + 1) * g.row_words);
  else
    g.store_words = (ncb + g.rows0 - 1) * L * nwb * g.rows0;
  g.text_stride = half_bank_pad(W);
  g.smem_bytes = 4 * lanes * (g.lane_words + g.text_stride + max_ops + 1 +
                              (window ? 4 * nw + 2 : 0));
  return g;
}

// K1's instantiation for (nw, k, nwb, place), or null: every (NW, KP, NWB)
// that some W <= 128 and k < W reach, with nwb = min(NW, ceil((2k+3)/32)),
// the band in shared memory at KP <= 64 and in device memory at KP = 128
// (K1_PLACEMENT in kernels/genasm_dc.py); NW = 5..8 from tb_fused_wide.cu.
K1Kernel k1_kernel(int nw, int k, int nwb, int place) {
  const int kp = levels_bucket(k);
  if (nw > 4) return kp > 0 ? k1_kernel_wide(nw, kp, nwb, place) : nullptr;
#define K1_CASE(NW_, KP_, NWB_, PLACE_)                                 \
  if (nw == NW_ && kp == KP_ && nwb == NWB_ && place == PLACE_)         \
    return tb_fused_kernel<NW_, KP_, NWB_, PLACE_>;
#define K1_SHARED(NW_, KP_, NWB_) K1_CASE(NW_, KP_, NWB_, PLACE_SHARED)
  K1_SHARED(1, 16, 1) K1_SHARED(1, 32, 1)
  K1_SHARED(2, 16, 1) K1_SHARED(2, 16, 2) K1_SHARED(2, 32, 2)
  K1_SHARED(2, 64, 2)
  K1_SHARED(3, 16, 1) K1_SHARED(3, 16, 2) K1_SHARED(3, 32, 2)
  K1_SHARED(3, 32, 3) K1_SHARED(3, 64, 3)
  K1_SHARED(4, 16, 1) K1_SHARED(4, 16, 2) K1_SHARED(4, 32, 2)
  K1_SHARED(4, 32, 3) K1_SHARED(4, 64, 3) K1_SHARED(4, 64, 4)
  K1_CASE(3, 128, 3, PLACE_GLOBAL) K1_CASE(4, 128, 4, PLACE_GLOBAL)
#undef K1_SHARED
#undef K1_CASE
  return nullptr;
}

// The block geometry tb_fused_geometry derives, and nothing else: G
// threads per lane, whole warps, the shared bytes of k1_layout within the
// card's limit, a band in device memory for PLACE_GLOBAL.
bool k1_geometry_ok(int W, int nw, int k, int nwb, int ncb, int max_ops,
                    int lanes, int threads, int place, int smem,
                    const void* store, bool window) {
  const int kp = levels_bucket(k);
  const int G = kp < WORD ? kp : WORD;
  return kp > 0 && W >= 1 && W <= nw * WORD && nwb >= 1 && nwb <= nw &&
         ncb >= 1 && ncb <= W + 1 && max_ops >= 0 && lanes >= 1 &&
         threads == lanes * G && threads % WORD == 0 && threads <= 1024 &&
         (place == PLACE_SHARED || (place == PLACE_GLOBAL && store)) &&
         smem <= MAX_SHARED_BYTES &&
         smem == k1_layout(W, nw, k, kp, nwb, ncb, max_ops, lanes, place,
                           window).smem_bytes;
}

// K1 in either form (win.reads null: the standalone form) on `stream`.
int launch_k1(const void* pm, const void* text, void* ops, void* meta,
              void* store, const K1Window& win, int B, int W, int nw, int k,
              int nwb, int ncb, int early_term, int commit_limit,
              int max_ops, int max_steps, int lanes, int threads, int place,
              int smem, void* stream) {
  const bool window = win.reads != nullptr;
  const K1Kernel kernel = k1_kernel(nw, k, nwb, place);
  if (kernel == nullptr || B < 1 ||
      !k1_geometry_ok(W, nw, k, nwb, ncb, max_ops, lanes, threads, place,
                      smem, store, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const K1Layout lay = k1_layout(W, nw, k, levels_bucket(k), nwb, ncb,
                                 max_ops, lanes, place, window);
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + lanes - 1) / lanes, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
      static_cast<uint32_t*>(store), B, W, k, ncb, early_term, commit_limit,
      max_ops, max_steps, lay.row_words, lay.lane_words, lay.text_stride,
      lay.store_words, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int genasm_tb_fused_launch(const void* pm, const void* text, void* ops,
                           void* meta, void* store, int B, int W, int nw,
                           int k, int nwb, int ncb, int early_term,
                           int commit_limit, int max_ops, int max_steps,
                           int lanes, int threads, int place, int smem,
                           void* stream) {
  return launch_k1(pm, text, ops, meta, store, K1Window{}, B, W, nw, k, nwb,
                   ncb, early_term, commit_limit, max_ops, max_steps, lanes,
                   threads, place, smem, stream);
}

// K1's window form (K1Window): one main window of the fused loop, the
// lanes' slices of `reads` (B, read_cols) and `refs` (B, ref_cols) uint8
// at read_pos / ref_pos, committed into the pass's state (read_pos,
// ref_pos, off, dist int32, failed bool, all (B,)), its op buffer `buf`
// (B, buf_cols) uint8 and the window's level count `level`, in place.
int genasm_tb_window_launch(const void* reads, const void* refs,
                            const void* read_len, void* read_pos,
                            void* ref_pos, void* off, void* dist,
                            void* failed, void* buf, void* level,
                            void* store, int B, int read_cols, int ref_cols,
                            int buf_cols, int W, int nw, int k, int nwb,
                            int ncb, int early_term, int commit_limit,
                            int max_ops, int max_steps, int lanes,
                            int threads, int place, int smem, void* stream) {
  if (reads == nullptr || W > read_cols || W > ref_cols || buf_cols < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const K1Window win{
      static_cast<const uint8_t*>(reads), static_cast<const uint8_t*>(refs),
      static_cast<const int32_t*>(read_len), static_cast<int32_t*>(read_pos),
      static_cast<int32_t*>(ref_pos), static_cast<int32_t*>(off),
      static_cast<int32_t*>(dist), static_cast<uint8_t*>(failed),
      static_cast<uint8_t*>(buf), static_cast<int32_t*>(level), read_cols,
      ref_cols, buf_cols};
  return launch_k1(nullptr, nullptr, nullptr, nullptr, store, win, B, W, nw,
                   k, nwb, ncb, early_term, commit_limit, max_ops, max_steps,
                   lanes, threads, place, smem, stream);
}

// Blocks of K1's instantiation for (nw, k, nwb, place) that one SM holds at
// once with `threads` threads and `smem` dynamic shared bytes a block, and
// the instantiation's dynamic shared-memory limit on this device as the
// card reports it once `smem` is allowed.
int genasm_tb_fused_occupancy(int nw, int k, int nwb, int place, int threads,
                              int smem, int* blocks, int* smem_limit) {
  return static_cast<int>(occupancy(k1_kernel(nw, k, nwb, place), threads,
                                    smem, blocks, smem_limit));
}

const char* genasm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
