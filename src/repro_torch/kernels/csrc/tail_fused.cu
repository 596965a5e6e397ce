// K2 and K4: the C entry points of the fused GenASM-DC+TB kernels of the
// ragged rectangular tail (tail_fused_kernel, tail_fused.cuh), their block
// layout, and their instantiations at NW = 1..4 (W <= 128);
// tail_fused_wide.cu holds NW = 5..8.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry without an instantiation); they never
// synchronise and allocate nothing.

#include "tail_fused.cuh"

namespace {

// Shared layout of a block (32-bit words; tail_geometry computes the same
// sizes: change both together): per lane the store (PLACE_SHARED), then
// per lane text_stride text codes, then ops (max_ops, lanes), dist
// (lanes) and one word for the block's longest lane.
struct TailLayout {
  int rows0, row_words, lane_words, text_stride, store_words;
  long long smem_bytes;
};

TailLayout tail_layout(int n_text, int k, int kp, int nwb, int max_ops,
                       int lanes, int place) {
  const int G = kp < WORD ? kp : WORD, L = kp / G;
  TailLayout t;
  t.rows0 = (k + L) / L;
  t.text_stride = half_bank_pad(n_text);
  t.row_words = t.lane_words = t.store_words = 0;
  if (place == PLACE_SHARED) {
    t.row_words = n_text * nwb + ((nwb * (n_text - 1)) % 2 == 0 ? 1 : 0);
    t.lane_words = half_bank_pad((k + 1) * t.row_words);
  } else {
    t.store_words = (n_text + t.rows0 - 1) * L * nwb * t.rows0;
  }
  t.smem_bytes = 4LL * (static_cast<long long>(lanes) *
                            (t.lane_words + t.text_stride + max_ops + 1) + 1);
  return t;
}

// The instantiation for (nw, k, nwb, place), or null: K4 at every (NW, KP)
// with NWB = NW, K2 at every (NW, KP, NWB < NW) that some k <= 63 reaches
// with nwb = min(NW, ceil((2k+3)/32)); each in both placements up to KP =
// 64, in device memory at KP = 128 (K2 there only as tail_store='band',
// whose band is the whole vector); NW = 5..8 from tail_fused_wide.cu.
TailKernel tail_kernel(int nw, int k, int nwb, int place) {
  const int kp = levels_bucket(k);
  if (nw > 4) return kp > 0 ? tail_kernel_wide(nw, kp, nwb, place) : nullptr;
#define TAIL_CASE(NW_, KP_, NWB_)                                   \
  if (nw == NW_ && kp == KP_ && nwb == NWB_) {                      \
    if (place == PLACE_SHARED)                                      \
      return tail_fused_kernel<NW_, KP_, NWB_, PLACE_SHARED>;       \
    return tail_fused_kernel<NW_, KP_, NWB_, PLACE_GLOBAL>;         \
  }
  TAIL_CASE(1, 16, 1) TAIL_CASE(1, 32, 1)
  TAIL_CASE(2, 16, 1) TAIL_CASE(2, 16, 2) TAIL_CASE(2, 32, 2)
  TAIL_CASE(2, 64, 2)
  TAIL_CASE(3, 16, 1) TAIL_CASE(3, 16, 2) TAIL_CASE(3, 16, 3)
  TAIL_CASE(3, 32, 2) TAIL_CASE(3, 32, 3) TAIL_CASE(3, 64, 3)
  TAIL_CASE(4, 16, 1) TAIL_CASE(4, 16, 2) TAIL_CASE(4, 16, 4)
  TAIL_CASE(4, 32, 2) TAIL_CASE(4, 32, 3) TAIL_CASE(4, 32, 4)
  TAIL_CASE(4, 64, 3) TAIL_CASE(4, 64, 4)
#undef TAIL_CASE
  // KP = 128 (k >= 64 at W = 96, 128): nwb = nw, and one lane's store
  // fits no block's shared memory, so global only
  if (kp == 128 && nwb == nw && place == PLACE_GLOBAL) {
    if (nw == 3) return tail_fused_kernel<3, 128, 3, PLACE_GLOBAL>;
    if (nw == 4) return tail_fused_kernel<4, 128, 4, PLACE_GLOBAL>;
  }
  return nullptr;
}

// The block tail_geometry derives, and nothing else: G threads per lane,
// whole warps, the shared bytes of tail_layout within the card's limit,
// a store in device memory for PLACE_GLOBAL.
bool tail_geometry_ok(int n_text, int W, int nw, int k, int nwb,
                      int max_ops, int lanes, int threads, int place,
                      int smem, const void* store) {
  const int kp = levels_bucket(k);
  const int G = kp < WORD ? kp : WORD;
  return kp > 0 && n_text >= 1 && W >= 1 && W <= nw * WORD && nwb >= 1 &&
         nwb <= nw && max_ops >= 0 && lanes >= 1 && threads == lanes * G &&
         threads % WORD == 0 && threads <= 1024 &&
         (place == PLACE_SHARED || (place == PLACE_GLOBAL && store)) &&
         smem <= MAX_SHARED_BYTES &&
         smem == tail_layout(n_text, k, kp, nwb, max_ops, lanes, place)
                     .smem_bytes;
}

int tail_launch(int banded, const void* pm, const void* text,
                const void* m_len, const void* n_len, void* ops, void* meta,
                void* store, int B, int n_text, int W, int nw, int k, int nwb,
                int early_term, int commit_limit, int max_ops, int max_steps,
                int lanes, int threads, int place, int smem, void* stream) {
  const TailKernel kernel = tail_kernel(nw, k, nwb, place);
  if (kernel == nullptr || B < 1 ||
      !tail_geometry_ok(n_text, W, nw, k, nwb, max_ops, lanes, threads,
                        place, smem, store))
    return static_cast<int>(cudaErrorInvalidValue);
  const TailLayout lay = tail_layout(n_text, k, levels_bucket(k), nwb,
                                     max_ops, lanes, place);
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + lanes - 1) / lanes, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<const int32_t*>(m_len), static_cast<const int32_t*>(n_len),
      static_cast<int32_t*>(ops), static_cast<int32_t*>(meta),
      static_cast<uint32_t*>(store), B, n_text, k, banded, early_term,
      commit_limit, max_ops, max_steps, lay.row_words, lay.lane_words,
      lay.text_stride, lay.store_words);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2: nwb = the config's band words (< nw unless tail_store='band' asks
// for the band where it is as wide as the vector).
int genasm_tail_banded_launch(const void* pm, const void* text,
                              const void* m_len, const void* n_len, void* ops,
                              void* meta, void* store, int B, int n_text,
                              int W, int nw, int k, int nwb, int early_term,
                              int commit_limit, int max_ops, int max_steps,
                              int lanes, int threads, int place, int smem,
                              void* stream) {
  return tail_launch(1, pm, text, m_len, n_len, ops, meta, store, B, n_text,
                     W, nw, k, nwb, early_term, commit_limit, max_ops,
                     max_steps, lanes, threads, place, smem, stream);
}

// K4: nwb must be nw (the full vector).
int genasm_tail_full_launch(const void* pm, const void* text,
                            const void* m_len, const void* n_len, void* ops,
                            void* meta, void* store, int B, int n_text, int W,
                            int nw, int k, int nwb, int early_term,
                            int commit_limit, int max_ops, int max_steps,
                            int lanes, int threads, int place, int smem,
                            void* stream) {
  if (nwb != nw) return static_cast<int>(cudaErrorInvalidValue);
  return tail_launch(0, pm, text, m_len, n_len, ops, meta, store, B, n_text,
                     W, nw, k, nwb, early_term, commit_limit, max_ops,
                     max_steps, lanes, threads, place, smem, stream);
}

// Blocks of the tail instantiation for (nw, k, nwb, place) that one SM
// holds at once with `threads` threads and `smem` dynamic shared bytes a
// block, and its dynamic shared-memory limit as the card reports it once
// `smem` is allowed.
int genasm_tail_occupancy(int nw, int k, int nwb, int place, int threads,
                          int smem, int* blocks, int* smem_limit) {
  return static_cast<int>(occupancy(tail_kernel(nw, k, nwb, place), threads,
                                    smem, blocks, smem_limit));
}

}  // extern "C"
