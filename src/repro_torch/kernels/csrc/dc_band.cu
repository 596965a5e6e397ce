// K3: the C entry points of GenASM-DC of the square W x W window alone
// (dc_band_kernel, dc_band.cuh), its block layout, and its instantiations
// at NW = 1..4 (W <= 128); dc_band_wide.cu holds NW = 5..8.
//
// The C entry points return cudaGetLastError() after the launch (or an
// error code for a geometry without an instantiation); they never
// synchronise and allocate nothing.

#include "dc_band.cuh"

namespace {

// The smallest odd multiple of r that is >= words.
int odd_multiple(int words, int r) { return (((words + r - 1) / r) | 1) * r; }

// Shared layout of a block (32-bit words; dc_band_geometry computes the
// same sizes: change both together): per lane text_stride text codes,
// then (K3_STAGED) the ring, 2 x chunk slots of lanes x lane_stride words.
struct K3Layout {
  int text_stride, lane_stride, smem_bytes;
};

K3Layout k3_layout(int W, int kp, int nwb, int lanes, int chunk, int place) {
  K3Layout t;
  t.text_stride = half_bank_pad(W);
  const int r = WORD / (lanes < WORD ? lanes : WORD);
  t.lane_stride = place == K3_STAGED ? odd_multiple(kp * nwb, r) : 0;
  t.smem_bytes =
      4 * (lanes * t.text_stride + 2 * chunk * lanes * t.lane_stride);
  return t;
}

// K3's instantiation for (nw, k, nwb, place), or null: every (NW, KP, NWB)
// that some W <= 128 and k < W reach (K1's), in both placements; NW =
// 5..8 from dc_band_wide.cu.
K3Kernel k3_kernel(int nw, int k, int nwb, int place) {
  const int kp = levels_bucket(k);
  if (nw > 4) return kp > 0 ? k3_kernel_wide(nw, kp, nwb, place) : nullptr;
#define K3_CASE(NW_, KP_, NWB_)                                 \
  if (nw == NW_ && kp == KP_ && nwb == NWB_) {                  \
    if (place == K3_STAGED)                                     \
      return dc_band_kernel<NW_, KP_, NWB_, K3_STAGED>;         \
    return dc_band_kernel<NW_, KP_, NWB_, K3_DIRECT>;           \
  }
  K3_CASE(1, 16, 1) K3_CASE(1, 32, 1)
  K3_CASE(2, 16, 1) K3_CASE(2, 16, 2) K3_CASE(2, 32, 2) K3_CASE(2, 64, 2)
  K3_CASE(3, 16, 1) K3_CASE(3, 16, 2) K3_CASE(3, 32, 2) K3_CASE(3, 32, 3)
  K3_CASE(3, 64, 3)
  K3_CASE(4, 16, 1) K3_CASE(4, 16, 2) K3_CASE(4, 32, 2) K3_CASE(4, 32, 3)
  K3_CASE(4, 64, 3) K3_CASE(4, 64, 4)
  K3_CASE(3, 128, 3) K3_CASE(4, 128, 4)
#undef K3_CASE
  return nullptr;
}

// The block dc_band_geometry derives, and nothing else: G threads per
// lane, whole warps, a chunk that is a power of two, the shared bytes of
// k3_layout within the card's limit.
bool k3_geometry_ok(int W, int nw, int k, int nwb, int ncb, int lanes,
                    int threads, int place, int chunk, int smem) {
  const int kp = levels_bucket(k);
  const int G = kp < WORD ? kp : WORD;
  return kp > 0 && W >= 1 && W <= nw * WORD && nwb >= 1 && nwb <= nw &&
         ncb >= 1 && ncb <= W + 1 && lanes >= 1 && threads == lanes * G &&
         threads % WORD == 0 && threads <= 1024 &&
         (place == K3_STAGED || place == K3_DIRECT) && chunk >= 1 &&
         chunk <= 64 && (chunk & (chunk - 1)) == 0 &&
         smem <= MAX_SHARED_BYTES &&
         smem == k3_layout(W, kp, nwb, lanes, chunk, place).smem_bytes;
}

}  // namespace

extern "C" {

int genasm_dc_band_launch(const void* pm, const void* text, void* band,
                          void* dist, void* levels, int B, int W, int nw,
                          int k, int nwb, int ncb, int early_term, int lanes,
                          int threads, int place, int chunk, int smem,
                          void* stream) {
  const K3Kernel kernel = k3_kernel(nw, k, nwb, place);
  if (kernel == nullptr || B < 1 ||
      !k3_geometry_ok(W, nw, k, nwb, ncb, lanes, threads, place, chunk, smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const K3Layout lay =
      k3_layout(W, levels_bucket(k), nwb, lanes, chunk, place);
  const cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + lanes - 1) / lanes, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pm), static_cast<const int32_t*>(text),
      static_cast<uint32_t*>(band), static_cast<int32_t*>(dist),
      static_cast<int32_t*>(levels), B, W, k, ncb, early_term,
      lay.text_stride, lay.lane_stride, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of K3's instantiation for (nw, k, nwb, place) that one SM holds at
// once with `threads` threads and `smem` dynamic shared bytes a block, and
// its dynamic shared-memory limit as the card reports it once `smem` is
// allowed.
int genasm_dc_band_occupancy(int nw, int k, int nwb, int place, int threads,
                             int smem, int* blocks, int* smem_limit) {
  return static_cast<int>(occupancy(k3_kernel(nw, k, nwb, place), threads,
                                    smem, blocks, smem_limit));
}

}  // extern "C"
