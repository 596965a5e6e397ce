// K3's instantiations at NW = 5..8 (W = 129..256), in a translation unit of
// their own so that nvcc builds them beside dc_band.cu's.  K1's (NW, KP,
// NWB): every one that some 128 < W <= 256 and k < W reach with nwb =
// min(NW, ceil((2k+3)/32)), each in the one placement K3_PLACEMENT names
// (kernels/genasm_dc.py): direct at KP = 16, staged above.

#include "dc_band.cuh"

K3Kernel k3_kernel_wide(int nw, int kp, int nwb, int place) {
  if (place != (kp == 16 ? K3_DIRECT : K3_STAGED)) return nullptr;
#define K3_WIDE(NW_, KP_, NWB_)                                          \
  if (nw == NW_ && kp == KP_ && nwb == NWB_)                             \
    return dc_band_kernel<NW_, KP_, NWB_, KP_ == 16 ? K3_DIRECT : K3_STAGED>;
#define K3_NW(NW_)                                                      \
  K3_WIDE(NW_, 16, 1) K3_WIDE(NW_, 16, 2) K3_WIDE(NW_, 32, 2)           \
  K3_WIDE(NW_, 32, 3) K3_WIDE(NW_, 64, 3) K3_WIDE(NW_, 64, 4)           \
  K3_WIDE(NW_, 64, 5) K3_WIDE(NW_, 128, 5) K3_WIDE(NW_, 256, NW_)
  K3_NW(5) K3_NW(6) K3_NW(7) K3_NW(8)
  K3_WIDE(6, 128, 6) K3_WIDE(7, 128, 6) K3_WIDE(7, 128, 7)
  K3_WIDE(8, 128, 6) K3_WIDE(8, 128, 7) K3_WIDE(8, 128, 8)
#undef K3_NW
#undef K3_WIDE
  return nullptr;
}
