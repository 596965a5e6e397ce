// K1's instantiations at NW = 5..8 (W = 129..256), in a translation unit of
// their own so that nvcc builds them beside tb_fused.cu's, not after them.
// Every (NW, KP, NWB) that some 128 < W <= 256 and k < W reach, with nwb =
// min(NW, ceil((2k+3)/32)): NWB 1, 2 at KP = 16; 2, 3 at KP = 32; 3, 4, 5
// at KP = 64; 5 .. NW at KP = 128; NW at KP = 256.  The band is in device
// memory at every KP (K1_PLACEMENT in kernels/genasm_dc.py): at KP >= 64
// one lane's band fits no block, and below that a shared band would leave
// 2-8 lanes an SM.

#include "tb_fused.cuh"

K1Kernel k1_kernel_wide(int nw, int kp, int nwb, int place) {
  if (place != PLACE_GLOBAL) return nullptr;
#define K1_WIDE(NW_, KP_, NWB_)                         \
  if (nw == NW_ && kp == KP_ && nwb == NWB_)            \
    return tb_fused_kernel<NW_, KP_, NWB_, PLACE_GLOBAL>;
#define K1_NW(NW_)                                                      \
  K1_WIDE(NW_, 16, 1) K1_WIDE(NW_, 16, 2) K1_WIDE(NW_, 32, 2)           \
  K1_WIDE(NW_, 32, 3) K1_WIDE(NW_, 64, 3) K1_WIDE(NW_, 64, 4)           \
  K1_WIDE(NW_, 64, 5) K1_WIDE(NW_, 128, 5) K1_WIDE(NW_, 256, NW_)
  K1_NW(5) K1_NW(6) K1_NW(7) K1_NW(8)
  K1_WIDE(6, 128, 6) K1_WIDE(7, 128, 6) K1_WIDE(7, 128, 7)
  K1_WIDE(8, 128, 6) K1_WIDE(8, 128, 7) K1_WIDE(8, 128, 8)
#undef K1_NW
#undef K1_WIDE
  return nullptr;
}
