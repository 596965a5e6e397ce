// K1's instantiations at NW = 5..8 (W = 129..256), in a translation unit of
// their own so that nvcc builds them beside tb_fused.cu's, not after them.
// Only the (NW, KP) where the template beat the wide family's register
// fill (TEMPLATE_KEPT in kernels/genasm_dc.py: KP <= 32, and KP = 64 and
// 256 at NW = 5, 6); everywhere else at these widths K1 runs
// tb_fused_xwide.cu.  Each (NW, KP, NWB) that some 128 < W <= 256 and
// k < W reach there, with nwb = min(NW, ceil((2k+3)/32)): NWB 1, 2 at
// KP = 16; 2, 3 at KP = 32; 3, 4, 5 at KP = 64; NW at KP = 256.  The band
// is in device memory (K1_PLACEMENT): at KP >= 64 one lane's band fits no
// block, and below that a shared band would leave 2-8 lanes an SM.

#include "tb_fused.cuh"

K1Kernel k1_kernel_wide(int nw, int kp, int nwb, int place) {
  if (place != PLACE_GLOBAL) return nullptr;
#define K1_WIDE(NW_, KP_, NWB_)                         \
  if (nw == NW_ && kp == KP_ && nwb == NWB_)            \
    return tb_fused_kernel<NW_, KP_, NWB_, PLACE_GLOBAL>;
  K1_WIDE(5, 16, 1) K1_WIDE(5, 16, 2) K1_WIDE(5, 32, 2) K1_WIDE(5, 32, 3)
  K1_WIDE(5, 64, 3) K1_WIDE(5, 64, 4) K1_WIDE(5, 64, 5) K1_WIDE(5, 256, 5)
  K1_WIDE(6, 16, 1) K1_WIDE(6, 16, 2) K1_WIDE(6, 32, 2) K1_WIDE(6, 32, 3)
  K1_WIDE(6, 64, 3) K1_WIDE(6, 64, 4) K1_WIDE(6, 64, 5) K1_WIDE(6, 256, 6)
  K1_WIDE(7, 16, 1) K1_WIDE(7, 16, 2) K1_WIDE(7, 32, 2) K1_WIDE(7, 32, 3)
  K1_WIDE(8, 16, 1) K1_WIDE(8, 16, 2) K1_WIDE(8, 32, 2) K1_WIDE(8, 32, 3)
#undef K1_WIDE
  return nullptr;
}
