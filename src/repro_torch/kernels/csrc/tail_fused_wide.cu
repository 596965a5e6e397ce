// The tails' instantiations at NW = 5..8 (W = 129..256), in a translation
// unit of their own so that nvcc builds them beside tail_fused.cu's.  K2 at
// every (NW, KP, NWB) that some 128 < W <= 256 and k < W reach with nwb =
// min(NW, ceil((2k+3)/32)) (K1's: NWB 1, 2 at KP = 16; 2, 3 at KP = 32;
// 3, 4, 5 at KP = 64; 5 .. NW at KP = 128; NW at KP = 256), and K4 (and
// K2 as tail_store='band' where the band is the whole vector) at NWB = NW
// at every KP.  Device memory only (TAIL_PLACEMENT in
// kernels/genasm_dc.py).

#include "tail_fused.cuh"

TailKernel tail_kernel_wide(int nw, int kp, int nwb, int place) {
  if (place != PLACE_GLOBAL) return nullptr;
#define TAIL_WIDE(NW_, KP_, NWB_)                       \
  if (nw == NW_ && kp == KP_ && nwb == NWB_)            \
    return tail_fused_kernel<NW_, KP_, NWB_, PLACE_GLOBAL>;
#define TAIL_NW(NW_)                                                    \
  TAIL_WIDE(NW_, 16, 1) TAIL_WIDE(NW_, 16, 2) TAIL_WIDE(NW_, 16, NW_)   \
  TAIL_WIDE(NW_, 32, 2) TAIL_WIDE(NW_, 32, 3) TAIL_WIDE(NW_, 32, NW_)   \
  TAIL_WIDE(NW_, 64, 3) TAIL_WIDE(NW_, 64, 4) TAIL_WIDE(NW_, 64, 5)     \
  TAIL_WIDE(NW_, 128, 5) TAIL_WIDE(NW_, 256, NW_)
  TAIL_NW(5) TAIL_NW(6) TAIL_NW(7) TAIL_NW(8)
  TAIL_WIDE(6, 64, 6) TAIL_WIDE(7, 64, 7) TAIL_WIDE(8, 64, 8)
  TAIL_WIDE(6, 128, 6) TAIL_WIDE(7, 128, 6) TAIL_WIDE(7, 128, 7)
  TAIL_WIDE(8, 128, 6) TAIL_WIDE(8, 128, 7) TAIL_WIDE(8, 128, 8)
#undef TAIL_NW
#undef TAIL_WIDE
  return nullptr;
}
