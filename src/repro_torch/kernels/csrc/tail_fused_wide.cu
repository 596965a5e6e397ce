// The tails' instantiations at NW = 5..8 (W = 129..256), in a translation
// unit of their own so that nvcc builds them beside tail_fused.cu's.  Only
// the (NW, KP) where the template beat the wide family's register fill
// (TEMPLATE_KEPT["tail"] in kernels/genasm_dc.py: KP <= 32, KP = 64 and
// 256 at NW = 5, 6, and KP = 128 at NW = 5); everywhere else at these
// widths K2 and K4 run tail_fused_xwide.cu.  K2 at each (NW, KP, NWB) that
// some 128 < W <= 256 and k < W reach there with nwb = min(NW,
// ceil((2k+3)/32)) (K1's: NWB 1, 2 at KP = 16; 2, 3 at KP = 32; 3, 4, 5
// at KP = 64; NW at KP >= 128), and K4 (and K2 as tail_store='band' where
// the band is the whole vector) at NWB = NW.  Device memory only
// (TAIL_PLACEMENT).

#include "tail_fused.cuh"

TailKernel tail_kernel_wide(int nw, int kp, int nwb, int place) {
  if (place != PLACE_GLOBAL) return nullptr;
#define TAIL_WIDE(NW_, KP_, NWB_)                       \
  if (nw == NW_ && kp == KP_ && nwb == NWB_)            \
    return tail_fused_kernel<NW_, KP_, NWB_, PLACE_GLOBAL>;
  TAIL_WIDE(5, 16, 1) TAIL_WIDE(5, 16, 2) TAIL_WIDE(5, 16, 5)
  TAIL_WIDE(5, 32, 2) TAIL_WIDE(5, 32, 3) TAIL_WIDE(5, 32, 5)
  TAIL_WIDE(5, 64, 3) TAIL_WIDE(5, 64, 4) TAIL_WIDE(5, 64, 5)
  TAIL_WIDE(5, 128, 5) TAIL_WIDE(5, 256, 5)
  TAIL_WIDE(6, 16, 1) TAIL_WIDE(6, 16, 2) TAIL_WIDE(6, 16, 6)
  TAIL_WIDE(6, 32, 2) TAIL_WIDE(6, 32, 3) TAIL_WIDE(6, 32, 6)
  TAIL_WIDE(6, 64, 3) TAIL_WIDE(6, 64, 4) TAIL_WIDE(6, 64, 5)
  TAIL_WIDE(6, 64, 6) TAIL_WIDE(6, 256, 6)
  TAIL_WIDE(7, 16, 1) TAIL_WIDE(7, 16, 2) TAIL_WIDE(7, 16, 7)
  TAIL_WIDE(7, 32, 2) TAIL_WIDE(7, 32, 3) TAIL_WIDE(7, 32, 7)
  TAIL_WIDE(8, 16, 1) TAIL_WIDE(8, 16, 2) TAIL_WIDE(8, 16, 8)
  TAIL_WIDE(8, 32, 2) TAIL_WIDE(8, 32, 3) TAIL_WIDE(8, 32, 8)
#undef TAIL_WIDE
  return nullptr;
}
