"""K1's block geometry (``genasm_dc.tb_fused_geometry``) over every (W, k)
the CUDA kernels take: W in {16, 32, 64}, 1 <= k < W, k + 1 <= 64.  The
geometry is computed on the host, so it is checked here; the CUDA side
refuses anything else (``chip_smoke.py`` phase ``k1_grid`` launches it)."""
import pytest

from repro_torch.core.config import AlignerConfig
from repro_torch.kernels import genasm_dc

CASES = [(W, k) for W in (16, 32, 64) for k in range(1, W) if k + 1 <= 64]


@pytest.mark.parametrize("W,k", CASES)
def test_tb_fused_geometry(W, k):
    cfg = AlignerConfig(W=W, O=W // 3, k=k)
    geo = genasm_dc.tb_fused_geometry(cfg)
    kp = genasm_dc.levels_bucket(k)
    assert geo.group == min(kp, 32)
    assert geo.group * geo.levels_per_thread == kp >= k + 1
    assert geo.threads % 32 == 0 and 0 < geo.threads <= 1024
    assert geo.lanes * geo.group == geo.threads
    assert geo.shared_bytes <= genasm_dc.MAX_SHARED_BYTES
    # the block's lanes' bands, texts and staged ops fit its shared memory
    need = (cfg.ncols_band * cfg.nwb * (k + 1) + W + cfg.tb_max_ops) * 4
    assert geo.shared_bytes >= geo.lanes * need


def test_tb_fused_geometry_refuses_too_many_levels():
    with pytest.raises(ValueError, match="k \\+ 1 <= 64"):
        genasm_dc.tb_fused_geometry(AlignerConfig(W=96, O=32, k=64))


@pytest.mark.parametrize("threads", [32, 64, 256, 512, 1024])
@pytest.mark.parametrize("k", [5, 12, 24, 48])
def test_tb_fused_geometry_block_sizes(k, threads):
    cfg = AlignerConfig(W=64, O=24, k=k)
    geo = genasm_dc.tb_fused_geometry(cfg, threads=threads)
    base = genasm_dc.tb_fused_geometry(cfg)
    assert geo.threads == threads == geo.lanes * geo.group
    assert (geo.group, geo.levels_per_thread) == (base.group,
                                                  base.levels_per_thread)
    # shared memory is per lane: it scales with the block's lanes
    assert geo.shared_bytes * base.lanes == base.shared_bytes * geo.lanes


@pytest.mark.parametrize("threads", [0, 16, 48, 2048])
def test_tb_fused_geometry_refuses_partial_warps(threads):
    with pytest.raises(ValueError, match="whole warps"):
        genasm_dc.tb_fused_geometry(AlignerConfig(), threads=threads)
