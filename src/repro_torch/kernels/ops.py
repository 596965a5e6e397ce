"""Layout marshalling around the kernels (port of ``repro/kernels/ops.py``):
standard layout in; out, the DC band (K3) or the traceback dict (K1, K2,
K4).

The batch pads to a ``cfg.lane_tile`` multiple (the pad unit only: the
kernels derive their own blocks), the pattern masks and texts go to the
kernel layout (lanes
innermost, words as int32 bits), and the kernels' outputs come back in the
layout the windowed pipeline and ``core.traceback`` consume.  Every tensor
stays on the device of the inputs; ``levels`` is a 0-d tensor there (no
host sync).
"""
from __future__ import annotations

import torch

from ..core.bitops import build_pm_ext, from_bits32, to_bits32
from ..core.config import AlignerConfig
from .genasm_dc import (META_DFIN, META_DIST, META_LVL, META_NOPS, META_OK,
                        META_RD, META_RF, genasm_dc, genasm_tail_fused,
                        genasm_tb_fused)


def _pad_to_tile(pat_codes, text_codes, tile: int):
    """Pad the batch to a tile multiple with all-zero ('AAA...') lanes: they
    solve at level 0, so they never raise the ``levels`` statistic.  Padded
    lanes are trimmed after the kernel."""
    pad = (-pat_codes.shape[0]) % tile
    if pad:
        pat_codes = torch.nn.functional.pad(pat_codes, (0, 0, 0, pad))
        text_codes = torch.nn.functional.pad(text_codes, (0, 0, 0, pad))
    return pat_codes, text_codes


def _to_kernel_layout(pat_codes, text_codes, cfg: AlignerConfig):
    """(B, m) pattern codes, (B, n) text codes -> pm (5, NW, B) int32 bits,
    text (n, B) int32, both contiguous."""
    pm = build_pm_ext(pat_codes, cfg.nw)                      # (B, 5, NW)
    pm_k = to_bits32(pm.permute(1, 2, 0)).contiguous()
    text_k = text_codes.to(torch.int32).T.contiguous()
    return pm_k, text_k


def _unpack_meta(ops, meta, cfg: AlignerConfig) -> dict:
    dist = meta[META_DIST]
    skip = dist > cfg.k
    return {
        "ops": ops,
        "n_ops": meta[META_NOPS],
        "read_adv": meta[META_RD],
        "ref_adv": meta[META_RF],
        "cost": torch.where(skip, 0, dist - meta[META_DFIN]),
        "ok": meta[META_OK].to(torch.bool),
        "d_final": meta[META_DFIN],
        "dist": dist,
        "solved": ~skip,
        "levels": meta[META_LVL].max(),
    }


def genasm_dc_op(pat_codes, text_codes, *, cfg: AlignerConfig):
    """GenASM-DC (K3) of (B, W) reversed square windows.  Returns dist (B,)
    int32, the band (k+1, ncols_band, B, nwb) as int64 words (the layout
    ``core.traceback`` reads, as ``core.genasm.dc_dmajor`` stores it) and
    levels, the 0-d max of the per-lane level counts."""
    B = pat_codes.shape[0]
    pat_codes, text_codes = _pad_to_tile(pat_codes, text_codes,
                                         cfg.lane_tile)
    pm_k, text_k = _to_kernel_layout(pat_codes, text_codes, cfg)
    dist, band, levels = genasm_dc(pm_k, text_k, cfg=cfg)
    band = from_bits32(band[..., :B]).permute(0, 1, 3, 2).contiguous()
    return dist[:B], band, levels.max()


def genasm_tb_fused_op(pat_codes, text_codes, *, cfg: AlignerConfig,
                       commit_limit: int, max_ops: int,
                       max_steps: int) -> dict:
    """Fused GenASM-DC+TB (K1) of (B, W) reversed square windows.  Returns
    ops (B, max_ops) uint8 front-first, n_ops, read_adv, ref_adv, cost, ok,
    d_final, dist, solved and levels."""
    B = pat_codes.shape[0]
    pat_codes, text_codes = _pad_to_tile(pat_codes, text_codes,
                                         cfg.lane_tile)
    pm_k, text_k = _to_kernel_layout(pat_codes, text_codes, cfg)
    ops_k, meta = genasm_tb_fused(pm_k, text_k, cfg=cfg,
                                  commit_limit=commit_limit, max_ops=max_ops,
                                  max_steps=max_steps)
    ops = ops_k.T[:B].to(torch.uint8)
    return _unpack_meta(ops, meta[:, :B], cfg)


def genasm_tail_fused_op(pat_codes, text_codes, m_len, n_len, *,
                         cfg: AlignerConfig, n_text: int, commit_limit: int,
                         max_ops: int, max_steps: int) -> dict:
    """Fused rectangular-tail DC+TB (K2 when ``cfg.tail_banded``, else K4).

    pat_codes: (B, <= m_pad) reversed tail patterns, sentinel-padded past
    m_len; text_codes: (B, n_text) reversed tail texts, sentinel-padded past
    n_len.  Batch-padding lanes are 'A' vs 'A' one-char problems
    (m_len = n_len = 1) that solve at level 0."""
    B = pat_codes.shape[0]
    pat_codes, text_codes = _pad_to_tile(pat_codes, text_codes,
                                         cfg.lane_tile)
    pad = (-B) % cfg.lane_tile
    m_len = torch.nn.functional.pad(m_len.to(torch.int32), (0, pad), value=1)
    n_len = torch.nn.functional.pad(n_len.to(torch.int32), (0, pad), value=1)
    pm_k, text_k = _to_kernel_layout(pat_codes, text_codes, cfg)
    ops_k, meta = genasm_tail_fused(pm_k, text_k, m_len[None, :].contiguous(),
                                    n_len[None, :].contiguous(), cfg=cfg,
                                    n_text=n_text, commit_limit=commit_limit,
                                    max_ops=max_ops, max_steps=max_steps)
    ops = ops_k.T[:B].to(torch.uint8)
    return _unpack_meta(ops, meta[:, :B], cfg)
