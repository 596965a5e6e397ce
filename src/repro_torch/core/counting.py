"""Analytic DP-table footprint / memory-access model (port of
``repro.core.counting``; the paper's §I claims).

GenASM-DC keeps its running bitvectors on chip; the *memory* pressure is
(a) writing the traceback table and (b) the traceback's reads.  These
counters mirror that accounting for each variant, in 32-bit words:

  baseline  (edges4, no ET, full vectors, all columns)   — GenASM (MICRO'20)
  +SENE     (store only R = M&S&D&I)                     — paper idea 1
  +ET       (only levels 0..d_min computed/stored)       — paper idea 2
  +DENT     (band words of reachable columns only)       — paper idea 3

``WindowCounts``, the three ``*_counts``, ``kernel_scratch_words``,
``tail_scratch_words`` and ``reduction_report`` are the reference's
formulas, number for number.

The ``gpu_*`` functions describe where the port's Hopper kernels keep
their stores, from the blocks ``kernels.genasm_dc`` derives (the
reference's versions model its Triton path, a register model):

  * K1 (``tb_fused_geometry``): the DENT band in the block's dynamic
    shared memory, (k+1) x ncols_band x nwb words a lane plus row and bank
    pads, or at k >= 64 or W > 128 in device memory in the skewed
    (ncols_band + rows0 - 1) x L x nwb x rows0 layout
    (``gpu_store_words``).
  * K2 / K4 (``tail_geometry``): the tail's store in shared memory or in
    device memory, whichever ``TAIL_PLACEMENT`` names; in device memory
    the skewed (n_text + rows0 - 1) x L x nwb x rows0 layout
    (``gpu_tail_store_words``).
  * K3 (``dc_band_geometry``): the band is the kernel's output, (k+1) x
    ncols_band x nwb words a lane in device memory, written through a
    ring of wavefront steps in shared memory or straight from registers
    (``gpu_split_store_words``).
  * The fill: each of a lane's G threads carries L = KP / G levels from
    one wavefront step to the next, not k+1 (``gpu_lane_state_words``).
  * Where ``kernel_family`` names the wide family (K1 and the tails from
    W = 129, K3 from W = 257; ``xwide_geometry``): K1's band
    (k+1) x ncols_band x nwbr words a lane and the tails' store (k+1) x
    n_text x nwbr (nwbr: the window's nwb words, plus one where it is
    narrower than the vector, raw; K4: nw) in the scratch of a persistent
    block, reused for each lane group it walks.  The fill state of all
    three is in registers, one warp a lane, each thread one word of L =
    ``XR_LEVELS`` levels for two steps; K3's band leaves its block through
    a staging buffer in shared memory (``xr_k3_layout``), and its scratch
    is only the fill's buffers.  ``gpu_scratch_in_flight`` gives the
    scratch of the blocks the card holds at once.
"""
from __future__ import annotations

import dataclasses

from ..kernels.genasm_dc import (MEMORY_SHARE, XR_LEVELS, kernel_family,
                                 tail_geometry, tb_fused_geometry,
                                 xwide_geometry)
from .config import AlignerConfig
from .windowing import H100_SMS, sm_blocks


@dataclasses.dataclass(frozen=True)
class WindowCounts:
    footprint_words: int     # allocated traceback storage
    dc_writes: int           # words written to the traceback table
    tb_reads: int            # words read back by the traceback


def baseline_counts(cfg: AlignerConfig, tb_steps: float) -> WindowCounts:
    """Unimproved GenASM-TB: 4 full bitvectors per (column, level)."""
    cells = cfg.W * (cfg.k + 1)
    words = 4 * cfg.nw
    # traceback inspects the 4 stored edge vectors of the current cell
    return WindowCounts(cells * words, cells * words,
                        int(tb_steps * 4 * cfg.nw))


def improved_counts(cfg: AlignerConfig, tb_steps: float,
                    levels_run: float) -> WindowCounts:
    """SENE + DENT (+ET via levels_run = average levels actually filled)."""
    cols = cfg.ncols_band
    alloc = cols * (cfg.k + 1) * cfg.nwb
    writes = int(cols * levels_run * cfg.nwb)
    # SENE recomputation reads R[d][j-1], R[d-1][j-1], R[d-1][j] per step
    reads = int(tb_steps * 3 * cfg.nwb)
    return WindowCounts(alloc, writes, reads)


def sene_only_counts(cfg: AlignerConfig, tb_steps: float) -> WindowCounts:
    cells = cfg.W * (cfg.k + 1)
    return WindowCounts(cells * cfg.nw, cells * cfg.nw,
                        int(tb_steps * 3 * cfg.nw))


def kernel_scratch_words(cfg: AlignerConfig, tile: int) -> int:
    """The square kernels' DENT band store, in words, per problem tile:
    (k+1) levels x ncols_band reachable columns x nwb band words per lane
    (the reference's declared VMEM scratch).  Equals
    ``improved_counts(...).footprint_words * tile``."""
    return (cfg.k + 1) * cfg.ncols_band * cfg.nwb * tile


def tail_scratch_words(cfg: AlignerConfig, tile: int,
                       n_text: int | None = None,
                       banded: bool | None = None) -> int:
    """The rectangular-tail store, in words, per problem tile (the
    reference's declared VMEM scratch).

    banded (default: cfg.tail_banded) — the DENT-style tail band keeps
    nwb words per (level, text column) around the per-lane diagonal,
    with column 0 analytic (ones_below needs no store); the full-store
    fallback keeps the whole (k+1, n_text+1, NW) SENE table."""
    if n_text is None:
        n_text = cfg.W + 4 * cfg.k
    if banded is None:
        banded = cfg.tail_banded
    if banded:
        return (cfg.k + 1) * n_text * cfg.nwb * tile
    return (cfg.k + 1) * (n_text + 1) * cfg.nw * tile


def gpu_store_words(cfg: AlignerConfig, tile: int) -> int:
    """Words of K1's DENT band for `tile` lanes, wherever
    ``tb_fused_geometry`` places it: in the block's dynamic shared memory
    per lane k+1 rows of ncols_band x nwb words, with the row and bank
    pads; in device memory (KP >= 128) the skewed
    (ncols_band + rows0 - 1) x L x nwb x rows0 layout; where K1 runs the
    wide family (``kernel_family``: W >= 129) that family's, (k+1) x
    ncols_band rows of nwbs words (nwbr raw words, and at NW <= 8 pads to
    a sector) in its block's scratch.  The reference's Triton path kept
    the same band unpadded in device memory (``kernel_scratch_words``)."""
    if kernel_family(cfg, "tb_fused") == "xwide":
        return xwide_geometry(cfg, "tb_fused").store_words * tile
    geo = tb_fused_geometry(cfg)
    return (geo.band_words or geo.store_words) * tile


def gpu_tail_store_words(cfg: AlignerConfig, tile: int,
                         n_text: int | None = None,
                         banded: bool | None = None) -> int:
    """Words of the tail kernel's store for `tile` lanes (K2 where
    `banded`, default ``cfg.tail_banded``, else K4; ``n_text`` text
    columns, default W + 4k, with the aligner's op budget W + n_text),
    wherever ``tail_geometry`` places it: in shared memory k+1 padded rows
    of n_text x nwb words (K4: nw), in device memory the skewed
    (n_text + rows0 - 1) x L x nwb x rows0 layout; where the tails run
    the wide family (``kernel_family``: W >= 129) that family's (k+1) x
    n_text rows of nwbs words (nwbr raw words, K4: nw; and at NW <= 8
    pads to a sector) in its block's scratch.  The reference's Triton path
    kept (k+1) x n_text x nwb (K4: (k+1) x (n_text+1) x nw) words in
    device memory (``tail_scratch_words``)."""
    if n_text is None:
        n_text = cfg.W + 4 * cfg.k
    if kernel_family(cfg, "tail") == "xwide":
        banded = cfg.tail_banded if banded is None else banded
        return xwide_geometry(cfg, "tail_banded" if banded else "tail_full",
                              n_text).store_words * tile
    geo = tail_geometry(cfg, n_text, cfg.W + n_text, banded=banded)
    return (geo.shared_store_words or geo.store_words) * tile


def gpu_split_store_words(cfg: AlignerConfig, tile: int) -> int:
    """Words of K3's band for `tile` lanes: the kernel's output, (k+1) x
    ncols_band x nwb words a lane in device memory
    (``kernel_scratch_words``).  It leaves the block through a ring of
    wavefront steps in shared memory (``dc_band_geometry``'s "staged") or
    straight from the fill's registers ("direct"), at NW >= 9 through the
    wide block's staging buffer; the ring and the buffer are staging, not
    store."""
    return kernel_scratch_words(cfg, tile)


def gpu_lane_state_words(cfg: AlignerConfig) -> int:
    """Live DP words one fill thread carries from one wavefront step to
    the next: its L = KP / G levels of the current column and the column
    before of the level below its lowest (the word its neighbour shuffles
    up), nw words each.  A lane's G threads hold G times that.  Where K1
    runs the wide family (``kernel_family``: W >= 129; the register fill)
    a thread holds one word of its L = ``XR_LEVELS`` levels and of the
    level below, for the last two steps.  The reference's lane-per-thread
    model carried 2 x (k+1) columns of nw words in one thread."""
    if kernel_family(cfg, "tb_fused") == "xwide":
        return 2 * (XR_LEVELS + 1)
    geo = tb_fused_geometry(cfg)
    return (geo.levels_per_thread + 1) * cfg.nw


def gpu_scratch_in_flight(cfg: AlignerConfig, kernel: str,
                          n_text: int | None = None,
                          free_bytes: int | None = None,
                          sms: int = H100_SMS) -> dict:
    """The wide family's scratch of `kernel` ("tb_fused",
    "tail_banded", "tail_full" or "dc_band"; tails at `n_text` columns,
    default W + 4k): bytes a lane (its store and the fill's buffers), a
    block, and in flight: the blocks ``sms``
    SMs hold at once (``windowing.sm_blocks`` of the block's shared
    bytes and threads), no more than fit ``MEMORY_SHARE`` of
    `free_bytes` where given.  K3's band is its output, sized by the
    batch, not scratch.  Where `kernel` runs its template
    (``kernel_family``) its stores are a lane's each
    (``gpu_store_words``, ``gpu_tail_store_words``): None."""
    if kernel_family(cfg, kernel) != "xwide":
        return None
    geo = xwide_geometry(cfg, kernel, n_text, free_bytes)
    block = 4 * geo.block_words
    blocks = sms * sm_blocks(geo.shared_bytes, geo.threads)
    if free_bytes is not None and block:
        blocks = min(blocks, int(MEMORY_SHARE * free_bytes) // block)
    return {"lanes_per_block": geo.lanes, "threads": geo.threads,
            "chunk": geo.chunk, "shared_bytes": geo.shared_bytes,
            "store_bytes_per_lane": 4 * geo.store_words,
            "scratch_bytes_per_block": block, "blocks_in_flight": blocks,
            "lanes_in_flight": blocks * geo.lanes,
            "scratch_bytes_in_flight": blocks * block}


def reduction_report(cfg: AlignerConfig, avg_levels: float,
                     tb_steps: float | None = None) -> dict:
    """Footprint / access reduction factors for a steady-state main window.

    avg_levels: measured average of (d_min+1) per window (ET).
    tb_steps:   traceback walk length; defaults to stride + avg window cost.
    """
    if tb_steps is None:
        tb_steps = cfg.stride + (avg_levels - 1.0)
    base = baseline_counts(cfg, tb_steps)
    sene = sene_only_counts(cfg, tb_steps)
    impr = improved_counts(cfg, tb_steps, avg_levels)
    impr_alloc_touched = cfg.ncols_band * avg_levels * cfg.nwb
    return {
        "baseline_footprint_words": base.footprint_words,
        "improved_footprint_words": impr.footprint_words,
        "improved_touched_words": impr_alloc_touched,
        "footprint_reduction_alloc": base.footprint_words / impr.footprint_words,
        "footprint_reduction_touched": base.footprint_words / impr_alloc_touched,
        "sene_only_reduction": base.footprint_words / sene.footprint_words,
        "baseline_accesses": base.dc_writes + base.tb_reads,
        "improved_accesses": impr.dc_writes + impr.tb_reads,
        "access_reduction": (base.dc_writes + base.tb_reads)
                            / max(1, impr.dc_writes + impr.tb_reads),
        # the reference's name: the improved band's bytes a problem
        # (kernel_scratch_words(cfg, 1) * 4)
        "vmem_bytes_per_problem": impr.footprint_words * 4,
    }
