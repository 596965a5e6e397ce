"""The GenASM kernels: wrappers, launch counts and plain versions.

Four kernels, each a port of a Pallas TPU kernel of
``repro/kernels/genasm_dc.py`` and written by hand in CUDA C++ in
``csrc/`` (``tb_fused.cu``, ``tail_fused.cu``, ``dc_band.cu``; the wide
family ``*_xwide.cu`` where ``kernel_family`` names it):

  * K1 ``genasm_tb_fused``    <- ``_kernel_fused``: improved GenASM-DC
    (SENE + DENT + ET) of a square W x W window, then the traceback walked
    in the same kernel over the stored DENT band.  Its window form
    (``window_step.genasm_tb_window``, counted as K1) is one main window
    of the fused loop: the slices read and the ops and state committed in
    the same launch.
  * K2 ``genasm_tail_banded`` <- ``_kernel_tail_banded``: the ragged
    rectangular tail (m_len <= W pattern chars against n_len <= n_text
    text chars) with a per-lane diagonal band store.
  * K4 ``genasm_tail_full``   <- ``_kernel_tail_fused``: the same tail with
    the full (k+1, n_text+1, NW) SENE store, taken when the band is no
    strict win (``cfg.tail_banded`` False: every rescue rung at W=64).
  * K3 ``genasm_dc``          <- ``_kernel``: K1's DC fill alone, with the
    DENT band as an output for a separate traceback (``backend='split'``).

Layout as on the TPU: one problem per lane, lanes innermost.  Inputs are
``pm (5, NW, B)`` int32 (the 0-active pattern masks' bits, row 4 all ones),
``text (n, B)`` int32 and, for the tails, ``m_len``/``n_len`` ``(1, B)``
int32.  The fused kernels output ``ops (max_ops, B)`` int32, front-first,
padded with OP_NONE, and ``meta (META_ROWS, B)`` int32 (rows ``META_*``);
K3 outputs ``dist (B,)``, ``band (k+1, ncols_band, nwb, B)`` (the band's
bits) and ``levels (B,)``, all int32.

``META_LVL`` (K3: ``levels``) holds, per lane, ``min(dist, k) + 1`` with early termination
and ``k + 1`` without; the TPU kernel wrote the same statistic per lane
tile.  Only its maximum over the batch is ever read (``kernels.ops``),
and both give ``min(max dist, k) + 1`` there, so the results agree.

All four run a group of threads per lane over one wavefront fill;
``tb_fused_geometry``, ``tail_geometry`` and ``dc_band_geometry`` derive
their blocks from the configuration (K1 keeps the DENT band in shared
memory, or in device memory where ``K1_PLACEMENT`` says so (k >= 64); the
tails keep their store in shared or device memory, whichever
``TAIL_PLACEMENT`` names; K3 writes its band out through a ring in shared
memory or straight from registers, whichever ``K3_PLACEMENT`` names).
``cfg.lane_tile`` sets no block: it is only the batch pad unit
(``kernels.ops``).  Which family runs a kernel at a configuration is
``kernel_family``'s answer, and nothing else's:

  * the templates, instantiated per (NW, KP, NWB): all four kernels at
    NW = 1..4 (W <= 128; level capacities KP = 16, 32, 64, 128) and K3 at
    NW = 5..8 (W = 129..256, KP up to 256, ``csrc/dc_band_wide.cu``);
  * the wide family (``csrc/genasm_xwide_reg.cuh``, ``xwide_geometry``):
    K1 and K2/K4 at NW >= 5 (W >= 129), K3 at NW >= 9 (W >= 257); one
    kernel each, NW, k and NWB at run time, on a persistent grid whose
    scratch is sized by the blocks in flight.  All three hold a lane's
    levels in registers, one warp a lane (``xr_layout``: 8 word threads
    a level group at NW <= 8, 16 at NW <= 16, else 32; K3 writes its band
    through a staging buffer in shared memory, ``xr_k3_layout``); the one
    refusal is a lane whose scratch exceeds the card's free memory
    (``check_scratch_fits``).

The templates' geometries (``tb_fused_geometry``, ...) and occupancy
queries serve the templates' configurations only, ``xwide_geometry`` and
``xwide_occupancy`` the wide family's.
A block's threads are capped by its kernel's registers (``REGISTERS``:
ptxas's count, 65,536 a block).

Each wrapper checks device, dtype, shape and contiguity.  For a CPU tensor
it runs the kernel's plain PyTorch version (vectorised over lanes, the
reference's arithmetic, words as int64 in [0, 2**32)); for a CUDA tensor it
launches the kernel and raises if the launch fails; any other device
raises.  ``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls of
the plain versions, one per wrapper call, so a run can show which path did
the work.  A launch issued while its thread captures a CUDA graph
(``recording_launches``) runs nothing then: it is recorded, and each
replay of the graph counts the launches it holds (``add_launches``).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading

import torch

from ..core.bitops import (WORD_BITS, extract_window, from_bits32, get_bit,
                           to_bits32)
from ..core.config import AlignerConfig
from ..core.genasm import _dist_from_final, jmajor_columns
from ..core.traceback import _zbit_band, _zbit_full, sene_avail, walk

# meta row layout of the fused kernels (8 rows, as on the TPU)
META_DIST, META_LVL, META_NOPS, META_RD, META_RF, META_DFIN, META_OK = range(7)
META_ROWS = 8

KERNELS = ("tb_fused", "tail_banded", "tail_full", "dc_band")
#: kernel launches per wrapper; plain-version calls per wrapper
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
#: the counts are bumped from a session's dispatch and retire threads
#: alike; ``d[k] += 1`` is not atomic, so every update takes this lock
_COUNTS_LOCK = threading.Lock()


def _bump(counts: dict, name: str) -> None:
    with _COUNTS_LOCK:
        counts[name] += 1


#: per thread: the launches a CUDA graph being captured on it holds
_RECORDING = threading.local()


@contextlib.contextmanager
def recording_launches():
    """Within this context the calling thread's kernel launches are
    recorded into the dict it yields, not counted in LAUNCHES: the
    launches of a CUDA graph captured here, which run at its replays."""
    rec = dict.fromkeys(KERNELS, 0)
    outer = getattr(_RECORDING, "launches", None)
    _RECORDING.launches = rec
    try:
        yield rec
    finally:
        _RECORDING.launches = outer


def add_launches(launches: dict) -> None:
    """Count the launches one replay of a captured graph holds."""
    with _COUNTS_LOCK:
        for name, n in launches.items():
            LAUNCHES[name] += n


def _count_launch(name: str) -> None:
    rec = getattr(_RECORDING, "launches", None)
    if rec is None:
        _bump(LAUNCHES, name)
    else:
        rec[name] = rec.get(name, 0) + 1


def reset_counts() -> None:
    """Every count to 0."""
    with _COUNTS_LOCK:
        for counts in (LAUNCHES, PLAIN_CALLS):
            for name in counts:
                counts[name] = 0


# --------------------------------------------------------------------------
# plain PyTorch versions: the fill is core.genasm's text-major column step,
# the walk core.traceback's; each supplies the store reader of its kernel
# --------------------------------------------------------------------------

def _pm_words(pm):
    """Kernel-layout pm (5, NW, B) int32 bits -> (B, 5, NW) int64 words."""
    return from_bits32(pm).permute(2, 0, 1)


def _fill(pmw, text, n_len, k: int):
    """All columns of every level, (n+1, B, k+1, NW), columns past a
    lane's n_len frozen: the SENE recurrence the kernels run, in their
    wavefront order.  text: (n, B) kernel layout."""
    return jmajor_columns(pmw, text.T.long(), n_len, k=k)[0]


def _dist(r_final, m_len, k: int):
    """dist = lowest level whose bit m_len-1 is 0, else k+1; lanes with
    m_len = 0 never hit (the kernels' guard)."""
    dist = _dist_from_final(r_final, m_len, k)[0].long()
    return torch.where(m_len >= 1, dist, k + 1)


def _d_end(dist, cfg: AlignerConfig):
    if cfg.early_term:
        return torch.clamp(dist, max=cfg.k) + 1
    return torch.full_like(dist, cfg.k + 1)


def _peq(pmw, text, m_pad: int):
    """peq(ii, jj): P[ii] == T[jj-1] through the pattern masks (indices
    clipped as the kernels clip them; sentinel text matches nothing)."""
    lanes = torch.arange(pmw.shape[0], device=pmw.device)
    n = text.shape[0]

    def peq(ii, jj):
        cj = torch.gather(text, 0, torch.clamp(jj - 1, 0, n - 1)[None])[0]
        valid = (cj >= 0) & (cj < 4)
        words = pmw[lanes, torch.where(valid, cj.long(), 0)]
        bit = get_bit(words, torch.clamp(ii, 0, m_pad - 1))
        return valid & (bit == 0)
    return peq


def _pack(ops, dist, d_end, walk_state):
    nops, rd, rf, d, ok = walk_state
    meta = torch.zeros((META_ROWS, dist.shape[0]), dtype=torch.int64,
                       device=dist.device)
    for row, val in ((META_DIST, dist), (META_LVL, d_end), (META_NOPS, nops),
                     (META_RD, rd), (META_RF, rf), (META_DFIN, d),
                     (META_OK, ok.long())):
        meta[row] = val
    return ops.to(torch.int32), meta.to(torch.int32)


def dc_band_plain(pm, text, *, cfg: AlignerConfig):
    """Plain version of K3: column-major DC fill of the W x W window; every
    level of the last ncols_band columns is stored as its DENT band window
    at the static base ``cfg.band_base(j)``.  Returns dist (B,), band
    (k+1, ncb, nwb, B) as int32 bits and the level count (B,), all int32."""
    W, k, ncb = cfg.W, cfg.k, cfg.ncols_band
    B = pm.shape[-1]
    col0 = W + 1 - ncb
    R = _fill(_pm_words(pm), text,
              torch.full((B,), W, dtype=torch.int64, device=pm.device), k)
    dist = _dist(R[W], torch.full((B,), W, device=pm.device), k)
    bases = torch.tensor([cfg.band_base(j) for j in range(col0, W + 1)],
                         dtype=torch.int64, device=pm.device)[:, None, None]
    band = extract_window(R[col0:], bases, cfg.nwb)      # (ncb, B, k+1, nwb)
    return (dist.to(torch.int32), to_bits32(band.permute(2, 0, 3, 1))
            .contiguous(), _d_end(dist, cfg).to(torch.int32))


def tb_fused_plain(pm, text, *, cfg: AlignerConfig, commit_limit: int,
                   max_ops: int, max_steps: int):
    """Plain version of K1: K3's fill (``dc_band_plain``), then the walk
    over the band it stores."""
    W, k = cfg.W, cfg.k
    B = pm.shape[-1]
    dev = pm.device
    dist, band, levels = dc_band_plain(pm, text, cfg=cfg)
    rb = from_bits32(band).permute(0, 1, 3, 2)           # (k+1, ncb, B, nwb)
    bases = torch.tensor([cfg.band_base(j) for j in range(W + 1)],
                         dtype=torch.int64, device=dev)
    lanes = torch.arange(B, device=dev)
    col0 = W + 1 - cfg.ncols_band
    dist = dist.long()

    def zbit(dd, jj, ii):
        return _zbit_band(rb, bases, col0, lanes, dd, jj, ii)

    ops, state = walk(
        dist=dist, k=k,
        init_i=torch.full((B,), W - 1, dtype=torch.int64, device=dev),
        init_j=torch.full((B,), W, dtype=torch.int64, device=dev),
        commit_limit=commit_limit, max_ops=max_ops, max_steps=max_steps,
        avail=sene_avail(zbit, _peq(_pm_words(pm), text, cfg.m_pad)))
    return _pack(ops, dist, levels, state)


def _tail_plain(pm, text, m_len, n_len, cfg: AlignerConfig, zbit_of, *,
                commit_limit: int, max_ops: int, max_steps: int):
    """A tail kernel's plain version: the ragged fill, then the walk with
    the store reader ``zbit_of(R, m_len, n_len)`` builds from the fill."""
    k = cfg.k
    pmw = _pm_words(pm)
    m_len, n_len = m_len[0].long(), n_len[0].long()
    R = _fill(pmw, text, n_len, k)
    dist = _dist(R[-1], m_len, k)
    ops, state = walk(
        dist=dist, k=k, init_i=m_len - 1, init_j=n_len,
        commit_limit=commit_limit, max_ops=max_ops, max_steps=max_steps,
        avail=sene_avail(zbit_of(R, m_len, n_len),
                         _peq(pmw, text, cfg.m_pad)))
    return _pack(ops, dist, _d_end(dist, cfg), state)


def tail_banded_plain(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                      n_text: int, commit_limit: int, max_ops: int,
                      max_steps: int):
    """Plain version of K2: the ragged tail whose store keeps, per column,
    the band window around the lane's own diagonal; column 0 and the
    first row are analytic."""
    k, nwb = cfg.k, cfg.nwb
    band_hi = cfg.m_pad - WORD_BITS * nwb
    lanes = torch.arange(pm.shape[-1], device=pm.device)

    def zbit_of(R, m_len, n_len):
        diag = m_len - 1 - n_len
        cols = torch.arange(1, n_text + 1, device=pm.device)[:, None]
        base = torch.clamp(cols + diag - (k + 1), 0, band_hi)  # (n_text, B)
        band = extract_window(R[1:], base[..., None], nwb)
        band = band.permute(2, 0, 1, 3)                 # (k+1, n_text, B, nwb)

        def zbit(dd, jj, ii):
            off = ii - torch.clamp(jj + diag - (k + 1), 0, band_hi)
            inband = (off >= 0) & (off < nwb * WORD_BITS)
            words = band[torch.clamp(dd, 0, k),
                         torch.clamp(jj, 1, n_text) - 1, lanes]
            bit = get_bit(words, torch.clamp(off, 0, nwb * WORD_BITS - 1))
            z = torch.where(jj <= 0, ii < dd, (bit == 0) & inband)
            return torch.where(ii < 0, jj <= dd, z)
        return zbit

    return _tail_plain(pm, text, m_len, n_len, cfg, zbit_of,
                       commit_limit=commit_limit, max_ops=max_ops,
                       max_steps=max_steps)


def tail_full_plain(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                    n_text: int, commit_limit: int, max_ops: int,
                    max_steps: int):
    """Plain version of K4: the ragged tail storing every full column
    vector of every level, read back as the 'and' traceback reads it."""
    lanes = torch.arange(pm.shape[-1], device=pm.device)

    def zbit_of(R, m_len, n_len):
        def zbit(dd, jj, ii):
            return _zbit_full(R, lanes, dd, jj, ii)
        return zbit

    return _tail_plain(pm, text, m_len, n_len, cfg, zbit_of,
                       commit_limit=commit_limit, max_ops=max_ops,
                       max_steps=max_steps)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(cfg, pm, text, n_text, lens=()):
    device = pm.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel and no plain version for device "
                         f"{device}: pass CPU or CUDA tensors")
    B = pm.shape[-1]
    _check("pm", pm, (5, cfg.nw, B), device)
    _check("text", text, (n_text, B), device)
    for name, t in zip(("m_len", "n_len"), lens):
        _check(name, t, (1, B), device)
    return device.type == "cuda"


def _outputs(max_ops, B, device):
    return (torch.empty((max_ops, B), dtype=torch.int32, device=device),
            torch.empty((META_ROWS, B), dtype=torch.int32, device=device))


def _store(B: int, words: int, device):
    """A kernel's store in device memory, `words` int32 a lane (or a
    block, for the wide family's scratch; none: an empty tensor, whose
    pointer the kernel does not read)."""
    return torch.empty((B, words) if words else 0, dtype=torch.int32,
                       device=device)


def _library():
    from .build import load_library
    return load_library()


def _check_rc(lib, what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.genasm_error_string(rc).decode()})")


def _launch(name, *tensors, ints, block=(), entry=None):
    """Launch kernel `name` of the CUDA library on the current stream of
    the tensors' device, with the block geometry ``block`` its entry point
    (``genasm_<entry>_launch``, `entry` default `name`) takes; raise if
    the launch is refused."""
    lib = _library()
    fn = getattr(lib, f"genasm_{entry or name}_launch")
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _count_launch(name)
        rc = fn(*[t.data_ptr() for t in tensors], *ints, *block, stream)
    _check_rc(lib, f"genasm_{name} kernel launch", rc)


# --------------------------------------------------------------------------
# the blocks of K1 (csrc/tb_fused.cu), K2/K4 (csrc/tail_fused.cu) and K3
# (csrc/dc_band.cu): the same sizes are computed again in C (k1_layout,
# tail_layout, k3_layout), which refuses any other; change both together
# --------------------------------------------------------------------------

K1_THREADS = 128                #: threads per K1 block (fewer where its
                                #: shared memory does not fit)
TAIL_THREADS = 128              #: threads per K2/K4 block (the same)
MAX_SHARED_BYTES = 232_448      #: dynamic shared memory of one H100 block
PLACEMENTS = ("shared", "global")   #: K1's band and the tails' store, in
                                    #: C's numbering
#: K1 and the tails (K2 / K4) at NW = 5..8 (W = 129..256) run the wide
#: family's register fill (8 word threads a level group, 4 level groups a
#: warp, a stored row one 32 B sector) at every (NW, KP) but those named
#: here, whose templates stay: where the template was faster, or the fill
#: more than 3 % slower, in tools/torch_xwide_ab.py's A/B in turns (2,048
#: lanes; W = 160 / 192 / 224 / 256 at k = 15, 30, 60, 120 and 140 / 150
#: / 200 / 240; K1 in both forms; NVIDIA H100 80GB HBM3, 700 W; PERF.md
#: section 6): KP <= 32 at every NW (the fill 1.5-2.6x slower: one
#: strip of 28 levels for 16, or a second strip for 3); KP = 64 at NW = 5,
#: 6 (K1 9-33 %, K2 19-53 % slower); KP = 256 at NW = 5, 6 (K1's window
#: form 6-9 %, K4 5-9 % slower); and the tails at NW = 5, KP = 128 (K4 16 %
#: slower).  Only these templates are instantiated at NW = 5..8.
TEMPLATE_KEPT = {
    "tb_fused": frozenset({(nw, kp) for nw in range(5, 9) for kp in (16, 32)}
                          | {(5, 64), (6, 64), (5, 256), (6, 256)}),
    "tail": frozenset({(nw, kp) for nw in range(5, 9) for kp in (16, 32)}
                      | {(5, 64), (6, 64), (5, 128), (5, 256), (6, 256)})}
#: where the tails keep a lane's store, by (NW, KP): the placement that
#: tools/torch_tail_sweep.py measured faster (the sum of its device ms at
#: 2,048 and 4,096 lanes, 128 threads a block, W = 32 / 64 / 96 / 128 at
#: k = 12, 24, 48; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6).  K2
#: and K4 share it.  Shared memory wins only where a lane's store is small
#: (KP = 16 at NW <= 2, and NW = 1); global wherever one lane's store does
#: not fit a block.
#: At NW = 5..8 (W = 129..256) only "global" is instantiated, at the
#: (NW, KP) ``TEMPLATE_KEPT`` names: it won at every NW >= 3 of the sweep,
#: and a lane's store there is 0.1-10 MB.
TAIL_PLACEMENT = {(1, 16): "shared", (1, 32): "shared",
                  (2, 16): "shared", (2, 32): "global", (2, 64): "global",
                  (3, 16): "global", (3, 32): "global", (3, 64): "global",
                  (4, 16): "global", (4, 32): "global", (4, 64): "global",
                  (3, 128): "global", (4, 128): "global",
                  **dict.fromkeys(sorted(TEMPLATE_KEPT["tail"]), "global")}
#: where K1 keeps a lane's DENT band, by (NW, KP): in shared memory up to
#: KP = 64 at NW <= 4; at KP = 128 (k >= 64, W = 96 or 128) one lane's
#: band, (k+1) x ncols_band x nwb words, is 134,160 B at W = 128, k = 64
#: and 264,192 B at k = 127, so it goes to device memory, in the tails'
#: skewed global layout (tb_fused.cu).  At NW = 5..8 (W = 129..256) device
#: memory at every KP: at KP >= 64 one lane's band fits no block (289 KB at
#: W = 256, O = 96, k = 63); at KP = 16 and 32 a shared band (22.8-74.5 KB
#: a lane) would leave 2-8 lanes an SM in one block of 149-191 KB, where
#: the tails' sweep found device memory faster at every NW >= 3 (PERF.md
#: section 6); only "global" is instantiated there, at the (NW, KP)
#: ``TEMPLATE_KEPT`` names.
K1_PLACEMENT = {**{(nw, kp): "shared" if kp <= 64 else "global"
                   for nw in range(1, 5) for kp in (16, 32, 64, 128)},
                **dict.fromkeys(sorted(TEMPLATE_KEPT["tb_fused"]),
                                "global")}
#: the widest NW whose instantiations cover every placement (W <= 128);
#: at NW = 5..8 only the placement the tables name is built
NARROW_NW = 4
#: the widest NW of the templates (W <= 256: K3 at NW = 5..8, K1 and the
#: tails there only at ``TEMPLATE_KEPT``).  A fill thread there holds L x NW
#: words of its levels (L = KP / 32 at KP >= 32) plus the pattern masks'
#: 4 x NW; at W = 512 that would be 16 x 16 = 256 words, past a thread's
#: 255 registers, so NW > TEMPLATE_NW runs the wide family everywhere
TEMPLATE_NW = 8

#: registers of one block (and of one SM) on an H100
MAX_BLOCK_REGISTERS = 65_536
#: registers a thread of each kernel's instantiations takes, by (NW, KP):
#: ptxas's count (``-Xptxas -v``, the build's report), the most over NWB
#: and placement (CUDA 12.8, sm_90a; PERF.md section 6), at the (NW, KP)
#: instantiated (NW = 5..8: ``TEMPLATE_KEPT``).  None spills; the most is
#: 160 (K1 at NW = 6, KP = 256; K1's counts are those of its one build with
#: the window form, ``window_step.genasm_tb_window``).
#: "xwide": the wide family's kernels (``kernel_family``; no spill, CUDA
#: 12.8 on an H100, the same at every NW: WT is a run-time field): K1's
#: two (standalone and window form) bound by __launch_bounds__ to four
#: blocks of 128 threads an SM, 128 registers; the tails' to three; K3's
#: to one block of 512 threads (122 registers).
#: A block's threads are capped so that they hold their registers
#: (``max_threads``); chip_smoke.py's build phase fails where ptxas counts
#: more than this table.
REGISTERS = {
    "tb_fused": {(1, 16): 39, (1, 32): 39, (2, 16): 48, (2, 32): 48,
                 (2, 64): 48, (3, 16): 56, (3, 32): 56, (3, 64): 55,
                 (3, 128): 72, (4, 16): 71, (4, 32): 71, (4, 64): 77,
                 (4, 128): 112,
                 (5, 16): 71, (5, 32): 72, (5, 64): 96, (5, 256): 157,
                 (6, 16): 72, (6, 32): 72, (6, 64): 115, (6, 256): 160,
                 (7, 16): 92, (7, 32): 92, (8, 16): 93, (8, 32): 95,
                 "xwide": 128},
    "tail": {(1, 16): 42, (1, 32): 42, (2, 16): 48, (2, 32): 48,
             (2, 64): 47, (3, 16): 61, (3, 32): 61, (3, 64): 62,
             (3, 128): 72, (4, 16): 71, (4, 32): 74, (4, 64): 80,
             (4, 128): 96,
             (5, 16): 68, (5, 32): 68, (5, 64): 78, (5, 128): 95,
             (5, 256): 149, (6, 16): 72, (6, 32): 72, (6, 64): 98,
             (6, 256): 154, (7, 16): 80, (7, 32): 80, (8, 16): 93,
             (8, 32): 93,
             "xwide": 146},
    "dc_band": {(1, 16): 37, (1, 32): 37, (2, 16): 37, (2, 32): 37,
                (2, 64): 48, (3, 16): 52, (3, 32): 46, (3, 64): 56,
                (3, 128): 64, (4, 16): 54, (4, 32): 57, (4, 64): 68,
                (4, 128): 80,
                (5, 16): 62, (5, 32): 64, (5, 64): 84, (5, 128): 107,
                (5, 256): 149, (6, 16): 69, (6, 32): 69, (6, 64): 98,
                (6, 128): 112, (6, 256): 168, (7, 16): 77, (7, 32): 86,
                (7, 64): 110, (7, 128): 122, (7, 256): 195, (8, 16): 90,
                (8, 32): 89, (8, 64): 112, (8, 128): 142, (8, 256): 213,
                "xwide": 122},
}


#: K3's band placements, in C's numbering: "staged" through a ring of
#: wavefront steps in shared memory, written out lane-innermost by the whole
#: block; "direct" from each fill thread's registers
K3_PLACEMENTS = ("staged", "direct")
#: K3's block, and its band placement and ring chunk by KP: what
#: tools/torch_k3_sweep.py measured fastest (device ms summed over 2,048
#: and 4,096 lanes, W = 32 / 64 / 96 / 128 at k = 12, 24, 48, and W = 96 /
#: 128 at k = 64, 95, 96, 127 for KP = 128; NVIDIA H100 80GB HBM3, 700 W;
#: PERF.md section 6), the same at every NW.  16 lanes a block (256 or 512
#: threads; a staged band row leaves it as 64 B) was best or within 3 % of
#: it everywhere; direct wins at KP = 16 (staged is 18-53 % slower there:
#: the band fits L2), staged at KP = 32, 64 and 128 (2.0x to 12x).  The
#: chunk is the number of wavefront steps between two write-outs of the
#: ring (a power of two); at KP = 128, NW = 4 a ring of 2 x 4 steps does
#: not fit a 16-lane block, and chunks 1 and 2 were within 0.3 %.  KP =
#: 256 (k >= 128, W = 129..256) is staged too, at chunk 1: there a ring
#: slot is 2,052 words a lane (NWB = 8, 8 lanes), so two slots of one step
#: for 8 lanes are 131 KB; 16 lanes, or a chunk of 2, would be 262 KB, past
#: a block.  The lanes halve while the ring does not fit or the registers
#: cap the block (``_lanes``), and at NW = 5..8 only the placement named
#: here is instantiated.
K3_LANES = 16
K3_PLACEMENT = {16: "direct", 32: "staged", 64: "staged", 128: "staged",
                256: "staged"}
K3_CHUNK = {16: 8, 32: 8, 64: 4, 128: 2, 256: 1}


def kernel_family(cfg: AlignerConfig, name: str) -> str:
    """Which family runs kernel `name` (one of ``KERNELS``, or "tail" for
    K2 and K4, which share their route) at `cfg`: "xwide", the wide
    family's one kernel (``xwide_geometry``), or "template", the
    instantiation of `cfg`'s (NW, KP, NWB) (``tb_fused_geometry``,
    ``tail_geometry``, ``dc_band_geometry``).  The wide family runs all
    four at NW >= 9, and K1 and the tails at NW = 5..8 except at the (NW,
    KP) ``TEMPLATE_KEPT`` names; the templates run the rest."""
    family = _XW_FAMILY.get(name, name)
    if family not in ("tb_fused", "tail", "dc_band"):
        raise ValueError(f"no kernel {name!r}: one of {KERNELS} or 'tail'")
    if cfg.nw > TEMPLATE_NW:
        return "xwide"
    if cfg.nw <= NARROW_NW or family == "dc_band" or \
            (cfg.nw, levels_bucket(cfg.k)) in TEMPLATE_KEPT[family]:
        return "template"
    return "xwide"


@dataclasses.dataclass(frozen=True)
class TbFusedGeometry:
    group: int                  #: G, threads per lane
    levels_per_thread: int      #: L = KP / G
    lanes: int                  #: lanes per block
    threads: int                #: threads per block
    shared_bytes: int           #: dynamic shared memory per block
    band_words: int             #: int32 words of a lane's DENT band in
                                #: shared memory, pads included ("shared"),
                                #: else 0
    placement: str = "shared"   #: where a lane's band lives (PLACEMENTS)
    store_words: int = 0        #: int32 words of a lane's band in device
                                #: memory ("global"), else 0


@dataclasses.dataclass(frozen=True)
class TailGeometry:
    group: int                  #: G, threads per lane
    levels_per_thread: int      #: L = KP / G
    lanes: int                  #: lanes per block
    threads: int                #: threads per block
    placement: str              #: where a lane's store lives (PLACEMENTS)
    shared_bytes: int           #: dynamic shared memory per block
    store_words: int            #: int32 words of a lane's store in device
                                #: memory ("global"), else 0
    shared_store_words: int     #: int32 words of a lane's store in shared
                                #: memory, pads included ("shared"), else 0


@dataclasses.dataclass(frozen=True)
class DcBandGeometry:
    group: int                  #: G, threads per lane
    levels_per_thread: int      #: L = KP / G
    lanes: int                  #: lanes per block
    threads: int                #: threads per block
    placement: str              #: how the band leaves (K3_PLACEMENTS)
    chunk: int                  #: steps between the ring's write-outs
    lane_stride: int            #: words of a lane in a ring slot ("staged")
    shared_bytes: int           #: dynamic shared memory per block


def check_scratch_fits(cfg: AlignerConfig, free_bytes: int) -> None:
    """Raise ValueError where one block of a wide kernel (each kernel that
    ``kernel_family`` gives the wide family at `cfg`) cannot hold its
    scratch: every W and k < W has a kernel, so the one refusal is one
    lane whose scratch (K1's band, the tail's store at the aligner's W +
    4k text columns in K4's and K2's width, with the register fill's
    buffers; K3's buffers) exceeds ``MEMORY_SHARE`` of the card's
    `free_bytes`.  The error names W, k and the bytes
    (``xwide_geometry``).  A template's kernel is not checked: its store
    is a lane's each."""
    for name in ("tb_fused", "dc_band", "tail_full", "tail_banded"):
        if kernel_family(cfg, name) == "xwide":
            xwide_geometry(cfg, name, free_bytes=free_bytes)


def levels_bucket(k: int) -> int:
    """KP: the smallest level capacity (a power of two, 16 or more) >=
    k+1; the templates are instantiated at KP = 16 .. 256."""
    kp = 16
    while kp < k + 1:
        kp *= 2
    return kp


def registers(kernel: str, cfg: AlignerConfig) -> int:
    """The registers a thread of `kernel`'s ("tb_fused", "tail" or
    "dc_band") instantiation for `cfg` takes (``REGISTERS``; the wide
    family's one kernel where ``kernel_family`` names it)."""
    if kernel_family(cfg, kernel) == "xwide":
        return REGISTERS[kernel]["xwide"]
    return REGISTERS[kernel][(cfg.nw, levels_bucket(cfg.k))]


def max_threads(kernel: str, cfg: AlignerConfig) -> int:
    """The most threads (whole warps, <= 1,024) a block of `kernel`'s
    instantiation for `cfg` may have: a warp's registers are allocated in
    units of 256 (8 a thread), a block holds 65,536.  At 255 registers a
    thread that is 256 threads, never less than a warp."""
    per_warp = 32 * -(-registers(kernel, cfg) // 8) * 8
    return min(1024, MAX_BLOCK_REGISTERS // per_warp * 32)


def _half_bank_pad(words: int) -> int:
    """The smallest count >= words that is 16 mod 32."""
    return words + (16 - words % 32) % 32


def _shared_store_words(levels: int, cols: int, nwb: int) -> int:
    """Words of one lane's store in shared memory: `levels` rows of
    ``cols * nwb`` words (plus one where that makes the row stride minus
    nwb even), padded to 16 mod 32 words."""
    row_words = cols * nwb + (1 if nwb * (cols - 1) % 2 == 0 else 0)
    return _half_bank_pad(levels * row_words)


def _odd_multiple(words: int, r: int) -> int:
    """The smallest odd multiple of r that is >= words."""
    return (-(-words // r) | 1) * r


def _group(k: int) -> tuple[int, int]:
    """(G, L): min(KP, 32) threads per lane, KP / G levels each."""
    kp = levels_bucket(k)
    return min(kp, 32), kp // min(kp, 32)


def _lanes(threads: int | None, default: int, group: int, block_bytes,
           what: str, cap: int) -> int:
    """Lanes per block: ``threads / G`` for the given whole-warp block
    (``_fit_registers`` checks it against `cap` once its other checks
    pass), else ``default / G`` halved while the block exceeds `cap`, the
    threads the instantiation's registers allow, or ``block_bytes(lanes)``
    (the block's shared bytes) exceeds the card's limit, down to one warp
    (`cap` is never less than a warp)."""
    if threads is not None:
        if threads % 32 or not 32 <= threads <= 1024:
            raise ValueError(f"threads={threads}: {what}'s block is whole "
                             f"warps, 32..1024 threads")
        return threads // group
    lanes = default // group
    while lanes * group > cap or (block_bytes(lanes) > MAX_SHARED_BYTES
                                  and lanes * group > 32):
        lanes //= 2
    return lanes


def _fit_registers(threads: int, cap: int, what: str) -> None:
    """Raise ValueError where a given block of `threads` exceeds `cap`,
    the threads its instantiation's registers allow."""
    if threads > cap:
        raise ValueError(f"threads={threads}: {what}'s registers allow "
                         f"{cap} threads a block (65,536 registers)")


# --------------------------------------------------------------------------
# the wide family (csrc/genasm_xwide_reg.cuh and *_xwide.cu; K1 and the
# tails from NW = 5, K3 from NW = 9, ``kernel_family``): one kernel each for
# K1, K2/K4 and K3, NW, k and NWB at run time, on a persistent grid, all on
# the register fill (one warp a lane; xr_layout and xr_k3_layout in C
# compute the same sizes)
# --------------------------------------------------------------------------

#: the share of the card's free memory the wide family's scratch may take
#: (the rest is the batch's tensors and the other kernels')
MEMORY_SHARE = 0.5
#: the register fill (K1, K2/K4): levels a thread holds (C's XR_LEVELS),
#: steps between two stagings of a warp's text (XR_TEXT_CHUNK), rows of its
#: staged masks (the four symbols and all ones), lanes (warps) a block, and
#: the SMs whose blocks the grid should fill where free memory caps it
XR_LEVELS = 7
XR_TEXT_CHUNK = 128
XR_MASK_ROWS = 5
XR_LANES = 4
SMS = 132
#: K3's block: lane warps (16, a band row word of the block's lanes two 32 B
#: sectors; 8, one sector, was 16-65 % slower at W = 512 on 2,048 lanes,
#: PERF.md section 6; C's XR_K3_THREADS allows 16) and the steps between two
#: flushes of its staging buffer (halved, down to 2, while the block's
#: shared memory exceeds its share of an SM, ``_k3_shared_budget``)
XR_K3_LANES = 16
XR_K3_CHUNK = 8


@dataclasses.dataclass(frozen=True)
class XwideGeometry:
    lanes: int                  #: lanes a block (a lane group), one warp
                                #: each
    words: int                  #: WT: word threads a level group, one
                                #: word each (16 or 32)
    depth: int                  #: GW: level groups a warp
    threads: int                #: 32 x lanes
    shared_bytes: int           #: dynamic shared memory per block
    store_words: int            #: int32 words of a lane's store in the
                                #: block's scratch (K1's band, the tails'
                                #: store; K3: 0, its band is the output)
    nwb: int                    #: words of a stored window
    levels: int = 0             #: L, levels a thread
    strips: int = 0             #: level strips of GW x L levels
    word_strips: int = 0        #: word strips of WT words
    lane_words: int = 0         #: scratch words a lane: its store, the
                                #: level below a strip, the word strips'
                                #: carries (K3: and raw top words)
    chunk: int = 0              #: K3: steps between two flushes of its
                                #: staging buffer; else 0

    @property
    def block_words(self) -> int:
        """int32 words of one block's scratch in device memory: its lanes'
        stores and buffers."""
        return self.lane_words * self.lanes


def xr_layout(nw: int, k: int, nwb: int, cols: int, jlo: int,
              last_max: int) -> dict:
    """The register fill's layout of one lane warp (C's ``xr_layout``):
    WT word threads (8 where nw <= 8, 16 where nw <= 16, else 32) a level
    group, GW = 32 / WT groups a warp of ``XR_LEVELS`` levels, H = GW x L
    levels a strip;
    shared bytes a warp (the staged masks, 5 x 32 words, and text, u16 a
    step of a chunk plus H); a stored column's nwbr raw words (nwb, plus
    one where the window is narrower than the vector) and a stored row's
    slots nwbs (nwbr; at nw <= 8 eight, one 32 B sector, which the group's
    8 word threads write whole); and the scratch words of a lane: its store
    ((k+1) x `cols` rows of nwbs words), the buffer of the level below a
    strip (`last_max` x nw, where there are several strips and the store
    does not hold full columns from column 1: a store, nwb = nw and `jlo`
    <= 1) and the word strips' carries, at nw <= 8 rounded up to a
    multiple of 8 words (each lane's scratch starts on a sector)."""
    wt = 8 if nw <= 8 else 16 if nw <= 16 else 32
    gw = 32 // wt
    height = gw * XR_LEVELS
    strips = -(-(k + 1) // height)
    word_strips = -(-nw // wt)
    nwbr = nwb + (1 if nwb < nw else 0)
    nwbs = 8 if nw <= 8 else nwbr
    store = (k + 1) * cols * nwbs
    below_in_store = cols > 0 and nwb == nw and jlo <= 1
    below = last_max * nw if strips > 1 and not below_in_store else 0
    carry = 2 * (last_max + height - 1) if word_strips > 1 else 0
    lane = store + below + carry
    return dict(wt=wt, gw=gw, height=height, strips=strips,
                word_strips=word_strips, below_in_store=below_in_store,
                warp_bytes=4 * XR_MASK_ROWS * 32
                + 2 * (XR_TEXT_CHUNK + height),
                nwbr=nwbr, nwbs=nwbs, store_words=store, below_words=below,
                carry_words=carry,
                lane_words=-(-lane // 8) * 8 if nw <= 8 else lane)


def xr_k3_layout(nw: int, k: int, nwb: int, W: int, ncb: int, lanes: int,
                 chunk: int) -> dict:
    """K3's layout (C's ``xr_k3_layout``): the fill's (``xr_layout`` with
    no store, so the level below a strip is in the lane's buffer), a
    lane's raw top words of a word strip for the next (two buffers of
    ``last + H - 1`` steps x ``XR_LEVELS``, where there are word strips),
    and the block's two staging buffers of `chunk` steps x H levels, a row
    the `lanes` lanes of ``lane_stride`` words each (the raw words a window
    spans, nwb + 1, in the odd multiple of 32 / lanes above nwb: a flush's
    warp reads 32 banks), padded to 16 mod 32 words (the two level groups
    of a warp write opposite halves of the banks).  Shared bytes: the
    warps' masks and text, then the buffers."""
    x = xr_layout(nw, k, nwb, 0, W + 1 - ncb, W)
    lane_stride = _odd_multiple(nwb + 1, 32 // lanes)
    row_stride = _half_bank_pad(lanes * lane_stride)
    buf = chunk * x["height"] * row_stride
    raw = 2 * (W + x["height"] - 1) * XR_LEVELS if x["word_strips"] > 1 \
        else 0
    return dict(x, lane_stride=lane_stride, row_stride=row_stride,
                buf_words=buf, raw_words=raw,
                lane_words=x["lane_words"] + raw,
                smem=lanes * x["warp_bytes"] + 8 * buf)


#: the register family (``REGISTERS``) and the name in errors of each
#: kernel of ``KERNELS``
_XW_FAMILY = {"tb_fused": "tb_fused", "tail_banded": "tail",
              "tail_full": "tail", "dc_band": "dc_band"}
_XW_LABEL = {"tb_fused": "K1", "tail_banded": "K2", "tail_full": "K4",
             "dc_band": "K3"}


def _xw_refuse(cfg: AlignerConfig, name: str, need: int, free_bytes: int):
    raise ValueError(
        f"W={cfg.W} k={cfg.k}: one block of the wide {_XW_LABEL[name]} "
        f"needs {need:,} B of scratch, more than {MEMORY_SHARE:g} of the "
        f"card's {free_bytes:,} B free")


def _k3_shared_budget(cfg: AlignerConfig, lanes: int) -> int:
    """Shared bytes a K3 block of `lanes` warps may take: the card's
    232,448 over the blocks an SM's registers hold (65,536 over the
    block's, at ``REGISTERS``' count rounded to 8 a thread)."""
    per_warp = 32 * -(-registers("dc_band", cfg) // 8) * 8
    return MAX_SHARED_BYTES // max(1, MAX_BLOCK_REGISTERS
                                   // (per_warp * lanes))


def xwide_geometry(cfg: AlignerConfig, name: str, n_text: int | None = None,
                   free_bytes: int | None = None) -> XwideGeometry:
    """The wide block of kernel `name` (``KERNELS``: its
    registers cap the threads) for `cfg`; tails at `n_text` columns
    (default W + 4k).  One warp a lane, WT word threads x GW level groups
    of ``XR_LEVELS`` levels (``xr_layout``).

    K1, K2 and K4: ``XR_LANES`` warps a block within the registers' cap; a
    lane's scratch is its store (K1's band, (k+1) x ncols_band rows; the
    tail's, (k+1) x n_text rows; nwbs words a row) and its buffers.  K3
    (``xr_k3_layout``): ``XR_K3_LANES`` warps a block, its staging buffer
    flushed every ``XR_K3_CHUNK`` steps, the chunk halved (down to 2)
    while the block's shared memory exceeds its share of an SM's
    (``_k3_shared_budget``), then the lanes while it exceeds 232,448 B; a
    lane's scratch is its buffers (the band is the output).  With the
    card's `free_bytes`, the lanes halve while the blocks that fit
    ``MEMORY_SHARE`` of them are fewer than ``SMS`` (so the grid still
    fills the card), and a lane whose scratch exceeds that share raises
    ValueError naming W, k and the bytes: the one refusal of the family.
    A configuration whose `name` runs its template (``kernel_family``)
    raises ValueError."""
    if kernel_family(cfg, name) != "xwide":
        raise ValueError(f"W={cfg.W} k={cfg.k}: {_XW_LABEL[name]} runs its "
                         f"template at NW = {cfg.nw}, KP = "
                         f"{levels_bucket(cfg.k)}, not the wide family")
    nw, k = cfg.nw, cfg.k
    nwb = cfg.nw if name == "tail_full" else cfg.nwb
    cap = max_threads(_XW_FAMILY[name], cfg)
    room = None if free_bytes is None else int(MEMORY_SHARE * free_bytes)
    chunk = 0
    if name == "dc_band":
        def layout(lanes, chunk):
            return xr_k3_layout(nw, k, nwb, cfg.W, cfg.ncols_band, lanes,
                                chunk)
        lanes = 1 << (min(XR_K3_LANES, cap // 32).bit_length() - 1)
        chunk = XR_K3_CHUNK
        while chunk > 2 and layout(lanes, chunk)["smem"] > \
                _k3_shared_budget(cfg, lanes):
            chunk //= 2
        while lanes > 1 and layout(lanes, chunk)["smem"] > MAX_SHARED_BYTES:
            lanes //= 2
    else:
        if name == "tb_fused":
            cols = cfg.ncols_band
            x = xr_layout(nw, k, nwb, cols, cfg.W + 1 - cols, cfg.W)
        else:
            cols = cfg.W + 4 * k if n_text is None else n_text
            x = xr_layout(nw, k, nwb, cols, 1, cols)
        lanes = max(1, min(XR_LANES, cap // 32))
        layout = lambda lanes, chunk: dict(                 # noqa: E731
            x, smem=lanes * x["warp_bytes"])
    lane_bytes = 4 * layout(lanes, chunk)["lane_words"]
    if room is not None:
        if lane_bytes > room:
            _xw_refuse(cfg, name, lane_bytes, free_bytes)
        while lanes > 1 and lane_bytes and \
                room // (lanes * lane_bytes) < SMS:
            lanes //= 2
    x = layout(lanes, chunk)
    return XwideGeometry(
        lanes=lanes, words=x["wt"], depth=x["gw"], threads=32 * lanes,
        shared_bytes=x["smem"], store_words=x["store_words"], nwb=nwb,
        levels=XR_LEVELS, strips=x["strips"], word_strips=x["word_strips"],
        lane_words=x["lane_words"], chunk=chunk)


def xwide_occupancy(name: str, geo: XwideGeometry) -> tuple[int, int]:
    """``tb_fused_occupancy`` for the wide kernel that runs `name`
    (``KERNELS``; K2 and K4 share one) at `geo`."""
    return _occupancy(f"{_XW_FAMILY[name]}_xwide", geo.threads,
                      geo.shared_bytes)


def xwide_blocks(geo: XwideGeometry, B: int, resident: int,
                 free_bytes: int | None = None) -> int:
    """Blocks of a wide kernel's persistent grid for B lanes: one a lane
    group, at most the `resident` blocks the card holds at once, and no
    more than fit ``MEMORY_SHARE`` of `free_bytes` (each block walks
    lane groups blockIdx, blockIdx + blocks, ... and reuses its scratch)."""
    blocks = min(-(-B // geo.lanes), resident)
    if free_bytes is not None and geo.block_words:
        blocks = min(blocks, int(MEMORY_SHARE * free_bytes)
                     // (4 * geo.block_words))
    return max(blocks, 1)


def _templates_only(cfg: AlignerConfig, name: str, what: str) -> None:
    """Raise ValueError where kernel `name` runs the wide family at `cfg`
    (``kernel_family``; no template covers NW >= 9): that family derives
    its own block (``xwide_geometry``)."""
    if cfg.nw > TEMPLATE_NW:
        raise ValueError(f"W={cfg.W} k={cfg.k}: {what}'s templates stop at "
                         f"NW = {TEMPLATE_NW}; NW = {cfg.nw} runs the wide "
                         f"family (xwide_geometry)")
    if kernel_family(cfg, name) == "xwide":
        raise ValueError(f"W={cfg.W} k={cfg.k}: {what} runs the wide "
                         f"family at NW = {cfg.nw}, KP = "
                         f"{levels_bucket(cfg.k)} (xwide_geometry)")


def tb_fused_geometry(cfg: AlignerConfig, max_ops: int | None = None,
                      threads: int | None = None, *,
                      window: bool = False) -> TbFusedGeometry:
    """K1's block for `cfg` and an op budget (default ``cfg.tb_max_ops``):
    G = min(KP, 32) threads per lane with L = KP / G levels each,
    ``K1_THREADS / G`` lanes per block, halved while the block's shared
    bytes exceed the card's 232,448 (W > 64), down to one warp; or
    ``threads / G`` for a given whole-warp block (the sweep tool; not
    checked against the limit).  The dynamic shared memory is the
    kernel's layout: per lane the band where ``K1_PLACEMENT[(NW, KP)]`` is
    "shared", k+1 rows of ``ncb * nwb`` words (plus one where that makes
    the row stride minus nwb even) padded to 16 mod 32 words, the text
    padded the same way, the staged ops and the lane's dist, and in K1's
    window form (`window`, ``window_step.genasm_tb_window``) the lane's
    pattern masks and its commit, ``k1_window_words(nw)``.  "global":
    the band in device memory instead, ``(ncb + rows0 - 1) * L * nwb *
    rows0`` words a lane, rows0 = ceil((k+1)/L) (the skewed layout of
    ``tb_fused.cu``).  Raises ValueError where one warp's lanes do not
    fit.  The block's threads are capped by the instantiation's registers
    (``max_threads``).  The template's configurations only
    (``_templates_only``)."""
    _templates_only(cfg, "tb_fused", "K1")
    max_ops = cfg.tb_max_ops if max_ops is None else max_ops
    group, levels = _group(cfg.k)
    placement = K1_PLACEMENT[(cfg.nw, levels_bucket(cfg.k))]
    band = store = 0
    if placement == "shared":
        band = _shared_store_words(cfg.k + 1, cfg.ncols_band, cfg.nwb)
    else:
        rows0 = -(-(cfg.k + 1) // levels)
        store = (cfg.ncols_band + rows0 - 1) * levels * cfg.nwb * rows0
    lane_words = band + _half_bank_pad(cfg.W) + max_ops + 1 + (
        k1_window_words(cfg.nw) if window else 0)
    cap = max_threads("tb_fused", cfg)
    lanes = _lanes(threads, K1_THREADS, group,
                   lambda n: 4 * n * lane_words, "K1", cap)
    if threads is None and 4 * lanes * lane_words > MAX_SHARED_BYTES:
        raise ValueError(f"W={cfg.W} k={cfg.k}: K1's {lanes} lane(s) of "
                         f"{4 * lane_words} B exceed a block's "
                         f"{MAX_SHARED_BYTES} B of shared memory")
    _fit_registers(lanes * group, cap, "K1")
    return TbFusedGeometry(group=group, levels_per_thread=levels,
                           lanes=lanes, threads=lanes * group,
                           shared_bytes=4 * lanes * lane_words,
                           band_words=band, placement=placement,
                           store_words=store)


def k1_window_words(nw: int) -> int:
    """Shared words a lane K1's window form adds to its block: the lane's
    four pattern masks (nw words each) and its commit (offset, ops)."""
    return 4 * nw + 2


def _uninstantiated_placement(cfg: AlignerConfig, placement: str,
                              named: str, what: str) -> None:
    """Raise ValueError where `placement` is not `named` (the table's) at
    NW > ``NARROW_NW``, which instantiates only the table's placement."""
    if cfg.nw > NARROW_NW and placement != named:
        raise ValueError(f"W={cfg.W} k={cfg.k}: {what} is instantiated "
                         f"{named!r} only at W > 128, not {placement!r}")


def dc_band_geometry(cfg: AlignerConfig, threads: int | None = None, *,
                     placement: str | None = None,
                     chunk: int | None = None) -> DcBandGeometry:
    """K3's block for `cfg`: G = min(KP, 32) threads per lane with L = KP /
    G levels each, ``K3_LANES`` lanes per block (fewer where the
    instantiation's registers cap the block, ``max_threads``, or its ring
    does not fit the shared memory: halved, down to one warp), or
    ``threads / G`` for a given whole-warp block (the sweep tool), and the
    band's way out, `placement` (default ``K3_PLACEMENT[KP]``; at W > 128
    only that one is instantiated).  The block's shared memory holds per
    lane the text (W codes padded to 16 mod 32 words) and, "staged", a
    ring of 2 x `chunk` (default ``K3_CHUNK[KP]``, a power of two)
    wavefront steps, each lanes x lane_stride words, lane_stride = KP *
    nwb rounded up to an odd multiple of 32 / min(lanes, 32) (the
    write-out's reads then fall in distinct banks).  "staged" needs 8 lanes a block
    or more, so that a band row leaves the block as a 32 B sector at
    least.  Raises ValueError for a block that does not fit.  The
    template's configurations only (``_templates_only``)."""
    _templates_only(cfg, "dc_band", "K3")
    if placement not in (None, *K3_PLACEMENTS):
        raise ValueError(f"placement={placement!r} is not one of "
                         f"{K3_PLACEMENTS}")
    group, levels = _group(cfg.k)
    kp = levels_bucket(cfg.k)
    placement = placement or K3_PLACEMENT[kp]
    _uninstantiated_placement(cfg, placement, K3_PLACEMENT[kp], "K3")
    chunk = K3_CHUNK[kp] if chunk is None else chunk
    if not 1 <= chunk <= 64 or chunk & (chunk - 1):
        raise ValueError(f"chunk={chunk}: K3's ring takes a power of two "
                         f"steps, 1..64")

    def stride(lanes):
        if placement != "staged":
            return 0
        return _odd_multiple(kp * cfg.nwb, 32 // min(lanes, 32))

    def block_bytes(lanes):
        return 4 * (lanes * _half_bank_pad(cfg.W)
                    + 2 * chunk * lanes * stride(lanes))

    cap = max_threads("dc_band", cfg)
    lanes = _lanes(threads, K3_LANES * group, group, block_bytes, "K3", cap)
    if placement == "staged" and lanes < 8:
        raise ValueError(f"W={cfg.W} k={cfg.k}: K3's staged band needs "
                         f"8 lanes a block or more (a row of 32 B), not "
                         f"{lanes}")
    lane_stride, shared = stride(lanes), block_bytes(lanes)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"W={cfg.W} k={cfg.k}: K3's block of {lanes} "
                         f"lanes needs {shared} B of shared memory, more "
                         f"than a block's {MAX_SHARED_BYTES} B")
    _fit_registers(lanes * group, cap, "K3")
    return DcBandGeometry(group, levels, lanes, lanes * group, placement,
                          chunk, lane_stride, shared)


def tail_geometry(cfg: AlignerConfig, n_text: int, max_ops: int, *,
                  banded: bool | None = None, placement: str | None = None,
                  threads: int | None = None) -> TailGeometry:
    """The block of the tail kernel (K2 where `banded`, default
    ``cfg.tail_banded``, else K4) for `cfg`, ``n_text`` text columns and
    an op budget: G = min(KP, 32) threads per lane with L = KP / G levels
    each, and the lane's store of k+1 levels x n_text columns x nwb words
    (K4: nw) where `placement` (default ``TAIL_PLACEMENT[(nw, KP)]``) puts
    it.  "shared": per lane k+1 rows of ``n_text * nwb`` words (plus one
    where that makes the row stride minus nwb even) padded to 16 mod 32;
    ``TAIL_THREADS / G`` lanes a block, halved while the block exceeds the
    card's shared memory, down to one warp; where even that does not fit,
    the store goes to "global" (a ValueError if "shared" was asked for).
    "global": ``(n_text + rows0 - 1) * L * nwb * rows0`` words of device
    memory a lane, rows0 = ceil((k+1)/L) (the skewed layout of
    ``tail_fused.cu``).  Either way the block's shared memory also holds
    per lane the text (padded to 16 mod 32 words), the staged ops and
    dist, and one word for the block.  At W > 128 only "global" is
    instantiated.  The block's threads are capped by the instantiation's
    registers (``max_threads``).  `threads` (whole warps) is for the
    sweep tool.  The template's configurations only
    (``_templates_only``)."""
    _templates_only(cfg, "tail", "the tail")
    banded = cfg.tail_banded if banded is None else banded
    k, nwb = cfg.k, cfg.nwb if banded else cfg.nw
    if placement not in (None, *PLACEMENTS):
        raise ValueError(f"placement={placement!r} is not one of "
                         f"{PLACEMENTS}")
    group, levels = _group(k)
    rows0 = -(-(k + 1) // levels)
    common = _half_bank_pad(n_text) + max_ops + 1
    cap = max_threads("tail", cfg)

    def block_bytes(lanes, store_lane_words):
        return 4 * (lanes * (store_lane_words + common) + 1)

    named = TAIL_PLACEMENT[(cfg.nw, levels_bucket(k))]
    want = placement or named
    _uninstantiated_placement(cfg, want, named, "the tail")
    if want == "shared":
        store_lane = _shared_store_words(k + 1, n_text, nwb)
        lanes = _lanes(threads, TAIL_THREADS, group,
                       lambda n: block_bytes(n, store_lane), "the tail", cap)
        if block_bytes(lanes, store_lane) <= MAX_SHARED_BYTES:
            _fit_registers(lanes * group, cap, "the tail")
            return TailGeometry(group, levels, lanes, lanes * group,
                                "shared", block_bytes(lanes, store_lane), 0,
                                store_lane)
        if placement == "shared":
            raise ValueError(f"W={cfg.W} k={cfg.k}: a tail lane's store "
                             f"of {4 * store_lane} B exceeds a block's "
                             f"{MAX_SHARED_BYTES} B of shared memory")
    lanes = _lanes(threads, TAIL_THREADS, group,
                   lambda n: block_bytes(n, 0), "the tail", cap)
    if block_bytes(lanes, 0) > MAX_SHARED_BYTES:
        raise ValueError(f"W={cfg.W} k={cfg.k}: the tail's {lanes} lane(s) "
                         f"need {block_bytes(lanes, 0)} B of shared memory, "
                         f"more than a block's {MAX_SHARED_BYTES} B")
    _fit_registers(lanes * group, cap, "the tail")
    return TailGeometry(group, levels, lanes, lanes * group, "global",
                        block_bytes(lanes, 0),
                        (n_text + rows0 - 1) * levels * nwb * rows0, 0)


def _occupancy(query, *args) -> tuple[int, int]:
    lib = _library()
    blocks, limit = ctypes.c_int(0), ctypes.c_int(0)
    name = f"genasm_{query}_occupancy"
    _check_rc(lib, name, getattr(lib, name)(*args, ctypes.byref(blocks),
                                            ctypes.byref(limit)))
    return blocks.value, limit.value


def tb_fused_occupancy(cfg: AlignerConfig,
                       geo: TbFusedGeometry) -> tuple[int, int]:
    """For K1's instantiation of `cfg` at block `geo` on the current card:
    the blocks one SM holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and the
    instantiation's dynamic shared-memory limit as the card reports it once
    ``geo.shared_bytes`` is allowed (``cudaFuncGetAttributes``)."""
    return _occupancy("tb_fused", cfg.nw, cfg.k, cfg.nwb,
                      PLACEMENTS.index(geo.placement), geo.threads,
                      geo.shared_bytes)


def tail_occupancy(cfg: AlignerConfig, geo: TailGeometry,
                   banded: bool | None = None) -> tuple[int, int]:
    """``tb_fused_occupancy`` for the tail kernel's instantiation of `cfg`
    (K2 where `banded`, default ``cfg.tail_banded``, else K4) at `geo`."""
    banded = cfg.tail_banded if banded is None else banded
    return _occupancy("tail", cfg.nw, cfg.k, cfg.nwb if banded else cfg.nw,
                      PLACEMENTS.index(geo.placement), geo.threads,
                      geo.shared_bytes)


def dc_band_occupancy(cfg: AlignerConfig,
                      geo: DcBandGeometry) -> tuple[int, int]:
    """``tb_fused_occupancy`` for K3's instantiation of `cfg` at `geo`."""
    return _occupancy("dc_band", cfg.nw, cfg.k, cfg.nwb,
                      K3_PLACEMENTS.index(geo.placement), geo.threads,
                      geo.shared_bytes)


#: blocks one SM holds of a wide kernel, by (family, threads, shared
#: bytes, device): the occupancy query runs once each
_RESIDENT = {}


def free_bytes(device) -> int:
    """Bytes of `device`'s memory a wide launch's scratch can take now:
    cudaMemGetInfo's free (read in relaxed capture mode, so also during a
    capture, where every earlier capture's pool is already taken off it),
    plus, outside a capture, the free blocks PyTorch's caching allocator
    holds in its default pool on the current stream (the pools of
    captured graphs, and other streams' blocks, are not the allocation's
    to use; a capture allocates from its own pool)."""
    device = torch.device(device)
    lib = _library()
    free = ctypes.c_ulonglong(0)
    with torch.cuda.device(device):
        _check_rc(lib, "genasm_mem_free",
                  lib.genasm_mem_free(ctypes.byref(free)))
        if torch.cuda.is_current_stream_capturing():
            return free.value
        stream = torch.cuda.current_stream(device).cuda_stream
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        cached = sum(
            seg["total_size"] - seg["active_size"]
            for seg in torch.cuda.memory_snapshot()
            if seg.get("device") == index and seg.get("stream") == stream
            and tuple(seg.get("segment_pool_id", ())) == (0, 0))
    return free.value + cached


def xwide_resident(name: str, geo: XwideGeometry, device) -> int:
    """Blocks of the wide kernel that runs `name` at `geo` the card holds
    at once: blocks an SM x SMs."""
    device = torch.device(device)
    key = (_XW_FAMILY[name], geo.threads, geo.shared_bytes, device)
    if key not in _RESIDENT:
        with torch.cuda.device(device):
            per_sm = xwide_occupancy(name, geo)[0]
        _RESIDENT[key] = per_sm * torch.cuda.get_device_properties(
            device).multi_processor_count
    return _RESIDENT[key]


def _xwide_launch(name: str, cfg: AlignerConfig, tensors, ints,
                  n_text: int | None = None, *, B: int | None = None,
                  entry: str | None = None) -> None:
    """Launch the wide kernel of `name` (its count; entry point
    ``genasm_<entry>_launch``, default ``<name>_xwide``) at the block
    ``xwide_geometry`` gives for the card's free memory now, on a
    persistent grid (``xwide_blocks``) of B lanes (default the last axis
    of the first tensor) with the scratch its blocks reuse."""
    device = tensors[0].device
    B = tensors[0].shape[-1] if B is None else B
    free = free_bytes(device)
    geo = xwide_geometry(cfg, name, n_text, free)
    blocks = xwide_blocks(geo, B, xwide_resident(name, geo, device), free)
    scratch = _store(blocks, geo.block_words, device)
    if name == "dc_band":
        block = (geo.lanes, geo.threads, geo.shared_bytes, geo.chunk,
                 geo.lane_words)
    else:
        block = (geo.lanes, geo.threads, geo.shared_bytes, geo.store_words,
                 geo.lane_words)
    _launch(name, *tensors, scratch, ints=ints, block=(*block, blocks),
            entry=entry or f"{name}_xwide")


def genasm_tb_fused(pm, text, *, cfg: AlignerConfig, commit_limit: int,
                    max_ops: int, max_steps: int):
    """K1: fused DC+TB of square W x W windows.  Returns (ops, meta)."""
    cuda = _check_inputs(cfg, pm, text, cfg.W)
    if not cuda:
        _bump(PLAIN_CALLS, "tb_fused")
        return tb_fused_plain(pm, text, cfg=cfg, commit_limit=commit_limit,
                              max_ops=max_ops, max_steps=max_steps)
    B = pm.shape[-1]
    ops, meta = _outputs(max_ops, B, pm.device)
    ints = (B, cfg.W, cfg.nw, cfg.k, cfg.nwb, cfg.ncols_band,
            int(cfg.early_term), commit_limit, max_ops, max_steps)
    if B and kernel_family(cfg, "tb_fused") == "xwide":
        _xwide_launch("tb_fused", cfg, (pm, text, ops, meta), ints)
    elif B:
        geo = tb_fused_geometry(cfg, max_ops)
        _launch("tb_fused", pm, text, ops, meta,
                _store(B, geo.store_words, pm.device), ints=ints,
                block=(geo.lanes, geo.threads,
                       PLACEMENTS.index(geo.placement), geo.shared_bytes))
    return ops, meta


def genasm_dc(pm, text, *, cfg: AlignerConfig):
    """K3: DC of square W x W windows, the DENT band written out.  Returns
    (dist (B,), band (k+1, ncols_band, nwb, B), levels (B,)), int32."""
    cuda = _check_inputs(cfg, pm, text, cfg.W)
    if not cuda:
        _bump(PLAIN_CALLS, "dc_band")
        return dc_band_plain(pm, text, cfg=cfg)
    B = pm.shape[-1]
    dist, levels = (torch.empty(B, dtype=torch.int32, device=pm.device)
                    for _ in range(2))
    band = torch.empty((cfg.k + 1, cfg.ncols_band, cfg.nwb, B),
                       dtype=torch.int32, device=pm.device)
    if B and kernel_family(cfg, "dc_band") == "xwide":
        _xwide_launch("dc_band", cfg, (pm, text, band, dist, levels),
                      (B, cfg.W, cfg.nw, cfg.k, cfg.nwb, cfg.ncols_band,
                       int(cfg.early_term)))
    elif B:
        geo = dc_band_geometry(cfg)
        _launch("dc_band", pm, text, band, dist, levels,
                ints=(B, cfg.W, cfg.nw, cfg.k, cfg.nwb, cfg.ncols_band,
                      int(cfg.early_term)),
                block=(geo.lanes, geo.threads,
                       K3_PLACEMENTS.index(geo.placement), geo.chunk,
                       geo.shared_bytes))
    return dist, band, levels


def _tail(name, plain, banded, pm, text, m_len, n_len, *, cfg, n_text,
          commit_limit, max_ops, max_steps):
    cuda = _check_inputs(cfg, pm, text, n_text, (m_len, n_len))
    if not cuda:
        _bump(PLAIN_CALLS, name)
        return plain(pm, text, m_len, n_len, cfg=cfg, n_text=n_text,
                     commit_limit=commit_limit, max_ops=max_ops,
                     max_steps=max_steps)
    B = pm.shape[-1]
    ops, meta = _outputs(max_ops, B, pm.device)
    ints = (B, n_text, cfg.W, cfg.nw, cfg.k, cfg.nwb if banded else cfg.nw,
            int(cfg.early_term), commit_limit, max_ops, max_steps)
    if B and kernel_family(cfg, name) == "xwide":
        _xwide_launch(name, cfg, (pm, text, m_len, n_len, ops, meta), ints,
                      n_text)
    elif B:
        geo = tail_geometry(cfg, n_text, max_ops, banded=banded)
        _launch(name, pm, text, m_len, n_len, ops, meta,
                _store(B, geo.store_words, pm.device),
                ints=ints,
                block=(geo.lanes, geo.threads,
                       PLACEMENTS.index(geo.placement), geo.shared_bytes))
    return ops, meta


def genasm_tail_banded(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                       n_text: int, commit_limit: int, max_ops: int,
                       max_steps: int):
    """K2: rectangular tail with the per-lane diagonal band store."""
    return _tail("tail_banded", tail_banded_plain, True, pm, text, m_len,
                 n_len, cfg=cfg, n_text=n_text, commit_limit=commit_limit,
                 max_ops=max_ops, max_steps=max_steps)


def genasm_tail_full(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                     n_text: int, commit_limit: int, max_ops: int,
                     max_steps: int):
    """K4: rectangular tail with the full SENE store."""
    return _tail("tail_full", tail_full_plain, False, pm, text, m_len, n_len,
                 cfg=cfg, n_text=n_text, commit_limit=commit_limit,
                 max_ops=max_ops, max_steps=max_steps)


def genasm_tail_fused(pm, text, m_len, n_len, *, cfg: AlignerConfig,
                      n_text: int, commit_limit: int, max_ops: int,
                      max_steps: int):
    """The tail kernel ``cfg.tail_banded`` selects (K2, else K4)."""
    fn = genasm_tail_banded if cfg.tail_banded else genasm_tail_full
    return fn(pm, text, m_len, n_len, cfg=cfg, n_text=n_text,
              commit_limit=commit_limit, max_ops=max_ops, max_steps=max_steps)
