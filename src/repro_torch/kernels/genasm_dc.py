"""The GenASM kernels: wrappers, launch counts and plain versions.

Four kernels, each a port of a Pallas TPU kernel of
``repro/kernels/genasm_dc.py`` and written by hand in CUDA C++ in
``csrc/`` (``tb_fused.cu``, ``tail_fused.cu``, ``dc_band.cu``):

  * K1 ``genasm_tb_fused``    <- ``_kernel_fused``: improved GenASM-DC
    (SENE + DENT + ET) of a square W x W window, then the traceback walked
    in the same kernel over the stored DENT band.
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
memory; the tails keep their store in shared or device memory, whichever
``TAIL_PLACEMENT`` names; K3 writes its band out through a ring in shared
memory or straight from registers, whichever ``K3_PLACEMENT`` names).
``cfg.lane_tile`` sets no block: it is only the batch pad unit
(``kernels.ops``).  The kernels are instantiated for W <= 128 and
k + 1 <= 64; any other configuration raises ValueError on the card.

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
        rec[name] += 1


def reset_counts() -> None:
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
    lane's n_len frozen: the same column-major SENE recurrence the kernels
    run.  text: (n, B) kernel layout."""
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


def _library():
    from .build import load_library
    return load_library()


def _check_rc(lib, what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({lib.genasm_error_string(rc).decode()})")


def _launch(name, *tensors, ints, block=()):
    """Launch kernel `name` of the CUDA library on the current stream of
    the tensors' device, with the block geometry ``block`` its entry point
    takes; raise if the launch is refused."""
    lib = _library()
    fn = getattr(lib, f"genasm_{name}_launch")
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
PLACEMENTS = ("shared", "global")   #: the tails' store, in C's numbering
#: where the tails keep a lane's store, by (NW, KP): the placement that
#: tools/torch_tail_sweep.py measured faster (the sum of its device ms at
#: 2,048 and 4,096 lanes, 128 threads a block, W = 32 / 64 / 96 / 128 at
#: k = 12, 24, 48; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6).  K2
#: and K4 share it.  Shared memory wins only where a lane's store is small
#: (KP = 16 at NW <= 2, and NW = 1); global wherever one lane's store does
#: not fit a block.
TAIL_PLACEMENT = {(1, 16): "shared", (1, 32): "shared",
                  (2, 16): "shared", (2, 32): "global", (2, 64): "global",
                  (3, 16): "global", (3, 32): "global", (3, 64): "global",
                  (4, 16): "global", (4, 32): "global", (4, 64): "global"}


#: K3's band placements, in C's numbering: "staged" through a ring of
#: wavefront steps in shared memory, written out lane-innermost by the whole
#: block; "direct" from each fill thread's registers
K3_PLACEMENTS = ("staged", "direct")
#: K3's block, and its band placement and ring chunk by KP: what
#: tools/torch_k3_sweep.py measured fastest (device ms summed over 2,048
#: and 4,096 lanes, W = 32 / 64 / 96 / 128 at k = 12, 24, 48; NVIDIA H100
#: 80GB HBM3, 700 W; PERF.md section 6), the same at every NW.  16 lanes a
#: block (256 or 512 threads; a staged band row leaves it as 64 B) was
#: best or within 3 % of it everywhere; direct wins at KP = 16 (staged is
#: 18-53 % slower there: the band fits L2), staged at KP = 32 and 64
#: (2.0x to 10x).  The chunk is the number of wavefront steps between two
#: write-outs of the ring (a power of two).
K3_LANES = 16
K3_PLACEMENT = {16: "direct", 32: "staged", 64: "staged"}
K3_CHUNK = {16: 8, 32: 8, 64: 4}


@dataclasses.dataclass(frozen=True)
class TbFusedGeometry:
    group: int                  #: G, threads per lane
    levels_per_thread: int      #: L = KP / G
    lanes: int                  #: lanes per block
    threads: int                #: threads per block
    shared_bytes: int           #: dynamic shared memory per block
    band_words: int             #: int32 words of a lane's DENT band in
                                #: shared memory, pads included


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


def check_instantiated(cfg: AlignerConfig) -> None:
    """Raise ValueError unless the CUDA kernels are instantiated for
    `cfg`: W <= 128 (four words a bitvector) and k + 1 <= 64 levels."""
    if cfg.nw > 4 or cfg.k + 1 > 64:
        raise ValueError(f"W={cfg.W} k={cfg.k}: the CUDA kernels are "
                         f"instantiated for W <= 128 and k + 1 <= 64")


def levels_bucket(k: int) -> int:
    """KP: the smallest instantiated level capacity (16, 32, 64) >= k+1."""
    for kp in (16, 32, 64):
        if k + 1 <= kp:
            return kp
    raise ValueError(f"k={k}: the CUDA kernels are instantiated for "
                     f"k + 1 <= 64")


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
           what: str) -> int:
    """Lanes per block: ``threads / G`` for the given whole-warp block,
    else ``default / G`` halved while ``block_bytes(lanes)`` (the block's
    shared bytes) exceeds the card's limit, down to one warp."""
    if threads is not None:
        if threads % 32 or not 32 <= threads <= 1024:
            raise ValueError(f"threads={threads}: {what}'s block is whole "
                             f"warps, 32..1024 threads")
        return threads // group
    lanes = default // group
    while block_bytes(lanes) > MAX_SHARED_BYTES and lanes * group > 32:
        lanes //= 2
    return lanes


def tb_fused_geometry(cfg: AlignerConfig, max_ops: int | None = None,
                      threads: int | None = None) -> TbFusedGeometry:
    """K1's block for `cfg` and an op budget (default ``cfg.tb_max_ops``):
    G = min(KP, 32) threads per lane with L = KP / G levels each,
    ``K1_THREADS / G`` lanes per block, halved while the block's shared
    bytes exceed the card's 232,448 (W > 64), down to one warp; or
    ``threads / G`` for a given whole-warp block (the sweep tool; not
    checked against the limit).  The dynamic shared memory is the
    kernel's layout: per lane the band, k+1 rows of ``ncb * nwb`` words
    (plus one where that makes the row stride minus nwb even) padded to 16
    mod 32 words, the text padded the same way, the staged ops and the
    lane's dist.  Raises ValueError where one warp's lanes do not fit."""
    check_instantiated(cfg)
    max_ops = cfg.tb_max_ops if max_ops is None else max_ops
    group, levels = _group(cfg.k)
    band = _shared_store_words(cfg.k + 1, cfg.ncols_band, cfg.nwb)
    lane_words = band + _half_bank_pad(cfg.W) + max_ops + 1
    lanes = _lanes(threads, K1_THREADS, group,
                   lambda n: 4 * n * lane_words, "K1")
    if threads is None and 4 * lanes * lane_words > MAX_SHARED_BYTES:
        raise ValueError(f"W={cfg.W} k={cfg.k}: K1's {lanes} lane(s) of "
                         f"{4 * lane_words} B exceed a block's "
                         f"{MAX_SHARED_BYTES} B of shared memory")
    return TbFusedGeometry(group=group, levels_per_thread=levels,
                           lanes=lanes, threads=lanes * group,
                           shared_bytes=4 * lanes * lane_words,
                           band_words=band)


def dc_band_geometry(cfg: AlignerConfig, threads: int | None = None, *,
                     placement: str | None = None,
                     chunk: int | None = None) -> DcBandGeometry:
    """K3's block for `cfg`: G = min(KP, 32) threads per lane with L = KP /
    G levels each, ``K3_LANES`` lanes per block, or ``threads / G`` for a
    given whole-warp block (the sweep tool), and the band's way out,
    `placement` (default ``K3_PLACEMENT[KP]``).  The block's shared
    memory holds per lane the text (W codes padded to 16 mod 32 words) and,
    "staged", a ring of 2 x `chunk` (default ``K3_CHUNK[KP]``, a power of
    two) wavefront steps, each lanes x lane_stride words, lane_stride =
    KP * nwb rounded up to an odd multiple of 32 / min(lanes, 32) (the
    write-out's reads then fall in distinct banks).  "staged" needs 8 lanes a block
    or more, so that a band row leaves the block as a 32 B sector at
    least.  Raises ValueError for a block that does not fit."""
    check_instantiated(cfg)
    if placement not in (None, *K3_PLACEMENTS):
        raise ValueError(f"placement={placement!r} is not one of "
                         f"{K3_PLACEMENTS}")
    group, levels = _group(cfg.k)
    kp = levels_bucket(cfg.k)
    lanes = _lanes(threads, K3_LANES * group, group, lambda n: 0, "K3")
    placement = placement or K3_PLACEMENT[kp]
    chunk = K3_CHUNK[kp] if chunk is None else chunk
    if not 1 <= chunk <= 64 or chunk & (chunk - 1):
        raise ValueError(f"chunk={chunk}: K3's ring takes a power of two "
                         f"steps, 1..64")
    lane_stride = 0
    if placement == "staged":
        if lanes < 8:
            raise ValueError(f"W={cfg.W} k={cfg.k}: K3's staged band needs "
                             f"8 lanes a block or more (a row of 32 B), not "
                             f"{lanes}")
        lane_stride = _odd_multiple(kp * cfg.nwb, 32 // min(lanes, 32))
    shared = 4 * (lanes * _half_bank_pad(cfg.W)
                  + 2 * chunk * lanes * lane_stride)
    if shared > MAX_SHARED_BYTES:
        raise ValueError(f"W={cfg.W} k={cfg.k}: K3's block of {lanes} "
                         f"lanes needs {shared} B of shared memory, more "
                         f"than a block's {MAX_SHARED_BYTES} B")
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
    dist, and one word for the block.  `threads` (whole warps) is for the
    sweep tool."""
    check_instantiated(cfg)
    if placement not in (None, *PLACEMENTS):
        raise ValueError(f"placement={placement!r} is not one of "
                         f"{PLACEMENTS}")
    banded = cfg.tail_banded if banded is None else banded
    k, nwb = cfg.k, cfg.nwb if banded else cfg.nw
    group, levels = _group(k)
    rows0 = -(-(k + 1) // levels)
    common = _half_bank_pad(n_text) + max_ops + 1

    def block_bytes(lanes, store_lane_words):
        return 4 * (lanes * (store_lane_words + common) + 1)

    want = placement or TAIL_PLACEMENT[(cfg.nw, levels_bucket(k))]
    if want == "shared":
        store_lane = _shared_store_words(k + 1, n_text, nwb)
        lanes = _lanes(threads, TAIL_THREADS, group,
                       lambda n: block_bytes(n, store_lane), "the tail")
        if block_bytes(lanes, store_lane) <= MAX_SHARED_BYTES:
            return TailGeometry(group, levels, lanes, lanes * group,
                                "shared", block_bytes(lanes, store_lane), 0,
                                store_lane)
        if placement == "shared":
            raise ValueError(f"W={cfg.W} k={cfg.k}: a tail lane's store "
                             f"of {4 * store_lane} B exceeds a block's "
                             f"{MAX_SHARED_BYTES} B of shared memory")
    lanes = _lanes(threads, TAIL_THREADS, group,
                   lambda n: block_bytes(n, 0), "the tail")
    if block_bytes(lanes, 0) > MAX_SHARED_BYTES:
        raise ValueError(f"W={cfg.W} k={cfg.k}: the tail's {lanes} lane(s) "
                         f"need {block_bytes(lanes, 0)} B of shared memory, "
                         f"more than a block's {MAX_SHARED_BYTES} B")
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
    return _occupancy("tb_fused", cfg.nw, cfg.k, cfg.nwb, geo.threads,
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
    if B:
        geo = tb_fused_geometry(cfg, max_ops)
        _launch("tb_fused", pm, text, ops, meta,
                ints=(B, cfg.W, cfg.nw, cfg.k, cfg.nwb, cfg.ncols_band,
                      int(cfg.early_term), commit_limit, max_ops, max_steps),
                block=(geo.lanes, geo.threads, geo.shared_bytes))
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
    if B:
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
    if B:
        geo = tail_geometry(cfg, n_text, max_ops, banded=banded)
        store = torch.empty((B, geo.store_words) if geo.store_words else 0,
                            dtype=torch.int32, device=pm.device)
        _launch(name, pm, text, m_len, n_len, ops, meta, store,
                ints=(B, n_text, cfg.W, cfg.nw, cfg.k,
                      cfg.nwb if banded else cfg.nw, int(cfg.early_term),
                      commit_limit, max_ops, max_steps),
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
