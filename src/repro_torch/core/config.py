"""Aligner configuration (PyTorch port of ``repro.core.config``).

``backend`` picks one of three execution paths, each the counterpart of a
reference backend (``repro_torch.convert`` maps a reference config):

  * ``'fused'`` (reference ``'pallas_fused'`` / ``'pallas_gpu'``): DC+TB
    fused in one kernel per window (K1) and per tail (K2 / K4);
  * ``'split'`` (reference ``'pallas'``): the DC kernel K3 writes the DENT
    band to device memory, a separate PyTorch traceback walks it; the tail
    is the plain ``dc_jmajor`` + traceback;
  * ``'plain'`` (reference ``'jnp'``): PyTorch fills (``core.genasm``)
    and traceback, no kernel; the only backend for the unimproved stores
    ``'edges4'`` and ``'and'``.

All three give the same results.  On the kernel backends the device of the
tensors decides between the hand-written CUDA kernels and their plain
PyTorch versions.  ``lane_tile`` is the batch pad unit only; the kernels
derive their own blocks (``kernels.genasm_dc``: ``tb_fused_geometry``,
``tail_geometry``, ``dc_band_geometry``).
"""
from __future__ import annotations

import dataclasses
import hashlib

from .bitops import WORD_BITS, n_words

#: valid knob choices, shared by validation, docs and tests
BACKENDS = ("fused", "split", "plain")
STORES = ("edges4", "and", "band")
TAIL_STORES = ("auto", "band", "full")


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    """GenASM window/threshold configuration.

    W, O follow GenASM (MICRO'20): align W-char windows, commit the first
    W-O traceback operations, advance.  ``k`` is the per-window edit budget.
    ``early_term`` is the paper's ET: only the level count reported in
    ``levels`` depends on it.  ``store`` is the traceback store of the
    main windows: 'edges4' all four M/S/D/I bitvectors (unimproved
    GenASM-TB), 'and' only R = M & S & D & I (SENE), 'band' the DENT band
    of R (SENE + DENT).  ``backend`` is one of BACKENDS (module docstring).
    ``tail_store`` picks the fused rectangular-tail kernel: 'band' the
    per-lane diagonal band store, 'full' the whole (k+1, n_text+1, NW)
    table, 'auto' the band whenever it is a strict win.
    """
    W: int = 64
    O: int = 24
    k: int = 12
    store: str = "band"
    early_term: bool = True
    tb_margin: int = 3          # extra stored columns beyond the provable band
    backend: str = "fused"
    lane_tile: int = 128        # the batch pad unit
    tail_store: str = "auto"

    def __post_init__(self):
        if not 0 < self.O < self.W:
            raise ValueError(f"O={self.O} must satisfy 0 < O < W "
                             f"(W={self.W}: the overlap is a strict part "
                             f"of every window)")
        if not 0 < self.k < self.W:
            raise ValueError(f"k={self.k} must satisfy 0 < k < W "
                             f"(W={self.W}: the edit budget cannot exceed "
                             f"the window)")
        if self.lane_tile <= 0:
            raise ValueError(f"lane_tile={self.lane_tile} must be a "
                             f"positive lane count")
        if self.store not in STORES:
            raise ValueError(f"store={self.store!r} is not one of {STORES}")
        if self.tail_store not in TAIL_STORES:
            raise ValueError(f"tail_store={self.tail_store!r} is not one "
                             f"of {TAIL_STORES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend={self.backend!r} is not one of "
                             f"{BACKENDS}")
        # the kernels implement the fully-improved (banded) DP only
        if self.backend != "plain" and self.store != "band":
            raise ValueError(f"backend={self.backend!r} requires "
                             f"store='band' (got store={self.store!r}): "
                             f"the CUDA kernels implement the banded DP "
                             f"only")

    @property
    def nw(self) -> int:
        """words per full bitvector (pattern dim padded to words)"""
        return n_words(self.W)

    @property
    def m_pad(self) -> int:
        return self.nw * WORD_BITS

    @property
    def nwb(self) -> int:
        """words per DENT band window: covers [center-k-1, center+k+1]."""
        need = 2 * self.k + 3
        return min(self.nw, -(-need // WORD_BITS))

    @property
    def stride(self) -> int:
        return self.W - self.O

    @property
    def tb_max_ops(self) -> int:
        """Op budget of one committed main-window traceback walk."""
        return self.stride + self.k + 2

    @property
    def tb_max_steps(self) -> int:
        return self.stride + self.k + 4

    @property
    def ncols_band(self) -> int:
        """columns (incl. col 0) kept by DENT column pruning: the traceback
        commits <= W-O read chars, hence visits <= W-O+k text columns."""
        return min(self.W + 1, self.stride + self.k + self.tb_margin)

    @property
    def tail_band_supported(self) -> bool:
        """The tail's band window (2k+3 bits) fits in fewer words than the
        full pattern vector, so the banded store is a strict win."""
        return self.nwb < self.nw

    @property
    def tail_banded(self) -> bool:
        """Resolved tail_store policy: does the tail kernel store the band?"""
        if self.tail_store == "band":
            return True
        if self.tail_store == "full":
            return False
        return self.tail_band_supported

    def replace(self, **overrides) -> "AlignerConfig":
        """A copy with `overrides` applied (re-validated by __post_init__)."""
        return dataclasses.replace(self, **overrides)

    def fingerprint(self) -> str:
        """Stable content hash of every knob: equal configs hash equal."""
        blob = ";".join(f"{f.name}={getattr(self, f.name)!r}"
                        for f in dataclasses.fields(self))
        return hashlib.sha1(blob.encode()).hexdigest()[:16]

    def band_base(self, j: int, m_pad: int | None = None) -> int:
        """Lowest stored bit of column j's band window (static per column
        for square W x W windows: band center = j-1)."""
        m_pad = m_pad or self.m_pad
        return max(0, min(j - 2 - self.k, m_pad - WORD_BITS * self.nwb))


def resolve_config(cfg: AlignerConfig | None = None,
                   **overrides) -> AlignerConfig:
    """One validated AlignerConfig from a config (None = defaults) plus
    keyword overrides; None-valued overrides are ignored, unknown knob
    names raise TypeError even when None."""
    cfg = cfg if cfg is not None else AlignerConfig()
    unknown = set(overrides) - {f.name
                                for f in dataclasses.fields(AlignerConfig)}
    if unknown:
        raise TypeError(f"unknown AlignerConfig knobs: {sorted(unknown)}")
    real = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(cfg, **real) if real else cfg
