"""Host<->device transfer accounting (port of ``repro/core/transfer.py``).

Every upload and download of a batch goes through ``to_device`` /
``to_host``, so a run can show the transfer contract: one upload and one
download per batch for ``rescue_mode='device'`` however many rescue rounds
run, and one more of each per compacted rescue-rung dispatch of the
session's ``rescue_mode='bucket'``.

Two ways of counting, fed by the same calls:

* process-wide, on the port's default :mod:`repro_torch.obs` registry
  (``transfer_h2d_calls_total`` etc.), read by :func:`stats` and cleared
  by :func:`reset` (this family only, never the whole registry), as the
  reference counts.  The session's transfers count only here;
* per aligner, a ``TransferStats`` whose ``to_device`` / ``to_host``
  count on the object too (``GenASMAligner.transfers``), with
  ``gate_syncs``: the rescue ladder's round gate is a host check of
  ``failed.any()``, a device-to-host sync counted apart from the
  downloads.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs import default_registry

# the session's background retire executor downloads concurrently with the
# dispatch thread's uploads; Counter.inc is locked, so the counts stay
# exact for the 1-upload/1-download assertions
_REG = default_registry()
_H2D_CALLS = _REG.counter("transfer_h2d_calls_total")
_H2D_BYTES = _REG.counter("transfer_h2d_bytes_total")
_D2H_CALLS = _REG.counter("transfer_d2h_calls_total")
_D2H_BYTES = _REG.counter("transfer_d2h_bytes_total")


def reset() -> None:
    for c in (_H2D_CALLS, _H2D_BYTES, _D2H_CALLS, _D2H_BYTES):
        c.reset()


def stats() -> "TransferStats":
    """Snapshot of the process-wide counters since the last reset()."""
    return TransferStats(h2d_calls=_H2D_CALLS.value,
                         h2d_bytes=_H2D_BYTES.value,
                         d2h_calls=_D2H_CALLS.value,
                         d2h_bytes=_D2H_BYTES.value)


def to_device(arrays, device) -> tuple:
    """Upload a tuple of numpy arrays to `device`; counts as ONE
    transfer."""
    _H2D_CALLS.inc()
    _H2D_BYTES.inc(sum(int(a.nbytes) for a in arrays))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def to_host(tensors: dict) -> dict:
    """Download a dict of tensors as numpy; counts as ONE transfer."""
    out = {key: t.cpu().numpy() for key, t in tensors.items()}
    _D2H_CALLS.inc()
    _D2H_BYTES.inc(sum(int(a.nbytes) for a in out.values()))
    return out


@dataclasses.dataclass
class TransferStats:
    h2d_calls: int = 0
    h2d_bytes: int = 0
    d2h_calls: int = 0
    d2h_bytes: int = 0
    gate_syncs: int = 0

    def to_device(self, arrays, device) -> tuple:
        """:func:`to_device`, counted on this object too."""
        self.h2d_calls += 1
        self.h2d_bytes += sum(int(a.nbytes) for a in arrays)
        return to_device(arrays, device)

    def to_host(self, tensors: dict) -> dict:
        """:func:`to_host`, counted on this object too."""
        out = to_host(tensors)
        self.d2h_calls += 1
        self.d2h_bytes += sum(int(a.nbytes) for a in out.values())
        return out
