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
  ``gate_syncs``: the eager rescue ladder's round gate is a host check of
  ``failed.any()``, a device-to-host sync counted apart from the
  downloads (a session's device-mode graph on the card makes none).

On a mesh a batch moves as one tensor a shard (``distributed.sharding``):
an upload copies each shard's lanes from host memory straight to its
device, a download joins the shards' arrays in lane order, and each still
counts as ONE transfer of the whole batch's bytes, as the reference's
sharded batch does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributed.sharding import merge_pairs
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


def host_empty(shape, dtype, device):
    """An uninitialised host array of numpy `dtype` to fill and then
    upload to `device`: (what to hand ``to_device``, a numpy view to fill).
    For the card a pinned tensor, which the upload sends as it is (no copy
    into pinned memory) and which the caching host allocator reuses only
    once that copy is done; else a numpy array."""
    if torch.device(device).type == "cuda":
        t = torch.empty(shape, dtype=torch.from_numpy(
            np.empty(0, dtype)).dtype, pin_memory=True)
        return t, t.numpy()
    a = np.empty(shape, dtype)
    return a, a


def _upload(a, device):
    """One array (numpy, or a host tensor from ``host_empty``) to
    `device`.  To the card through pinned host memory, without a host
    sync: the copy queues behind the stream's earlier work (a session's
    previous dispatch) instead of waiting for it."""
    t = a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_device(arrays, device, shards=None) -> tuple:
    """Upload a tuple of batch-major numpy arrays (or ``host_empty``
    tensors) to `device`; counts as ONE transfer.  With `shards` (``sharding.pair_shards``: a (device,
    lane slice) a shard), each array comes back as a tuple of per-shard
    tensors, each on its shard's device."""
    _H2D_CALLS.inc()
    _H2D_BYTES.inc(sum(int(a.nbytes) for a in arrays))
    if shards is None:
        return tuple(_upload(a, device) for a in arrays)
    return tuple(tuple(_upload(a[lanes], dev) for dev, lanes in shards)
                 for a in arrays)


def _download(t) -> np.ndarray:
    if isinstance(t, (tuple, list)):
        return merge_pairs([x.cpu().numpy() for x in t])
    return t.cpu().numpy()


def to_host(tensors: dict) -> dict:
    """Download a dict of tensors as numpy; counts as ONE transfer.  A
    value that is a tuple of per-shard tensors comes back as one array,
    the shards joined in lane order."""
    out = {key: _download(t) for key, t in tensors.items()}
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

    def to_device(self, arrays, device, shards=None) -> tuple:
        """:func:`to_device`, counted on this object too."""
        self.h2d_calls += 1
        self.h2d_bytes += sum(int(a.nbytes) for a in arrays)
        return to_device(arrays, device, shards)

    def to_host(self, tensors: dict) -> dict:
        """:func:`to_host`, counted on this object too."""
        out = to_host(tensors)
        self.d2h_calls += 1
        self.d2h_bytes += sum(int(a.nbytes) for a in out.values())
        return out
