"""Host<->device transfer accounting (port of ``repro/core/transfer.py``,
without the metrics registry).

Each aligner owns a ``TransferStats``; every upload and download of a
batch goes through its ``to_device`` / ``to_host``, so a run can show the
contract of ``rescue_mode='device'``: one upload and one download per
batch however many rescue rounds run.  The rescue ladder's round gate is a
host check of ``failed.any()``; those device-to-host syncs are counted
apart, in ``gate_syncs``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TransferStats:
    h2d_calls: int = 0
    h2d_bytes: int = 0
    d2h_calls: int = 0
    d2h_bytes: int = 0
    gate_syncs: int = 0

    def to_device(self, arrays, device) -> tuple:
        """Upload a tuple of numpy arrays; counts as ONE transfer."""
        self.h2d_calls += 1
        self.h2d_bytes += sum(int(a.nbytes) for a in arrays)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in arrays)

    def to_host(self, tensors: dict) -> dict:
        """Download a dict of tensors as numpy; counts as ONE transfer."""
        out = {key: t.cpu().numpy() for key, t in tensors.items()}
        self.d2h_calls += 1
        self.d2h_bytes += sum(int(a.nbytes) for a in out.values())
        return out
