"""CIGAR utilities (port of ``repro/core/cigar.py``): 2-bit packing,
run-length encoding and the host-side decode of a downloaded batch."""
from __future__ import annotations

import numpy as np
import torch

from .oracle import OP_CHARS, OP_NONE


def pack_ops(ops: torch.Tensor) -> torch.Tensor:
    """Pack (B, L) uint8 op codes (0..3; OP_NONE padding -> 0) into
    (B, ceil(L/16)) uint32 words, 2 bits per op."""
    B, L = ops.shape
    o = torch.nn.functional.pad(ops, (0, (-L) % 16))
    o = torch.where(o == OP_NONE, 0, o).to(torch.int64).reshape(B, -1, 16)
    sh = torch.arange(16, dtype=torch.int64, device=ops.device) * 2
    return (o << sh).sum(-1).to(torch.uint32)


def unpack_ops(packed: np.ndarray, n_ops: np.ndarray) -> list[np.ndarray]:
    """Host-side inverse of pack_ops."""
    out = []
    for row, n in zip(np.asarray(packed), np.asarray(n_ops)):
        # op t lives in word t//16 at bit offset 2*(t%16)
        ops = np.stack([(row >> np.uint32(2 * i)) & 3 for i in range(16)],
                       axis=1).reshape(-1)
        out.append(ops[:n].astype(np.uint8))
    return out


def ops_to_string(ops: np.ndarray) -> str:
    """Run-length encode an op array into a CIGAR string (=XID alphabet)."""
    ops = np.asarray(ops)
    if ops.size == 0:
        return ""
    change = np.nonzero(np.diff(ops))[0] + 1
    bounds = np.concatenate([[0], change, [len(ops)]])
    return "".join(
        f"{bounds[i+1]-bounds[i]}{OP_CHARS[ops[bounds[i]]]}"
        for i in range(len(bounds) - 1)
    )


def decode_batch(host: dict, n: int, default_k: int):
    """Decode the first `n` lanes of one downloaded output dict into
    writable per-lane state: (failed, dist, k_used, rcon, fcon, all_ops),
    with all_ops[i] None for failed lanes.  Pure numpy over downloaded
    buffers, so the session's retire thread runs it beside the dispatch
    thread.  `default_k` fills k_used where the output does not report it
    (the plain per-rung step of the session's bucket rescue)."""
    failed = np.array(host["failed"][:n], bool)
    dist = np.asarray(host["dist"])[:n].astype(np.int64)
    n_ops = np.asarray(host["n_ops"])[:n]
    ops_buf = np.asarray(host["ops"])[:n]
    rcon = np.asarray(host["read_consumed"])[:n].astype(np.int32)
    fcon = np.asarray(host["ref_consumed"])[:n].astype(np.int32)
    if "k_used" in host:
        k_used = np.asarray(host["k_used"])[:n].astype(np.int32)
    else:
        k_used = np.where(failed, 0, default_k).astype(np.int32)
    all_ops = [ops_buf[i, :n_ops[i]].copy() if not failed[i] else None
               for i in range(n)]
    return failed, dist, k_used, rcon, fcon, all_ops


def records_from_state(failed, dist, k_used, rcon, fcon, all_ops) -> list:
    """Per-lane result records {ok, dist, cigar, k_used, ops,
    read_consumed, ref_consumed}; failed lanes report zeros and an empty
    CIGAR."""
    recs = []
    for i in range(len(all_ops)):
        bad = bool(failed[i])
        ops = all_ops[i] if all_ops[i] is not None else np.zeros(0, np.uint8)
        recs.append({
            "ok": not bad,
            "dist": 0 if bad else int(dist[i]),
            "cigar": "" if bad else ops_to_string(ops),
            "k_used": 0 if bad else int(k_used[i]),
            "ops": ops,
            "read_consumed": 0 if bad else int(rcon[i]),
            "ref_consumed": 0 if bad else int(fcon[i]),
        })
    return recs
