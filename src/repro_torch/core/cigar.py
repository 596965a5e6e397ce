"""CIGAR utilities (numpy port of ``repro/core/cigar.py``): run-length
encoding and the host-side decode of a downloaded batch."""
from __future__ import annotations

import numpy as np

from .oracle import OP_CHARS


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


def decode_batch(host: dict, n: int):
    """Decode the first `n` lanes of one downloaded output dict into
    writable per-lane state: (failed, dist, k_used, rcon, fcon, all_ops),
    with all_ops[i] None for failed lanes."""
    failed = np.array(host["failed"][:n], bool)
    dist = np.asarray(host["dist"])[:n].astype(np.int64)
    n_ops = np.asarray(host["n_ops"])[:n]
    ops_buf = np.asarray(host["ops"])[:n]
    rcon = np.asarray(host["read_consumed"])[:n].astype(np.int32)
    fcon = np.asarray(host["ref_consumed"])[:n].astype(np.int32)
    k_used = np.asarray(host["k_used"])[:n].astype(np.int32)
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
