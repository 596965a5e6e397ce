"""Reference oracles (numpy copy of ``repro.core.oracle``): the op codes,
classic DP edit distance with its full table and an optimal traceback,
CIGAR validation and run-length encoding.  Independent of the DP under
test, so it checks the kernels' output on the card."""
from __future__ import annotations

import numpy as np

# CIGAR op codes used throughout the port (2-bit packable)
OP_MATCH = 0  # '='  consumes read + ref
OP_SUBST = 1  # 'X'  consumes read + ref
OP_INS = 2    # 'I'  consumes read only  (insertion w.r.t. the reference)
OP_DEL = 3    # 'D'  consumes ref only   (deletion  w.r.t. the reference)
OP_NONE = 255  # padding past the last op of an op buffer
OP_CHARS = "=XID"


def levenshtein(p: np.ndarray, t: np.ndarray) -> int:
    """Edit distance between code arrays p (pattern/read) and t (text/ref)."""
    m, n = len(p), len(t)
    prev = np.arange(n + 1)
    for i in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int64)
        cur[0] = i
        sub = prev[:-1] + (t != p[i - 1])
        # cur[j] = min(sub[j-1], prev[j] + 1, cur[j-1] + 1): the cur[j-1]
        # dependency is resolved by a serial pass
        best = np.minimum(sub, prev[1:] + 1)
        run = cur[0]
        for j in range(1, n + 1):
            run = min(best[j - 1], run + 1)
            cur[j] = run
        prev = cur
    return int(prev[n])


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def validate_cigar(p: np.ndarray, t: np.ndarray, ops,
                   expected_dist=None) -> None:
    """Raise AssertionError unless the front-first op list is a valid
    alignment of p against t (and costs expected_dist, when given)."""
    i = j = cost = 0
    for op in ops:
        if op == OP_MATCH:
            _check(i < len(p) and j < len(t) and p[i] == t[j],
                   f"bad match at read {i} / ref {j}")
            i += 1; j += 1
        elif op == OP_SUBST:
            _check(i < len(p) and j < len(t) and p[i] != t[j],
                   f"subst on equal chars at read {i} / ref {j}")
            i += 1; j += 1; cost += 1
        elif op == OP_INS:
            _check(i < len(p), f"insertion past the read end at {i}")
            i += 1; cost += 1
        elif op == OP_DEL:
            _check(j < len(t), f"deletion past the ref end at {j}")
            j += 1; cost += 1
        else:
            raise AssertionError(f"unknown op {op}")
    _check(i == len(p), f"read not fully consumed: {i} != {len(p)}")
    _check(j == len(t), f"ref not fully consumed: {j} != {len(t)}")
    if expected_dist is not None:
        _check(cost == expected_dist,
               f"cigar cost {cost} != distance {expected_dist}")


def dp_table(p: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The full (m+1, n+1) edit-distance DP table of p against t."""
    m, n = len(p), len(t)
    D = np.zeros((m + 1, n + 1), dtype=np.int64)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = np.arange(n + 1)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            D[i, j] = min(
                D[i - 1, j - 1] + (p[i - 1] != t[j - 1]),
                D[i - 1, j] + 1,
                D[i, j - 1] + 1,
            )
    return D


def dp_traceback(p: np.ndarray, t: np.ndarray) -> tuple[int, list[int]]:
    """Optimal CIGAR (front-first op list) preferring =, X, D, I like the
    GenASM traceback implementations (D = consume text only)."""
    D = dp_table(p, t)
    i, j = len(p), len(t)
    ops: list[int] = []
    while i > 0 or j > 0:
        d = D[i, j]
        if i > 0 and j > 0 and p[i - 1] == t[j - 1] and D[i - 1, j - 1] == d:
            ops.append(OP_MATCH); i -= 1; j -= 1
        elif i > 0 and j > 0 and D[i - 1, j - 1] == d - 1:
            ops.append(OP_SUBST); i -= 1; j -= 1
        elif j > 0 and D[i, j - 1] == d - 1:
            ops.append(OP_DEL); j -= 1
        else:
            ops.append(OP_INS); i -= 1
    ops.reverse()
    return int(D[len(p), len(t)]), ops


def ops_to_cigar_string(ops) -> str:
    """Run-length encode a front-first op list into a CIGAR-like string."""
    out = []
    prev, run = None, 0
    for op in list(ops) + [None]:
        if op == prev:
            run += 1
        else:
            if prev is not None:
                out.append(f"{run}{OP_CHARS[prev]}")
            prev, run = op, 1
    return "".join(out)
