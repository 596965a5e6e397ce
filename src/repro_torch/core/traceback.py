"""GenASM-TB: batched traceback over the three storage modes (PyTorch port
of ``repro.core.traceback``).

* 'edges4' (unimproved GenASM): reads the stored M/S/D/I edge bitvectors.
* 'and'    (SENE): stores only R = M & S & D & I; edge availability is
  recomputed from neighbouring stored R values and the pattern.
* 'band'   (SENE+DENT): like 'and' but reads the stored sub-word band
  windows; positions outside the band are provably unreachable.

``walk`` is the one GenASM-TB walk of the port: ``traceback`` calls it with
the readers of its store, and the plain versions of the fused kernels
(``kernels.genasm_dc``) with theirs.  Plain PyTorch on both devices: the
reference's traceback is jitted jnp, not a kernel.
"""
from __future__ import annotations

import torch

from .bitops import WORD_BITS, get_bit
from .config import AlignerConfig
from .oracle import OP_DEL, OP_INS, OP_MATCH, OP_NONE, OP_SUBST


def _zbit_full(r, lanes, d, j, i):
    """bit i of stored R_j[d] == 0 (full-vector store r (C, B, K1, NW));
    i == -1 encodes the DP's first column: ED(0, j) <= d  <=>  j <= d."""
    C, _, K1, NW = r.shape
    words = r[torch.clamp(j, 0, C - 1), lanes, torch.clamp(d, 0, K1 - 1)]
    bit = get_bit(words, torch.clamp(i, 0, NW * WORD_BITS - 1))
    return torch.where(i < 0, j <= d, bit == 0)


def _zbit_band(rb, bases, col0, lanes, d, j, i):
    """bit i of the stored band window of column j, level d == 0.
    rb: (K1, CB, B, NWB); bases: band_base of every column 0..n."""
    K1, CB, _, NWB = rb.shape
    words = rb[torch.clamp(d, 0, K1 - 1), torch.clamp(j - col0, 0, CB - 1),
               lanes]
    off = i - bases[torch.clamp(j, 0, bases.shape[0] - 1)]
    inband = (off >= 0) & (off < NWB * WORD_BITS)
    bit = get_bit(words, torch.clamp(off, 0, NWB * WORD_BITS - 1))
    return torch.where(i < 0, j <= d, (bit == 0) & inband)


def _ebit(edges, lanes, d, j, i):
    """edges4 mode: the four stored edge bits (M, S, D, I) of column j,
    level d, bit i == 0, as a (4, B) stack.  edges: (C, B, K1, NW, 4)."""
    C, _, K1, NW, _ = edges.shape
    words = edges[torch.clamp(j, 0, C - 1), lanes, torch.clamp(d, 0, K1 - 1)]
    return get_bit(words.permute(2, 0, 1),
                   torch.clamp(i, 0, NW * WORD_BITS - 1)) == 0


def edges_avail(edges, lanes):
    """Edge availability read from the stored M/S/D/I vectors (edges4)."""
    def avail(i, j, d):
        z = _ebit(edges, lanes, d, j, i)
        jpos, dpos = j > 0, d > 0
        return jpos & z[0], jpos & dpos & z[1], jpos & dpos & z[2], dpos & z[3]
    return avail


def sene_avail(zbit, peq):
    """Edge availability recomputed from stored R (SENE): ``zbit(d, j, i)``
    tests bit i of R_j[d] and must broadcast over a leading axis (the four
    cells of a step are read in one call); ``peq(i, j)`` tests
    P[i] == T[j-1]."""
    def avail(i, j, d):
        jm, dm, im = j - 1, d - 1, i - 1
        z = zbit(torch.stack([d, dm, dm, dm]), torch.stack([jm, jm, jm, j]),
                 torch.stack([im, im, i, im]))
        jpos, dpos = j > 0, d > 0
        return (jpos & peq(i, j) & z[0], jpos & dpos & z[1],
                jpos & dpos & z[2], dpos & z[3])
    return avail


def walk(*, dist, k, init_i, init_j, commit_limit, max_ops, max_steps,
         avail):
    """GenASM-TB walk, vectorised over lanes: per-lane (i, j, d) cursors
    advanced with the =,X,D,I preference, a tail drain (pattern exhausted
    -> remaining text as deletions) and the commit-limit stop.
    ``avail(i, j, d)`` gives the (M, S, D, I) edges available at a cell.

    The loop ends once every lane is done: a done lane changes no output,
    so the early exit is exact.  On a CUDA device the check is one
    device-to-host sync per step.  Returns ops (max_ops, B) int64
    front-first, padded with OP_NONE, and (n_ops, read_adv, ref_adv,
    d_final, ok)."""
    B = dist.shape[0]
    dev = dist.device
    lanes = torch.arange(B, device=dev)
    i, j, d = init_i, init_j, dist
    zeros = torch.zeros(B, dtype=torch.int64, device=dev)
    nops, rd, rf = zeros, zeros, zeros
    done = dist > k
    ok = torch.ones(B, dtype=torch.bool, device=dev)
    ops = torch.full((max_ops + 1, B), OP_NONE, dtype=torch.int64, device=dev)
    for _ in range(max_steps):
        if bool(done.all()):
            break
        tail = i < 0
        stopped = rd >= commit_limit
        active = ~done & ~stopped
        body = ~tail
        mA, sA, dA, iA = (e & body for e in avail(i, j, d))
        tail_emit = tail & (j > 0)
        any_edge = mA | sA | dA | iA | tail_emit
        cM = mA
        not_m = ~mA
        cS = not_m & sA
        not_ms = not_m & ~sA
        cD = not_ms & dA
        cI = not_ms & ~dA & iA
        op = torch.where(cM, OP_MATCH, torch.where(cS, OP_SUBST, torch.where(
            cD, OP_DEL, torch.where(cI, OP_INS, OP_DEL))))
        takes_read = active & (cM | cS | cI)
        takes_ref = active & (cM | cS | cD | tail_emit)
        costs = active & (cS | cD | cI | tail_emit)
        new_i = i - takes_read.long()
        new_j = j - takes_ref.long()
        emit = active & any_edge
        slot = torch.where(emit & (nops < max_ops), nops, max_ops)
        ops[slot, lanes] = op          # row max_ops is the drop slot
        nops = nops + emit.long()
        finished = (new_i < 0) & (new_j <= 0)
        ok = ok & torch.where(active & ~finished,
                              any_edge | ((i < 0) & (j <= 0)), True)
        done = done | (active & finished) | stopped
        i, j = new_i, new_j
        d = d - costs.long()
        rd = rd + takes_read.long()
        rf = rf + takes_ref.long()
    return ops[:max_ops], (nops, rd, rf, d, ok)


def traceback(store, pat_codes, text_codes, m_len, n_len, dist,
              commit_limit, *, cfg: AlignerConfig, mode: str, max_ops: int,
              max_steps: int) -> dict:
    """Walk the stored DP from the (m_len-1, n_len) corner.

    store: {'R': (n+1, B, k+1, NW)} ('and'), plus 'edges'
    (n+1, B, k+1, NW, 4) ('edges4'), or {'Rb': (k+1, ncb, B, nwb)}
    ('band'), words as int64.  Returns ops (B, max_ops) uint8 front-first,
    n_ops, read_adv, ref_adv, cost (edits spent on committed ops) and
    d_final as int32, and ok (internal invariant).  Problems with
    dist > k are skipped (ok stays True, n_ops = 0)."""
    dev = pat_codes.device
    B = pat_codes.shape[0]
    k = cfg.k
    lanes = torch.arange(B, device=dev)
    dist = dist.long()
    pat = pat_codes.long()
    text = text_codes.long()

    if mode == "edges4":
        avail = edges_avail(store["edges"], lanes)
    else:
        if mode == "band":
            n = text.shape[1]
            bases = torch.tensor([cfg.band_base(j) for j in range(n + 1)],
                                 dtype=torch.int64, device=dev)
            col0 = n + 1 - cfg.ncols_band
            rb = store["Rb"]

            def zbit(d, j, i):
                return _zbit_band(rb, bases, col0, lanes, d, j, i)
        else:
            r = store["R"]

            def zbit(d, j, i):
                return _zbit_full(r, lanes, d, j, i)

        def peq(i, j):
            pi = torch.clamp(i, 0, pat.shape[1] - 1)
            tj = torch.clamp(j - 1, 0, text.shape[1] - 1)
            return pat[lanes, pi] == text[lanes, tj]

        avail = sene_avail(zbit, peq)

    ops, (nops, rd, rf, d, ok) = walk(
        dist=dist, k=k, init_i=m_len.long() - 1, init_j=n_len.long(),
        commit_limit=commit_limit, max_ops=max_ops, max_steps=max_steps,
        avail=avail)
    cost = torch.where(dist > k, 0, dist - d)
    return {"ops": ops.T.to(torch.uint8), "n_ops": nops.to(torch.int32),
            "read_adv": rd.to(torch.int32), "ref_adv": rf.to(torch.int32),
            "cost": cost.to(torch.int32), "ok": ok,
            "d_final": d.to(torch.int32)}
