"""Int8-compressed gradient all-reduce (port of
``repro/distributed/collectives.py``) on ``torch.distributed``: a ring
reduce-scatter whose every hop carries int8 values and one float32 scale,
then an int8 all-gather of the reduced shards; ~1/4 the wire bytes of a
float32 all-reduce.

Quantisation is the reference's as XLA compiles it (every call of the
reference's ring is compiled), op for op in float32: per chunk the scale
is ``max|x| / 127 + 1e-12``, where XLA folds the division by the constant
into a product with its float32 reciprocal (``INV_127``) and contracts
the product and the sum into one fused multiply-add, and the values are
``clip(round(x / scale), -127, 127)`` (round half to even).  A hop's
``dequant(q, s) + mine`` is contracted the same way.  The port computes
each fused multiply-add in float64 and rounds once to float32
(``_fma``): the product of two float32 values is exact in float64.  The
ring accumulates in float32 and re-quantises at every hop, so its error
grows by up to one quantum a hop (the reference's test bounds the
relative error by 0.05).

A hop is one ``dist.batch_isend_irecv`` of a send to the next rank and a
receive from the previous one, each message the int8 values with the
scale's four bytes appended; the all-gather is ``dist.all_gather`` into a
list (the one all-gather call that PyTorch 2.11 and 2.13 both have).
``train.step.make_train_step(grad_sync=make_compressed_grad_sync(g))``
syncs a data-parallel step's gradients with it; the default sync is the
float32 ``dist.all_reduce``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


#: 1 / 127 rounded to float32: the constant XLA multiplies by
INV_127 = float(torch.tensor(1 / 127, dtype=torch.float32))


#: 1e-12 rounded to float32
EPS = float(torch.tensor(1e-12, dtype=torch.float32))


def _fma(a, b, c):
    """``a * b + c`` rounded once to float32, as a fused multiply-add
    (`b`, `c`: tensors or Python floats)."""
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a.double() * b + c).float()


def _quant(x):
    """(int8 values, float32 scale (..., 1)) of float32 `x`, one absmax
    scale over the last dimension."""
    scale = _fma(x.abs().amax(dim=-1, keepdim=True), INV_127, EPS)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q, scale):
    return q.float() * scale


def _pack(q, scale):
    """One int8 message: the values, then the scale's four bytes."""
    return torch.cat([q, scale.reshape(1).view(torch.int8)])


def _unpack(msg):
    return msg[:-4], msg[-4:].clone().view(torch.float32)


def ring_reduce_scatter_q8(x, group=None):
    """x: (n * chunk,) float32 on every rank of `group` -> (chunk,), the
    fully reduced chunk ``me`` (this rank's index in the group).  The
    partial sum of chunk c starts at rank (c + 1) % n and rings to c,
    each hop quantised to int8 with one float32 scale."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    xs = x.reshape(n, -1)
    nxt, prv = ((me + 1) % n, (me - 1) % n) if group is None else (
        dist.get_global_rank(group, (me + 1) % n),
        dist.get_global_rank(group, (me - 1) % n))
    acc = xs[(me - 1) % n]
    for t in range(n - 1):
        msg = _pack(*_quant(acc))
        got = torch.empty_like(msg)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, msg, nxt, group),
                dist.P2POp(dist.irecv, got, prv, group)]):
            req.wait()
        c = (me - 2 - t) % n          # chunk id of the partial just received
        q, scale = _unpack(got)
        acc = _fma(q.float(), scale, xs[c])       # dequant(q) + mine
    return acc


def compressed_allreduce(x, group=None):
    """The sum of float32 `x` over `group`'s ranks, through the int8 ring
    reduce-scatter and an int8 all-gather: ``dist.all_reduce``'s
    replacement at ~1/4 the wire bytes.  `x` is padded with zeros to a
    multiple of the group's size."""
    n = dist.get_world_size(group)
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    shard = ring_reduce_scatter_q8(flat, group)
    msg = _pack(*_quant(shard))
    parts = [torch.empty_like(msg) for _ in range(n)]
    dist.all_gather(parts, msg, group=group)
    full = torch.cat([_dequant(*_unpack(m)) for m in parts])
    return full[:x.numel()].reshape(x.shape)


def make_compressed_grad_sync(group=None):
    """A ``grad_sync`` for ``train.step.make_train_step``: every gradient
    (name -> float32 tensor) averaged over `group` through
    ``compressed_allreduce``, leaf by leaf as the reference's tree map."""
    def sync(grads: dict) -> dict:
        n = dist.get_world_size(group)
        return {k: compressed_allreduce(g, group) / n
                for k, g in grads.items()}
    return sync
