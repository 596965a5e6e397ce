"""Train step factory (port of ``repro/train/step.py``): loss and gradients
(``torch.autograd`` over ``model.loss``) -> clip -> AdamW, with optional
gradient accumulation over micro-batches, on one device or data-parallel
over a process group.

The training state is ``{"model": nn.Module, "opt": {"m", "v", "step"}}``:
the model holds the (float32 master) weights, ``opt`` the AdamW state of
``optim.adamw``, keyed by the model's parameter names.  A step updates
both in place and returns the same state object, so a caller that holds
the state sees the update (the reference returns new arrays).

Data parallelism (``group=``): every rank holds the whole state and runs
the loss and its backward on its own rows of the global batch
(``shard_batch``); the float32 gradients are then averaged over the group
(``make_allreduce_grad_sync``: ``dist.all_reduce`` over a few flat
buckets, the reference's implicit float32 all-reduce; or
``distributed.collectives.make_compressed_grad_sync``) before the clip
and AdamW, so every rank applies the same update and the replicas stay
equal.  The reported loss is the group's mean; the MoE router's
load-balancing loss is the global batch's (``models.moe.global_batch``).
"""
from __future__ import annotations

import torch

from ..models.moe import global_batch
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state

#: bytes of one bucket of the float32 gradient all-reduce
BUCKET_BYTES = 256 << 20


def make_allreduce_grad_sync(group=None):
    """A ``grad_sync``: every float32 gradient (name -> tensor) averaged
    over `group` with ``dist.all_reduce``, the gradients packed in order
    into flat buckets of at most ``BUCKET_BYTES`` (a larger one alone)."""
    import torch.distributed as dist

    def sync(grads: dict) -> dict:
        n = dist.get_world_size(group)
        out, bucket, size = {}, [], 0

        def flush():
            flat = torch.cat([grads[k].reshape(-1) for k in bucket])
            dist.all_reduce(flat, group=group)
            flat /= n
            for k, part in zip(bucket, flat.split(
                    [grads[k].numel() for k in bucket])):
                out[k] = part.view_as(grads[k])
        for key, g in grads.items():
            if bucket and size + g.nbytes > BUCKET_BYTES:
                flush()
                bucket, size = [], 0
            bucket.append(key)
            size += g.nbytes
        if bucket:
            flush()
        return out
    return sync


def shard_batch(batch: dict, rank: int, world: int,
                grad_accum: int = 1) -> dict:
    """Rank `rank`'s rows of a global `batch` (numpy arrays or tensors):
    each of the `grad_accum` micro-batches of the global batch split into
    `world` equal row blocks, the rank taking block `rank` of each, so
    that its i-th micro-batch is its share of the global i-th; with
    ``grad_accum=1`` rows ``[rank*B/world, (rank+1)*B/world)``.  The
    M-RoPE ``positions`` (3, B, S) split on dim 1.  ValueError where the
    rows do not divide."""
    out = {}
    for k, v in batch.items():
        dim = 1 if k == "positions" and v.ndim == 3 else 0
        B = v.shape[dim]
        if B % (world * grad_accum):
            raise ValueError(f"{k}: {B} rows do not divide into {world} "
                             f"ranks x {grad_accum} micro-batches")
        per, micro = B // (world * grad_accum), B // grad_accum
        rows = slice(rank * per, (rank + 1) * per) if grad_accum == 1 else \
            [i * micro + rank * per + j for i in range(grad_accum)
             for j in range(per)]
        out[k] = v[rows] if dim == 0 else v[:, rows]
    return out


def make_train_step(model, opt_cfg: AdamWConfig, grad_accum: int = 1,
                    group=None, grad_sync=None, mesh=None):
    """``train_step(state, batch) -> (state, metrics)`` for `model` (the
    state's ``"model"``), metrics ``{"loss", "grad_norm", "lr"}`` as 0-d
    tensors on the device; `batch` holds numpy arrays or tensors.  With
    `grad_accum` > 1 the batch splits along dim 0 into `grad_accum`
    micro-batches whose float32 gradients are summed and divided by
    `grad_accum` (the reference's ``lax.scan``); the loss is their
    mean.  With a process `group`, `batch` is this rank's rows
    (``shard_batch``), the gradients are averaged over the group by
    `grad_sync` (default ``make_allreduce_grad_sync(group)``) before the
    clip, and the loss is the group's mean; ``group=None`` is the
    single-device step.

    With a ``("data", "model")`` torch `mesh` the model is sharded on it
    (``distributed.model_parallel.shard_model``, in place, where it is
    not yet; build the state with ``init_state`` after) and `batch` is
    the rows of this rank's ``data`` coordinate (``shard_batch`` with the
    ``data`` rank and size; every ``model`` rank of a row reads the same
    rows).  The gradients arrive averaged over ``data`` from the
    reduce-scatters of the model's reads, the clip counts every element
    of the full gradient once (``ModelParallel.global_norm``), the loss
    is the mean over ``data`` and the router's statistics the global
    batch's.  `group` and `grad_sync` do not apply (ValueError)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be >= 1")
    mp = None
    if mesh is not None:
        if group is not None or grad_sync is not None:
            raise ValueError("a (data, model) mesh averages the gradients "
                             "in the model's reads: no group= or "
                             "grad_sync= (the int8 ring syncs whole "
                             "replicated gradients)")
        from ..distributed.model_parallel import shard_model
        mp = shard_model(model, mesh)
        group = mp.group["data"]
    params = dict(model.named_parameters())
    if group is not None and grad_sync is None and mp is None:
        grad_sync = make_allreduce_grad_sync(group)

    def train_step(state, batch):
        for p in params.values():
            p.grad = None
        with torch.enable_grad(), global_batch(group):
            if grad_accum == 1:
                loss, _ = model.loss(batch)
                loss.backward()
            else:
                n = next(iter(batch.values())).shape[0] // grad_accum
                loss = torch.zeros((), dtype=torch.float32,
                                   device=model.device)
                for i in range(grad_accum):
                    micro, _ = model.loss({k: v[i * n:(i + 1) * n]
                                           for k, v in batch.items()})
                    micro.backward()
                    loss = loss + micro.detach()
                loss = loss / grad_accum
        grads = {name: p.grad if p.grad is None or grad_accum == 1
                 else p.grad.float() / grad_accum
                 for name, p in params.items()}
        for p in params.values():
            p.grad = None
        loss = loss.detach()
        if mp is not None:
            loss = mp.all_reduce(loss, "data") / mp.size["data"]
            om = adamw_update(params, grads, state["opt"], opt_cfg,
                              norm=mp.global_norm)
            return state, {"loss": loss, **om}
        if group is not None:
            import torch.distributed as dist
            grads = grad_sync({k: torch.zeros(params[k].shape,
                                              dtype=torch.float32,
                                              device=params[k].device)
                               if g is None else g.float()
                               for k, g in grads.items()})
            dist.all_reduce(loss, group=group)
            loss /= dist.get_world_size(group)
        om = adamw_update(params, grads, state["opt"], opt_cfg)
        return state, {"loss": loss, **om}

    return train_step


def init_state(model) -> dict:
    """The training state of `model`: the model itself and zero AdamW
    state on its device.  Build the model with ``param_dtype="float32"``
    for the reference's float32 master weights."""
    return {"model": model,
            "opt": init_opt_state(dict(model.named_parameters()))}


def abstract_state(model) -> dict:
    """Names, shapes and dtypes of `model`'s training state, as tensors on
    the ``meta`` device in the state's layout: what
    ``checkpoint.restore_checkpoint`` reads a checkpoint against."""
    def meta(p, dtype):
        return torch.empty(p.shape, dtype=dtype, device="meta")
    params = dict(model.named_parameters())
    return {"model": {n: meta(p, p.dtype) for n, p in params.items()},
            "opt": {"m": {n: meta(p, torch.float32)
                          for n, p in params.items()},
                    "v": {n: meta(p, torch.float32)
                          for n, p in params.items()},
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def state_partition_specs(model) -> dict:
    """The logical specs of `model`'s training state, in the state's
    layout: ``{"model": specs, "opt": {"m": specs, "v": specs, "step":
    ()}}`` with ``specs = model.partition_specs()`` (the reference's
    ``state_partition_specs``)."""
    specs = model.partition_specs()
    return {"model": specs, "opt": {"m": specs, "v": specs, "step": ()}}


def replica_digest(state) -> list:
    """Two integers a leaf of a training state (``checkpoint.flat_state``
    order) that change with any bit of it: the sum of its 32-bit words,
    and their sum weighted by position (mod 65,521, plus 1); computed on
    the state's devices, for checking that data-parallel replicas are
    bit-identical without moving them.  For a state sharded over a
    ``("data", "model")`` mesh each leaf's entry adds a third item, the
    block it holds (``"data=1,model=0"``; ``""`` where it is whole), so
    that ``replicas_agree`` compares the ranks that hold the same
    block."""
    from ..checkpoint.ckpt import flat_state, param_of
    from ..distributed.model_parallel import of
    mp = of(state["model"])
    out = []
    for key, t in flat_state(state).items():
        w = t.detach().reshape(-1)
        w = (w.view(torch.int32) if w.element_size() == 4
             else w.view(torch.int16) if w.element_size() == 2
             else w).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append([int(w.sum()), int((w * pos).sum())])
        if mp is not None:
            name = param_of(key)
            out[-1].append("" if name is None else ",".join(
                f"{a}={mp.coord[a]}" for a in mp.sharded_over(name)))
    return out


def replicas_agree(digests: list) -> bool:
    """Whether the ranks' ``replica_digest`` lists (one a rank) agree:
    every leaf bit-identical on the ranks that hold the same block of it
    (on every rank where the state is not sharded)."""
    for leaf in zip(*digests):
        seen = {}
        for entry in leaf:
            key = entry[2] if len(entry) > 2 else ""
            if seen.setdefault(key, entry[:2]) != entry[:2]:
                return False
    return len({len(d) for d in digests}) == 1
