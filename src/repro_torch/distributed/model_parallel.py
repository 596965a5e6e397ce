"""A training state sharded over a ``("data", "model")`` mesh, and the
collectives of its compute (the port's counterpart of the reference's
``jax.jit(in_shardings=...)`` under such a mesh, where GSPMD shards the
state and the compute by each parameter's spec).

``shard_model(model, mesh)`` keeps on each rank only its block of every
parameter: the block of the full value that ``runtime.elastic.place``
gives that rank (``ModelParallel.shard``) under the parameter's logical
spec fitted to the mesh (``launch.dryrun.fit_pspec``).  The optimizer
state made after it (``train.step.init_state``) has the blocks' shapes,
so each rank holds its shard of every float32 master weight and of
AdamW's ``m`` and ``v``.

A layer reads its weights in one of two ways (``models.common
.ParamModule``):

* **gathered** (``p["w"]``, the generic path every architecture runs):
  ``_Gather`` all-gathers the block over every axis that shards it, so
  the layer computes on the full weight, replicated over ``model``.  In
  the backward pass the float32 gradient is reduce-scattered over
  ``data`` (a sum, then divided by the data size: the mean over the
  global batch's rows that a single device takes) and cut to this rank's
  block over ``model``, whose ranks all computed the same gradient.  A
  leaf that ``data`` does not shard has its gradient all-reduced over
  ``data`` and divided the same way.  Any spec works, a split that
  falls mid-head included.
* **split** (``p.local("w")``, tensor parallelism): the block is
  gathered over ``data`` only and keeps its ``model`` split, and the
  layer computes its share (heads, MLP columns, experts, vocabulary
  rows).  Such a region starts with ``copy_to_model`` (identity; the
  backward all-reduces the input's gradient over ``model``) and ends
  with ``reduce_from_model`` (an all-reduce of the partial outputs; the
  backward is the identity).

Split compute runs in train mode only: prefill and decode (under
``inference_mode``) read gathered weights, so their caches keep every
head.  Where a layer takes which path is counted in ``paths``.

Collectives: ``all_reduce``, ``reduce_scatter_tensor`` and an all-gather
(NCCL's ``all_gather_into_tensor``; over gloo into a list).  A CUDA tensor in
a gloo group is staged through pinned host memory (two ranks sharing one
card need gloo; NCCL refuses them), counted in ``stats["staged"]``.  A
collective that fails raises.  With ``timing`` on, each collective's time
is recorded (CUDA events, host time on the CPU) under its kind:
``model_all_reduce``, ``model_gather``, ``data_gather``,
``data_reduce_scatter`` and ``norm``.
"""
from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist
from torch import nn

AXES = ("data", "model")


def _axes_of(entry) -> tuple:
    """The mesh axes of one entry of a fitted spec, in mesh order."""
    if entry is None:
        return ()
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(a for a in AXES if a in axes)


class ModelParallel:
    """The collectives and the shard layout of a ``(data, model)`` torch
    ``DeviceMesh`` (``runtime.elastic.make_elastic_mesh``) for the
    parameters of one model: their fitted specs by name (``specs``) and
    their full shapes (``shapes``)."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        if names != AXES:
            raise ValueError(f"a model-parallel mesh has axes {AXES}, "
                             f"not {names}")
        self.mesh = mesh
        self.group = {a: mesh.get_group(a) for a in AXES}
        self.size = {a: int(mesh.size(i)) for i, a in enumerate(AXES)}
        self.coord = {a: int(mesh.get_local_rank(a)) for a in AXES}
        self.nccl = dist.get_backend(self.group["model"]) == "nccl"
        self.specs: dict = {}
        self.shapes: dict = {}
        self.stats = collections.Counter()
        self.paths = collections.Counter()
        self.timing = False
        self._times: list = []

    # ----------------------------------------------------------- layout --
    @property
    def shape(self) -> dict:
        return dict(self.size)

    def dims(self, name: str) -> list:
        """Per tensor dimension of parameter `name`, the axes that shard
        it (mesh order)."""
        return [_axes_of(e) for e in self.specs[name]]

    def shard(self, full: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's block of `full` (a leaf laid out as parameter
        `name`, whole, the same on every rank) as ``runtime.elastic.place``
        keeps it under the fitted spec: the one place specs become
        shards.  Nothing is sent."""
        from ..launch.dryrun import NamedSharding
        from ..runtime.elastic import place
        return place(full, NamedSharding(self.mesh, self.specs[name])) \
            .to_local()

    def block(self, full: torch.Tensor, name: str, axes=AXES, coord=None):
        """The block of `full` (parameter `name`'s whole value) over
        `axes` that this rank (or the one at `coord`, axis -> index)
        holds, as a view: along each dimension the slice its coordinates
        name, the outer axis first, as ``shard`` keeps it (the tests hold
        the two equal); ``gather_to_root`` assembles a leaf with it."""
        coord = self.coord if coord is None else coord
        t = full
        for d, dim_axes in enumerate(self.dims(name)):
            n, idx = 1, 0
            for a in dim_axes:
                if a in axes:
                    idx = idx * self.size[a] + coord[a]
                    n *= self.size[a]
            if n > 1:
                step = t.shape[d] // n
                t = t.narrow(d, idx * step, step)
        return t

    def sharded_over(self, name: str) -> tuple:
        """The axes that shard parameter `name`, in mesh order."""
        return tuple(a for a in AXES
                     if any(a in ax for ax in self.dims(name)))

    def model_split(self, name: str, dim: int) -> bool:
        """Whether dimension `dim` of parameter `name` is split over
        ``model`` alone (a block that split compute can use)."""
        return self.size["model"] > 1 and \
            self.dims(name)[dim] == ("model",)

    # ------------------------------------------------------ collectives --
    def _record(self, kind: str, start, device):
        if not self.timing:
            return
        if device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._times.append((kind, start, end))
        else:
            self._times.append((kind, (time.perf_counter() - start) * 1e3))

    def _start(self, device):
        if not self.timing:
            return None
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def take_times(self) -> list:
        """The collectives timed since the last call: ``(kind, ms or
        (start, end) CUDA events)`` records."""
        out, self._times = self._times, []
        return out

    def _staged(self, fn, src, dst):
        """``fn(src, dst)``, a collective that reads `src` and writes `dst`
        (the same tensor where it works in place): on the tensors as they
        are, or, for CUDA tensors in a gloo group, on pinned host copies,
        `dst`'s copied back after."""
        if self.nccl or not src.is_cuda:
            fn(src, dst)
            return
        self.stats["staged"] += 1
        h_src = torch.empty(src.shape, dtype=src.dtype,
                            pin_memory=True).copy_(src)
        h_dst = h_src if dst is src else torch.empty(
            dst.shape, dtype=dst.dtype, pin_memory=True)
        fn(h_src, h_dst)
        dst.copy_(h_dst)

    def all_reduce(self, t, axis: str, op=dist.ReduceOp.SUM,
                   kind: str | None = None):
        """A new tensor: `t` reduced over `axis` (`t` itself where the
        axis has one rank)."""
        if self.size[axis] == 1:
            return t
        out = t.detach().contiguous().clone()
        start = self._start(t.device)
        self._staged(lambda x, _: dist.all_reduce(
            x, op=op, group=self.group[axis]), out, out)
        self.stats[f"{axis}_all_reduce"] += 1
        self._record(kind or f"{axis}_all_reduce", start, t.device)
        return out

    def all_gather(self, t, axis: str, dim: int, kind: str | None = None):
        """The blocks of `axis`'s ranks joined along `dim`, in rank
        order."""
        n = self.size[axis]
        if n == 1:
            return t
        x = t.detach().movedim(dim, 0).contiguous()
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        group = self.group[axis]
        start = self._start(t.device)
        if self.nccl:
            gather = getattr(dist, "all_gather_single", None) or \
                dist.all_gather_into_tensor
            gather(out, x, group=group)
        else:
            def fn(src, dst):
                dist.all_gather(list(dst.chunk(n)), src, group=group)
            self._staged(fn, x, out)
        self.stats[f"{axis}_gather"] += 1
        self._record(kind or f"{axis}_gather", start, t.device)
        return out.movedim(0, dim)

    def reduce_scatter(self, t, axis: str, dim: int):
        """The sum of `t` over `axis`'s ranks, cut to this rank's block
        along `dim`."""
        n = self.size[axis]
        if n == 1:
            return t
        start = self._start(t.device)
        x = t.detach().movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        scatter = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        self._staged(lambda src, dst: scatter(dst, src,
                                              group=self.group[axis]), x, out)
        out = out.movedim(0, dim)
        self.stats[f"{axis}_reduce_scatter"] += 1
        self._record(f"{axis}_reduce_scatter", start, t.device)
        return out

    # ----------------------------------------------------------- reads --
    def gather_fwd(self, t, name: str, axes=AXES):
        """Parameter `name`'s block `t` gathered over `axes` (the inner
        axis of a dimension first)."""
        for d, dim_axes in enumerate(self.dims(name)):
            inner = [a for a in dim_axes if a in axes]
            if inner and list(dim_axes[len(dim_axes) - len(inner):]) \
                    != inner:
                raise ValueError(f"{name}: dimension {d} is split over "
                                 f"{dim_axes}; gathering {inner} alone "
                                 f"leaves no contiguous block")
            for a in reversed(inner):
                t = self.all_gather(t, a, d)
        return t

    def gather_bwd(self, g, name: str, axes=AXES):
        """The gradient of a ``gather_fwd`` read: reduce-scattered over
        ``data`` (or all-reduced, where ``data`` does not shard the leaf),
        divided by the data size, and cut to this rank's block over
        ``model``."""
        g = g.contiguous()
        for d, dim_axes in enumerate(self.dims(name)):
            for a in dim_axes:
                if a not in axes:
                    continue
                if a == "data":
                    g = self.reduce_scatter(g, "data", d)
                else:
                    step = g.shape[d] // self.size[a]
                    g = g.narrow(d, self.coord[a] * step, step)
        n = self.size["data"]
        if "data" not in self.sharded_over(name):
            g = self.all_reduce(g, "data", kind="data_reduce_scatter")
        return g / n if n > 1 else g.contiguous()

    def full(self, t, name: str):
        """Parameter `name`'s whole value, differentiable (the gathered
        read)."""
        return _Gather.apply(t, self, name, AXES)

    def local(self, t, name: str):
        """Parameter `name`'s ``model`` block, gathered over ``data``
        (the split read), differentiable."""
        return _Gather.apply(t, self, name, ("data",))

    def full_value(self, t, name: str):
        """The whole value of a state leaf laid out as parameter `name`
        (no gradient): what a checkpoint saves (its collectives are not
        timed)."""
        timing, self.timing = self.timing, False
        try:
            with torch.no_grad():
                return self.gather_fwd(t.detach(), name)
        finally:
            self.timing = timing

    def gather_to_root(self, t, name: str):
        """The whole value of a state leaf laid out as parameter `name` on
        the mesh's first rank, None on the others: every rank's block sent
        there (``dist.gather`` over the world, which the mesh spans; host
        memory over gloo), no gradient.  What a checkpoint saves."""
        ranks = self.mesh.mesh.flatten().tolist()
        root, me = ranks[0], dist.get_rank()
        x = t.detach().contiguous()
        host = x if self.nccl else x.cpu()
        parts = [torch.empty_like(host) for _ in ranks] if me == root \
            else None
        dist.gather(host, parts, dst=root)
        if me != root:
            return None
        full = torch.empty(self.shapes[name], dtype=t.dtype, device=t.device)
        M = self.size["model"]
        for rank, part in enumerate(parts):     # the world's rank order
            pos = ranks.index(rank)             # its place in the mesh
            self.block(full, name, coord={"data": pos // M,
                                          "model": pos % M}).copy_(part)
        return full

    # ---------------------------------------------------------- tp ops --
    def copy_to_model(self, x):
        return _CopyToModel.apply(x, self) if self.size["model"] > 1 else x

    def reduce_from_model(self, x):
        return _ReduceFromModel.apply(x, self) if self.size["model"] > 1 \
            else x

    def gather_from_model(self, x, dim: int):
        """An activation split over ``model`` along `dim`, joined (its
        gradient cut back to this rank's part)."""
        return _GatherActivation.apply(x, self, dim) \
            if self.size["model"] > 1 else x

    # ------------------------------------------------------------ norm --
    def global_norm(self, grads: dict) -> torch.Tensor:
        """The float32 L2 norm of the full gradient from the blocks in
        `grads` (name -> tensor): each block's sum of squares, summed over
        the axes that shard its leaf only, so that every element counts
        once (a leaf replicated over an axis is not counted again on its
        other ranks)."""
        parts = {(): [], ("data",): [], ("model",): [],
                 ("data", "model"): []}
        for n, g in grads.items():
            parts[self.sharded_over(n)].append(g.float().square().sum())
        dev = next(iter(grads.values())).device
        zero = torch.zeros((), dtype=torch.float32, device=dev)

        def total(key):
            return sum(parts[key], zero)
        # over data: the data-only and both-axes sums; then over model:
        # the model-only and that both-axes sum
        over_data = self.all_reduce(torch.stack(
            [total(("data",)), total(("data", "model"))]), "data",
            kind="norm")
        over_model = self.all_reduce(torch.stack(
            [total(("model",)), over_data[1]]), "model", kind="norm")
        return torch.sqrt(total(()) + over_data[0] + over_model[0]
                          + over_model[1])

    def record_path(self, block: str, path: str) -> None:
        self.paths[f"{block}: {path}"] += 1


class _Gather(torch.autograd.Function):
    """Gather-on-use: forward ``ModelParallel.gather_fwd``, backward
    ``gather_bwd``."""

    @staticmethod
    def forward(ctx, t, mp, name, axes):
        ctx.mp, ctx.name, ctx.axes = mp, name, axes
        out = mp.gather_fwd(t, name, axes)
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.gather_bwd(g, ctx.name, ctx.axes), None, None, None


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient over ``model``."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.all_reduce(g, "model", kind="model_all_reduce"), None


class _ReduceFromModel(torch.autograd.Function):
    """An all-reduce over ``model``; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, mp):
        return mp.all_reduce(x, "model", kind="model_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherActivation(torch.autograd.Function):
    """An all-gather over ``model`` along a dimension; the backward keeps
    this rank's part."""

    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.all_gather(x, "model", dim, kind="model_gather")

    @staticmethod
    def backward(ctx, g):
        mp, dim = ctx.mp, ctx.dim
        step = g.shape[dim] // mp.size["model"]
        return g.narrow(dim, mp.coord["model"] * step, step), None, None


# ------------------------------------------------------------- models ----

def of(model) -> ModelParallel | None:
    """The ``ModelParallel`` a model was sharded with, or None."""
    return model.__dict__.get("mp") if isinstance(model, nn.Module) \
        else None


def split(p) -> ModelParallel | None:
    """The ``ModelParallel`` under which `p` (a ``ParamModule``, or a
    parameter dict) computes split over ``model``: its own where ``model``
    has more than one rank and the forward is not under
    ``inference_mode``; else None."""
    mp = p.__dict__.get("mp") if isinstance(p, nn.Module) else None
    if mp is None or mp.size["model"] == 1 or \
            torch.is_inference_mode_enabled():
        return None
    return mp


def shard_model(model, mesh) -> ModelParallel:
    """Keep on this rank only its block of every parameter of `model`
    (every rank holds the same full values when it is called), under the
    logical specs of ``model.partition_specs()`` fitted to `mesh`, and
    make every ``ParamModule`` read through the returned
    ``ModelParallel``.  Returns the existing one where `model` is already
    sharded on `mesh`; ValueError on another mesh."""
    from ..launch.dryrun import fit_pspec, mesh_axes
    mp = of(model)
    if mp is not None:
        if mp.mesh is not mesh and mesh_axes(mp.mesh) != mesh_axes(mesh):
            raise ValueError(f"the model is sharded on {mp.shape}, not "
                             f"{mesh_axes(mesh).shape}")
        return mp
    mp = ModelParallel(mesh)
    axes = mesh_axes(mesh)
    specs = model.partition_specs()
    with torch.no_grad():
        for name, p in model.named_parameters():
            mp.specs[name] = fit_pspec(tuple(p.shape), specs[name], axes)
            mp.shapes[name] = tuple(p.shape)
            p.data = mp.shard(p.data, name).clone()
    for prefix, sub in model.named_modules():
        names = {n: f"{prefix}.{n}" if prefix else n
                 for n, _ in sub.named_parameters(recurse=False)}
        sub.__dict__["mp"] = mp
        sub.__dict__["_mp_names"] = names
    return mp
