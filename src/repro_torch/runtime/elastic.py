"""Elastic scaling (port of ``repro/runtime/elastic.py``): a ``("data",
"model")`` mesh over the devices that are there now, and re-placing
(resharding) a training state onto it.

Checkpoints are logical (``checkpoint/ckpt.py``), so a rescale is a
restore under the new mesh's shardings; a live state is re-placed with
``reshard``: each leaf becomes a DTensor
(``torch.distributed.tensor.distribute_tensor``) on a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions are named
from ``pod``, ``data`` and ``model``.  A fitted spec becomes placements:
``Shard(d)`` on every mesh dimension named for tensor dimension d, and
``Replicate()`` on every other, so ``("pod", "data")`` on one dimension
is pod-major as in JAX (the mesh lists ``pod`` before ``data``).  Every
rank holds the full value and keeps its own slice: placing a leaf moves
nothing between ranks.
"""
from __future__ import annotations

import torch

from ..core.aligner import resolve_device
from ..launch.mesh import make_test_mesh


def best_mesh_shape(n_devices: int, model_parallel: int = 0):
    """Factor available devices into (data, model); prefers the largest
    model axis <= 16 that divides, unless pinned."""
    if model_parallel:
        assert n_devices % model_parallel == 0
        return (n_devices // model_parallel, model_parallel)
    for m in (16, 8, 4, 2, 1):
        if n_devices % m == 0:
            return (n_devices // m, m)
    return (n_devices, 1)


def make_elastic_mesh(model_parallel: int = 0, devices=None):
    """With a ``torch.distributed`` process group initialised: a
    ``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
    "model")`` over the world's ranks, shaped by ``best_mesh_shape``, on
    the ranks' device type (`devices` then names it; default: CUDA where
    the backend is NCCL, else the CPU).  Without a process group: the
    port's ``launch.mesh.DeviceMesh`` over `devices` (default: every
    visible CUDA device; a RuntimeError where there is none)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        n = dist.get_world_size()
        kind = torch.device(devices[0]).type if devices else (
            "cuda" if dist.get_backend() == "nccl" else "cpu")
        return init_device_mesh(kind, best_mesh_shape(n, model_parallel),
                                mesh_dim_names=("data", "model"))
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    shape = best_mesh_shape(len(devices), model_parallel)
    return make_test_mesh(shape, ("data", "model"), devices)


def placements(spec, mesh) -> tuple:
    """DTensor placements of a fitted `spec` on a torch `mesh`: one a mesh
    dimension, ``Shard(d)`` where the spec names that dimension for
    tensor dimension d, else ``Replicate()``.  ValueError for a spec that
    lists a dimension's axes in another order than the mesh (DTensor
    shards the outer mesh dimension first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dimension {d} "
                             f"are not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def place(t, sharding):
    """`t` (the full value, on every rank) as a DTensor under `sharding`
    (``launch.dryrun.NamedSharding`` on a torch mesh): each rank keeps its
    own slice, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    t = t.detach().to(mesh.device_type)
    return distribute_tensor(t, mesh, placements(sharding.spec, mesh),
                             src_data_rank=None)


def reshard(tree, pspec_tree, mesh):
    """Place `tree` (nested dicts / tuples of tensors: a state of plain
    mappings, ``{"model": {name: tensor}, "opt": ...}``) onto the torch
    `mesh` as DTensors under the logical specs of `pspec_tree`, each
    fitted to the mesh (``launch.dryrun.fit_pspec``: axes that do not
    divide are dropped).  Returns the tree of DTensors."""
    from ..launch.dryrun import tree_shardings
    from torch.utils import _pytree
    shardings = tree_shardings(tree, pspec_tree, mesh)
    return _pytree.tree_map(place, tree, shardings)
