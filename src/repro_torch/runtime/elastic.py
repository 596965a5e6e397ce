"""Elastic scaling (port of ``repro/runtime/elastic.py``): a ``("data",
"model")`` mesh over the devices that are there now.

Checkpoints are logical (``checkpoint/ckpt.py``), so a rescale is a
restore under the new mesh.  Re-placing a live training state onto a
mesh (``reshard``) waits for the port's multi-card training (ROADMAP
Queue 1 item 4): the port trains on one device.
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
    """A ``DeviceMesh`` with axes ``("data", "model")`` over `devices`
    (default: every visible CUDA device; a RuntimeError where there is
    none), shaped by ``best_mesh_shape``."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    shape = best_mesh_shape(len(devices), model_parallel)
    return make_test_mesh(shape, ("data", "model"), devices)


def reshard(tree, pspec_tree, mesh):
    """Not ported yet: placing a training state onto a mesh needs the
    port's multi-card training (``state_partition_specs``,
    ``distributed/collectives.py``)."""
    raise NotImplementedError(
        "reshard needs multi-card training, ROADMAP Queue 1 item 4; the "
        "port trains on one device")
