"""Device meshes for the aligner (port of ``repro/launch/mesh.py``).

PyTorch has no mesh object, so the port defines one: a :class:`DeviceMesh`
is an array of ``torch.device`` shaped like the mesh, with one name from
``pod``, ``data`` and ``model`` per axis.  It holds no device state; the
aligner's pair axis shards over its ``pod`` and ``data`` axes
(``distributed.sharding``).

``make_test_mesh`` takes every visible CUDA device by default.  A device
appears more than once only where the caller lists it: one card listed N
times (or ``cpu`` listed N times, as the tests do) is an N-shard mesh
whose shards run one after another on that device.
"""
from __future__ import annotations

import numpy as np
import torch

AXIS_NAMES = ("pod", "data", "model")


class DeviceMesh:
    """``devices``: a numpy object array of ``torch.device``, shaped like
    the mesh; ``axis_names``: one name a dimension, from AXIS_NAMES, none
    twice; ``shape``: axis name -> size, in axis order (as
    ``jax.sharding.Mesh.shape``).  Meshes over the same devices with the
    same axes are equal."""

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx, d in np.ndenumerate(np.asarray(devices, dtype=object)):
            arr[idx] = torch.device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} for "
                             f"{len(axis_names)} axis names {axis_names}")
        if (len(set(axis_names)) != len(axis_names)
                or not set(axis_names) <= set(AXIS_NAMES)):
            raise ValueError(f"axis_names={axis_names}: each must be one of "
                             f"{AXIS_NAMES}, none twice")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def _key(self):
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, DeviceMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        return (f"DeviceMesh({self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def make_test_mesh(shape=(2, 2), axes=("data", "model"), devices=None):
    """A mesh of `shape` over `devices` (default: every visible CUDA
    device, in index order).  Raises ValueError where the shape's product
    differs from the number of devices."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{int(np.prod(shape))} devices, got "
                         f"{len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return DeviceMesh(arr.reshape(shape), axes)


def batch_axes(mesh) -> tuple:
    """Axes the global batch shards over."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
