"""How the aligner's pair (batch) axis maps onto a device mesh (port of
the aligner half of ``repro/distributed/sharding.py``).

``pair_axes`` / ``n_pair_shards`` name the mesh's data axes,
``pair_pad_multiple`` is the batch quantum that gives every shard an
equal, tile-aligned share, and ``quantise_lanes`` / ``bucket_lanes`` /
``lane_classes`` quantise the session's lane classes to it, as in the
reference.  A mesh is a :class:`repro_torch.launch.mesh.DeviceMesh`; any
other object raises TypeError naming its type.

In place of the reference's NamedShardings and ``shard_map``, a batch is
held as one tensor a shard, each on its shard's device:
``pair_shards`` says which lanes go where, ``transfer.to_device(...,
shards=)`` copies each shard from host memory straight to its device,
``check_shards`` holds per-shard inputs to the mesh and ``merge_pairs``
joins per-shard downloads in lane order.

Shard boundaries are the reference's: the batch pads, notionally, to
B' = ceil(B / unit) * unit lanes (unit = ``pair_pad_multiple``), and
shard s, with s = pod * |data| + data, takes the lanes
[s * B' / n, (s + 1) * B' / n) that exist.  Shards with no real lane are
left out; they are always the last ones.  A ``model`` axis replicates in
the reference; here each pair shard runs once, on the device at
``model`` index 0 of its row.
"""
from __future__ import annotations

import numpy as np

from ..core.config import KERNEL_BACKENDS
from ..launch.mesh import DeviceMesh


def check_mesh(mesh) -> None:
    """Raise TypeError, naming its type, for a mesh that is not a
    DeviceMesh (None passes)."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.DeviceMesh "
                        f"or None, not {type(mesh).__name__}")


def pair_axes(mesh) -> tuple:
    """Mesh axes the alignment pair axis shards over (data-parallel)."""
    check_mesh(mesh)
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def n_pair_shards(mesh) -> int:
    """How many equal shards the pair axis splits into (1: no mesh)."""
    n = 1
    for a in pair_axes(mesh):
        n *= mesh.shape[a]
    return n


def pair_pad_multiple(cfg, mesh) -> int:
    """Batch-size quantum for sharded serving: lane_tile * n_devices for
    the kernel backends (each device's shard must hold whole pad units),
    n_devices for 'plain'.  1 when unsharded."""
    n = n_pair_shards(mesh)
    if n == 1:
        return 1
    tile = cfg.lane_tile if cfg.backend in KERNEL_BACKENDS else 1
    return n * tile


def quantise_lanes(n: int, cfg, mesh) -> int:
    """Round a lane count up to the batch quantum: the smallest multiple of
    `pair_pad_multiple(cfg, mesh)` >= n."""
    q = pair_pad_multiple(cfg, mesh)
    return -(-max(n, 1) // q) * q


def bucket_lanes(n: int, cfg, mesh) -> int:
    """The session's static lane class for an n-request dispatch: the
    smallest quantised power-of-two class >= n (classes are
    ``quantise_lanes(2**j)``), so ragged dispatch sizes collapse onto a
    handful of batch shapes.  Idempotent: a value that already IS a class
    maps to itself, even when the pair quantum is not a power of two."""
    p2 = 1
    while quantise_lanes(p2, cfg, mesh) < n:
        p2 *= 2
    return quantise_lanes(p2, cfg, mesh)


def lane_classes(ceiling: int, cfg, mesh) -> tuple:
    """The lane-class ladder up to (and including) ``bucket_lanes(ceiling)``,
    ascending: the batch shapes adaptive batching may step between."""
    top = bucket_lanes(max(ceiling, 1), cfg, mesh)
    out = []
    p2 = 1
    while True:
        c = quantise_lanes(p2, cfg, mesh)
        if not out or c > out[-1]:
            out.append(c)
        if c >= top:
            return tuple(out)
        p2 *= 2


def mesh_fingerprint(mesh) -> tuple:
    """Stable identity of a mesh for process-wide executable-cache keys:
    axis names, axis sizes and each flat device's index (0 for the CPU).
    The cache key carries the session's device string beside it, so a
    CPU mesh and a CUDA mesh never share an executable."""
    check_mesh(mesh)
    if mesh is None:
        return ("nomesh",)
    names = tuple(mesh.axis_names)
    sizes = tuple(int(mesh.shape[a]) for a in names)
    ids = tuple(d.index or 0 for d in mesh.devices.flat)
    return (names, sizes, ids)


def pair_devices(mesh) -> tuple:
    """The device of each pair shard, in shard order (pod-major, then
    data): the device at ``model`` index 0 of the shard's row."""
    axes = pair_axes(mesh)
    names = mesh.axis_names
    order = [names.index(a) for a in axes]
    order += [i for i in range(len(names)) if i not in order]
    flat = np.transpose(mesh.devices, order).reshape(n_pair_shards(mesh), -1)
    return tuple(flat[:, 0])


def pair_shards(n_lanes: int, cfg, mesh):
    """The shards of an `n_lanes` batch on `mesh`: (device, lane slice)
    per shard that holds a real lane, in lane order (module docstring).
    None when `mesh` is None, so a caller passes it on unchanged."""
    if mesh is None:
        return None
    n = n_pair_shards(mesh)
    per = quantise_lanes(n_lanes, cfg, mesh) // n
    return tuple((dev, slice(s * per, min((s + 1) * per, n_lanes)))
                 for s, dev in enumerate(pair_devices(mesh))
                 if s * per < n_lanes)


_ARG_NAMES = ("reads", "read_len", "refs", "ref_len")


def check_shards(args, mesh) -> None:
    """Raise unless `args` are per-shard tensors for `mesh`: each a
    sequence of the same number of tensors, at least one and at most
    ``n_pair_shards(mesh)``, shard i on the mesh's i-th pair device, with
    equal lane counts across one shard's arrays."""
    devices = pair_devices(mesh)
    counts = {len(a) if isinstance(a, (tuple, list)) else None
              for a in args}
    if len(counts) != 1 or None in counts or not 0 < counts.pop() <= len(
            devices):
        raise TypeError(f"on a mesh of {len(devices)} pair shards, "
                        f"{', '.join(_ARG_NAMES)} are each a tuple of one "
                        f"tensor a shard (transfer.to_device(..., shards=))")
    for i, shard in enumerate(zip(*args)):
        want = devices[i]
        for name, t in zip(_ARG_NAMES, shard):
            if t.device.type != want.type or (
                    want.index is not None and t.device.index != want.index):
                raise ValueError(f"{name} of shard {i} is on {t.device}; "
                                 f"the mesh puts that shard on {want}")
        if len({t.shape[0] for t in shard}) != 1:
            raise ValueError(f"shard {i}: lane counts differ across "
                             f"{_ARG_NAMES}: {[t.shape[0] for t in shard]}")


def merge_pairs(parts):
    """Join per-shard host arrays in lane order: one array, as the
    unsharded batch would have given."""
    return np.concatenate(parts) if len(parts) > 1 else parts[0]

