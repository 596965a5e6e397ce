"""The arithmetic half of ``repro/distributed/sharding.py``: how the
aligner's pair (batch) axis is quantised into the lane classes the session
front door (``repro_torch.api``) dispatches.

Only ``mesh=None`` runs: one card is one device.  Any other mesh raises
NotImplementedError (multi-device is ROADMAP Queue 1 item 8), never a
quiet single-device run.  Unsharded, the pair quantum is 1 on every
backend, so lane classes are the powers of two, as in the reference.
"""
from __future__ import annotations

from ..core.config import KERNEL_BACKENDS


def _refuse(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"mesh={mesh!r}: the port runs on one device (mesh=None); "
            f"sharding the pair axis over a mesh is ROADMAP Queue 1 "
            f"item 8")


def n_pair_shards(mesh) -> int:
    """How many equal shards the pair axis splits into (1: no mesh)."""
    _refuse(mesh)
    return 1


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
    """Stable identity of a mesh for process-wide executable-cache keys."""
    _refuse(mesh)
    return ("nomesh",)
