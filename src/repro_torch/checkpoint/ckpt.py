"""Checkpointing (port of ``repro/checkpoint/ckpt.py``): atomic,
manifest-driven, async-capable.

The layout on disk is the reference's: ``<dir>/step_%08d/shard_0.npz``
with every leaf of the training state under its name, and
``manifest.json`` (``step``, ``keys`` sorted, ``n_shards``, ``time``);
a checkpoint is written to ``.tmp_step_<N>`` and renamed into place
(``os.replace``), and only the newest `keep` are kept.  The names are the
port's: ``model.<parameter>``, ``opt.m.<parameter>``,
``opt.v.<parameter>`` and ``opt.step`` (``flat_state``).

The values are copied from the device to the host before
``save_checkpoint`` returns; with ``async_save`` a thread writes them.
``np.savez`` has no bfloat16, and the training state is float32 (the
float32 master weights and AdamW moments), so a bfloat16 leaf is refused
rather than upcast.  A restore loads into the tensors of the state it is
given, in place on their devices, or, for an ``abstract_state`` (tensors
on the ``meta`` device), into new CPU tensors.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch
from torch import nn


def flat_state(state) -> dict:
    """name -> tensor of a training state ``{"model": nn.Module or {name:
    tensor}, "opt": {"m", "v", "step"}}``."""
    model = state["model"]
    params = (dict(model.named_parameters()) if isinstance(model, nn.Module)
              else model)
    flat = {f"model.{n}": p for n, p in params.items()}
    for part in ("m", "v"):
        flat.update({f"opt.{part}.{n}": t
                     for n, t in state["opt"][part].items()})
    flat["opt.step"] = state["opt"]["step"]
    return flat


def _nest(flat: dict) -> dict:
    """``flat_state``'s inverse for a state of plain mappings."""
    state = {"model": {}, "opt": {"m": {}, "v": {}}}
    for key, t in flat.items():
        if key == "opt.step":
            state["opt"]["step"] = t
        elif key.startswith("model."):
            state["model"][key[len("model."):]] = t
        else:
            state["opt"][key[len("opt.")]][key[len("opt.m."):]] = t
    return state


def save_checkpoint(ckpt_dir, state, step: int, *, keep: int = 3,
                    async_save: bool = False):
    """Atomic: write to a tmp dir, rename.  Returns the checkpoint's path
    (or the in-flight thread when `async_save`).  Raises ValueError,
    writing nothing, for a bfloat16 leaf."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    flat = flat_state(state)
    bf16 = sorted(k for k, t in flat.items() if t.dtype == torch.bfloat16)
    if bf16:
        raise ValueError(f"bfloat16 leaves {bf16[:8]}: np.savez has no "
                         f"bfloat16 and a checkpoint does not upcast; "
                         f"train float32 master weights "
                         f"(get_model(..., param_dtype='float32'))")
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    # snapshot to host memory synchronously (copies, never views of the
    # live tensors the next step updates in place); write async if asked
    host = {k: t.detach().to("cpu", copy=True).numpy()
            for k, t in flat.items()}

    def _write():
        tmp = ckpt_dir / f".tmp_step_{step}"
        tmp.mkdir(exist_ok=True)
        np.savez(tmp / "shard_0.npz", **host)
        (tmp / "manifest.json").write_text(json.dumps(
            {"step": step, "keys": sorted(host), "n_shards": 1,
             "time": time.time()}))
        final = ckpt_dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(ckpt_dir, keep)

    if async_save:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return ckpt_dir / f"step_{step:08d}"


def _gc(ckpt_dir: pathlib.Path, keep: int):
    ckpts = sorted(p for p in ckpt_dir.iterdir() if p.name.startswith("step_"))
    for p in ckpts[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
                   if p.name.startswith("step_"))
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir, state, *, step: int | None = None):
    """Load checkpoint `step` (default: the latest) into `state` and return
    ``(state, step)``.  A live state (``train.step.init_state``) is loaded
    in place, each tensor on its own device; an ``abstract_state`` gives a
    new state of CPU tensors.  Raises ValueError, loading nothing, where a
    name, shape or dtype differs from the checkpoint's."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    flat = flat_state(state)
    with np.load(ckpt_dir / f"step_{step:08d}" / "shard_0.npz") as data:
        arrays = {k: torch.from_numpy(data[k]) for k in data.files}
    missing = sorted(set(flat) - set(arrays))
    extra = sorted(set(arrays) - set(flat))
    bad = [(k, tuple(arrays[k].shape), arrays[k].dtype, tuple(t.shape),
            t.dtype) for k, t in flat.items() if k in arrays and
           (arrays[k].shape != t.shape or arrays[k].dtype != t.dtype)]
    if missing or extra or bad:
        raise ValueError(f"checkpoint step {step} in {ckpt_dir} does not "
                         f"match the state: missing {missing[:8]}, "
                         f"unexpected {extra[:8]}, (name, shape, dtype "
                         f"saved, wanted) {bad[:8]}")
    if all(t.is_meta for t in flat.values()):
        return _nest({k: arrays[k] for k in flat}), step
    with torch.no_grad():
        for k, t in flat.items():
            t.copy_(arrays[k])
    return state, step
