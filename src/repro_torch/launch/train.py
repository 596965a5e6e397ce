"""Training entry point (port of ``repro/launch/train.py``): float32 master
weights under the config's compute dtype, the synthetic token stream, and
the supervised loop with checkpoint/restart, on one device (the card
unless ``--device cpu``) or over ranks on a ``("data", "model")`` mesh.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --tiny --steps 200 --batch 8 --seq 256 --ckpt-dir /path/to/ckpt

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 4 -m repro_torch.launch.train --arch llama3.2-1b \\
      --model-parallel 2 ...

Under ``torch.distributed.run`` (``RANK`` and ``WORLD_SIZE`` set) it
initialises the process group, NCCL on cards and gloo for ``--device
cpu`` (``--backend`` overrides: two ranks sharing one card need gloo,
NCCL refuses them).  Each rank takes ``cuda:LOCAL_RANK`` unless the
caller names a device (``--device cuda:<i>``); a ``LOCAL_RANK`` past the
visible cards is an error.

The mesh is ``best_mesh_shape(world, --model-parallel)`` over ``("data",
"model")``, as the reference's: the default 0 prefers the largest model
axis that divides the world ((1, 2) on 2 ranks), M >= 1 pins it, and a
world that M does not divide fails the reference's ``assert`` before any
group is made.  Every rank reads the same global ``TokenStream`` batch
and takes the rows of its ``data`` coordinate (``train.step
.shard_batch``: rows ``[r*B/n, (r+1)*B/n)`` over n data ranks without
accumulation), so the run sees the tokens a single-device run sees; a
``--batch`` that does not divide is a ValueError.

* M = 1 (data parallel): every rank holds the whole state and the
  gradients are averaged over the ranks (``--grad-compress``: the int8
  ring of ``distributed.collectives``).
* M > 1: the state is sharded over the mesh
  (``distributed.model_parallel.shard_model``: each rank holds its block
  of every float32 weight and of AdamW's ``m`` and ``v``) and the
  attention heads, MLP columns, MoE experts and vocabulary compute split
  over ``model`` (``--grad-compress`` is a ValueError there: the ring
  syncs whole replicated gradients).  The entry point prints the
  state's bytes a rank beside the dry run's ``sharded.state_bytes``
  (``launch.dryrun.sharded_state_bytes``).

Rank 0 writes the checkpoints and only rank 0 prints.  ``--metrics-out``
adds, a step, the ``model`` all-reduce ms and the ``data`` gather and
reduce-scatter ms (CUDA events) where M > 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from ..checkpoint.ckpt import flat_state
from ..core.aligner import resolve_device
from ..data.tokens import TokenStream
from ..models.registry import get_config, get_model, tiny_config
from ..optim.adamw import AdamWConfig
from ..runtime.elastic import best_mesh_shape, make_elastic_mesh
from ..runtime.ft import FailureInjector, supervise
from ..train.step import (init_state, make_allreduce_grad_sync,
                          make_train_step, replica_digest, shard_batch)


def build(args, device=None):
    """(config, model): the model with float32 master weights on `device`
    (default ``args.device``), drawn from a generator there seeded
    ``args.seed``, computing in ``args.dtype`` where it is given."""
    cfg = get_config(args.arch)
    if args.tiny:
        cfg = tiny_config(cfg, n_layers=args.layers or 2)
    else:
        over = {}
        if args.layers:
            over["n_layers"] = args.layers
        if args.d_model:
            over["d_model"] = args.d_model
        if over:
            cfg = dataclasses.replace(cfg, **over)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    dev = resolve_device(args.device if device is None else device)
    model = get_model(cfg, device=dev, param_dtype="float32",
                      generator=torch.Generator(device=dev)
                      .manual_seed(args.seed))
    return cfg, model


def rank_device(device: str) -> torch.device:
    """This rank's device: ``--device`` as given where it names one
    (``cpu``, ``cuda:<i>``), else ``cuda:LOCAL_RANK``; RuntimeError where
    ``LOCAL_RANK`` is not below the visible cards."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", 0))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {local} but "
                           f"{torch.cuda.device_count()} visible cards; "
                           f"pass --device cuda:<i> to share one")
    return torch.device("cuda", local)


def init_distributed(dev: torch.device, backend: str = "auto"):
    """The world's process group (None without ``RANK`` / ``WORLD_SIZE``
    in the environment): NCCL on cards, gloo on the CPU, or `backend`.
    Returns ``(group, created)``: a group initialised by the caller is
    used as it is."""
    import torch.distributed as dist
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None, False
    if dist.is_initialized():
        return dist.group.WORLD, False
    if backend == "auto":
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, device_id=dev if backend == "nccl" else None)
    return dist.group.WORLD, True


def _timed(fn, dev, times: list, mp=None, coll_times=None):
    """`fn` with each call's device time recorded (CUDA events; host time
    on the CPU) into `times`, and with an `mp` (``ModelParallel`` with
    ``timing`` on) the call's collectives into `coll_times`, a list a
    call."""
    def timed(*args):
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*args)
            ev[1].record()
            times.append(ev)
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            times.append((time.perf_counter() - t0) * 1e3)
        if mp is not None:
            coll_times.append(mp.take_times())
        return out
    return timed


def _ms(times: list) -> list:
    return [ev[0].elapsed_time(ev[1]) if isinstance(ev, list) else ev
            for ev in times]


def _collective_ms(steps: list) -> dict:
    """``{kind: [ms a step]}`` from ``ModelParallel.take_times`` records,
    a list a step (``_timed``)."""
    out = {}
    for i, records in enumerate(steps):
        for rec in records:
            ms = rec[1] if len(rec) == 2 else rec[1].elapsed_time(rec[2])
            row = out.setdefault(rec[0], [0.0] * len(steps))
            row[i] += ms
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=0)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="compute dtype (default: the config's); the "
                         "master weights are float32 either way")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "nccl", "gloo"))
    ap.add_argument("--grad-compress", action="store_true",
                    help="sync gradients with the int8 ring "
                         "(distributed.collectives)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None,
                    help="rank 0 writes the log, each step's time and "
                         "gradient sync time, peak memory and every "
                         "rank's replica digest here (JSON)")
    args = ap.parse_args(argv)

    world = int(os.environ["WORLD_SIZE"]) if "RANK" in os.environ \
        and "WORLD_SIZE" in os.environ else 1
    # before any group: the reference's assert, the rows, the flags
    shape = best_mesh_shape(world, args.model_parallel)
    if args.batch % (shape[0] * args.grad_accum):
        raise ValueError(f"--batch {args.batch} does not divide into "
                         f"{shape[0]} data ranks x --grad-accum "
                         f"{args.grad_accum}")
    if args.grad_compress and shape[1] > 1:
        raise ValueError(f"--grad-compress syncs whole replicated "
                         f"gradients; --model-parallel {args.model_parallel}"
                         f" gives a model axis of {shape[1]} on {world} "
                         f"ranks, whose state is sharded")
    dev = rank_device(args.device)
    group, created = init_distributed(dev, args.backend)
    try:
        return _run(args, dev, group, shape)
    finally:
        if created:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run(args, dev, group, mesh_shape):
    import torch.distributed as dist
    from .dryrun import sharded_state_bytes
    rank = dist.get_rank(group) if group is not None else 0
    world = dist.get_world_size(group) if group is not None else 1
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg, model = build(args, dev)
    split = mesh_shape[1] > 1
    mesh = make_elastic_mesh(mesh_shape[1], devices=[dev]) \
        if group is not None else make_elastic_mesh(
            args.model_parallel, devices=[model.device])
    shape = (dict(zip(mesh.mesh_dim_names, mesh.shape))
             if hasattr(mesh, "mesh_dim_names") else mesh.shape)
    n_params = sum(p.numel() for p in model.parameters())
    say(f"mesh: {shape} on {model.device}  arch: {cfg.name}  "
        f"params: {n_params / 1e6:.1f}M")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    sync_times, step_times, coll_times = [], [], []
    sync = mp = None
    if split:
        step_fn = make_train_step(model, opt_cfg,
                                  grad_accum=args.grad_accum, mesh=mesh)
        mp = model.mp
        mp.timing = bool(args.metrics_out)
    elif group is not None:
        if args.grad_compress:
            from ..distributed.collectives import make_compressed_grad_sync
            sync = make_compressed_grad_sync(group)
        else:
            sync = make_allreduce_grad_sync(group)
        if args.metrics_out:
            sync = _timed(sync, dev, sync_times)
    if not split:
        step_fn = make_train_step(model, opt_cfg,
                                  grad_accum=args.grad_accum, group=group,
                                  grad_sync=sync)
    if args.metrics_out:
        step_fn = _timed(step_fn, dev, step_times, mp, coll_times)
    state = init_state(model)
    state_bytes = sum(t.numel() * t.element_size()
                      for t in flat_state(state).values())
    dry_bytes = sharded_state_bytes(model, mesh) if split else None
    if split:
        say(f"state bytes a rank: {state_bytes} (dry run sharded."
            f"state_bytes on {shape}: {dry_bytes})")
    stream = TokenStream(cfg.vocab, args.batch, args.seq, args.seed,
                         family=cfg.family, d_model=cfg.d_model,
                         n_codebooks=cfg.n_codebooks)
    d_rank, d_size = (mp.coord["data"], mp.size["data"]) if split \
        else (rank, world)
    data = stream if group is None else (
        lambda i: shard_batch(stream.batch_at(i), d_rank, d_size,
                              args.grad_accum))
    injector = (FailureInjector([args.inject_failure_at])
                if args.inject_failure_at >= 0 else None)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    state, log, restarts = supervise(
        step_fn, state, data,
        steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, injector=injector,
        log_every=args.log_every, group=group)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    toks = args.steps * args.batch * args.seq
    for rec in log[-5:]:
        say(json.dumps(rec))
    losses = [r["loss"] for r in log if "loss" in r]
    say(f"done: {args.steps} steps, {restarts} restarts, "
        f"{toks/wall:.0f} tok/s, final loss "
        f"{losses[-1] if losses else float('nan'):.4f}")
    if args.metrics_out:
        digest = replica_digest(state)
        digests = [digest] * world
        if group is not None:
            dist.all_gather_object(digests, digest, group=group)
        if rank == 0:
            with open(args.metrics_out, "w") as f:
                json.dump({"log": log, "restarts": restarts, "world": world,
                           "mesh": shape, "device": str(dev),
                           "backend": dist.get_backend(group)
                           if group is not None else None,
                           "step_ms": _ms(step_times),
                           "sync_ms": _ms(sync_times), "wall_s": wall,
                           "collective_ms": _collective_ms(coll_times),
                           "paths": dict(mp.paths) if mp else None,
                           "staged": mp.stats["staged"] if mp else None,
                           "state_bytes": state_bytes,
                           "dryrun_state_bytes": dry_bytes,
                           "tokens": toks, "params": n_params,
                           "peak_memory_bytes":
                           torch.cuda.max_memory_allocated(dev)
                           if dev.type == "cuda" else None,
                           "digests": digests}, f)
    return log


if __name__ == "__main__":
    main()
