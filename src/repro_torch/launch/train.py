"""Training entry point (port of ``repro/launch/train.py``): float32 master
weights under the config's compute dtype, the synthetic token stream, and
the supervised loop with checkpoint/restart, on one device (the card
unless ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --tiny --steps 200 --batch 8 --seq 256 --ckpt-dir /path/to/ckpt

Training over several cards (``--model-parallel`` above 1, a data axis)
waits for ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from ..core.aligner import resolve_device
from ..data.tokens import TokenStream
from ..models.registry import get_config, get_model, tiny_config
from ..optim.adamw import AdamWConfig
from ..runtime.elastic import make_elastic_mesh
from ..runtime.ft import FailureInjector, supervise
from ..train.step import init_state, make_train_step


def build(args):
    """(config, model): the model with float32 master weights on
    ``args.device``, drawn from a generator there seeded ``args.seed``."""
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
    dev = resolve_device(args.device)
    model = get_model(cfg, device=dev, param_dtype="float32",
                      generator=torch.Generator(device=dev)
                      .manual_seed(args.seed))
    return cfg, model


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
    args = ap.parse_args(argv)
    if args.model_parallel not in (0, 1):
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: training over several "
            f"cards is ROADMAP Queue 1 item 4; the port trains on one "
            f"device")

    cfg, model = build(args)
    mesh = make_elastic_mesh(args.model_parallel, devices=[model.device])
    n_params = sum(p.numel() for p in model.parameters())
    print(f"mesh: {mesh.shape} on {model.device}  arch: {cfg.name}  "
          f"params: {n_params / 1e6:.1f}M")

    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(10, args.steps // 20))
    step_fn = make_train_step(model, opt_cfg, grad_accum=args.grad_accum)
    state = init_state(model)
    stream = TokenStream(cfg.vocab, args.batch, args.seq, args.seed,
                         family=cfg.family, d_model=cfg.d_model,
                         n_codebooks=cfg.n_codebooks)
    injector = (FailureInjector([args.inject_failure_at])
                if args.inject_failure_at >= 0 else None)
    t0 = time.time()
    state, log, restarts = supervise(
        step_fn, state, stream, steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        injector=injector)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.time() - t0
    toks = args.steps * args.batch * args.seq
    for rec in log[-5:]:
        print(json.dumps(rec))
    losses = [r["loss"] for r in log if "loss" in r]
    print(f"done: {args.steps} steps, {restarts} restarts, "
          f"{toks/wall:.0f} tok/s, final loss "
          f"{losses[-1] if losses else float('nan'):.4f}")
    return log


if __name__ == "__main__":
    main()
