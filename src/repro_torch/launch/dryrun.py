"""Dry run of every (architecture x input-shape) cell of the LM scaffold
(port of ``repro/launch/dryrun.py``): the cell's step at full size with
nothing allocated, its FLOPs, bytes and memory a card, and its roofline
on H100s.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all [--mesh 8x1] [--out build/dryrun]

The reference lowers and compiles each cell with XLA on its production
meshes and reads XLA's cost and memory analyses.  The port has no XLA;
its counterparts:

* **Build**: the model on the ``meta`` device at the cell's full config
  (``get_model(device="meta")``: shapes and dtypes, no memory, no draw),
  then the cell's step on ``input_specs``: loss, backward and
  ``adamw_update`` for ``train``; ``prefill``; ``decode_step`` on
  ``abstract_cache``.  Each card of the port's data-parallel trainer runs
  the step on its share of the global batch, so the step runs on
  ``ceil(GB / cards)`` rows (``rows_per_card``), as the reference's
  per-device program; the global figures are a card's times the cards
  that hold rows.
* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over that run
  (matmuls, attention, convolutions; elementwise ops count nothing).
  The port's layers are a Python loop, so a full-depth count is exact;
  ``cost_points`` also holds the counts at ``depth_unit`` and twice it,
  the reference's two-point extrapolation, and ``extrapolated_flops``.
* **Bytes**, twice: ``bytes_upper_bound``, a ``TorchDispatchMode``
  summing every aten op's input and output bytes (views excluded): the
  unfused counterpart of XLA's "bytes accessed", an upper bound of what a
  fused step moves, reported beside the roofline and never in it
  (``memory_upper_s``); and ``bytes_lower_bound``, what the step must move
  at the least, each byte read or written once (``_bytes_lower_bound``),
  the memory term of the roofline, so ``bound_s`` is a lower bound on
  the step's time.
* **Memory a card**, twice: ``replicated``, what the port's data-parallel
  trainer holds (the full float32 state and its float32 gradients plus
  the batch shard for ``train``; the bfloat16 weights plus the cache
  shard for serving), and ``sharded``, the bytes of every leaf's shard
  under the fitted ``state_partition_specs`` / ``cache_pspecs`` on
  ``--mesh`` (what ``runtime.elastic.reshard`` places and what a model
  axis would run).  Each adds the activations: for ``train`` the tensors
  autograd saves for backward (``saved_tensors_hooks``; with remat the
  layers' inputs), the counterpart of ``temp_bytes``; for serving the
  largest single op output.  ``fits`` holds each total against the
  card's 80 GB.
* **Collectives a card**: the data-parallel trainer's own, a ring
  all-reduce of the float32 gradients, 2 (n - 1) / n x 4 B x N, and
  ``int8_ring_bytes`` for ``distributed.collectives`` (about a quarter);
  serving replicas exchange nothing.  They go through
  ``analysis.roofline.roofline_terms`` (H100 constants, NVLink).

``long_500k`` is skipped, with the reference's message, for
architectures that are not sub-quadratic.  JSON goes under ``--out``
(default ``build/dryrun``, ignored by git), one file a cell.

The spec helpers (``fit_pspec``, ``batch_pspec``, ``cache_pspecs``,
``tree_shardings``) are the reference's decisions on specs written as
tuples (a mesh-axis name, a tuple of names, or None a dimension; the
port has no ``PartitionSpec``) over any mesh-like object with ``.shape``
(name -> size) and ``.axis_names``: the port's ``launch.mesh.DeviceMesh``,
a ``torch.distributed.device_mesh.DeviceMesh`` (through ``mesh_axes``) or
a stub.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..analysis.roofline import (HBM_BW, count_params, model_flops,
                                 roofline_terms, useful_fraction)
from ..models.registry import (ARCH_IDS, SHAPES, batch_specs, get_config,
                               get_model, input_specs, shape_applicable,
                               tiny_config)
from ..optim.adamw import AdamWConfig
from ..train.step import init_state, make_train_step

OUT_DIR = pathlib.Path("build/dryrun")
CARD_BYTES = 80e9          # one H100 SXM's HBM3
SKIP_MESSAGE = "long_500k requires sub-quadratic mixing (DESIGN.md §4)"


# ------------------------------------------------------------- meshes ----

@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """A mesh's axis names and sizes: ``shape`` name -> size, in axis
    order, and ``axis_names``."""
    names: tuple
    sizes: tuple

    @property
    def axis_names(self) -> tuple:
        return self.names

    @property
    def shape(self) -> dict:
        return dict(zip(self.names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def mesh_axes(mesh) -> MeshAxes:
    """`mesh`'s names and sizes: a ``torch.distributed`` DeviceMesh (its
    ``mesh_dim_names``), or anything with ``.shape`` (name -> size) and
    ``.axis_names``."""
    if isinstance(mesh, MeshAxes):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return MeshAxes(tuple(names), tuple(int(s) for s in mesh.shape))
    return MeshAxes(tuple(mesh.axis_names),
                    tuple(int(mesh.shape[a]) for a in mesh.axis_names))


def parse_mesh(text: str) -> MeshAxes:
    """``"8x1"`` -> (data 8, model 1); ``"2x16x16"`` -> (pod 2, data 16,
    model 16)."""
    sizes = tuple(int(s) for s in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(sizes))
    if names is None or min(sizes) < 1:
        raise ValueError(f"--mesh {text!r}: want DATAxMODEL or "
                         f"PODxDATAxMODEL, e.g. 8x1, 2x4, 16x16, 2x16x16")
    return MeshAxes(names, sizes)


# -------------------------------------------------------------- specs ----

def _axis_size(mesh, axes):
    n = 1
    shape = mesh.shape
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        if a not in shape:
            return 0          # axis absent from this mesh -> can't shard
        n *= shape[a]
    return n


class PSpec(tuple):
    """A fitted spec: one entry a dimension, a mesh-axis name, a tuple of
    names or None.  A tuple that ``torch.utils._pytree`` keeps as one leaf
    (a cache's tuples of states stay apart from their specs)."""

    def __repr__(self):
        return f"PSpec{tuple(self)!r}"


def fit_pspec(shape, spec, mesh) -> PSpec:
    """Drop partition axes that don't divide the dimension (e.g. batch=1)
    or that the mesh lacks; one entry a dimension."""
    out = []
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        if ax is None:
            out.append(None)
            continue
        sz = _axis_size(mesh, ax)
        if isinstance(ax, tuple) and len(ax) == 1:
            ax = ax[0]        # as PartitionSpec writes a one-axis tuple
        out.append(ax if sz and dim % sz == 0 else None)
    return PSpec(out)


def _zero_over_pod(sp, mesh):
    """The logical 'data' axis of a parameter spec widens to ('pod',
    'data') on a mesh with pods (ZeRO over pods too)."""
    if "pod" not in mesh.axis_names:
        return sp
    return tuple(("pod", "data") if a == "data" else a for a in sp)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: `mesh` and its fitted `spec` (the port's
    stand-in for ``jax.sharding.NamedSharding``;
    ``runtime.elastic.placements`` turns it into DTensor placements)."""
    mesh: object
    spec: tuple


def tree_shardings(tree, spec_tree, mesh, zero_pod: bool = False):
    """A ``NamedSharding`` a leaf of `tree` (nested dicts, lists and
    tuples of tensors, or of anything with a ``.shape``) from the logical
    spec at the same place of `spec_tree` (dicts matched by key), fitted
    to `mesh`."""
    axes = mesh_axes(mesh)

    def walk(t, sp):
        if isinstance(t, dict):
            return {k: walk(v, sp[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, s_) for v, s_ in zip(t, sp, strict=True))
        sp = tuple(sp)
        if zero_pod:
            sp = _zero_over_pod(sp, axes)
        return NamedSharding(mesh, fit_pspec(tuple(t.shape), sp, axes))
    return walk(tree, spec_tree)


def _dp(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def batch_pspec(t, mesh) -> PSpec:
    """Shard the leading batch dim over (pod,)data; positions (3,B,S) on
    dim 1; scalars replicated."""
    mesh = mesh_axes(mesh)
    shape = tuple(t.shape)
    if len(shape) == 0:
        return PSpec()
    if len(shape) == 3 and shape[0] == 3:   # M-RoPE positions
        return fit_pspec(shape, (None, _dp(mesh), None), mesh)
    return fit_pspec(shape, (_dp(mesh),) + (None,) * (len(shape) - 1), mesh)


def cache_pspecs(cache, mesh):
    """KV caches shard batch over data and *sequence over model*; SSM /
    conv / xLSTM states shard batch and the largest inner dim where
    divisible (the reference's decisions), a spec a leaf of `cache`."""
    mesh = mesh_axes(mesh)
    dp = _dp(mesh)

    def one(path, s):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        shape = tuple(s.shape)
        if "kv" in keys:           # (L/A, B, S, KV, Dh)
            return fit_pspec(shape, (None, dp, "model", None, None), mesh)
        if "ssm" in keys:          # (L, B, H, N, P)
            return fit_pspec(shape, (None, dp, "model", None, None), mesh)
        if "conv" in keys:         # (L, B, dconv-1, ch)
            return fit_pspec(shape, (None, dp, None, "model"), mesh)
        if "states" in keys:       # xlstm per-layer states, B leading
            return fit_pspec(shape, (dp,) + (None,) * (len(shape) - 1), mesh)
        return PSpec()

    return _pytree.tree_map_with_path(one, cache)


def depth_unit(cfg):
    return max(cfg.local_global_every, cfg.shared_attn_every,
               cfg.slstm_every, 1)


def shard_bytes(t, spec, mesh) -> int:
    """Bytes of one card's shard of `t` under the fitted `spec`."""
    mesh = mesh_axes(mesh)
    n = 1
    for ax in spec:
        if ax is not None:
            n *= _axis_size(mesh, ax)
    return t.numel() * t.element_size() // n


# ------------------------------------------------------------ counting ----

class BytesMode(TorchDispatchMode):
    """Sums every aten op's input and output tensor bytes (views and
    ``detach`` excluded: they move nothing), and keeps the largest single
    output."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.largest_output = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func is not torch.ops.aten.detach.default:
            ins = [t for t in _pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            outs = [t for t in _pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
            self.largest_output = max([self.largest_output] + [
                t.numel() * t.element_size() for t in outs])
            self.ops += 1
        return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def cell_config(arch: str, *, n_layers=None, tiny: bool = False):
    cfg = get_config(arch)
    if tiny:
        cfg = tiny_config(cfg)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def _rows(batch: dict, rows: int) -> dict:
    """`batch` cut to its first `rows` rows (positions on dim 1)."""
    return {k: v if v.ndim == 0 else
            v[:, :rows] if k == "positions" and v.ndim == 3 else v[:rows]
            for k, v in batch.items()}


def lower_cell(arch: str, shape: str, *, n_layers=None, tiny: bool = False,
               rows: int | None = None):
    """Build the cell's model on ``meta`` and run its step once on `rows`
    rows of the cell's global batch (default all) under the counters.
    Returns ``(counts, cfg, meta)``: counts ``flops``, ``bytes``,
    ``largest_output_bytes``, ``saved_bytes``, ``aten_ops``."""
    cfg = cell_config(arch, n_layers=n_layers, tiny=tiny)
    S, GB, kind = SHAPES[shape]
    if tiny:
        S, GB = 128, 8
    rows = GB if rows is None else rows
    batch = _rows(input_specs(cfg, shape, tiny=tiny)["batch"], rows)
    counts = _lower(cfg, batch, kind, S, rows)
    return counts, cfg, {"seq": S, "batch": GB, "rows": rows, "kind": kind}


def _lower(cfg, batch: dict, kind: str, S: int, rows: int) -> dict:
    """``lower_cell``'s counts of one step of `kind` on `batch` (`rows`
    rows of `S` tokens) with the model on ``meta``."""
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    flops, moved = FlopCounterMode(display=False), BytesMode()
    if kind == "train":
        model = get_model(cfg, device="meta", param_dtype="float32")
        step = make_train_step(model, AdamWConfig())
        state = init_state(model)
        with flops, moved, torch.autograd.graph.saved_tensors_hooks(
                pack, lambda t: t):
            step(state, batch)
        if cfg.remat:           # each layer's input, kept for its recompute
            saved[0] += cfg.n_layers * rows * S * cfg.d_model \
                * model.compute_dtype.itemsize
    else:
        model = get_model(cfg, device="meta")
        with flops, moved:
            if kind == "prefill":
                model.prefill(batch)
            else:               # the position does not change the work
                model.decode_step(dict(batch, cache_pos=0),
                                  model.abstract_cache(rows, S))
    return {"flops": float(flops.get_total_flops()),
            "bytes": float(moved.bytes),
            "largest_output_bytes": moved.largest_output,
            "saved_bytes": saved[0], "aten_ops": moved.ops}


def _bytes_lower_bound(kind: str, n_params: int, n_active: int,
                       batch: dict, cache, rows: int) -> dict:
    """The bytes a card's step must move at the least, each read or
    written once, by part: for ``train`` the float32 state AdamW reads
    (weight, gradient, m, v) and writes (weight, m, v), 7 x 4 B a
    parameter; for serving the bfloat16 weights a token meets
    (`n_active`) read once and the card's cache (`cache`, the decode
    cache a prefill writes or a decode step reads) once; and the card's
    `rows` of `batch` read once."""
    parts = {"state_bytes": 7 * 4 * n_params} if kind == "train" else {
        "weight_bytes": 2 * n_active,
        "cache_bytes": 0 if cache is None else _nbytes(cache)}
    parts["batch_bytes"] = _nbytes(_rows(batch, rows))
    parts["total_bytes"] = sum(parts.values())
    return parts


def _active_params(model, cfg):
    """Parameters a token meets: every parameter less the experts it is
    not routed to (``(1 - top_k / n_experts)`` of the experts' weights;
    the router counts whole)."""
    total = count_params(model)
    if cfg.n_experts:
        expert = sum(p.numel() for n, p in model.named_parameters()
                     if ".moe." in n and not n.endswith(".router"))
        total = total - int(expert * (1 - cfg.top_k / cfg.n_experts))
    return total


def _fit(p, spec, mesh):
    return fit_pspec(tuple(p.shape), _zero_over_pod(spec, mesh), mesh)


def _shard_elems(model, mesh) -> int:
    """Each parameter's elements on a card under its fitted spec, summed
    (the whole shapes of a model that ``model_parallel.shard_model``
    sharded)."""
    from ..distributed.model_parallel import of
    mp, specs = of(model), model.partition_specs()
    mesh = mesh_axes(mesh)
    total = 0
    for n, p in model.named_parameters():
        whole = torch.empty(mp.shapes[n] if mp else p.shape, device="meta")
        total += shard_bytes(whole, _fit(whole, specs[n], mesh), mesh) \
            // whole.element_size()
    return total


def sharded_state_bytes(model, mesh) -> int:
    """``memory.sharded.state_bytes`` of a training cell of `model` on
    `mesh`: the float32 weight, ``m`` and ``v`` of every parameter's
    block under its fitted spec, and the int32 step (what a rank of
    ``launch.train`` holds on that mesh)."""
    return 12 * _shard_elems(model, mesh) + 4


def train_memory(cfg, seq: int, global_batch: int, mesh) -> dict:
    """``memory.sharded`` of a training step of `cfg` (float32 masters,
    the config's compute dtype) on `global_batch` x `seq` tokens on
    `mesh`: each ``data`` rank's rows run through the step on ``meta``."""
    mesh = mesh_axes(mesh)
    batch = batch_specs(cfg, seq, global_batch, "train")
    rows = global_batch // _axis_size(mesh, _dp(mesh))
    counts = _lower(cfg, _rows(batch, rows), "train", seq, rows)
    return _memory(get_model(cfg, device="meta"), "train", counts, batch,
                   None, rows, mesh, mesh.size)["sharded"]


def _memory(model, kind: str, counts: dict, inputs: dict, cache, rows: int,
            mesh: MeshAxes, cards: int) -> dict:
    """``replicated`` and ``sharded`` bytes a card, each with its parts
    and ``fits`` against ``CARD_BYTES``: `inputs` and `cache` are the
    cell's global ones, `rows` a card's share of the batch."""
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    GB = _pytree.tree_leaves(inputs)[0].shape[0] if "positions" not in \
        inputs else inputs["positions"].shape[1]
    act = counts["saved_bytes"] if kind == "train" \
        else counts["largest_output_bytes"]
    elems = _shard_elems(model, mesh)
    if kind == "train":         # float32 weight, m, v and gradient
        rep = {"state_bytes": 12 * n_params + 4, "grad_bytes": 4 * n_params}
        shard = {"state_bytes": 12 * elems + 4, "grad_bytes": 4 * elems}
    else:                       # bfloat16 weights
        rep, shard = {"weight_bytes": 2 * n_params}, \
            {"weight_bytes": 2 * elems}
        if cache is not None:
            rep["cache_bytes"] = _nbytes(cache) * rows // GB
            shard["cache_bytes"] = sum(
                shard_bytes(t, sp, mesh) for t, sp in zip(
                    _pytree.tree_leaves(cache),
                    _pytree.tree_leaves(cache_pspecs(cache, mesh))))
    dp = _axis_size(mesh, _dp(mesh))
    shard_rows = GB // dp if GB % dp == 0 else GB
    rep.update(batch_bytes=_nbytes(_rows(inputs, rows)),
               activation_bytes=act)
    shard.update(batch_bytes=_nbytes(_rows(inputs, shard_rows)),
                 activation_bytes=act * shard_rows // rows)
    for part in (rep, shard):
        part["total_bytes"] = sum(part.values())
    return {"replicated": {**rep, "cards": cards, "rows_per_card": rows},
            "sharded": {**shard, "mesh": mesh.shape,
                        "rows_per_card": shard_rows},
            "fits": {"replicated": rep["total_bytes"] <= CARD_BYTES,
                     "sharded": shard["total_bytes"] <= CARD_BYTES},
            "card_bytes": CARD_BYTES}


def run_cell(arch: str, shape: str, out_dir=None, mesh="8x1",
             tiny: bool = False) -> dict:
    """The cell's record: its counts at full depth and at the two depth
    points, memory a card, collective bytes and the roofline on
    ``mesh.size`` cards of the port's data-parallel trainer.  Writes
    ``<out_dir>/<arch>__<shape>.json`` when `out_dir` is given."""
    mesh = parse_mesh(mesh) if isinstance(mesh, str) else mesh_axes(mesh)
    cfg0 = cell_config(arch, tiny=tiny)
    if not shape_applicable(cfg0, shape):
        rec = {"arch": arch, "shape": shape, "skipped": SKIP_MESSAGE}
        _write(rec, out_dir)
        return rec
    t0 = time.time()
    S, GB, kind = SHAPES[shape]
    if tiny:
        S, GB = 128, 8
    cards = min(mesh.size, GB)              # cards that hold a row
    rows = -(-GB // cards)
    counts, cfg, meta = lower_cell(arch, shape, tiny=tiny, rows=rows)
    unit = depth_unit(cfg0)
    points = {}
    for mult in (1, 2):
        points[mult] = counts if unit * mult == cfg0.n_layers else \
            lower_cell(arch, shape, n_layers=unit * mult, tiny=tiny,
                       rows=rows)[0]
    Lf = cfg0.n_layers

    def extrap(key):
        f1, f2 = points[1][key], points[2][key]
        return f1 + (f2 - f1) * (Lf - unit) / unit

    model = get_model(cfg0, device="meta")
    specs = input_specs(cfg0, shape, tiny=tiny)
    n_params = count_params(model)
    n_active = _active_params(model, cfg0)
    memory = _memory(model, kind, counts, specs["batch"], specs.get("cache"),
                     rows, mesh, cards)
    # a ring all-reduce of the float32 gradients: 2 (n - 1) / n of them a
    # card; the int8 ring: n - 1 hops of a chunk and its scale, then an
    # all-gather of as many
    train = kind == "train"
    ring = 2 * (cards - 1) / cards * 4 * n_params if train else 0.0
    int8_ring = 2 * (cards - 1) / cards * (n_params + 4 * cards) \
        if train else 0.0
    flops_global = counts["flops"] * cards
    bytes_global = counts["bytes"] * cards
    lower = _bytes_lower_bound(kind, n_params, n_active, specs["batch"],
                               None if train else model.abstract_cache(
                                   rows, S), rows)
    tokens = GB * S if kind in ("train", "prefill") else GB
    mfl = model_flops(n_active, tokens, train)
    terms = roofline_terms(flops_global, lower["total_bytes"] * cards, ring,
                           cards)
    rec = {"arch": arch, "shape": shape, "tiny": tiny, **meta,
           "cards": cards, "mesh": mesh.shape,
           "memory": memory,
           "cost_per_card": {"flops": counts["flops"],
                             "bytes_upper_bound": counts["bytes"],
                             "aten_ops": counts["aten_ops"]},
           "roofline": {
               **terms,
               "flops_global": flops_global,
               "bytes_lower_bound": lower,
               "bytes_upper_bound_global": bytes_global,
               "memory_upper_s": bytes_global / (cards * HBM_BW),
               "coll_wire_bytes_per_card": ring,
               "int8_ring_bytes_per_card": int8_ring,
               "model_flops": mfl,
               "useful_fraction": useful_fraction(mfl, flops_global),
               "n_params": n_params,
               "n_active_params": n_active,
               "depth_unit": unit,
               "extrapolated_flops": extrap("flops"),
               "cost_points": {str(unit * m): points[m] for m in points}},
           "wall_s": round(time.time() - t0, 2)}
    _write(rec, out_dir)
    return rec


def _write(rec: dict, out_dir) -> None:
    if out_dir is None:
        return
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{rec['arch']}__{rec['shape']}.json").write_text(
        json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="8x1",
                    help="cards as DATAxMODEL or PODxDATAxMODEL: 8x1 (one "
                         "host, default), 2x4, 16x16, 2x16x16")
    ap.add_argument("--out", default=str(OUT_DIR))
    ap.add_argument("--tiny", action="store_true",
                    help="every cell at tiny_config and 8 x 128 tokens")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    out = pathlib.Path(args.out)
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    recs = []
    for arch in archs:
        for shape in shapes:
            cell = out / f"{arch}__{shape}.json"
            if cell.exists() and not args.force:
                print(f"[skip] {cell.name} (cached)")
                continue
            try:
                rec = run_cell(arch, shape, out, mesh=mesh, tiny=args.tiny)
            except Exception as e:  # record failures for triage
                import traceback
                rec = {"arch": arch, "shape": shape, "error": str(e),
                       "traceback": traceback.format_exc()}
                _write(rec, out)
            recs.append(rec)
            status = ("SKIP" if "skipped" in rec else
                      "ERR " if "error" in rec else "ok  ")
            dom = rec.get("roofline", {}).get("dominant", "-")
            print(f"[{status}] {arch:22s} {shape:12s} {rec.get('wall_s', '')}s"
                  f" dominant={dom}", flush=True)
    return recs


if __name__ == "__main__":
    main()
