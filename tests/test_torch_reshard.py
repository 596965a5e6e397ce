"""Sharding decisions and resharding in the port against the reference, on
the CPU: the models' ``partition_specs``, ``state_partition_specs`` fitted
by ``launch.dryrun.fit_pspec`` (ZeRO over pods), ``batch_pspec`` and
``cache_pspecs`` for every architecture at full size on stub meshes;
``runtime.elastic.reshard``'s DTensor shards against the slices of the
reference's ``NamedSharding.devices_indices_map``; and a checkpoint saved
under one mesh restored under others (the reference's
``test_elastic_reshard_across_mesh_sizes``).

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when it is
imported; ``ref_dryrun`` imports it with the environment saved and
restored, so nothing leaks into later subprocesses.
"""
import functools
import json
import os
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.utils import _pytree

from test_torch_collectives import run_jax, run_ranks

from repro.models import registry as ref_registry
from repro.models.common import ParamSpec
from repro_torch.convert import specs_from_reference
from repro_torch.launch import dryrun
from repro_torch.models import registry
from repro_torch.train.step import abstract_state, state_partition_specs

MESHES = [(8, 1), (2, 4), (16, 16), (2, 16, 16)]


def ref_dryrun():
    saved = dict(os.environ)
    try:
        import repro.launch.dryrun as mod
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


class StubMesh:
    """A mesh as the reference's spec helpers read it (``shape`` and
    ``axis_names``): no devices."""

    def __init__(self, sizes):
        self.axis_names = (("pod",) if len(sizes) == 3 else ()) + \
            ("data", "model")
        self.shape = dict(zip(self.axis_names, sizes))


@functools.lru_cache(maxsize=None)
def _models(arch):
    return (ref_registry.get_model(ref_registry.get_config(arch)),
            registry.get_model(arch, device="meta", param_dtype="float32"))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_partition_specs_equal_the_reference(arch):
    ref, port = _models(arch)
    specs = port.partition_specs()
    assert list(specs) == [n for n, _ in port.named_parameters()]
    assert specs == specs_from_reference(ref.param_specs())
    st = state_partition_specs(port)
    assert st["model"] == specs and st["opt"]["m"] == specs \
        and st["opt"]["v"] == specs and st["opt"]["step"] == ()


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_spec_decisions_equal_the_reference(arch, sizes):
    """Every leaf's fitted spec, the port's against the reference's: the
    training state's (``zero_pod=True``, as the dry run places it), every
    input of every shape cell, and every decode cache leaf."""
    rd = ref_dryrun()
    mesh = StubMesh(sizes)
    ref, port = _models(arch)

    def fit(ps):
        sp = rd._zero_over_pod(tuple(ps.spec), mesh)
        return SimpleNamespace(shape=ps.shape,
                               spec=tuple(rd.fit_pspec(ps.shape, sp, mesh)))
    want = specs_from_reference(jax.tree_util.tree_map(
        fit, ref.param_specs(), is_leaf=lambda x: isinstance(x, ParamSpec)))
    got = dryrun.tree_shardings(abstract_state(port),
                                state_partition_specs(port), mesh,
                                zero_pod=True)
    for part in (got["model"], got["opt"]["m"], got["opt"]["v"]):
        assert {n: tuple(s.spec) for n, s in part.items()} == want
    assert got["opt"]["step"].spec == ()

    cfg, ref_cfg = port.cfg, ref.cfg
    for shape in registry.SHAPES:
        if not registry.shape_applicable(cfg, shape):
            continue
        ref_in = ref_registry.input_specs(ref_cfg, shape)
        port_in = registry.input_specs(cfg, shape)
        for k, t in port_in["batch"].items():
            assert tuple(dryrun.batch_pspec(t, mesh)) == tuple(
                rd.batch_pspec(ref_in["batch"][k], mesh)), (shape, k)
        if "cache" in port_in:
            ref_c = {jax.tree_util.keystr(p): tuple(s) for p, s in
                     jax.tree_util.tree_flatten_with_path(
                         rd.cache_pspecs(ref_in["cache"], mesh))[0]}
            port_c = {_pytree.keystr(p): tuple(s) for p, s in
                      _pytree.tree_flatten_with_path(
                          dryrun.cache_pspecs(port_in["cache"], mesh))[0]}
            assert _by_path(ref_c) == _by_path(port_c), shape


def _by_path(specs: dict) -> dict:
    """Path strings of both pytree libraries in one form: ``['kv']['k']``
    and ``[0][1]``."""
    return {p.replace(".", "").replace("'", "").replace('"', ""): s
            for p, s in specs.items()}


# ----------------------------------------------------- DTensor shards ----

_SLICES = """
import json, numpy as np, jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_test_mesh
mesh = make_test_mesh((2, 2), ('data', 'model'))
leaves = json.loads(LEAVES)
out = {}
for name, shape, spec in leaves:
    spec = [tuple(a) if isinstance(a, list) else a for a in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    per = {}
    for d, idx in m.items():
        i, j = (int(v) for v in np.argwhere(mesh.devices == d)[0])
        per[i * 2 + j] = [[s.start or 0, s.stop if s.stop is not None
                           else shape[k]] for k, s in enumerate(idx)]
    out[name] = per
print(json.dumps(out))
"""

_RANKS = """
import json, os, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.checkpoint.ckpt import (flat_state, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.launch.dryrun import tree_shardings
from repro_torch.models import registry
from repro_torch.runtime.elastic import reshard
from repro_torch.train.step import (abstract_state, init_state,
                                    state_partition_specs)
dist.init_process_group("gloo")
r = dist.get_rank()
OUT = os.environ["OUT"]
cfg = registry.tiny_config(registry.get_config("llama3.2-1b"))
model = registry.get_model(cfg, device="cpu", param_dtype="float32",
                           generator=torch.Generator().manual_seed(0))
state = init_state(model)
with torch.no_grad():           # moments that differ from the weights
    for part, sign in (("m", 1.0), ("v", 2.0)):
        for n, p in model.named_parameters():
            state["opt"][part][n].copy_(p * sign + 0.5)
    state["opt"]["step"].fill_(5)
live = {"model": dict(model.named_parameters()), "opt": state["opt"]}
full = {k: t.detach().clone() for k, t in flat_state(live).items()}
specs = state_partition_specs(model)
slices = json.load(open(os.path.join(OUT, "slices.json")))

def local(state):
    return {k: t.to_local() for k, t in flat_state(state).items()}

checks = {}
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
placed = local(reshard(live, specs, mesh))
checks["reshard_2x2"] = all(
    torch.equal(placed[k], full[k][tuple(slice(a, b) for a, b in
                                         slices[k][str(r)])])
    for k in full)
checks["sharded_leaves"] = sum(placed[k].numel() < full[k].numel()
                               for k in full)
mesh_a = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
save_checkpoint(OUT, reshard(live, specs, mesh_a), 5, write=r == 0)
dist.barrier()
for shape in ((2, 2), (1, 4)):
    mesh_b = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    sh = tree_shardings(abstract_state(model), specs, mesh_b)
    back, step = restore_checkpoint(OUT, abstract_state(model), shardings=sh)
    flat = flat_state(back)
    name = "x".join(map(str, shape))
    checks[f"restore_{name}"] = step == 5 and all(
        torch.equal(flat[k].full_tensor(), full[k]) for k in full)
    checks[f"restore_{name}_local"] = all(
        torch.equal(flat[k].to_local(), t) for k, t in
        local(reshard(live, specs, mesh_b)).items())
with open(os.path.join(OUT, f"rank{r}.json"), "w") as f:
    json.dump(checks, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def reshard_checks(tmp_path_factory):
    d = tmp_path_factory.mktemp("reshard")
    cfg = registry.tiny_config(registry.get_config("llama3.2-1b"))
    model = registry.get_model(cfg, device="meta", param_dtype="float32")
    sh = dryrun.tree_shardings(abstract_state(model),
                               state_partition_specs(model),
                               dryrun.MeshAxes(("data", "model"), (2, 2)))
    from repro_torch.checkpoint.ckpt import flat_state
    shapes = flat_state(abstract_state(model))
    leaves = [[k, list(shapes[k].shape), list(s.spec)]
              for k, s in flat_state(sh).items()]
    out = run_jax(_SLICES.replace("LEAVES", repr(json.dumps(leaves))), 4)
    (d / "slices.json").write_text(out.strip().splitlines()[-1])
    run_ranks(_RANKS, 4, d)
    return [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]


def test_dtensor_shards_equal_the_reference_slices(reshard_checks):
    """Under mesh (2, 2) every rank's local shard of every leaf is the
    slice the reference gives the device at the same mesh coordinate."""
    for checks in reshard_checks:
        assert checks["reshard_2x2"]
        assert checks["sharded_leaves"] > 0


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_checkpoint_restores_across_mesh_shapes(reshard_checks, shape):
    """Saved under (4, 1), restored under `shape`: every leaf bit-equal to
    the state saved, each rank's shard the slice ``reshard`` gives."""
    for checks in reshard_checks:
        assert checks[f"restore_{shape}"]
        assert checks[f"restore_{shape}_local"]


def test_placements_follow_the_mesh_order():
    """``("pod", "data")`` on one dimension shards the outer mesh dimension
    first (pod-major, as JAX); an order the mesh does not have is
    refused."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.runtime.elastic import placements
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)
