"""Training on a ``("data", "model")`` mesh in the port
(``distributed.model_parallel``, ``train.step.make_train_step(mesh=)``,
``checkpoint.ckpt`` on a sharded state) against the port's single-device
step and the reference's, on the CPU.

Tiny Llama, OLMoE and Zamba2 in float32 train 3 steps of 8 x 16 tokens
from the reference's initial parameters on meshes (1, 2) and (2, 2),
tiny Llama on (1, 4), and tiny Llama with 2 KV heads on (1, 4) (a split
that falls mid-head: its attention runs on gathered weights), in worlds
of 2 and 4 ``gloo`` processes (``run_ranks``).  Each rank holds its
block of every float32 weight and of AdamW's ``m`` and ``v`` and reads
the rows of its ``data`` coordinate.  Bounds: the port's single-device
step within rtol = atol = 1e-5 (float32 sums in another order); the
reference's single-device step within 1e-4 (the bound of
``tests/test_torch_train.py``), and the reference's own (2, 2) sharded
step (run as ``tests/test_distributed.py`` runs it, in one subprocess
with 4 virtual devices) within 1e-4; the first step's global gradient
norm within 1e-6 relative of the single device's; the ranks that hold
the same block bit-identical (``replicas_agree``); each rank's state
bytes equal to the dry run's ``sharded.state_bytes``; a checkpoint saved
on (2, 2) restored on (1, 4) equal leaf for leaf.

Wall time: about 60 s on one worker (the reference's jitted steps
compile; the worlds start ~3 s a process).
"""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_collectives import run_jax, run_ranks
from test_torch_train import batch_at, np_tree, port_model, ref_batch, \
    ref_config

from repro.models import registry as ref_registry
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch.checkpoint.ckpt import flat_state
from repro_torch.convert import _reference_leaves, params_from_reference
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_state, make_train_step, \
    replicas_agree

#: name -> (architecture, config changes); the index is the seed of the
#: initial parameters and of the token stream
VARIANTS = {"llama": ("llama3.2-1b", {}), "olmoe": ("olmoe-1b-7b", {}),
            "zamba2": ("zamba2-2.7b", {}),
            "llama_kv2": ("llama3.2-1b", {"n_kv_heads": 2})}
RUNS = [("llama", (1, 2)), ("olmoe", (1, 2)), ("zamba2", (1, 2)),
        ("llama", (2, 2)), ("olmoe", (2, 2)), ("zamba2", (2, 2)),
        ("llama", (1, 4)), ("llama_kv2", (1, 4))]
B, STEPS = 8, 3
OPT = dict(lr=1e-3, total_steps=50, warmup_steps=2)
TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)

_WORKER = """
import dataclasses, json, os
import numpy as np, torch, torch.distributed as dist
from repro_torch.checkpoint.ckpt import (flat_state, param_of,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.data.tokens import TokenStream
from repro_torch.launch.dryrun import sharded_state_bytes
from repro_torch.models import attention, registry
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.elastic import make_elastic_mesh
from repro_torch.train.step import (init_state, make_train_step,
                                    replica_digest, shard_batch)
dist.init_process_group("gloo")
r, n = dist.get_rank(), dist.get_world_size()
OUT = os.environ["OUT"]
case = json.load(open(os.path.join(OUT, "case.json")))
heads = []
real_attention = attention.attention
def spy(q, *a, **kw):
    heads.append(q.shape[2])
    return real_attention(q, *a, **kw)
attention.attention = spy

def gather(obj):
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out

def model_of(name):
    arch, over = case["variants"][name]
    cfg = dataclasses.replace(
        registry.tiny_config(registry.get_config(arch)), dtype="float32",
        **over)
    model = registry.get_model(cfg, device="cpu", param_dtype="float32")
    init = np.load(os.path.join(OUT, name + ".npz"))
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[k]))
    return cfg, model

def full_state(mp, state):
    return {k: (t if param_of(k) is None else mp.full_value(t, param_of(k)))
            .detach().clone() for k, t in flat_state(state).items()}

for name, shape in case["runs"]:
    seed = list(case["variants"]).index(name)
    cfg, model = model_of(name)
    mesh = make_elastic_mesh(shape[1])
    assert tuple(mesh.shape) == tuple(shape), (mesh.shape, shape)
    step = make_train_step(model, AdamWConfig(**case["opt"]), 1, mesh=mesh)
    mp = model.mp
    state = init_state(model)
    stream = TokenStream(cfg.vocab, case["batch"], case["seq"], seed=seed,
                         family=cfg.family, d_model=cfg.d_model,
                         n_codebooks=cfg.n_codebooks)
    del heads[:]
    metrics = []
    for k in range(case["steps"]):
        b = shard_batch(stream.batch_at(k), mp.coord["data"],
                        mp.size["data"])
        m = step(state, b)[1]
        metrics.append({key: float(v) for key, v in m.items()})
    state_bytes = sum(t.numel() * t.element_size()
                      for t in flat_state(state).values())
    digests = gather(replica_digest(state))
    bytes_ = gather([state_bytes, sharded_state_bytes(model, mesh)])
    full = full_state(mp, state)
    blocks_equal = gather(all(torch.equal(mp.block(full[f"model.{k}"], k), p)
                              for k, p in model.named_parameters()))
    tag = f"{name}_{shape[0]}x{shape[1]}"
    if tag == case.get("ckpt"):
        save_checkpoint(os.path.join(OUT, "ckpt"), state, 3, write=r == 0)
        dist.barrier()
        _, other = model_of(name)
        make_train_step(other, AdamWConfig(**case["opt"]), 1,
                        mesh=make_elastic_mesh(4))
        restored = init_state(other)
        restore_checkpoint(os.path.join(OUT, "ckpt"), restored)
        back = full_state(other.mp, restored)
        if r == 0:
            torch.save({"saved": full, "restored": back,
                        "blocks": {k: tuple(t.shape) for k, t in
                                   flat_state(restored).items()}},
                       os.path.join(OUT, "ckpt.pt"))
    if r == 0:
        torch.save({"metrics": metrics, "digests": digests,
                    "bytes": bytes_, "state": full, "heads": list(heads),
                    "paths": dict(mp.paths),
                    "blocks_equal": blocks_equal},
                   os.path.join(OUT, tag + ".pt"))
dist.destroy_process_group()
"""

_REFERENCE = """
import dataclasses, json, numpy as np, jax
from jax.sharding import NamedSharding
from repro.launch.dryrun import tree_shardings, batch_pspec
from repro.launch.mesh import make_test_mesh, use_mesh
from repro.models.registry import get_config, get_model, tiny_config
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.train.step import abstract_state, make_train_step, \\
    state_partition_specs
OUT = OUT_DIR
case = json.load(open(OUT + "/ref_case.json"))
cfg = dataclasses.replace(tiny_config(get_config(case["arch"])),
                          dtype="float32")
model = get_model(cfg)
params = model.init(jax.random.PRNGKey(case["seed"]))
state = {"params": params, "opt": init_opt_state(params)}
step = make_train_step(model, AdamWConfig(**case["opt"]))
mesh = make_test_mesh((2, 2), ("data", "model"))
st_sh = tree_shardings(abstract_state(model), state_partition_specs(model),
                       mesh)
batches = np.load(OUT + "/ref_batches.npz")
losses = []
with use_mesh(mesh):
    state = jax.device_put(state, st_sh)
    jstep = None
    for k in range(case["steps"]):
        batch = {key: batches[f"{k}_{key}"] for key in case["keys"]}
        b_sh = {key: NamedSharding(mesh, batch_pspec(
            jax.ShapeDtypeStruct(v.shape, v.dtype), mesh))
            for key, v in batch.items()}
        if jstep is None:
            jstep = jax.jit(step, in_shardings=(st_sh, b_sh),
                            out_shardings=(st_sh, None))
        state, m = jstep(state, jax.device_put(batch, b_sh))
        losses.append(float(m["loss"]))
flat = jax.tree_util.tree_flatten_with_path(state["params"])[0]
np.savez(OUT + "/ref_params.npz", **{jax.tree_util.keystr(p): np.asarray(v)
                                     for p, v in flat})
json.dump({"losses": losses}, open(OUT + "/ref_out.json", "w"))
"""


def _ref_cfg(name: str):
    arch, over = VARIANTS[name]
    return dataclasses.replace(ref_config(arch), **over)


@functools.lru_cache(maxsize=None)
def _init_params(name: str):
    cfg = _ref_cfg(name)
    rm = ref_registry.get_model(cfg)
    return cfg, rm, np_tree(rm.init(jax.random.PRNGKey(
        list(VARIANTS).index(name))))


def _batch(name: str, k: int) -> dict:
    return batch_at(_ref_cfg(name), list(VARIANTS).index(name), k, batch=B)


@functools.lru_cache(maxsize=None)
def reference_run(name: str):
    """The reference's jitted single-device step, 3 steps: (losses, final
    params as port names)."""
    cfg, rm, params = _init_params(name)
    step = jax.jit(ref_step.make_train_step(rm, ref_adamw.AdamWConfig(**OPT)))
    state = {"params": params, "opt": ref_adamw.init_opt_state(params)}
    losses = []
    for k in range(STEPS):
        state, m = step(state, ref_batch(_batch(name, k)))
        losses.append(float(m["loss"]))
    return losses, dict(_reference_leaves(np_tree(state["params"])))


@functools.lru_cache(maxsize=None)
def port_run(name: str):
    """The port's single-device step from the same parameters: (metrics a
    step, flat state)."""
    cfg, _, params = _init_params(name)
    model = params_from_reference(port_model(cfg), params)
    step = make_train_step(model, AdamWConfig(**OPT))
    state = init_state(model)
    metrics = [{k: float(v) for k, v in step(state, _batch(name, k))[1]
                .items()} for k in range(STEPS)]
    return metrics, {k: t.detach().clone()
                     for k, t in flat_state(state).items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worker's results: the (1, 2) runs in a world of 2, the others
    (and the checkpoint across meshes) in a world of 4."""
    out = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"mp{n}")
        for name in VARIANTS:
            np.savez(d / f"{name}.npz",
                     **dict(_reference_leaves(_init_params(name)[2])))
        runs = [(name, shape) for name, shape in RUNS
                if shape[0] * shape[1] == n]
        (d / "case.json").write_text(json.dumps(dict(
            variants=VARIANTS, runs=runs, opt=OPT, batch=B, seq=16,
            steps=STEPS, ckpt="llama_2x2" if n == 4 else None)))
        run_ranks(_WORKER, n, d)
        for name, shape in runs:
            out[(name, shape)] = d / f"{name}_{shape[0]}x{shape[1]}.pt"
        out[n] = d
    return out


def _result(worlds, name, shape):
    return torch.load(worlds[(name, shape)])


IDS = [f"{name}-{s[0]}x{s[1]}" for name, s in RUNS]


@pytest.mark.parametrize("name,shape", RUNS, ids=IDS)
def test_mp_equals_the_single_device_step(worlds, name, shape):
    got = _result(worlds, name, shape)
    metrics, state = port_run(name)
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               [m["loss"] for m in metrics], **TOL)
    assert set(got["state"]) == set(state)
    for k, t in state.items():
        np.testing.assert_allclose(got["state"][k].numpy(), t.numpy(),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("name,shape", RUNS, ids=IDS)
def test_mp_equals_the_reference(worlds, name, shape):
    got = _result(worlds, name, shape)
    losses, params = reference_run(name)
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]], losses,
                               **REF_TOL)
    for k, want in params.items():
        np.testing.assert_allclose(got["state"][f"model.{k}"].numpy(), want,
                                   err_msg=k, **REF_TOL)


@pytest.mark.parametrize("name,shape", RUNS, ids=IDS)
def test_global_norm_counts_each_element_once(worlds, name, shape):
    """The first step's gradient norm (before any update, so the same
    gradients) against the single device's: a leaf replicated over an
    axis counted once, not once a rank."""
    got = _result(worlds, name, shape)["metrics"][0]["grad_norm"]
    want = port_run(name)[0][0]["grad_norm"]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,shape", RUNS, ids=IDS)
def test_ranks_holding_a_block_are_bit_identical(worlds, name, shape):
    """``replicas_agree`` over every rank's ``replica_digest``; on (2, 2)
    some leaves (the norms, the step) are whole on every rank and some
    are split over both axes, so the check compares both kinds."""
    digests = _result(worlds, name, shape)["digests"]
    assert len(digests) == shape[0] * shape[1]
    assert replicas_agree(digests)
    keys = {e[2] for e in digests[0]}
    assert "" in keys and any("model=" in k for k in keys)
    if shape[0] > 1:
        assert any("data=0,model=0" == k for k in keys)


@pytest.mark.parametrize("name,shape", RUNS, ids=IDS)
def test_state_bytes_equal_the_dry_run(worlds, name, shape):
    """Each rank's float32 weight, m and v blocks and the step, in bytes,
    equal ``launch.dryrun.sharded_state_bytes`` for the mesh, and are
    below the replicated state; each rank's parameter blocks (cut by
    ``runtime.elastic.place``) are the blocks ``ModelParallel.block``
    names for its coordinates, which ``gather_to_root`` assembles."""
    got = _result(worlds, name, shape)
    assert all(got["blocks_equal"])
    replicated = sum(t.numel() * t.element_size()
                     for t in port_run(name)[1].values())
    for state_bytes, dry in got["bytes"]:
        assert state_bytes == dry
        assert state_bytes < replicated


def test_attention_runs_its_heads_split(worlds):
    """A ``model`` rank's attention ran H/M of the H = 4 query heads where
    the heads divide, and every head on gathered weights in the
    mid-head case (2 KV heads over 4 ranks), whose result is held to the
    single device within 1e-5 above."""
    for (name, shape), want in ((("llama", (1, 2)), {2}),
                                (("llama", (2, 2)), {2}),
                                (("llama", (1, 4)), {1}),
                                (("olmoe", (1, 2)), {2}),
                                (("llama_kv2", (1, 4)), {4})):
        got = _result(worlds, name, shape)
        assert set(got["heads"]) == want, (name, shape, got["heads"])
        gathered = [p for p in got["paths"] if p.endswith("gathered")]
        assert gathered == (["attention: gathered"]
                            if name == "llama_kv2" else []), got["paths"]
    olmoe = _result(worlds, "olmoe", (2, 2))["paths"]
    assert "moe: split, 2 of 4 experts" in olmoe


def test_checkpoint_saved_on_2x2_restores_on_1x4(worlds):
    """A checkpoint of the (2, 2) Llama state (each leaf gathered, rank 0
    writes) restored into a state sharded on (1, 4): every leaf equal,
    each rank holding its (1, 4) block."""
    ck = torch.load(worlds[4] / "ckpt.pt")
    assert set(ck["saved"]) == set(ck["restored"])
    for k, t in ck["saved"].items():
        assert torch.equal(ck["restored"][k], t), k
    assert ck["blocks"]["model.embed"] == (64, 64)


def test_equals_the_reference_sharded_step(worlds, tmp_path):
    """The port's (2, 2) Llama run against the reference's jitted step
    with its state placed on a (2, 2) mesh of 4 virtual devices, the same
    parameters and batches: losses and parameters within 1e-4."""
    arch, _ = VARIANTS["llama"]
    seed = list(VARIANTS).index("llama")
    batches = [_batch("llama", k) for k in range(STEPS)]
    np.savez(tmp_path / "ref_batches.npz",
             **{f"{k}_{key}": v for k, b in enumerate(batches)
                for key, v in b.items()})
    (tmp_path / "ref_case.json").write_text(json.dumps(dict(
        arch=arch, seed=seed, opt=OPT, steps=STEPS,
        keys=sorted(batches[0]))))
    run_jax(_REFERENCE.replace("OUT_DIR", repr(str(tmp_path))), 4)
    ref = json.loads((tmp_path / "ref_out.json").read_text())
    got = _result(worlds, "llama", (2, 2))
    np.testing.assert_allclose([m["loss"] for m in got["metrics"]],
                               ref["losses"], **REF_TOL)
    _, want = reference_run("llama")
    with np.load(tmp_path / "ref_params.npz") as data:
        sharded = {k: data[k] for k in data.files}
    # the reference's sharded and single-device runs hold the same leaves
    assert len(sharded) == len(jax.tree_util.tree_leaves(
        _init_params("llama")[2]))
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(_init_params("llama")[2]),
        [sharded[jax.tree_util.keystr(p)] for p, _ in
         jax.tree_util.tree_flatten_with_path(_init_params("llama")[2])[0]])
    for k, v in _reference_leaves(tree):
        np.testing.assert_allclose(got["state"][f"model.{k}"].numpy(), v,
                                   err_msg=k, **REF_TOL)
    assert set(dict(_reference_leaves(tree))) == set(want)
