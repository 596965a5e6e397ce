"""Data-parallel training in the port (``train.step.make_train_step(group=)``,
``shard_batch``, ``models.moe.global_batch``, ``launch.train`` under a
process group) against the port's single-device step and the
reference's, on the CPU.

Tiny Llama, OLMoE and Zamba2 in float32 train 3 steps of 8 x 16 tokens
from the reference's initial parameters in worlds of 2 and 4 ``gloo``
processes (``run_ranks``), each rank on its rows of the same global
batch.  Bounds: the port's single-device step within rtol = atol = 1e-5
(the ranks' gradients are summed in another order: float32 rounding
only); the reference's single-device step within 1e-4 (the bound of
``tests/test_torch_train.py``); the replicas bit-identical
(``replica_digest``).  The world of 2 also runs ``grad_accum=2``,
OLMoE's router statistics over the group, and a supervised
``launch.train`` run with a failure at step 7 against the straight run.
"""
import dataclasses
import functools
import json

import jax
import numpy as np
import pytest
import torch

from test_torch_collectives import run_ranks
from test_torch_train import batch_at, np_tree, port_model, ref_batch, \
    ref_config

from repro.models import registry as ref_registry
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch.checkpoint.ckpt import flat_state
from repro_torch.convert import _reference_leaves, params_from_reference
from repro_torch.models.moe import router_topk
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_state, make_train_step

ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "zamba2-2.7b")
B, STEPS = 8, 3
OPT = dict(lr=1e-3, total_steps=50, warmup_steps=2)
TOL = dict(rtol=1e-5, atol=1e-5)
REF_TOL = dict(rtol=1e-4, atol=1e-4)

_WORKER = """
import dataclasses, json, os
import numpy as np, torch, torch.distributed as dist
from repro_torch.checkpoint.ckpt import flat_state
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as launch
from repro_torch.models import registry
from repro_torch.models.moe import global_batch, router_topk
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (init_state, make_allreduce_grad_sync,
                                    make_train_step, replica_digest,
                                    shard_batch)
dist.init_process_group("gloo")
world = dist.group.WORLD
r, n = dist.get_rank(), dist.get_world_size()
OUT = os.environ["OUT"]
case = json.load(open(os.path.join(OUT, "case.json")))

def gather(obj):
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out

def model_of(arch):
    cfg = dataclasses.replace(
        registry.tiny_config(registry.get_config(arch)), dtype="float32")
    model = registry.get_model(cfg, device="cpu", param_dtype="float32")
    init = np.load(os.path.join(OUT, arch + ".npz"))
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(torch.from_numpy(init[k]))
    return cfg, model

for i, arch in enumerate(case["archs"]):
    for ga in case["grad_accum"]:
        cfg, model = model_of(arch)
        seen = []
        sync = make_allreduce_grad_sync(world)
        def spy(g, sync=sync, seen=seen):
            out = sync(g)
            seen.append({k: v.clone() for k, v in out.items()})
            return out
        step = make_train_step(model, AdamWConfig(**case["opt"]), ga,
                               group=world, grad_sync=spy)
        state = init_state(model)
        stream = TokenStream(cfg.vocab, case["batch"], case["seq"], seed=i,
                             family=cfg.family, d_model=cfg.d_model,
                             n_codebooks=cfg.n_codebooks)
        losses = [float(step(state, shard_batch(stream.batch_at(k), r, n,
                                                ga))[1]["loss"])
                  for k in range(case["steps"])]
        digests = gather(replica_digest(state))
        if r == 0:
            torch.save({"losses": losses, "digests": digests,
                        "grads1": seen[0],
                        "state": {k: t.detach().clone() for k, t in
                                  flat_state(state).items()}},
                       os.path.join(OUT, f"n{n}_{arch}_ga{ga}.pt"))

if case["extra"]:
    cfg, model = model_of("olmoe-1b-7b")
    x = torch.randn((8, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    mine = x[r * 8 // n:(r + 1) * 8 // n]
    with torch.no_grad():
        with global_batch(world):
            aux_group = float(router_topk(mine, model.layers[0].moe["router"],
                                          cfg)[2])
        aux_local = float(router_topk(mine, model.layers[0].moe["router"],
                                      cfg)[2])
    auxes = gather([aux_group, aux_local])
    runs = {}
    for name, extra in (("straight", []), ("failed", ["--inject-failure-at",
                                                      "7"])):
        ckpt = os.path.join(OUT, "ckpt_" + name)
        metrics = os.path.join(OUT, name + ".json")
        launch.main(["--arch", "llama3.2-1b", "--tiny", "--steps", "10",
                     "--batch", "8", "--seq", "16", "--ckpt-every", "1",
                     "--log-every", "1", "--device", "cpu", "--ckpt-dir",
                     ckpt, "--metrics-out", metrics, "--model-parallel",
                     "1"] + extra)
    if r == 0:
        json.dump({"aux": auxes}, open(os.path.join(OUT, "extra.json"), "w"))
dist.destroy_process_group()
"""


def _init_params(arch: str):
    """The reference's initial parameters of tiny `arch` (seed: its index
    in ARCHS) and the config."""
    cfg = ref_config(arch)
    rm = ref_registry.get_model(cfg)
    return cfg, rm, np_tree(rm.init(jax.random.PRNGKey(ARCHS.index(arch))))


@functools.lru_cache(maxsize=None)
def reference_run(arch: str):
    """The reference's jitted step, 3 steps: (losses, final params as
    port names)."""
    cfg, rm, params = _init_params(arch)
    step = jax.jit(ref_step.make_train_step(rm, ref_adamw.AdamWConfig(**OPT)))
    state = {"params": params,
             "opt": ref_adamw.init_opt_state(params)}
    losses = []
    for k in range(STEPS):
        state, m = step(state, ref_batch(batch_at(cfg, ARCHS.index(arch), k,
                                                  batch=B)))
        losses.append(float(m["loss"]))
    return losses, dict(_reference_leaves(np_tree(state["params"])))


@functools.lru_cache(maxsize=None)
def port_run(arch: str, grad_accum: int = 1):
    """The port's single-device step from the same parameters: (losses,
    flat state, the first step's gradients before the clip)."""
    cfg, _, params = _init_params(arch)
    model = params_from_reference(port_model(cfg), params)
    step = make_train_step(model, AdamWConfig(**OPT), grad_accum)
    state = init_state(model)
    grads, losses = None, []
    for k in range(STEPS):
        batch = batch_at(cfg, ARCHS.index(arch), k, batch=B)
        if k == 0:              # the step's gradients (micro-batch mean)
            probe = params_from_reference(port_model(cfg), params)
            rows = B // grad_accum
            with torch.enable_grad():
                for i in range(grad_accum):
                    probe.loss({key: v[i * rows:(i + 1) * rows]
                                for key, v in batch.items()})[0].backward()
            grads = {n: p.grad / grad_accum
                     for n, p in probe.named_parameters()}
        losses.append(float(step(state, batch)[1]["loss"]))
    return losses, {k: t.detach().clone()
                    for k, t in flat_state(state).items()}, grads


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The worker's results in worlds of 2 (with grad_accum=2 and the
    extra checks) and 4, read into memory as soon as each world ends:
    {n: {file name: its contents}} (``.pt`` loaded, ``.json`` parsed).
    The tests then read nothing from the temporary directory, which the
    module's later tests must not depend on."""
    out = {}
    for n in (2, 4):
        d = tmp_path_factory.mktemp(f"dp{n}")
        for arch in ARCHS:
            _, _, params = _init_params(arch)
            np.savez(d / f"{arch}.npz", **dict(_reference_leaves(params)))
        (d / "case.json").write_text(json.dumps(dict(
            archs=ARCHS, grad_accum=[1, 2] if n == 2 else [1], opt=OPT,
            batch=B, seq=16, steps=STEPS, extra=n == 2)))
        run_ranks(_WORKER, n, d)
        out[n] = {f"n{n}_{arch}_ga{ga}.pt": torch.load(
            d / f"n{n}_{arch}_ga{ga}.pt") for arch in ARCHS
            for ga in ((1, 2) if n == 2 else (1,))}
        if n == 2:
            out[n].update({name: json.loads((d / name).read_text())
                           for name in ("extra.json", "straight.json",
                                        "failed.json")})
    return out


def _result(worlds, n, arch, ga=1):
    return worlds[n][f"n{n}_{arch}_ga{ga}.pt"]


CASES = [(n, arch) for n in (2, 4) for arch in ARCHS]


@pytest.mark.parametrize("n,arch", CASES)
def test_dp_equals_the_single_device_step(worlds, n, arch):
    got = _result(worlds, n, arch)
    losses, state, _ = port_run(arch)
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    assert set(got["state"]) == set(state)
    for k, t in state.items():
        np.testing.assert_allclose(got["state"][k].numpy(), t.numpy(),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("n,arch", CASES)
def test_dp_equals_the_reference(worlds, n, arch):
    got = _result(worlds, n, arch)
    losses, params = reference_run(arch)
    np.testing.assert_allclose(got["losses"], losses, **REF_TOL)
    for k, want in params.items():
        np.testing.assert_allclose(got["state"][f"model.{k}"].numpy(), want,
                                   err_msg=k, **REF_TOL)


@pytest.mark.parametrize("n,arch", CASES)
def test_replicas_are_bit_identical(worlds, n, arch):
    digests = _result(worlds, n, arch)["digests"]
    assert len(digests) == n and all(d == digests[0] for d in digests)


#: below this the gradient's RMS over the steps (AdamW's bias-corrected
#: sqrt(v)) is float32 rounding noise of sums that cancel (in the tiny
#: models no element's lies between 1.5e-9 and 1.4e-7):
#: ``m / (sqrt(v) + eps)`` then follows the noise, not the gradient
NOISE = 1e-7


def _noise_elements(got_state, want_state, key: str, steps: int = STEPS):
    """The elements of state leaf `key` (``model.<p>``, ``opt.m.<p>``,
    ``opt.v.<p>``) whose gradient's RMS over `steps` is below NOISE in
    both runs and not zero in both (an element no step touched is
    deterministic and held to TOL)."""
    if key == "opt.step":
        return None
    name = key.split(".", 2)[-1] if key.startswith("opt.") else key[6:]
    va, vb = got_state[f"opt.v.{name}"], want_state[f"opt.v.{name}"]
    corr = 1 - AdamWConfig().b2 ** steps
    return ((va / corr).sqrt() < NOISE) & ((vb / corr).sqrt() < NOISE) \
        & ((va != 0) | (vb != 0))


@pytest.mark.parametrize("arch", ARCHS)
def test_dp_grad_accum(worlds, arch):
    """``grad_accum=2`` in a world of 2: each rank's i-th micro-batch is
    its share of the global i-th (``shard_batch``), so the run equals the
    single-device ``grad_accum=2`` step, OLMoE's router loss included:
    the losses of 3 steps, the first step's averaged gradients and every
    element of the state after 3 steps within 1e-5, except the few
    elements whose gradient is float32 noise in both runs
    (``_noise_elements``): there AdamW's ``m / (sqrt(v) + eps)`` follows
    the noise (one OLMoE embedding element, its gradient's RMS 1.4e-9
    against 6.3e-11, moves 8.2e-5).  Those are fewer than 1 in 10^4 of
    the state and are held to REF_TOL."""
    got = _result(worlds, 2, arch, ga=2)
    losses, state, grads = port_run(arch, grad_accum=2)
    np.testing.assert_allclose(got["losses"], losses, **TOL)
    for k, g in grads.items():
        np.testing.assert_allclose(got["grads1"][k].numpy(), g.numpy(),
                                   err_msg=k, **TOL)
    n_noise = n_all = 0
    for k, t in state.items():
        want, have = t.numpy(), got["state"][k].numpy()
        noise = _noise_elements(got["state"], state, k)
        n_all += t.numel()
        if noise is not None and bool(noise.any()):
            keep = ~noise.numpy()
            n_noise += int(noise.sum())
            np.testing.assert_allclose(have[noise.numpy()],
                                       want[noise.numpy()], err_msg=k,
                                       **REF_TOL)
            have, want = have[keep], want[keep]
        np.testing.assert_allclose(have, want, err_msg=k, **TOL)
    assert n_noise * 10_000 < n_all, (n_noise, n_all)
    assert all(d == got["digests"][0] for d in got["digests"])


@pytest.mark.parametrize("n", [2, 4])
def test_dp_gradients_average_once(worlds, n):
    """The synced gradients of the first step equal the single-device
    gradients of the global batch: the all-reduce divides by n once,
    OLMoE's router gradient (through the differentiable reduction of its
    statistics) included."""
    got = _result(worlds, n, "olmoe-1b-7b")["grads1"]
    _, _, want = port_run("olmoe-1b-7b")
    for k, g in want.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), err_msg=k,
                                   **TOL)


def test_moe_aux_is_the_global_batch(worlds):
    """Under ``global_batch(group)`` every rank's router loss is the
    global batch's; the mean of per-rank losses is not."""
    extra = worlds[2]["extra.json"]
    cfg, _, params = _init_params("olmoe-1b-7b")
    model = params_from_reference(port_model(cfg), params)
    x = torch.randn((8, 16, model.cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        want = float(router_topk(x, model.layers[0].moe["router"],
                                 model.cfg)[2])
    for aux_group, _ in extra["aux"]:
        np.testing.assert_allclose(aux_group, want, rtol=1e-6)
    per_rank = np.mean([aux_local for _, aux_local in extra["aux"]])
    assert abs(per_rank - want) > 1e-3 * abs(want), (per_rank, want)


def test_supervised_restart_equals_the_straight_run(worlds):
    """``launch.train`` in a world of 2 with a failure injected at step 7:
    one restart from rank 0's checkpoint, and the final state bit-equal
    to the straight run's on both ranks."""
    runs = {name: worlds[2][f"{name}.json"]
            for name in ("straight", "failed")}
    assert runs["straight"]["restarts"] == 0
    assert runs["failed"]["restarts"] == 1
    assert runs["failed"]["world"] == 2
    assert runs["failed"]["mesh"] == {"data": 2, "model": 1}
    restart = [r for r in runs["failed"]["log"] if "event" in r]
    assert restart and restart[0]["restored_to"] == 7
    digests = runs["straight"]["digests"] + runs["failed"]["digests"]
    assert all(d == digests[0] for d in digests)
    losses = {name: [r["loss"] for r in run["log"] if "loss" in r]
              for name, run in runs.items()}
    assert losses["failed"][-3:] == losses["straight"][-3:]


_LAUNCH = """
import json, os
import torch.distributed as dist
from repro_torch.launch import train as launch
OUT = os.environ["OUT"]
args = ["--arch", "llama3.2-1b", "--tiny", "--steps", "2", "--seq", "8",
        "--ckpt-every", "100", "--device", "cpu", "--ckpt-dir",
        os.path.join(OUT, "ck"), "--model-parallel", "1"]
try:
    launch.main(args + ["--batch", "7"])
    refused = None
except ValueError as e:
    refused = str(e)
launch.main(args + ["--batch", "4", "--metrics-out",
                    os.path.join(OUT, "run.json")])
json.dump({"refused": refused, "initialized": dist.is_initialized()},
          open(os.path.join(OUT, f"rank{os.environ['RANK']}.json"), "w"))
"""


def test_launch_train_initialises_its_own_process_group(tmp_path):
    """Under ``RANK`` / ``WORLD_SIZE`` (as ``torch.distributed.run`` sets
    them) ``launch.train.main`` on the CPU starts a gloo group of the
    world, trains over a (2, 1) mesh (``--model-parallel 1``: data
    parallel) and destroys the group it made; a global batch that does
    not divide over the ranks is a ValueError."""
    run_ranks(_LAUNCH, 2, tmp_path)
    run = json.loads((tmp_path / "run.json").read_text())
    assert run["world"] == 2 and run["backend"] == "gloo"
    assert run["mesh"] == {"data": 2, "model": 1}
    assert all(d == run["digests"][0] for d in run["digests"])
    for r in range(2):
        rank = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert "7 does not divide" in rank["refused"]
        assert rank["initialized"] is False


def test_model_parallel_needs_a_world_it_divides(tmp_path):
    """``--model-parallel 2`` in one process (a world of one) fails the
    reference's ``best_mesh_shape`` assert, before any group is made."""
    import torch.distributed as dist
    from repro_torch.launch.train import main
    with pytest.raises(AssertionError):
        main(["--tiny", "--device", "cpu", "--model-parallel", "2",
              "--ckpt-dir", str(tmp_path)])
    assert not dist.is_initialized()


_MODEL_PARALLEL = """
import json, os
from repro_torch.launch import train as launch
OUT, NAME = os.environ["OUT"], os.environ["NAME"]
launch.main(["--arch", "llama3.2-1b", "--tiny", "--steps", "3",
             "--batch", "4", "--seq", "8", "--ckpt-every", "100",
             "--log-every", "1", "--device", "cpu", "--ckpt-dir",
             os.path.join(OUT, "ck_" + NAME), "--metrics-out",
             os.path.join(OUT, NAME + ".json")]
            + os.environ["FLAGS"].split())
"""


def test_launch_train_model_parallel_2_trains(tmp_path):
    """``--model-parallel 2`` under 2 gloo ranks trains on mesh (1, 2):
    the state sharded (each rank's bytes equal the dry run's
    ``sharded.state_bytes``), attention, MLP and vocabulary split over
    ``model``, the loss falling; the default ``--model-parallel 0``
    factors the same world the same way (``best_mesh_shape``) and
    trains the same steps."""
    from repro_torch.train.step import replicas_agree
    # a world a run: a group made again over one store can read the
    # first's stale addresses and hang
    for name, flags in (("two", "--model-parallel 2"), ("default", "")):
        run_ranks(_MODEL_PARALLEL, 2, tmp_path,
                  env={"NAME": name, "FLAGS": flags})
    runs = {name: json.loads((tmp_path / f"{name}.json").read_text())
            for name in ("two", "default")}
    for run in runs.values():
        assert run["mesh"] == {"data": 1, "model": 2}
        assert run["world"] == 2 and run["backend"] == "gloo"
        assert run["state_bytes"] == run["dryrun_state_bytes"]
        assert replicas_agree(run["digests"])
        assert "attention: split, 2 of 4 heads" in run["paths"]
        assert not [p for p in run["paths"] if p.endswith("gathered")]
        assert set(run["collective_ms"]) >= {"model_all_reduce", "norm"}
        losses = [r["loss"] for r in run["log"] if "loss" in r]
        assert len(losses) == 3 and losses[-1] < losses[0]
    assert [r["loss"] for r in runs["two"]["log"]] == \
        [r["loss"] for r in runs["default"]["log"]]


_BACKEND = """
import json, os
import torch
from repro_torch.launch import train as launch
OUT = os.environ["OUT"]
seen = {}
real = launch.make_train_step
def spy(model, *a, **kw):
    seen["dtype"] = str(model.compute_dtype)
    return real(model, *a, **kw)
launch.make_train_step = spy
launch.main(["--arch", "olmoe-1b-7b", "--tiny", "--steps", "2", "--batch",
             "4", "--seq", "8", "--ckpt-every", "100", "--device", "cpu",
             "--backend", "gloo", "--dtype", "float32", "--ckpt-dir",
             os.path.join(OUT, "ck"), "--metrics-out",
             os.path.join(OUT, "run.json")])
json.dump(seen, open(os.path.join(OUT, f"rank{os.environ['RANK']}.json"),
                     "w"))
"""


def test_launch_train_takes_backend_and_compute_dtype(tmp_path):
    """``--backend gloo`` names the group's backend (what two ranks
    sharing one card need) and ``--dtype float32`` the compute dtype over
    the float32 master weights."""
    run_ranks(_BACKEND, 2, tmp_path)
    run = json.loads((tmp_path / "run.json").read_text())
    assert run["backend"] == "gloo" and run["world"] == 2
    for r in range(2):
        rank = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert rank["dtype"] == "torch.float32"
