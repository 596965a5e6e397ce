"""Fault tolerance of the port's training path (``checkpoint/ckpt.py``,
``runtime/ft.py``, ``runtime/elastic.py``, ``launch/train.py``): the
tests of ``tests/test_train_ft.py`` on the port, at the same tiny size
(tiny Llama, bfloat16 compute over float32 master weights, the AdamW
settings of that file), and the checkpoint layout against the
reference's.  The port updates its state in place, so a restore loads
into the model's and optimizer's own tensors; on the CPU a resumed run
equals an uninterrupted one bit for bit."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.models import registry as ref_registry
from repro.runtime import elastic as ref_elastic
from repro.train import step as ref_step
from repro_torch.checkpoint.ckpt import (flat_state, latest_step,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as train_launch
from repro_torch.models.registry import get_config, get_model, tiny_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import elastic
from repro_torch.runtime.ft import FailureInjector, Watchdog, supervise
from repro_torch.train.step import abstract_state, init_state, make_train_step

CFG = tiny_config(get_config("llama3.2-1b"))
OPT = AdamWConfig(lr=1e-3, total_steps=50, warmup_steps=2)


def fresh(seed: int = 0):
    """(model, train step, state) from one seeded init: equal seeds give
    equal states."""
    model = get_model(CFG, device="cpu", param_dtype="float32",
                      generator=torch.Generator().manual_seed(seed))
    return model, make_train_step(model, OPT), init_state(model)


@pytest.fixture
def stream():
    return TokenStream(CFG.vocab, 4, 64, seed=0)


def assert_states_equal(a, b):
    fa, fb = flat_state(a), flat_state(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k].cpu(), fb[k].cpu()), k


def test_train_state_holds_float32_masters_under_bf16_compute():
    model, _, state = fresh()
    assert model.compute_dtype == torch.bfloat16
    flat = flat_state(state)
    assert {t.dtype for k, t in flat.items() if k != "opt.step"} == \
        {torch.float32}
    assert flat["opt.step"].dtype == torch.int32
    assert len(flat) == 3 * len(list(model.parameters())) + 1


def test_checkpoint_roundtrip(tmp_path, stream):
    model, step, state = fresh()
    state, _ = step(state, stream.batch_at(0))
    save_checkpoint(tmp_path / "ck", state, 7, keep=2)
    assert latest_step(tmp_path / "ck") == 7
    restored, s = restore_checkpoint(tmp_path / "ck", abstract_state(model))
    assert s == 7
    assert_states_equal(restored, state)
    _, _, other = fresh(seed=1)
    into, s = restore_checkpoint(tmp_path / "ck", other)
    assert into is other and s == 7
    assert_states_equal(other, state)


def test_checkpoint_keep_n(tmp_path):
    _, _, state = fresh()
    for s in (10, 20, 30, 40):
        save_checkpoint(tmp_path / "ck", state, s, keep=2)
    steps = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert steps == ["step_00000030", "step_00000040"]


def test_checkpoint_layout_equals_the_reference(tmp_path):
    """The same files and manifest fields as the reference's checkpoint
    of the same model; the keys are the port's names, one a leaf."""
    ref_cfg = ref_registry.tiny_config(ref_registry.get_config("llama3.2-1b"))
    rm = ref_registry.get_model(ref_cfg)
    ref_ckpt.save_checkpoint(tmp_path / "ref", ref_step.init_state(
        rm, jax.random.PRNGKey(0)), 3)
    model, _, state = fresh()
    save_checkpoint(tmp_path / "port", state, 3)
    ref_dir, port_dir = tmp_path / "ref" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    assert sorted(p.name for p in port_dir.iterdir()) == \
        sorted(p.name for p in ref_dir.iterdir()) == \
        ["manifest.json", "shard_0.npz"]
    ref_man = json.loads((ref_dir / "manifest.json").read_text())
    man = json.loads((port_dir / "manifest.json").read_text())
    assert man.keys() == ref_man.keys()
    assert (man["step"], man["n_shards"]) == (ref_man["step"],
                                             ref_man["n_shards"]) == (3, 1)
    assert man["keys"] == sorted(flat_state(state))
    # a reference key names a weight stacked over the layers, or one leaf
    want = set()
    for key in ref_man["keys"]:
        head, *rest = key.split("/")
        head = ["model"] if head == "params" else ["opt"]
        if head == ["opt"] and rest[0] in ("m", "v"):
            head, rest = head + rest[:1], rest[1:]
        if rest[0] == "layers":
            want |= {".".join(head + ["layers", str(i)] + rest[1:])
                     for i in range(CFG.n_layers)}
        else:
            want.add(".".join(head + rest))
    assert set(man["keys"]) == want
    with np.load(port_dir / "shard_0.npz") as data:
        assert sorted(data.files) == man["keys"]


def test_bf16_leaf_is_refused(tmp_path):
    """``np.savez`` has no bfloat16: a state with bfloat16 weights is
    refused by name, and nothing is written."""
    model = get_model(CFG, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="bfloat16 leaves.*model.embed"):
        save_checkpoint(tmp_path / "ck", init_state(model), 1)
    assert not (tmp_path / "ck").exists()


def test_restore_refuses_a_state_that_does_not_match(tmp_path):
    _, _, state = fresh()
    save_checkpoint(tmp_path / "ck", state, 1)
    wide = get_model(tiny_config(get_config("llama3.2-1b"), n_layers=3),
                     device="cpu", param_dtype="float32")
    with pytest.raises(ValueError, match="missing.*layers.2"):
        restore_checkpoint(tmp_path / "ck", init_state(wide))
    bf16 = get_model(CFG, device="cpu")
    target = init_state(bf16)
    before = {k: t.clone() for k, t in flat_state(target).items()}
    with pytest.raises(ValueError, match="model.embed"):
        restore_checkpoint(tmp_path / "ck", target)
    for k, t in flat_state(target).items():
        assert torch.equal(t, before[k]), k
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", target)


def test_async_save_snapshots_before_returning(tmp_path):
    """The host copy is taken before ``save_checkpoint`` returns: a step
    that updates the weights in place meanwhile does not reach the
    file."""
    model, _, state = fresh()
    want = {k: t.clone() for k, t in flat_state(state).items()}
    thread = save_checkpoint(tmp_path / "ck", state, 5, async_save=True)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    thread.join(timeout=60)
    assert not thread.is_alive()
    restored, _ = restore_checkpoint(tmp_path / "ck", abstract_state(model))
    for k, t in flat_state(restored).items():
        assert torch.equal(t, want[k]), k


def test_supervised_restart_reaches_target(tmp_path, stream):
    _, step, state = fresh()
    inj = FailureInjector(fail_at=[7, 13])
    final, log, restarts = supervise(
        step, state, stream, steps=20, ckpt_dir=tmp_path / "ck",
        ckpt_every=5, injector=inj, log_every=5)
    assert restarts == 2
    assert int(final["opt"]["step"]) >= 20
    events = [r for r in log if "event" in r]
    assert len(events) == 2
    assert [e["restored_to"] for e in events] == [5, 10]
    assert all(np.isfinite(r["loss"]) for r in log if "loss" in r)


def test_restart_resumes_identical_state(tmp_path, stream):
    """Train 10 straight vs train-with-crash-at-7: the same final state
    (the data stream is a pure function of step, checkpoints at every
    step), bit for bit on the CPU."""
    _, step_a, s_a = fresh()
    s_a, _, _ = supervise(step_a, s_a, stream, steps=10,
                          ckpt_dir=tmp_path / "a", ckpt_every=1)
    _, step_b, s_b = fresh()
    inj = FailureInjector(fail_at=[7])
    s_b, log, r = supervise(step_b, s_b, stream, steps=10,
                            ckpt_dir=tmp_path / "b", ckpt_every=1,
                            injector=inj)
    assert r == 1 and log[0]["restored_to"] == 7
    assert_states_equal(s_a, s_b)


def test_supervise_resumes_from_an_existing_checkpoint(tmp_path, stream):
    """A new run over a directory with checkpoints starts from the latest
    (loaded into its own state) and ends where one straight run ends."""
    _, step, s = fresh()
    supervise(step, s, stream, steps=4, ckpt_dir=tmp_path / "ck",
              ckpt_every=2)
    _, step, resumed = fresh(seed=3)
    resumed, _, _ = supervise(step, resumed, stream, steps=6,
                              ckpt_dir=tmp_path / "ck", ckpt_every=2)
    _, step, straight = fresh()
    straight, _, _ = supervise(step, straight, stream, steps=6,
                               ckpt_dir=tmp_path / "straight", ckpt_every=2)
    assert int(resumed["opt"]["step"]) == 6
    assert_states_equal(resumed, straight)


def test_watchdog_flags_straggler():
    wd = Watchdog(factor=3.0)
    for i in range(20):
        wd.record(i, 0.1)
    assert wd.record(20, 1.0)
    assert wd.stragglers


def test_grad_accum_matches_full_batch(stream):
    """mean-of-microbatch-grads == full-batch grad (CE of means), in
    bfloat16 compute, as ``tests/test_train_ft.py`` holds the reference
    (the same tolerance)."""
    model, _, _ = fresh()
    batch = stream.batch_at(0)
    params = list(model.parameters())
    full = torch.autograd.grad(model.loss(batch)[0], params)
    acc = [torch.zeros_like(p) for p in params]
    for i in range(2):
        mb = {k: v[2 * i:2 * (i + 1)] for k, v in batch.items()}
        for a, g in zip(acc, torch.autograd.grad(model.loss(mb)[0],
                                                 params)):
            a += g
    for (name, _), f, a in zip(model.named_parameters(), full, acc):
        assert f.dtype == torch.float32
        np.testing.assert_allclose(f.numpy(), (a / 2).numpy(), rtol=5e-2,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48])
def test_best_mesh_shape_equals_the_reference(n):
    assert elastic.best_mesh_shape(n) == ref_elastic.best_mesh_shape(n)
    if n % 2 == 0:
        assert elastic.best_mesh_shape(n, 2) == \
            ref_elastic.best_mesh_shape(n, 2)


def test_elastic_mesh_over_given_devices():
    mesh = elastic.make_elastic_mesh(devices=["cpu"] * 4)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 4}
    assert elastic.make_elastic_mesh(2, devices=["cpu"] * 4).shape == \
        {"data": 2, "model": 2}
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        elastic.reshard({}, {}, mesh)


def test_train_main_on_cpu_with_an_injected_failure(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: a tiny llama
    trained 6 steps with a checkpoint every 2 and a failure at step 3,
    restored to step 2; the reference's lines."""
    log = train_launch.main([
        "--arch", "llama3.2-1b", "--tiny", "--steps", "6", "--batch", "2",
        "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
        "2", "--inject-failure-at", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mesh: {'data': 1, 'model': 1} on cpu  arch: llama3.2-1b" in out
    assert "done: 6 steps, 1 restarts" in out
    events = [r for r in log if "event" in r]
    assert len(events) == 1 and events[0]["restored_to"] == 2
    assert latest_step(tmp_path / "ck") == 6
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        train_launch.main(["--tiny", "--steps", "1", "--device", "cpu",
                           "--model-parallel", "2"])
