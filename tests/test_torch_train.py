"""The LM scaffold's training path in the port against the reference, on the
CPU: ``TransformerLM.loss`` and its gradients for every architecture at
``tiny_config`` in float32, remat, ``optim.adamw``, ``train.step`` (three
steps, gradient accumulation, a bfloat16-compute step over float32 master
weights) and ``convert.state_from_reference`` continuing from a checkpoint
the reference wrote.

The reference's parameters (``model.init``, float32) load into the port
through ``convert``; both sides see the same numpy batches from
``TokenStream``.  Tolerances (float32): the loss within rtol 1e-5 and
every gradient within atol 1e-5 + rtol 1e-4 (both sides run the same
float32 ops and differ in the order XLA's and PyTorch's kernels sum);
AdamW from equal gradients within rtol 1e-6; three train steps within
rtol = atol = 1e-4.
"""
import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.models import registry as ref_registry
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch.convert import (_reference_leaves,
                                 model_config_from_reference,
                                 params_from_reference, state_from_reference)
from repro_torch.data.tokens import TokenStream
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.step import make_train_step

B, S = 4, 16
OPT = dict(lr=1e-3, total_steps=50, warmup_steps=2)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def ref_config(arch: str, dtype: str = "float32"):
    return dataclasses.replace(
        ref_registry.tiny_config(ref_registry.get_config(arch)), dtype=dtype)


def port_model(ref_cfg, **kw):
    cfg = model_config_from_reference(dataclasses.asdict(ref_cfg))
    return registry.get_model(cfg, device="cpu", param_dtype="float32", **kw)


def batch_at(cfg, seed: int, i: int, batch: int = B) -> dict:
    return TokenStream(cfg.vocab, batch, S, seed=seed, family=cfg.family,
                       d_model=cfg.d_model,
                       n_codebooks=cfg.n_codebooks).batch_at(i)


def ref_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_named_close(got: dict, want_tree, **tol):
    """`got` (port name -> tensor) against a reference tree of the
    model's parameter layout."""
    want = dict(_reference_leaves(np_tree(want_tree)))
    assert set(got) == set(want)
    for k, g in got.items():
        np.testing.assert_allclose(g.detach().float().numpy(), want[k],
                                   err_msg=k, **tol)


# ----------------------------------------------------------- loss, grads --

@functools.lru_cache(maxsize=None)
def loss_and_grads(arch: str):
    i = registry.ARCH_IDS.index(arch)
    ref_cfg = ref_config(arch)
    rm = ref_registry.get_model(ref_cfg)
    rp = rm.init(jax.random.PRNGKey(i))
    batch = batch_at(ref_cfg, i, 0)
    (r_loss, r_aux), r_grads = jax.jit(jax.value_and_grad(
        rm.loss, has_aux=True))(rp, ref_batch(batch))
    model = params_from_reference(port_model(ref_cfg), np_tree(rp))
    loss, aux = model.loss(batch)
    loss.backward()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    return (r_loss, r_aux["ce"], r_grads), (loss.detach(),
                                           aux["ce"].detach(), grads)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_loss_equals_the_reference(arch):
    (r_loss, r_ce, _), (loss, ce, _) = loss_and_grads(arch)
    assert loss.dtype == ce.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=1e-5)
    np.testing.assert_allclose(float(ce), float(r_ce), rtol=1e-5)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_gradients_equal_the_reference(arch):
    (_, _, r_grads), (_, _, grads) = loss_and_grads(arch)
    assert {g.dtype for g in grads.values()} == {torch.float32}
    assert_named_close(grads, r_grads, rtol=1e-4, atol=1e-5)


def test_router_aux_enters_the_loss():
    """The MoE architectures add ``router_aux_coef * aux / n_layers``
    to the mean cross-entropy."""
    cfg = ref_config("olmoe-1b-7b")
    assert cfg.router_aux_coef > 0
    (r_loss, r_ce, _), (loss, ce, _) = loss_and_grads("olmoe-1b-7b")
    assert float(loss) > float(ce)
    np.testing.assert_allclose(float(loss - ce), float(r_loss - r_ce),
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b",
                                  "zamba2-2.7b", "xlstm-125m"])
def test_remat_gradients_equal_no_remat(arch):
    """``cfg.remat`` recomputes each layer in the backward pass (the
    transformer, zamba2 and xLSTM loops): the same loss and gradients,
    bit for bit on the CPU."""
    ref_cfg = ref_config(arch)
    assert not ref_cfg.remat                    # tiny_config turns it off
    batch = batch_at(ref_cfg, 0, 0)
    out = []
    for remat in (False, True):
        model = port_model(dataclasses.replace(ref_cfg, remat=remat),
                           generator=torch.Generator().manual_seed(1))
        loss, _ = model.loss(batch)
        loss.backward()
        out.append((loss, {n: p.grad for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for n, g in g0.items():
        assert (g is None) == (g1[n] is None), n
        assert g is None or torch.equal(g, g1[n]), n


def test_loss_masks_the_padded_vocab():
    """Columns past ``cfg.vocab`` take no probability: with the padded
    columns' logits made huge the loss does not move."""
    ref_cfg = dataclasses.replace(ref_config("llama3.2-1b"), vocab=250)
    model = port_model(ref_cfg)
    assert model.cfg.vocab_padded == 256
    batch = batch_at(ref_cfg, 0, 0)
    with torch.no_grad():
        before = model.loss(batch)[0]
        model.embed[250:] = 100.0               # tied: the padded logits
        after = model.loss(batch)[0]
    np.testing.assert_allclose(float(after), float(before), rtol=1e-6)


# ---------------------------------------------------------------- AdamW --

def _adamw_case(step0: int, clip: float, seed: int):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (6, 4), "final_norm": (4,), "layers": (2, 4, 3)}
    draw = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    grads = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
         for k, s in shapes.items()}
    v = {k: (np.abs(rng.standard_normal(s)) * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, clip_norm=clip)
    ref = jax.jit(lambda p, g, o: ref_adamw.adamw_update(
        p, g, o, ref_adamw.AdamWConfig(**cfg)))(
        draw, grads, {"m": m, "v": v, "step": jnp.int32(step0)})
    t = {k: torch.tensor(a) for k, a in draw.items()}
    opt = {"m": {k: torch.tensor(a) for k, a in m.items()},
           "v": {k: torch.tensor(a) for k, a in v.items()},
           "step": torch.tensor(step0, dtype=torch.int32)}
    metrics = adamw.adamw_update(t, {k: torch.tensor(a)
                                     for k, a in grads.items()},
                                 opt, adamw.AdamWConfig(**cfg))
    return ref, (t, opt, metrics)


@pytest.mark.parametrize("step0,clip", [(0, 1.0), (4, 1.0), (54, 1.0),
                                        (120, 1.0), (30, 100.0)],
                         ids=["first", "warmup", "mid", "end", "unclipped"])
def test_adamw_update_equals_the_reference(step0, clip):
    """One update from the same parameters, gradients and moments:
    warmup, mid-cosine and past the end of the schedule (clipped), and
    one step whose gradients are under the clip norm."""
    (r_params, r_opt, r_metrics), (params, opt, metrics) = \
        _adamw_case(step0, clip, seed=step0)
    assert int(opt["step"]) == int(r_opt["step"]) == step0 + 1
    assert opt["step"].dtype == torch.int32
    for k in params:
        np.testing.assert_allclose(params[k].numpy(), r_params[k],
                                   rtol=1e-6, err_msg=k)
        for part in ("m", "v"):
            # b1 m + (1 - b1) g cancels near 0: a one-ulp difference in the
            # clip scale (XLA and PyTorch sum the global norm in another
            # order) is relative to the terms, hence atol 1e-6 of the
            # moment's largest value
            want = np.asarray(r_opt[part][k])
            assert opt[part][k].dtype == torch.float32
            np.testing.assert_allclose(opt[part][k].numpy(), want,
                                       rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{part} {k}")
    for name in ("grad_norm", "lr"):
        assert metrics[name].ndim == 0
        np.testing.assert_allclose(float(metrics[name]),
                                   float(r_metrics[name]), rtol=1e-6)
    gn = float(metrics["grad_norm"])
    assert (gn > clip) == (clip == 1.0)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 30, 55, 100, 150])
def test_schedule_equals_the_reference(step):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100)
    want = ref_adamw.schedule(ref_adamw.AdamWConfig(**cfg), jnp.int32(step))
    got = adamw.schedule(adamw.AdamWConfig(**cfg),
                         torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_clip_and_global_norm_equal_the_reference():
    rng = np.random.default_rng(3)
    g = {k: rng.standard_normal((5, 3)).astype(np.float32) for k in "abc"}
    r_clipped, r_gn = ref_adamw.clip_by_global_norm(g, 0.5)
    clipped, gn = adamw.clip_by_global_norm(
        {k: torch.tensor(a) for k, a in g.items()}, 0.5)
    np.testing.assert_allclose(float(gn), float(r_gn), rtol=1e-6)
    np.testing.assert_allclose(float(adamw.global_norm(clipped)), 0.5,
                               rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(clipped[k].numpy(), r_clipped[k],
                                   rtol=1e-6)


def test_adamw_treats_a_missing_gradient_as_zeros():
    """An unused weight (musicgen's embedding under ``embeds`` input) has
    no gradient; the reference's is zeros, so its moments decay and the
    weight decays."""
    p = {"w": torch.ones(3), "u": torch.ones(2)}
    opt = adamw.init_opt_state(p)
    adamw.adamw_update(p, {"w": torch.ones(3), "u": None}, opt,
                       adamw.AdamWConfig(warmup_steps=1))
    assert torch.all(p["u"] < 1) and torch.all(opt["v"]["u"] == 0)


# ------------------------------------------------------------ train step --

@functools.lru_cache(maxsize=None)
def train_runs(arch: str):
    """The reference's jitted train step from ``init_state`` for 3 steps
    (a checkpoint saved after the first); the port from the same state
    for 3 steps, and from that checkpoint (``state_from_reference``) for
    2."""
    i = registry.ARCH_IDS.index(arch)
    ref_cfg = ref_config(arch)
    rm = ref_registry.get_model(ref_cfg)
    r_step = jax.jit(ref_step.make_train_step(
        rm, ref_adamw.AdamWConfig(**OPT)))
    r_state = ref_step.init_state(rm, jax.random.PRNGKey(i))
    init = np_tree(r_state)
    batches = [batch_at(ref_cfg, i, s) for s in range(3)]
    r_losses = []
    with tempfile.TemporaryDirectory() as tmp:
        for s, b in enumerate(batches):
            r_state, r_metrics = r_step(r_state, ref_batch(b))
            r_losses.append(float(r_metrics["loss"]))
            if s == 0:
                ref_ckpt.save_checkpoint(tmp, r_state, 1)
        restored, at = ref_ckpt.restore_checkpoint(
            tmp, ref_step.abstract_state(rm))
    assert at == 1
    opt_cfg = adamw.AdamWConfig(**OPT)

    def port_run(state_tree, first: int):
        state = state_from_reference(port_model(ref_cfg), state_tree)
        step = make_train_step(state["model"], opt_cfg)
        losses = []
        for b in batches[first:]:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
        return state, losses

    return (np_tree(r_state), r_losses), port_run(init, 0), \
        port_run(np_tree(restored), 1)


def assert_state_close(state, r_state, tol):
    assert_named_close(dict(state["model"].named_parameters()),
                       r_state["params"], **tol)
    for part in ("m", "v"):
        assert_named_close(state["opt"][part], r_state["opt"][part], **tol)
    assert int(state["opt"]["step"]) == int(r_state["opt"]["step"])


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_three_train_steps_equal_the_reference(arch):
    (r_state, r_losses), (state, losses), _ = train_runs(arch)
    np.testing.assert_allclose(losses, r_losses, **STEP_TOL)
    assert_state_close(state, r_state, STEP_TOL)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_reference_checkpoint_continues_to_the_reference(arch):
    """A checkpoint the reference's ``save_checkpoint`` wrote after step
    1, read back by the reference and carried over by
    ``state_from_reference``: two port steps reach the reference's state
    after step 3."""
    (r_state, r_losses), _, (state, losses) = train_runs(arch)
    np.testing.assert_allclose(losses, r_losses[1:], **STEP_TOL)
    assert_state_close(state, r_state, STEP_TOL)


def test_grad_accum_step_equals_the_reference():
    """``grad_accum=2`` against the reference's (its ``lax.scan`` over
    micro-batches): the same mean loss and updated state within 1e-4;
    metrics are only loss, grad_norm and lr in both."""
    ref_cfg = ref_config("llama3.2-1b")
    rm = ref_registry.get_model(ref_cfg)
    r_state = ref_step.init_state(rm, jax.random.PRNGKey(5))
    state = state_from_reference(port_model(ref_cfg), np_tree(r_state))
    r_step = jax.jit(ref_step.make_train_step(
        rm, ref_adamw.AdamWConfig(**OPT), grad_accum=2))
    step = make_train_step(state["model"], adamw.AdamWConfig(**OPT),
                           grad_accum=2)
    for i in range(2):
        b = batch_at(ref_cfg, 5, i)
        r_state, r_metrics = r_step(r_state, ref_batch(b))
        state, metrics = step(state, b)
        assert set(metrics) == set(r_metrics) == {"loss", "grad_norm", "lr"}
        for k in metrics:
            np.testing.assert_allclose(float(metrics[k]),
                                       float(r_metrics[k]), **STEP_TOL)
    assert_state_close(state, np_tree(r_state), STEP_TOL)


def test_state_from_reference_refuses_a_tree_that_does_not_match():
    ref_cfg = ref_config("llama3.2-1b")
    rm = ref_registry.get_model(ref_cfg)
    model = port_model(ref_cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}

    def tree():
        return np_tree(ref_step.init_state(rm, jax.random.PRNGKey(0)))
    bad = tree()
    bad["opt"]["m"]["layers"]["mlp"]["wd"] = \
        bad["opt"]["m"]["layers"]["mlp"]["wd"][:, :-1]
    with pytest.raises(ValueError, match="opt.m.*layers.0.mlp.wd"):
        state_from_reference(model, bad)
    missing = tree()
    del missing["opt"]["v"]["final_norm"]
    with pytest.raises(ValueError, match="opt.v.*final_norm"):
        state_from_reference(model, missing)
    bad = tree()
    bad["params"]["embed"] = bad["params"]["embed"][:-1]
    with pytest.raises(ValueError, match="embed"):
        state_from_reference(model, bad)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


# ------------------------------------------ bfloat16 over float32 masters --

#: bfloat16 step against the reference run op by op: the loss within
#: rtol 1e-2 and the gradient norm within rtol 2e-2 (a bfloat16 step is
#: 2**-8 = 0.4 % relative; the logits and the gradients each pass through
#: a few dozen bfloat16 roundings, summed with random signs); a parameter
#: within 2 lr + 1e-6 of the reference's: AdamW's first step moves a
#: weight by lr * sign(g) (m/sqrt(v) = g/|g|), so a gradient that
#: differs in sign near 0 moves it 2 lr the other way
BF16_LOSS_RTOL, BF16_NORM_RTOL = 1e-2, 2e-2


def test_bf16_compute_float32_master_step():
    ref_cfg = ref_config("llama3.2-1b", "bfloat16")
    rm = ref_registry.get_model(ref_cfg)
    r_state = ref_step.init_state(rm, jax.random.PRNGKey(2))
    state = state_from_reference(port_model(ref_cfg), np_tree(r_state))
    model = state["model"]
    assert model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    b = batch_at(ref_cfg, 2, 0)
    with jax.disable_jit():
        r_state, r_metrics = ref_step.make_train_step(
            rm, ref_adamw.AdamWConfig(**OPT))(r_state, ref_batch(b))
    state, metrics = make_train_step(model, adamw.AdamWConfig(**OPT))(
        state, b)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(r_metrics["loss"]),
                               rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(r_metrics["grad_norm"]),
                               rtol=BF16_NORM_RTOL)
    lr = float(r_metrics["lr"])
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert_named_close(dict(model.named_parameters()),
                       r_state["params"], rtol=0, atol=2 * lr + 1e-6)
