"""The LM scaffold's serving path in the port against the reference, for
every architecture of the registry at ``tiny_config`` in float32: the
reference's ``model.init`` parameters (as numpy) load into the port's
model through ``convert.params_from_reference``; the train-mode forward,
prefill and its cache, a decode step after ``pad_cache`` and its cache,
are held against the reference's (``greedy_generate`` and
``init_cache``: ``tests/test_torch_lm_serve.py``).  Also the registry,
the configs, ``TokenStream`` and the parameter loader's checks.  The
helpers here are shared by the other ``test_torch_lm_*`` files.

Tolerance (float32): rtol = atol = 1e-4 on logits and cache leaves of
order 1.  Both sides run the same float32 ops and differ only in the
order XLA's and PyTorch's kernels sum (measured: at most 6e-6); greedy
tokens are equal.  ``tests/test_torch_lm_bf16.py`` holds the bfloat16
logits.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import tokens as ref_tokens
from repro.models import registry as ref_registry
from repro.serve.kvcache import pad_cache as ref_pad_cache
from repro_torch.convert import (model_config_from_reference,
                                 params_from_reference)
from repro_torch.data.tokens import TokenStream, to_device
from repro_torch.models import registry
from repro_torch.serve.kvcache import pad_cache

F32_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, NEW = 2, 12, 4


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def leaves(tree):
    """A cache's leaves in key order (dicts by sorted key, tuples in
    order), so the reference's and the port's line up."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def assert_trees_close(got, want, tol):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_allclose(to_np(g), to_np(w), **tol)


@functools.lru_cache(maxsize=None)
def model_pair(arch: str, dtype: str):
    """(reference config, model, params; port model) at ``tiny_config``
    in `dtype`, the port loaded with the reference's parameters."""
    ref_cfg = dataclasses.replace(
        ref_registry.tiny_config(ref_registry.get_config(arch)), dtype=dtype)
    ref_model = ref_registry.get_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = model_config_from_reference(dataclasses.asdict(ref_cfg))
    model = registry.get_model(cfg, device="cpu")
    params_from_reference(model, jax.tree_util.tree_map(np.asarray,
                                                        ref_params))
    return ref_cfg, ref_model, ref_params, model


def batches(cfg, seed: int):
    """(prefill batch, decode batch) as numpy from ``TokenStream``: S
    prompt steps and the step after them (tokens, or embeddings for the
    audio family; M-RoPE positions for the VLM)."""
    b = TokenStream(cfg.vocab, B, S + 1, seed=seed, family=cfg.family,
                    d_model=cfg.d_model,
                    n_codebooks=cfg.n_codebooks).batch_at(0)
    b.pop("labels")
    key = "embeds" if "embeds" in b else "tokens"
    prefill = {key: b[key][:, :S]}
    decode = {key: b[key][:, S:S + 1], "cache_pos": S}
    if "positions" in b:
        prefill["positions"] = b["positions"][:, :, :S]
        decode["positions"] = b["positions"][:, :, S:S + 1]
    return prefill, decode


def ref_batch(batch):
    return {k: jnp.int32(v) if k == "cache_pos" else jnp.asarray(v)
            for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def f32_run(arch: str):
    """Every float32 output of the reference and the port for `arch`."""
    i = registry.ARCH_IDS.index(arch)
    ref_cfg, rm, rp, model = model_pair(arch, "float32")
    prefill, decode = batches(ref_cfg, seed=i)
    out = {}
    with torch.no_grad():
        out["train"] = (rm.forward(rp, ref_batch(prefill), mode="train")[0],
                        model(prefill, mode="train")[0])
    rl, rc = rm.prefill(rp, ref_batch(prefill))
    pl, pc = model.prefill(prefill)
    out["prefill"] = (rl, pl)
    out["prefill_cache"] = (rc, pc)
    rc, pc = ref_pad_cache(rc, S + NEW), pad_cache(pc, S + NEW)
    rl, rc = rm.decode_step(rp, ref_batch(decode), rc)
    pl, pc = model.decode_step(decode, pc)
    out["decode"] = (rl, pl)
    out["decode_cache"] = (rc, pc)
    return out


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
@pytest.mark.parametrize("what", ["train", "prefill", "prefill_cache",
                                  "decode", "decode_cache"])
def test_forward_modes_equal_the_reference(arch, what):
    want, got = f32_run(arch)[what]
    assert_trees_close(got, want, F32_TOL)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    ref = ref_registry.get_config(arch)
    assert dataclasses.asdict(registry.get_config(arch)) == \
        dataclasses.asdict(ref)
    tiny = registry.tiny_config(registry.get_config(arch))
    assert dataclasses.asdict(tiny) == \
        dataclasses.asdict(ref_registry.tiny_config(ref))
    for c, r in ((registry.get_config(arch), ref), (tiny,
                 ref_registry.tiny_config(ref))):
        assert (c.vocab_padded, c.head_dim, c.block_kind) == \
            (r.vocab_padded, r.head_dim, r.block_kind)
        for shape in registry.SHAPES:
            assert registry.shape_applicable(c, shape) == \
                ref_registry.shape_applicable(r, shape)


def test_registry_tables_equal_the_reference():
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    assert registry.SHAPES == ref_registry.SHAPES
    assert model_config_from_reference(dataclasses.asdict(
        ref_registry.get_config("qwen2-vl-2b"))).mrope_sections == (16, 24, 24)


@pytest.mark.parametrize("family", ["dense", "audio", "vlm"])
def test_token_stream_equals_the_reference(family):
    kw = dict(vocab=300, batch=3, seq=10, seed=5, family=family,
              d_model=8, n_codebooks=2)
    ours, ref = TokenStream(**kw), ref_tokens.TokenStream(**kw)
    for i in (0, 1, 7):
        got, want = ours.batch_at(i), ref.batch_at(i)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    it = ours.iterate(start=7)
    np.testing.assert_array_equal(next(it)["labels"],
                                  ref.batch_at(7)["labels"])
    tensors = to_device(ours.batch_at(1), device="cpu")
    assert tensors.keys() == want.keys()
    for k, t in tensors.items():
        np.testing.assert_array_equal(t.numpy(), ours.batch_at(1)[k])


def test_prefetcher_yields_the_stream_in_order():
    from repro_torch.data.tokens import Prefetcher
    stream = TokenStream(vocab=50, batch=2, seq=4, seed=1)
    pf = Prefetcher(stream.iterate(), depth=2)
    for i in range(4):
        np.testing.assert_array_equal(next(pf)["tokens"],
                                      stream.batch_at(i)["tokens"])
    pf.stop()


def test_params_from_reference_refuses_a_tree_that_does_not_match():
    ref_cfg, rm, rp, model = model_pair("llama3.2-1b", "float32")
    tree = jax.tree_util.tree_map(np.asarray, rp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["layers"]["attn"]["wq"] = bad["layers"]["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="layers.0.attn.wq"):
        params_from_reference(model, bad)
    missing = jax.tree_util.tree_map(lambda a: a, tree)
    del missing["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_reference(model, missing)
    extra = dict(tree, head=np.zeros((64, 256), np.float32))
    with pytest.raises(ValueError, match="head"):
        params_from_reference(model, extra)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_weights_live_in_the_compute_dtype():
    """``cfg.dtype`` (or ``dtype=``) is the weights' dtype: the cast the
    reference's ``cast_tree`` makes on every call, made once."""
    cfg = registry.tiny_config(registry.get_config("granite-3-2b"))
    assert cfg.dtype == "bfloat16"
    model = registry.get_model(cfg, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    model = registry.get_model(cfg, device="cpu", dtype=torch.float32)
    assert model.cfg.dtype == "float32"
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="dtype"):
        registry.get_model(cfg, device="cpu", dtype="float16")
    g = torch.Generator().manual_seed(3)
    a = registry.get_model(cfg, device="cpu", generator=g)
    b = registry.get_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    for (k, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), k
