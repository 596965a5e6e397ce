"""The LM scaffold's serving loop in the port against the reference, for
every architecture at ``tiny_config`` in float32 (the models and
tolerance of ``tests/test_torch_lm.py``): ``greedy_generate``'s tokens,
equal; ``init_cache``'s leaves, shapes and dtypes equal, and a decode
step from it within rtol = atol = 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.kvcache import greedy_generate as ref_greedy
from repro_torch.models import registry
from repro_torch.serve.kvcache import greedy_generate
from tests.test_torch_lm import (B, F32_TOL, NEW, S, assert_trees_close,
                                 batches, leaves, model_pair, ref_batch,
                                 to_np)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_greedy_generate_tokens_equal_the_reference(arch):
    ref_cfg, rm, rp, model = model_pair(arch, "float32")
    prompt, _ = batches(ref_cfg, seed=registry.ARCH_IDS.index(arch))
    if ref_cfg.n_codebooks:
        # an audio model's logits are per codebook: the reference's loop
        # feeds (B, 1, C) tokens back and fails; the port refuses up front
        toks = np.zeros((B, S), np.int32)
        with pytest.raises(ValueError):
            ref_greedy(rm, rp, jnp.asarray(toks), NEW, S + NEW)
        with pytest.raises(ValueError, match="codebook"):
            greedy_generate(model, toks, NEW, S + NEW)
        return
    want = ref_greedy(rm, rp, jnp.asarray(prompt["tokens"]), NEW, S + NEW)
    got = greedy_generate(model, prompt["tokens"], NEW, S + NEW)
    assert got.shape == (B, NEW) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_init_cache_equals_the_reference(arch):
    """Shapes and dtypes of ``init_cache`` leaf for leaf, and a decode
    step from it (float32 cache, a step at position 5)."""
    ref_cfg, rm, rp, model = model_pair(arch, "float32")
    want = rm.init_cache(B, 8, jnp.float32)
    got = model.init_cache(B, 8, torch.float32)
    assert [(tuple(g.shape), str(g.dtype).split(".")[-1]) for g in
            leaves(got)] == [(tuple(w.shape), str(w.dtype))
                             for w in leaves(want)]
    assert [str(g.dtype) for g in leaves(model.init_cache(B, 8))] == \
        [f"torch.{w.dtype}" for w in leaves(rm.init_cache(B, 8))]
    _, decode = batches(ref_cfg, seed=0)
    decode["cache_pos"] = 5
    rl, rc = rm.decode_step(rp, ref_batch(decode), want)
    pl, pc = model.decode_step(decode, got)
    np.testing.assert_allclose(to_np(pl), to_np(rl), **F32_TOL)
    assert_trees_close(pc, rc, F32_TOL)

