"""The LM scaffold in bfloat16, the port against the reference: the
train-mode, prefill and decode logits of every architecture at
``tiny_config`` (the models and batches of ``tests/test_torch_lm.py``).

The reference runs op by op here (``jax.disable_jit()``): each ``jnp`` op
rounds its result to bfloat16, as each PyTorch op does, and the port
takes the reference's ops one for one (``jax.nn.silu`` as
``x * (1 / (1 + exp(-x)))``, Python scalars rounded to bfloat16 first),
so the two agree to a bfloat16 step or two.  Compiled, XLA fuses the
layer body of the reference's ``lax.scan`` and rounds differently: for
zamba2 that alone moves the reference's logits by 0.14 against its own
op-by-op run, more than the JAX tests' 0.08
(``tests/test_models_semantics.py``), so the compiled reference cannot
be the yardstick here.

Tolerance: rtol = atol = 0.02, under the 0.08 ceiling: logits here are
below 5, where a bfloat16 step is 0.0156 at most (measured: 0.0176 at
most, zamba2; most architectures equal).
"""
import jax
import numpy as np
import pytest
import torch

from repro_torch.models import registry
from repro_torch.serve.kvcache import pad_cache
from repro.serve.kvcache import pad_cache as ref_pad_cache
from tests.test_torch_lm import (NEW, S, batches, model_pair, ref_batch,
                                 to_np)

BF16_TOL = dict(rtol=0.02, atol=0.02)
#: zamba2 and xLSTM (their SSD / recurrent scans, op by op, are the
#: slowest references) run in tests/test_torch_lm_bf16_ssm.py
ATTN_ARCHS = tuple(a for a in registry.ARCH_IDS
                   if a not in ("zamba2-2.7b", "xlstm-125m"))


def bf16_logits(arch: str):
    """(reference, port) logits of the train-mode forward, prefill and a
    decode step after ``pad_cache``, in bfloat16."""
    ref_cfg, rm, rp, model = model_pair(arch, "bfloat16")
    prefill, decode = batches(ref_cfg, seed=registry.ARCH_IDS.index(arch))
    out = {}
    with jax.disable_jit(), torch.no_grad():
        out["train"] = (rm.forward(rp, ref_batch(prefill), mode="train")[0],
                        model(prefill, mode="train")[0])
        rl, rc = rm.prefill(rp, ref_batch(prefill))
        pl, pc = model.prefill(prefill)
        out["prefill"] = (rl, pl)
        rl, _ = rm.decode_step(rp, ref_batch(decode),
                               ref_pad_cache(rc, S + NEW))
        pl, _ = model.decode_step(decode, pad_cache(pc, S + NEW))
        out["decode"] = (rl, pl)
    return out


def check_bf16(arch: str):
    for what, (want, got) in bf16_logits(arch).items():
        assert got.dtype == torch.bfloat16, what
        assert tuple(got.shape) == tuple(want.shape), what
        np.testing.assert_allclose(to_np(got), to_np(want), **BF16_TOL,
                                   err_msg=what)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_bf16_logits_equal_the_reference(arch):
    check_bf16(arch)
