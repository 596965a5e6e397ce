"""The bfloat16 logits of the two state-space architectures (zamba2's
Mamba2 backbone and xLSTM), the port against the reference run op by op:
the check and tolerance of ``tests/test_torch_lm_bf16.py``, in a file of
their own because their references are the slowest op by op."""
import pytest

from tests.test_torch_lm_bf16 import check_bf16


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_bf16_logits_equal_the_reference(arch):
    check_bf16(arch)
