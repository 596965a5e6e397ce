"""The port's oracles (``repro_torch.core.oracle``) against the
reference's: the DP table, the optimal traceback with its tie order
(=, X, D, I), the CIGAR string, the distance and the validator."""
import numpy as np
import pytest

from repro.core import oracle as ref
from repro_torch.core import oracle as port
from tests._hyp import given, settings, st

seq = st.lists(st.integers(0, 3), min_size=0, max_size=40)


@given(seq, seq)
@settings(max_examples=60, deadline=None)
def test_oracles_equal_reference(p, t):
    p, t = np.array(p, np.uint8), np.array(t, np.uint8)
    np.testing.assert_array_equal(port.dp_table(p, t), ref.dp_table(p, t))
    dist, ops = port.dp_traceback(p, t)
    assert (dist, ops) == ref.dp_traceback(p, t)
    assert dist == port.levenshtein(p, t) == ref.levenshtein(p, t)
    assert port.ops_to_cigar_string(ops) == ref.ops_to_cigar_string(ops)
    port.validate_cigar(p, t, ops, dist)


def test_traceback_tie_order_and_cigar_strings():
    """Equal-cost paths resolve =, then X, then D, then I, as GenASM's
    tracebacks do; runs encode front-first."""
    cases = [([0, 1], [1, 0]), ([0, 0, 0], [0, 0]), ([2], [3, 2]),
             ([1, 2, 3], []), ([], [3, 3])]
    for p, t in cases:
        p, t = np.array(p, np.uint8), np.array(t, np.uint8)
        assert port.dp_traceback(p, t) == ref.dp_traceback(p, t)
    assert port.ops_to_cigar_string([0, 0, 1, 3, 3, 2, 0]) == \
        ref.ops_to_cigar_string([0, 0, 1, 3, 3, 2, 0]) == "2=1X2D1I1="
    assert port.ops_to_cigar_string([]) == ref.ops_to_cigar_string([]) == ""


@pytest.mark.parametrize("ops,dist", [([0, 0, 1], 1), ([0, 0], None),
                                      ([0, 2, 3, 1], 3)])
def test_validate_cigar_refuses_what_the_reference_refuses(ops, dist):
    p, t = np.array([0, 1, 2], np.uint8), np.array([0, 1, 3], np.uint8)
    outcomes = []
    for mod in (ref, port):
        try:
            mod.validate_cigar(p, t, ops, dist)
            outcomes.append(True)
        except AssertionError:
            outcomes.append(False)
    assert outcomes[0] == outcomes[1]
