"""The port's roofline terms (``repro_torch.analysis.roofline``) with the
H100 SXM's constants, against hand-computed values and the reference's
formula (``repro.analysis.roofline``, TPU constants) at the same inputs:
the same arithmetic, other rates; and ``count_params`` over tensors and
an ``nn.Module``."""
import pytest
import torch

from repro.analysis import roofline as ref_roofline
from repro_torch.analysis import roofline


def test_h100_constants():
    assert roofline.HBM_BW == 3.35e12
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.NVLINK_BW == 450e9
    assert roofline.INT32_OPS == 132 * 64 * 1.98e9
    tpu = {ref_roofline.PEAK_FLOPS, ref_roofline.HBM_BW, ref_roofline.ICI_BW}
    assert not tpu & {roofline.PEAK_FLOPS, roofline.HBM_BW,
                      roofline.NVLINK_BW, roofline.INT32_OPS}


@pytest.mark.parametrize("flops, nbytes, coll, chips, dominant", [
    (989e12 * 4, 1.0, 1.0, 4, "compute"),
    (1.0, 3.35e12 * 8 * 2.0, 1.0, 8, "memory"),
    (1.0, 1.0, 450e9 * 0.5, 2, "collective"),
    (3e15, 7e12, 2e9, 1, "compute"),
])
def test_roofline_terms_by_hand_and_as_the_reference(flops, nbytes, coll,
                                                     chips, dominant):
    t = roofline.roofline_terms(flops, nbytes, coll, chips)
    want = {"compute_s": flops / (chips * 989e12),
            "memory_s": nbytes / (chips * 3.35e12),
            "collective_s": coll / 450e9}
    for key, v in want.items():
        assert t[key] == pytest.approx(v, rel=1e-12)
    assert t["dominant"] == dominant and t["bound_s"] == t[f"{dominant}_s"]
    # the reference's formula at the same inputs, its rates swapped in
    ref = ref_roofline.roofline_terms(flops, nbytes, coll, chips)
    scale = {"compute_s": ref_roofline.PEAK_FLOPS / 989e12,
             "memory_s": ref_roofline.HBM_BW / 3.35e12,
             "collective_s": ref_roofline.ICI_BW / 450e9}
    for key, s in scale.items():
        assert t[key] == pytest.approx(ref[key] * s, rel=1e-12)


def test_model_flops_and_useful_fraction_equal_the_reference():
    for n, tok, train in ((1e9, 1e6, True), (7e9, 2048, False)):
        assert roofline.model_flops(n, tok, train) == \
            ref_roofline.model_flops(n, tok, train)
    assert roofline.useful_fraction(3.0, 4.0) == 0.75 == \
        ref_roofline.useful_fraction(3.0, 4.0)
    assert roofline.useful_fraction(3.0, 0.0) == 0.0


def test_count_params():
    mod = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.ReLU(),
                              torch.nn.Linear(3, 2, bias=False))
    assert roofline.count_params(mod) == 4 * 3 + 3 + 3 * 2
    tree = {"a": torch.zeros(2, 5), "b": [torch.ones(7), (torch.ones(1, 1),)],
            "step": 3}
    assert roofline.count_params(tree) == 10 + 7 + 1
    assert roofline.count_params(torch.zeros(4, 4)) == 16
