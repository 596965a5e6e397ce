"""The aligner's W = 128 ladder k = 15 -> 30 -> 60 -> 120 (O = 42,
``rescue_rounds=3``), whose last rung runs at the level capacity KP =
128, against the reference: one read carries a 64-base insertion that
only k = 120 aligns (``rounds_run == 4``).  The reference runs its jnp
backend (its Pallas kernels at k = 120 take minutes in interpret mode; its
own tests hold the two equal) in a subprocess whose XLA skips its
``fusion`` pass (``test_torch_kp128.run_reference``), beside the port's
CPU ladder (``test_torch_w256_ladder.assert_ladder_equals_reference``)."""
import numpy as np

from repro_torch.data.genome import ReadSimConfig, simulate_reads, synth_genome
from tests.test_torch_config import cfg_pair
from tests.test_torch_kp128 import few_torch_threads  # noqa: F401
from tests.test_torch_w256_ladder import (assert_ladder_equals_reference,
                                          ladder_reference)

ROUNDS = 3


def _pairs():
    """3 reads of 250 bp; read 1 with a 64-base insertion."""
    rs = simulate_reads(synth_genome(200_000, seed=7), 3,
                        ReadSimConfig(read_len=250, seed=10))
    reads, refs = list(rs.reads), list(rs.ref_segments)
    burst = np.random.default_rng(5).integers(0, 4, 64).astype(np.uint8)
    mid = len(reads[1]) // 2
    reads[1] = np.concatenate([reads[1][:mid], burst, reads[1][mid:]])
    return reads, refs


def _cfgs():
    return cfg_pair(W=128, O=42, k=15, backend="jnp", lane_tile=4)


def reference_ladder(out: str) -> None:
    """``ladder_reference`` of this module's pairs and configuration."""
    ladder_reference(out, *_pairs(), _cfgs()[0], ROUNDS)


def test_w128_ladder_to_k120_equals_reference(tmp_path):
    assert_ladder_equals_reference(
        "tests.test_torch_kp128_ladder.reference_ladder",
        tmp_path / "ref.npz", *_pairs(), _cfgs()[1], ROUNDS, 1, 120)
