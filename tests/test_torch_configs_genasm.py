"""The paper's configuration in the port (``repro_torch.configs.genasm``)
against the reference's (``repro.configs.genasm``): field for field the
converted reference config (``convert.config_from_reference``), with one
difference named: ``backend``.  The reference leaves it at ``'jnp'`` (the
port's ``'plain'``); the port's ``CONFIG`` runs its default ``'fused'``,
and ``BASELINE``'s unimproved ``'edges4'`` store runs only on
``'plain'``.  Both align a corpus as the reference's configs do."""
import dataclasses

import pytest

from repro.configs import genasm as ref_genasm
from repro.core.aligner import GenASMAligner as RefAligner
from repro_torch.configs import genasm
from repro_torch.convert import config_from_reference
from repro_torch.core.aligner import GenASMAligner
from repro_torch.core.config import AlignerConfig
from tests.test_torch_aligner import assert_results_equal


@pytest.mark.parametrize("name, backend", [("CONFIG", "fused"),
                                           ("BASELINE", "plain")])
def test_configs_equal_the_converted_reference(name, backend):
    ref = getattr(ref_genasm, name)
    port = getattr(genasm, name)
    assert isinstance(port, AlignerConfig)
    assert ref.backend == "jnp" and port.backend == backend
    converted = config_from_reference(dataclasses.asdict(ref))
    assert converted.backend == "plain"
    assert dataclasses.replace(converted, backend=backend) == port
    diff = {f.name for f in dataclasses.fields(port)
            if getattr(port, f.name) != getattr(converted, f.name)}
    assert diff == ({"backend"} if backend != "plain" else set())


def test_baseline_runs_only_on_plain():
    with pytest.raises(ValueError, match="store='band'"):
        dataclasses.replace(genasm.BASELINE, backend="fused")


@pytest.mark.parametrize("name", ["CONFIG", "BASELINE"])
def test_configs_align_as_the_reference(corpus, name):
    reads, refs, _ = corpus
    reads, refs = reads[:8], refs[:8]
    ref = RefAligner(getattr(ref_genasm, name), rescue_rounds=1).align(
        reads, refs)
    port = GenASMAligner(getattr(genasm, name), rescue_rounds=1,
                         device="cpu").align(reads, refs)
    assert_results_equal(port, ref)
