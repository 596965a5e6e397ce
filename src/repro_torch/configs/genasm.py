"""The paper's own configuration (port of ``repro/configs/genasm.py``):
GenASM's window geometry with the paper's improvements, and the
unimproved baseline.

Field for field both equal ``convert.config_from_reference`` of the
reference's values, but for ``backend``: the reference leaves it at its
default ``'jnp'`` (the port's ``'plain'``); ``CONFIG`` takes the port's
default ``'fused'`` (the CUDA kernels K1, K2, K4), while ``BASELINE``'s
store ``'edges4'`` runs only on ``'plain'``, which it names.
"""
from ..core.config import AlignerConfig

CONFIG = AlignerConfig(W=64, O=24, k=12, store="band", early_term=True)

# unimproved baseline (GenASM as in MICRO'20: 4 edge bitvectors, no ET)
BASELINE = AlignerConfig(W=64, O=24, k=12, store="edges4", early_term=False,
                         backend="plain")
