"""The paper's comparison baselines (port of ``repro.baselines``): an
Edlib-like Myers bit-parallel edit distance (``myers``) and a KSW2-like
banded affine-gap DP (``dp``).  The reference writes both in ``jnp`` and
numpy, outside any Pallas kernel, so they port as PyTorch functions that
run on the device of the tensors they are given, with numpy tracebacks."""
