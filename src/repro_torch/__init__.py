"""PyTorch + CUDA port of the improved GenASM aligner.

``repro_torch.core.aligner.GenASMAligner`` aligns batches of (read,
ref-segment) pairs on an NVIDIA GPU through three hand-written CUDA
kernels (``repro_torch.kernels``), or on the CPU through their plain
PyTorch versions when the caller passes ``device="cpu"``.  The JAX package
``repro`` is the reference it is held against; this package imports
nothing of it, nor JAX.
"""
