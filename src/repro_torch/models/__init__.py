"""The language-model scaffold of the port (of ``repro.models``): one
``ModelConfig`` for ten architectures, their ``nn.Module`` forwards in the
``train`` / ``prefill`` / ``decode`` modes, and the registry that builds
them (``registry.get_model``)."""
