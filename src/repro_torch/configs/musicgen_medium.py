"""MusicGen-medium [arXiv:2306.05284]. Decoder-only over EnCodec tokens;
4 codebooks (delay pattern is a data-pipeline concern; the EnCodec frontend
is a stub — input_specs supplies summed frame embeddings)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    n_codebooks=4, act="gelu",
)
