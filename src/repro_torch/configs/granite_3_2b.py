"""Granite-3.0-2B-base [hf:ibm-granite/granite-3.0-2b-base].
GQA kv=8 with depth-scaled (muP-like) multipliers."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab=49155,
    embedding_multiplier=12.0, residual_multiplier=0.22,
    attention_multiplier=0.015625, logits_scaling=8.0,
    tie_embeddings=True,
)
