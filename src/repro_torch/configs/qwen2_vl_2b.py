"""Qwen2-VL-2B [arXiv:2409.12191]. M-RoPE (t/h/w sections); the vision
frontend is a stub per the assignment — input_specs supplies pre-merged
embeddings and 3D rotary position ids."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
    d_ff=8960, vocab=151936,
    qkv_bias=True, mrope_sections=(16, 24, 24),
)
