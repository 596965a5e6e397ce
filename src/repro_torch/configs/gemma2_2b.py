"""Gemma-2 2B [arXiv:2408.00118]. Alternating local(4096)/global attention,
attn/final logit softcaps, sandwich norms, GeGLU, scaled+tied embeddings."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216, vocab=256000,
    sliding_window=4096, local_global_every=2,
    attn_softcap=50.0, final_softcap=30.0,
    post_block_norm=True, scale_embed=True, tie_embeddings=True,
    act="gelu",
)
