"""xLSTM-125M [arXiv:2405.04517]. mLSTM blocks with an sLSTM block every
8th layer (xLSTM[7:1]); d_ff=0 — projections live inside the blocks."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8,
)
