"""OLMoE-1B-7B [arXiv:2409.02060]. 64 experts top-8, MHA (kv=16)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, norm_topk_prob=False, router_aux_coef=0.01,
)
