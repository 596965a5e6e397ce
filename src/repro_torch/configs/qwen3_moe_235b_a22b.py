"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family; assignment row].
128 experts top-8, GQA kv=4, per-expert FFN 1536."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936,
    n_experts=128, top_k=8, norm_topk_prob=True, router_aux_coef=0.001,
    rope_theta=1_000_000.0,
)
