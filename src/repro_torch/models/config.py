"""Unified model configuration covering all ten assigned architectures
(port of ``repro/models/config.py``; the same fields and defaults, so
``convert.model_config_from_reference`` passes every field as it is)."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0               # 0 -> d_model // n_heads

    # attention options
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0       # 0 = none; >0 window size
    local_global_every: int = 0   # gemma2: layer i is global iff i % 2 == 1
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE half-dim split
    post_block_norm: bool = False # gemma2 sandwich norms
    scale_embed: bool = False     # gemma2 sqrt(d) embedding scale

    # granite depth-scaled multipliers
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    attention_multiplier: float = 0.0      # 0 -> 1/sqrt(d_head)
    logits_scaling: float = 1.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    router_aux_coef: float = 0.0

    # SSM / hybrid (zamba2, xlstm)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    shared_attn_every: int = 0    # zamba2: shared attention block cadence
    slstm_every: int = 0          # xlstm: every Nth block is sLSTM

    # audio (musicgen)
    n_codebooks: int = 0

    act: str = "silu"             # silu | gelu
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # training-time knobs of the reference: remat recomputes each layer's
    # activations in the backward pass (torch.utils.checkpoint); the
    # port's layers are always a Python loop, so scan_layers is kept only
    # so configs convert field for field
    remat: bool = True
    scan_layers: bool = True

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 256 (the reference's sharding unit); greedy
        decoding reads only the first ``vocab`` columns."""
        return -(-self.vocab // 256) * 256

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def block_kind(self) -> str:
        if self.family in ("ssm",):
            return "xlstm"
        if self.family == "hybrid":
            return "mamba2"
        return "attn"

    def with_layers(self, n: int) -> "ModelConfig":
        return dataclasses.replace(self, n_layers=n)


# architecture families whose sequence mixing is sub-quadratic (long_500k runs)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")
