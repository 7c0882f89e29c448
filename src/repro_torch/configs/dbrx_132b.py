"""DBRX 132B (copy of ``repro/configs/dbrx_132b.py``): fine-grained MoE
[hf:databricks/dbrx-base].

40 layers, d_model 6144, 48 query heads over 8 KV heads of 128 (GQA); 16
experts, top-4, expert d_ff 10752, no shared expert; vocab 100352;
SwiGLU experts, LayerNorm, RoPE (theta 5e5), untied embeddings.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=10752,
    vocab=100352,
    head_dim=128,
    mlp="swiglu",
    norm="ln",
    rope="rope",
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752, n_shared=0),
    source="hf:databricks/dbrx-base; unverified",
)
