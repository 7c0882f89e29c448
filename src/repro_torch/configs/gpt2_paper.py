"""The paper's GPT-2-style decoder (copy of ``repro/configs/gpt2_paper.py``).

12L, d_model 768, 12 MHA heads of 64, d_ff 3072, GeLU, LayerNorm, RoPE in
place of learned positions, q/k/v/o biases, tied embeddings, vocab 50257
padded to 50304.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gpt2-paper",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv=12,
    d_ff=3072,
    vocab=50304,
    head_dim=64,
    qkv_bias=True,
    o_bias=True,
    mlp="gelu",
    norm="ln",
    rope="rope",
    tie_embeddings=True,
    source="Radford et al. 2019 (paper §6 task 4)",
)
