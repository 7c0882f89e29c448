"""Command R+ 104B (copy of ``repro/configs/command_r_plus_104b.py``)
[hf:CohereForAI/c4ai-command-r-plus].

64 layers, d_model 12288, 96 query heads over 8 KV heads of 128 (GQA),
d_ff 33792, vocab 256000; SwiGLU, LayerNorm, RoPE (theta 7.5e5), no
biases, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=33792,
    vocab=256000,
    head_dim=128,
    mlp="swiglu",
    norm="ln",
    rope="rope",
    rope_theta=75e4,
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-plus; unverified",
)
