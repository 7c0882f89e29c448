"""Qwen1.5-110B (copy of ``repro/configs/qwen15_110b.py``): dense GQA LM
with QKV biases [hf:Qwen/Qwen1.5-110B].

80 layers, d_model 8192, 64 query heads over 8 KV heads of 128 (GQA),
d_ff 49152, vocab 152064; SwiGLU, RMSNorm, RoPE (theta 1e6), q/k/v
biases, untied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=49152,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    mlp="swiglu",
    norm="rms",
    rope="rope",
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-110B; hf",
)
