"""Qwen2-VL-2B backbone (copy of ``repro/configs/qwen2_vl_2b.py``): VLM with
M-RoPE [arXiv:2409.12191].

28 layers, d_model 1536, 12 query heads over 2 KV heads of 128 (GQA),
d_ff 8960, vocab 151936; SwiGLU, RMSNorm, q/k/v biases, M-RoPE (temporal,
height and width position streams, theta 1e6), tied embeddings.  The ViT
frontend is a stub: a batch carries precomputed patch embeddings
(``vision_stub``, 1176-d = 14 x 14 patch x 2 frames x 3 channels) with
3-D positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    mlp="swiglu",
    norm="rms",
    rope="mrope",
    rope_theta=1e6,
    tie_embeddings=True,
    frontend="vision_stub",
    source="arXiv:2409.12191; hf",
)
