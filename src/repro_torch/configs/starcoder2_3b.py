"""StarCoder2-3B (copy of ``repro/configs/starcoder2_3b.py``): dense GQA code
LM [arXiv:2402.19173].

30 layers, d_model 3072, 24 query heads over 2 KV heads of 128 (GQA),
d_ff 12288, vocab 49152; q/k/v/o biases, GeLU MLP, LayerNorm, RoPE (theta
1e5), untied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv=2,
    d_ff=12288,
    vocab=49152,
    head_dim=128,
    qkv_bias=True,
    o_bias=True,
    mlp="gelu",
    norm="ln",
    rope="rope",
    rope_theta=1e5,
    source="arXiv:2402.19173; hf",
)
