"""Minitron-4B (copy of ``repro/configs/minitron_4b.py``): pruned-Nemotron
dense LM [arXiv:2407.14679].

32 layers, d_model 3072, 24 query heads over 8 KV heads of 128 (GQA),
d_ff 9216, vocab 256000; GeLU MLP (Nemotron's squared ReLU is the
reference's recorded deviation), LayerNorm, RoPE, untied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv=8,
    d_ff=9216,
    vocab=256000,
    head_dim=128,
    mlp="gelu",
    norm="ln",
    rope="rope",
    rope_theta=1e4,
    source="arXiv:2407.14679; hf",
)
