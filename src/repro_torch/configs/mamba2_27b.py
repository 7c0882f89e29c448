"""Mamba2-2.7B (copy of ``repro/configs/mamba2_27b.py``): attention-free
SSD LM [arXiv:2405.21060].

64 layers, d_model 2560, state 128, head dim 64 (80 heads at expand 2),
one B/C group, conv width 4, SSD chunk 256, vocab 50280; no attention and
no MLP (the Mamba-2 mixer is the whole block), RMSNorm, tied embeddings.
``n_heads``, ``n_kv``, ``d_ff`` and ``mlp`` are unused.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=1,
    n_kv=1,
    d_ff=0,
    vocab=50280,
    mlp="swiglu",
    norm="rms",
    rope="none",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, conv_width=4, chunk=256),
    source="arXiv:2405.21060; unverified",
)
