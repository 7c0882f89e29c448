"""MusicGen-large backbone (copy of ``repro/configs/musicgen_large.py``):
decoder-only over EnCodec tokens [arXiv:2306.05284].

48 layers, d_model 2048, 32 heads of 64 (MHA), d_ff 8192, vocab 2048 (the
EnCodec codebook); GeLU MLP, LayerNorm, untied embeddings.  The EnCodec
frontend is a stub: a batch carries precomputed 512-d frame embeddings
(``audio_stub``) and its labels stay codebook token ids.  RoPE stands in
for MusicGen's sinusoidal positions (the reference's recorded deviation).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=2048,
    head_dim=64,
    mlp="gelu",
    norm="ln",
    rope="rope",
    frontend="audio_stub",
    source="arXiv:2306.05284; hf",
)
