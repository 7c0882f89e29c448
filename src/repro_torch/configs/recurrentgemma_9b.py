"""RecurrentGemma-9B (copy of ``repro/configs/recurrentgemma_9b.py``):
Griffin hybrid [arXiv:2402.19427].

38 layers with the pattern (RG-LRU, RG-LRU, local attention): 12 full
periods and 2 trailing recurrent layers; d_model 4096, 16 query heads over
one KV head of 256 (MQA), d_ff 12288, vocab 256000, local attention window
2048, lru_width 4096; GeLU MLP, RMSNorm, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    mlp="gelu",
    norm="rms",
    rope="rope",
    rope_theta=1e4,
    local_window=2048,
    tie_embeddings=True,
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    layer_pattern=("rec", "rec", "attn"),
    source="arXiv:2402.19427; unverified",
)
