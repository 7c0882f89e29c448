"""DeepSeek-V2-Lite 16B (copy of ``repro/configs/deepseek_v2_lite_16b.py``):
MLA + fine-grained MoE [arXiv:2405.04434].

27 layers, d_model 2048; MLA with kv_lora 512, RoPE head 64, nope head 128,
16 heads; MoE with 64 routed experts, top-6, 2 shared, expert d_ff 1408;
the first layer uses a dense 10944-wide SwiGLU MLP; RMSNorm; untied
embeddings; vocab 102400.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=10944,  # the dense first layer's MLP width
    vocab=102400,
    mlp="swiglu",
    norm="rms",
    rope="rope",
    rope_theta=1e4,
    mla=MLAConfig(kv_lora=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(
        n_experts=64,
        top_k=6,
        d_ff_expert=1408,
        n_shared=2,
        first_layer_dense=True,
    ),
    source="arXiv:2405.04434; hf",
)
