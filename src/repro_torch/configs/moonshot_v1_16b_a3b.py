"""kimi/moonlight 16B-A3B MoE. [hf:moonshotai/Moonlight-16B-A3B; hf]

48L d_model=2048 16H (GQA kv=16 == MHA) per-expert d_ff=1408 vocab=163840,
MoE 64 experts top-6.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=163840,
    head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, period=1),
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)
