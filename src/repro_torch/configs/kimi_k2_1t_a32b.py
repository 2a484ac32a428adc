"""Kimi K2 — trillion-param MoE. [arXiv:2501.kimi2; unverified]

61L d_model=7168 64H (GQA kv=8) per-expert d_ff=2048 vocab=163840,
MoE 384 experts top-8 (all layers MoE per the assignment table).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    d_ff=0,                       # every layer is MoE
    vocab_size=163840,
    head_dim=112,                 # 7168 / 64
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048, period=1),
    source="[arXiv:2501.kimi2; unverified]",
)
