"""Jamba v0.1 52B — Mamba+attention 1:7 interleave, MoE. [arXiv:2403.19887; hf]

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2 on
every other layer. Attention on every 8th layer (1 attn : 7 mamba).
Hybrid -> long_500k runs (only 4 attention layers hold KV; mamba state O(1)).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    attn_period=8,                # layers 7,15,23,31 are attention
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336, period=2),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2, chunk_size=128),
    source="[arXiv:2403.19887; hf]",
)
