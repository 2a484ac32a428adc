"""xLSTM 1.3B — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

48L d_model=2048 4H (kv=4) d_ff=0 vocab=50304. Matrix-memory mLSTM blocks
with one sLSTM block every 8 layers (the assignment lists both kinds).
No KV cache: decode state is O(1) in context -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,                       # xLSTM blocks carry their own projections
    vocab_size=50304,
    head_dim=512,                 # 2048 / 4
    ssm=SSMConfig(kind="mlstm", chunk_size=128, slstm_period=8),
    source="[arXiv:2405.04517; unverified]",
)
