"""h2o-danube-3-4b — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, SWA window=4096.
SWA makes decode memory sub-quadratic in context -> long_500k cell runs with a
ring-buffer KV of the window size.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    head_dim=120,                 # 3840 / 32
    sliding_window=4096,
    source="[arXiv:2401.16818; unverified]",
)
