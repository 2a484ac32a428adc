"""LLaVA-NeXT 34B — anyres tiling VLM. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
Backbone only: the anyres vision frontend is a STUB — ``input_specs()``
supplies precomputed patch embeddings [B, 2880, d_model]
(4 tiles + 1 base image x 576 patches) concatenated as a prefix.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    num_image_patches=2880,
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
)
