"""Whisper Medium — encoder-decoder, conv frontend (stub). [arXiv:2212.04356; unverified]

24L (decoder; + 24 encoder layers) d_model=1024 16H (kv=16 == MHA)
d_ff=4096 vocab=51865. The conv1d+mel frontend is a STUB — ``input_specs()``
supplies precomputed frame embeddings [B, frames, d_model].
Decode cells run the decoder backbone with self-KV = cell seq_len and
cross-KV = 1500 encoder frames (beyond the trained 448-token max; exercised
as a backbone systems cell).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    is_encoder_decoder=True,
    num_encoder_layers=24,
    max_source_len=1500,
    source="[arXiv:2212.04356; unverified]",
)
