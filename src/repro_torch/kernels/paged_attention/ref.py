"""Plain PyTorch versions of the paged attention kernels."""
from repro_torch.models.attention_ops import (
    paged_decode_attention as paged_decode_attention_ref,
    paged_prefill_attention as paged_prefill_attention_ref,
)

__all__ = ["paged_decode_attention_ref", "paged_prefill_attention_ref"]
