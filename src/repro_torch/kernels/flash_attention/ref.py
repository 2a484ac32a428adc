"""Plain PyTorch version of the flash-attention kernel (chunked online
softmax, shared with the model's CPU execution path)."""
from repro_torch.models.attention_ops import flash_attention as flash_attention_ref

__all__ = ["flash_attention_ref"]
