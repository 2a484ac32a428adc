from repro_torch.kernels.paged_attention.ops import (
    paged_decode_attention, paged_prefill_attention,
)
