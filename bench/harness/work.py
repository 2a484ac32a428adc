"""The yardstick's arithmetic: the chip's published peaks, a model's
operations per token, and the bytes and operations of the attention
kernels' calls. ``bound`` and ``attention_work`` are copied from
``chip_smoke.py``; the rest counts what a served token needs.

All counts are of the work the inputs need (a product's multiply and add
are two operations; each input byte read once, each output byte written
once), never of what a kernel happens to do: padding, empty batch rows and
capacity slots that hold no token count nothing.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W power limit
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2


def bound(nbytes: float, flops: float) -> float:
    """Seconds: the larger of the bytes over the memory rate and the
    operations over the bf16 tensor-core peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


def visible(qpos: int, kv_limit: int, causal: bool = True) -> int:
    """Keys a query at ``qpos`` sees below ``kv_limit``."""
    return min(kv_limit, qpos + 1) if causal else kv_limit


def attention_work(sq: int, sk: int, hq: int, hkv: int, d: int,
                   causal: bool = True) -> Tuple[float, float]:
    """(bytes, flops) of one bf16 attention call at batch 1: Q, K and V read
    and O written once; Q K^T and P V are 4 d flops per query head and key
    that its query sees."""
    if causal and sq == sk:
        seen = sq * (sq + 1) // 2
    else:
        seen = sum(visible(i, sk, causal) for i in range(sq))
    return (2 * sq * hq * d + 2 * sk * hkv * d) * BF16, 4 * hq * d * seen


def paged_decode_work(ctxs: Iterable[int], hq: int, hkv: int, d: int,
                      page: int) -> Tuple[float, float]:
    """(bytes, flops) of one layer's paged decode call over the real rows
    whose contexts (keys attended, the new one included) are ``ctxs``: each
    row's q read and output written, its keys and values read once, its
    page-table entries read (int32); 4 d flops per query head and key."""
    nbytes = flops = 0
    for c in ctxs:
        nbytes += 2 * hq * d * BF16 + 2 * c * hkv * d * BF16 \
            + -(-c // page) * 4
        flops += 4 * hq * d * c
    return nbytes, flops


class ModelWork:
    """Operations of the served model, from the configuration's ``port``
    widths (what runs)."""

    def __init__(self, port: Dict):
        self.layers = port["num_layers"]
        d, hq, hkv, hd = (port["d_model"], port["num_heads"],
                          port["num_kv_heads"], port["head_dim"])
        self.d, self.hq, self.hkv, self.hd = d, hq, hkv, hd
        self.vocab = port["vocab_size"]
        proj = d * hq * hd * 2 + 2 * d * hkv * hd
        moe = port.get("moe")
        if moe:
            ffn = d * moe["num_experts"] + moe["top_k"] * 3 * d \
                * moe["d_expert"]
        else:
            ffn = 3 * d * port["d_ff"]
        self.matmul_params = proj + ffn     # a layer's, per token

    def token_flops(self, keys: int) -> float:
        """A decoded token that attends over ``keys`` keys: every layer's
        products and attention, and its logits."""
        return self.layers * (2 * self.matmul_params
                              + 4 * self.hq * self.hd * keys) \
            + 2 * self.d * self.vocab

    def prefill_flops(self, s: int) -> float:
        """A prompt of ``s`` tokens, causal, and the last position's
        logits."""
        return self.layers * (2 * self.matmul_params * s
                              + 4 * self.hq * self.hd * s * (s + 1) // 2) \
            + 2 * self.d * self.vocab
