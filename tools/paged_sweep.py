"""Paged decode and paged prefill over context lengths, on one GPU.

    python3 tools/paged_sweep.py

At llama3-8b's attention shapes (Hq 32, Hkv 8, D 128, page 16, bf16):
decode at batch 8 and prefill of one 256-token chunk, each at several
context lengths, timed by CUDA-graph replay over 8 layers' pools (the
device's time per call, without the host's), beside the least time the
card could take (bound). The slope against the context says what a key
tile costs, the intercept what a launch costs whatever its length. Prints
the card's name and power limit first. Needs a CUDA device; imports
neither JAX nor the JAX package.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402

LAYERS = 8
DECODE_CTX = (16, 128, 528, 1024, 2048, 3072)
PREFILL_START = (0, 256, 768, 1792)      # a 256-token chunk at q_start


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("paged_sweep: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt, hq, hkv, d = torch.bfloat16, cs.HQ, cs.HKV, cs.D
    b, n = 8, 192
    kp, vp = cs._pool(b * n + 1, dt, gen, LAYERS)
    pt = cs._page_table(b, n, b * n + 1, gen)
    q = torch.randn(b, hq, d, generator=gen, device="cuda").to(dt)
    for ctx_len in DECODE_CTX:
        ctx = torch.full((b,), ctx_len, dtype=torch.int32, device="cuda")
        it = iter(range(1 << 30))

        def dec():
            i = next(it) % LAYERS
            return ops.paged_decode_attention(q, kp[i], vp[i], pt, ctx)
        ms = cs.device_ms(dec, LAYERS, 20)
        bms, _ = cs.bound((2 * q.numel() + 2 * ctx_len * b * hkv * d) * 2,
                          4 * hq * d * ctx_len * b)
        print(f"[sweep] paged_decode B={b} N={n} ctx={ctx_len}: {ms:.4f} ms, "
              f"bound {bms:.4f} ms, {bms / ms:.3f} of it", flush=True)
    n = 192
    kp, vp = cs._pool(n + 1, dt, gen, LAYERS)
    pt = cs._page_table(1, n, n + 1, gen)
    q = torch.randn(1, 256, hq, d, generator=gen, device="cuda").to(dt)
    for start in PREFILL_START:
        q_start = torch.tensor([start], dtype=torch.int32, device="cuda")
        ctx = q_start + 256
        it = iter(range(1 << 30))

        def pre():
            i = next(it) % LAYERS
            return ops.paged_prefill_attention(q, kp[i], vp[i], pt, q_start,
                                               ctx)
        ms = cs.device_ms(pre, LAYERS, 20)
        seen = sum(cs.visible(start + i, start + 256, 0) for i in range(256))
        bms, by = cs.bound((2 * q.numel() + 2 * (start + 256) * hkv * d) * 2,
                           4 * hq * d * seen)
        print(f"[sweep] paged_prefill Sq=256 q_start={start} ctx="
              f"{start + 256}: {ms:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"{bms / ms:.3f} of it", flush=True)


if __name__ == "__main__":
    main()
