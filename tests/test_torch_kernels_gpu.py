"""The hand-written CUDA kernels against their plain PyTorch versions on a
CUDA device (skipped elsewhere), at the kernel test cases' shapes plus head
dims that exercise the tensor-core path's padding, the served models'
shapes (danube's head dim 120 with its window, moonshot's MHA, whisper's
encoder and cross-attention, llava's prefix; there also row by row, a
check that a kernel leaving out one key tile fails),
and the
SSD scan at chip_smoke.py's shapes (xLSTM, a ragged T, Mamba widths) plus
the cases of tests/test_ssd_kernel.py; the MoE layer's determinism; and
the training path's pieces on the card: flash's log-sum-exp output, the
gradients of ``FlashAttention`` (kernel forward) and of ``SsdScan`` (kernel
forward, plain recompute) against autograd through the plain versions.
Imports neither JAX nor ``repro``, so it runs on a machine with a card and
no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import ROW_RTOL, row_err  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import attention_ops as plain  # noqa: E402
from repro_torch.models.blocks import ssd_decode_step  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# B, Sq, Sk, Hq, Hkv, D, causal, window (tests/test_kernels.py FLASH_CASES,
# plus head dims 120 and 8; then the serve shapes, head dims 64, 112 and
# 120, Sq and Sk off the 128-row and 128-key tiles, windows that straddle a
# key tile, G = 1, 4 and 8, and head dims 256 and 192)
FLASH = [(2, 64, 64, 4, 2, 32, True, 0), (1, 128, 128, 8, 8, 64, True, 0),
         (2, 60, 60, 4, 1, 32, True, 0), (2, 64, 64, 4, 2, 32, False, 0),
         (2, 64, 64, 4, 2, 32, True, 24), (1, 32, 32, 2, 2, 128, True, 0),
         (1, 200, 200, 8, 2, 120, True, 0), (1, 70, 70, 4, 4, 8, False, 0),
         (1, 512, 512, 32, 8, 128, True, 0),
         (1, 2048, 2048, 32, 8, 128, True, 0),
         (2, 300, 300, 8, 2, 64, True, 0), (1, 333, 333, 4, 1, 112, False, 0),
         (2, 257, 257, 4, 4, 120, True, 0),
         (1, 130, 250, 4, 2, 128, False, 0), (2, 250, 130, 8, 1, 64, True, 0),
         (1, 400, 400, 8, 2, 128, True, 100),
         (1, 300, 300, 4, 4, 64, False, 70),
         (1, 256, 256, 16, 2, 128, True, 0),
         (1, 90, 200, 2, 1, 256, True, 0), (1, 100, 100, 4, 2, 192, False, 0)]
# B, Hq, Hkv, D, P, page, N, window (PAGED_CASES, plus D 120)
PAGED = [(2, 4, 2, 32, 16, 8, 4, 0), (3, 8, 8, 64, 32, 16, 6, 0),
         (2, 8, 1, 32, 16, 8, 4, 0), (2, 4, 2, 32, 16, 8, 4, 20),
         (1, 16, 4, 128, 8, 4, 2, 0), (3, 8, 2, 120, 40, 16, 12, 0)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run on the card only)")
    return torch.device("cuda")


def _randn(rng, shape, dt, dev):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev).to(dt)


def _paged(rng, case, dt, dev):
    B, Hq, Hkv, D, P, page, N, _ = case
    q = _randn(rng, (B, Hq, D), dt, dev)
    kp = _randn(rng, (P, page, Hkv, D), dt, dev)
    vp = _randn(rng, (P, page, Hkv, D), dt, dev)
    pt = torch.from_numpy(rng.permutation(P)[:B * N].reshape(B, N)
                          .astype(np.int32)).to(dev)
    ctx = torch.tensor([(N * page - 3) % (N * page) + 1, page + 1, 1][:B],
                       dtype=torch.int32, device=dev)
    return q, kp, vp, pt, ctx


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_decode_kernel_matches_plain(cuda, dt):
    rng = np.random.default_rng(0)
    kernels.reset_launch_counts()
    for case in PAGED:
        args = _paged(rng, case, dt, cuda)
        out = paged_ops.paged_decode_attention(*args, window=case[-1])
        ref = plain.paged_decode_attention(*args, window=case[-1])
        assert _err(out, ref) < TOL[dt], case
    assert kernels.launch_counts()["paged_decode_attention"] == len(PAGED)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_prefill_kernel_matches_plain(cuda, dt):
    rng = np.random.default_rng(1)
    kernels.reset_launch_counts()
    for case in PAGED:
        B, Hq, Hkv, D, P, page, N, window = case
        _, kp, vp, pt, _ = _paged(rng, case, dt, cuda)
        sq = min(70, N * page // 2)
        q = _randn(rng, (B, sq, Hq, D), dt, cuda)
        start = torch.tensor([N * page - sq, 0, 3][:B], dtype=torch.int32,
                             device=cuda)
        ctx = start + sq
        for w in {window, 5}:
            out = paged_ops.paged_prefill_attention(q, kp, vp, pt, start, ctx,
                                                    window=w)
            ref = plain.paged_prefill_attention(q, kp, vp, pt, start, ctx,
                                                window=w)
            assert _err(out, ref) < TOL[dt], (case, w)
    assert kernels.launch_counts()["paged_prefill_attention"] > len(PAGED)


def _decode_case(rng, dt, dev, b, n, ctx, page=16, hq=32, hkv=8, d=128):
    """Serve-shaped paged decode inputs: b sequences of n pages each in a
    pool of b * n + 1 pages, context lengths ``ctx``."""
    q = _randn(rng, (b, hq, d), dt, dev)
    kp = _randn(rng, (b * n + 1, page, hkv, d), dt, dev)
    vp = _randn(rng, (b * n + 1, page, hkv, d), dt, dev)
    pt = torch.from_numpy(rng.permutation(b * n + 1)[:b * n].reshape(b, n)
                          .astype(np.int32)).to(dev)
    return q, kp, vp, pt, torch.tensor(ctx, dtype=torch.int32, device=dev)


# (b, n, context lengths, window): the serve shape at ctx 528 and 2048 (5
# and 12 splits of 128 and 256 keys); contexts that end inside a split, on
# a split's last key and on its first; a window that skips whole splits
DECODE_SERVE = [(8, 40, [528] * 8, 0), (8, 192, [2048] * 8, 0),
                (8, 40, [1, 100, 129, 255, 300, 333, 500, 640], 0),
                (8, 40, [128, 256, 384, 512, 127, 257, 383, 513], 0),
                (4, 192, [2048, 3072, 1500, 700], 300)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_SERVE)
def test_paged_decode_splits_match_plain(cuda, dt, case):
    from repro_torch.kernels.paged_attention.kernel import decode_split_plan
    b, n, ctx, window = case
    assert decode_split_plan(b, 8, n, 16, 128)[0] > 1
    args = _decode_case(np.random.default_rng(7), dt, cuda, b, n, ctx)
    out = paged_ops.paged_decode_attention(*args, window=window)
    ref = plain.paged_decode_attention(*args, window=window)
    assert out.dtype == dt and out.shape == ref.shape
    assert _err(out, ref) < TOL[dt], case


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_paged_decode_row_without_keys_is_zero(cuda, dt):
    """ctx = 0: the kernel returns 0, as the Pallas kernel does; the plain
    version returns the mean of V there (ROADMAP queue 3), so that row is
    compared with 0 and the others with the plain version."""
    args = _decode_case(np.random.default_rng(8), dt, cuda, 4, 40,
                        [0, 528, 0, 17])
    out = paged_ops.paged_decode_attention(*args)
    ref = plain.paged_decode_attention(*args)
    assert torch.equal(out[0::2], torch.zeros_like(out[0::2]))
    assert _err(out[1::2], ref[1::2]) < TOL[dt]


@pytest.mark.gpu
def test_paged_decode_is_bitwise_reproducible(cuda):
    args = _decode_case(np.random.default_rng(9), torch.bfloat16, cuda, 8,
                        192, [2048, 17, 700, 3000, 1, 129, 2500, 1024])
    a = paged_ops.paged_decode_attention(*args, window=1000)
    b = paged_ops.paged_decode_attention(*args, window=1000)
    assert torch.equal(a, b)


# prefill: (Sq, Hq, Hkv, page): chunks off the 64-row tile with G = 1, 2
# and 8 at pages 4 and 8 (cp.async loads) and 16 (TMA page boxes)
PREFILL_ODD = [(70, 4, 4, 4), (70, 4, 4, 8), (70, 4, 4, 16), (37, 8, 4, 4),
               (37, 8, 4, 8), (37, 8, 4, 16), (100, 16, 2, 4),
               (100, 16, 2, 8), (100, 16, 2, 16), (1, 8, 1, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PREFILL_ODD)
def test_paged_prefill_group_sizes_match_plain(cuda, dt, case):
    sq, hq, hkv, page = case
    rng = np.random.default_rng(10)
    b, d, n = 2, 128, 64
    kp = _randn(rng, (b * n + 1, page, hkv, d), dt, cuda)
    vp = _randn(rng, (b * n + 1, page, hkv, d), dt, cuda)
    pt = torch.from_numpy(rng.permutation(b * n + 1)[:b * n].reshape(b, n)
                          .astype(np.int32)).to(cuda)
    q = _randn(rng, (b, sq, hq, d), dt, cuda)
    start = torch.tensor([n * page - sq, 5], dtype=torch.int32, device=cuda)
    ctx = start + sq
    for window in (0, 50):
        out = paged_ops.paged_prefill_attention(q, kp, vp, pt, start, ctx,
                                                window=window)
        ref = plain.paged_prefill_attention(q, kp, vp, pt, start, ctx,
                                            window=window)
        assert _err(out, ref) < TOL[dt], (case, window)


@pytest.mark.gpu
@pytest.mark.parametrize("page", [8, 16])
def test_paged_kernels_ignore_stale_slots_past_the_context(cuda, page):
    """Slots at or past a sequence's context may hold what a freed page
    left: with NaN there, both kernels return what they return with zeros
    there (page 8: cp.async loads; page 16: TMA page boxes)."""
    rng = np.random.default_rng(11)
    dt, b, n, hq, hkv, d, sq = torch.bfloat16, 2, 24, 32, 8, 128, 32
    kp = _randn(rng, (b * n + 1, page, hkv, d), dt, cuda)
    vp = _randn(rng, (b * n + 1, page, hkv, d), dt, cuda)
    pt = torch.from_numpy(rng.permutation(b * n + 1)[:b * n].reshape(b, n)
                          .astype(np.int32)).to(cuda)
    ctx = [n * page - 5, 9 * page + 3]          # both end inside a page
    stale_k, stale_v = kp.clone(), vp.clone()
    for i, c in enumerate(ctx):
        for j in range(n):
            lo = max(0, c - j * page)
            if lo < page:
                p = int(pt[i, j])
                stale_k[p, lo:], stale_v[p, lo:] = float("nan"), float("nan")
                kp[p, lo:], vp[p, lo:] = 0, 0
    ctx_t = torch.tensor(ctx, dtype=torch.int32, device=cuda)
    q = _randn(rng, (b, hq, d), dt, cuda)
    out = paged_ops.paged_decode_attention(q, stale_k, stale_v, pt, ctx_t)
    ref = plain.paged_decode_attention(q, kp, vp, pt, ctx_t)
    assert torch.isfinite(out).all() and _err(out, ref) < TOL[dt]
    q = _randn(rng, (b, sq, hq, d), dt, cuda)
    start = ctx_t - sq
    out = paged_ops.paged_prefill_attention(q, stale_k, stale_v, pt, start,
                                            ctx_t)
    ref = plain.paged_prefill_attention(q, kp, vp, pt, start, ctx_t)
    assert torch.isfinite(out).all() and _err(out, ref) < TOL[dt]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, dt):
    rng = np.random.default_rng(2)
    kernels.reset_launch_counts()
    for B, Sq, Sk, Hq, Hkv, D, causal, window in FLASH:
        q = _randn(rng, (B, Sq, Hq, D), dt, cuda)
        k = _randn(rng, (B, Sk, Hkv, D), dt, cuda)
        v = _randn(rng, (B, Sk, Hkv, D), dt, cuda)
        out = flash_ops.flash_attention(q, k, v, causal=causal, window=window)
        ref = plain.flash_attention(q, k, v, causal=causal, window=window)
        assert out.dtype == dt and out.shape == q.shape
        assert _err(out, ref) < TOL[dt], (B, Sq, D, causal, window)
    assert kernels.launch_counts()["flash_attention"] == len(FLASH)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_kernel_row_without_keys_is_zero(cuda, dt):
    """Causal with a window and Sk < Sq: rows i >= Sk + window - 1 see no
    key and return 0 (acc / max(l, 1e-30) over no key). The plain version
    masks with a finite -1e30, as the JAX reference does, and returns the
    mean of V there instead, so this case is not compared with it."""
    rng = np.random.default_rng(6)
    q = _randn(rng, (1, 300, 4, 128), dt, cuda)
    k = _randn(rng, (1, 100, 2, 128), dt, cuda)
    v = _randn(rng, (1, 100, 2, 128), dt, cuda)
    out = flash_ops.flash_attention(q, k, v, causal=True, window=50)
    assert torch.equal(out[:, 149:], torch.zeros_like(out[:, 149:]))
    assert out[:, :149].abs().amax() > 0


# (Hq, Hkv, D, window): danube (head dim 120, with and without its 4096-token
# window) and moonshot (MHA: Hq = Hkv = 16, G = 1)
SERVED = [(32, 8, 120, 0), (32, 8, 120, 4096), (16, 16, 128, 0)]


def _served_calls(rng, dt, dev, case):
    """(name, keys, call(window)) of flash over a 4608-token prompt, paged
    decode past the window and paged prefill chunks past it, each at the
    served shape ``case``; ``keys`` is the longest row's key count."""
    hq, hkv, d, _ = case
    s, page, n, b = 4608, 16, 296, 3
    q = _randn(rng, (1, s, hq, d), dt, dev)
    k = _randn(rng, (1, s, hkv, d), dt, dev)
    v = _randn(rng, (1, s, hkv, d), dt, dev)
    qd, kp, vp, pt, _ = _decode_case(rng, dt, dev, b, n, [0] * b, page,
                                     hq, hkv, d)
    ctx = torch.tensor([4609, 4736, 4097], dtype=torch.int32, device=dev)
    qp = _randn(rng, (b, 200, hq, d), dt, dev)
    start = torch.tensor([4400, 4000, 0], dtype=torch.int32, device=dev)
    pre = (qp, kp, vp, pt, start, start + 200)
    return [("flash", s, lambda ops, w: ops.flash_attention(q, k, v,
                                                            window=w)),
            ("decode", 4736, lambda ops, w: ops.paged_decode_attention(
                qd, kp, vp, pt, ctx, window=w)),
            ("prefill", 4600, lambda ops, w: ops.paged_prefill_attention(
                *pre, window=w))]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SERVED, ids=["d120", "d120_window",
                                              "mha"])
def test_kernels_at_the_served_models_shapes(cuda, dt, case):
    """Flash over a 4608-token prompt, paged decode past the window and a
    paged prefill chunk past it, against their plain versions: within TOL
    and, row by row, within ROW_RTOL of the row's largest value (an output
    row over ~4096 keys is ~0.03, smaller than TOL's bf16 limit)."""
    window = case[3]
    for name, _, call in _served_calls(np.random.default_rng(11), dt, cuda,
                                       case):
        out = call(flash_ops if name == "flash" else paged_ops, window)
        ref = call(plain, window)
        assert _err(out, ref) < TOL[dt], name
        assert row_err(out, ref) < ROW_RTOL[dt], name


@pytest.mark.gpu
@pytest.mark.parametrize("case", SERVED, ids=["d120", "d120_window",
                                              "mha"])
def test_served_shape_check_sees_a_one_tile_fault(cuda, case):
    """The kernels run with the window edge one 64-key tile off (the
    longest row leaves out its first tile), held against the plain version
    at the right window, fail the row check at the served shapes."""
    dt = torch.bfloat16
    window = case[3]
    for name, keys, call in _served_calls(np.random.default_rng(11), dt,
                                          cuda, case):
        fault = call(flash_ops if name == "flash" else paged_ops,
                     (window or keys) - 64)
        assert row_err(fault, call(plain, window)) > ROW_RTOL[dt], name


# B, Sq, Sk, Hq, Hkv, D, causal: chip_smoke.FLASH_SHAPES with fewer heads
# (whisper's bidirectional encoder over 1500 frames, its cross-attention of
# 448 decoder rows against 1500, llava's causal GQA prefill of 2880 patch
# rows and 512 tokens at G = 7)
FLASH_SERVED = [(2, 1500, 1500, 4, 4, 64, False),
                (2, 448, 1500, 4, 4, 64, False),
                (1, 3392, 3392, 14, 2, 128, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_SERVED, ids=[
    "whisper_encoder", "whisper_cross", "llava_prefix"])
def test_flash_at_the_enc_dec_and_vlm_shapes(cuda, dt, case):
    """Within TOL and, row by row, within ROW_RTOL of the row's largest
    value."""
    b, sq, sk, hq, hkv, d, causal = case
    rng = np.random.default_rng(12)
    q = _randn(rng, (b, sq, hq, d), dt, cuda)
    k = _randn(rng, (b, sk, hkv, d), dt, cuda)
    v = _randn(rng, (b, sk, hkv, d), dt, cuda)
    out = flash_ops.flash_attention(q, k, v, causal=causal)
    ref = plain.flash_attention(q, k, v, causal=causal)
    assert _err(out, ref) < TOL[dt]
    assert row_err(out, ref) < ROW_RTOL[dt]


@pytest.mark.gpu
def test_moe_is_bitwise_reproducible(cuda):
    """moonshot's MoE layer at full width on 512 tokens, twice: the combine
    adds each token's expert outputs in a fixed order (no atomics)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.blocks import MoE
    from repro_torch.models.common import tree_init

    cfg = ARCHS["moonshot-v1-16b-a3b"]
    moe = MoE()
    p = tree_init(moe.specs(cfg), torch.Generator(device=cuda).manual_seed(0),
                  cuda)
    x = torch.randn(512, cfg.d_model, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    a, aux_a, counts_a = moe(p, x, cfg, return_stats=True)
    b, aux_b, counts_b = moe(p, x, cfg, return_stats=True)
    assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)
    assert torch.equal(counts_a, counts_b)
    assert counts_a.sum().item() == 512 * cfg.moe.top_k


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 4, 4, 12, device=cuda, dtype=torch.bfloat16)
    kv = torch.zeros(1, 4, 4, 12, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_ops.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(1, 2), kv, kv)
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q.half(), kv.half(), kv.half())


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [1, 2])
def test_streamed_layers_decode_like_resident_ones(cuda, slots):
    """Paged decode with every layer streamed from pinned host memory
    through ``slots`` device buffers gives the logits of resident decode."""
    from repro_torch.configs import ARCHS, scaled_config
    from repro_torch.core import (
        StreamingFetch, identity_plan, make_fetch, split_blocks,
    )
    from repro_torch.core.layer_selection import RemapPlan
    from repro_torch.models import build_model

    cfg = scaled_config(ARCHS["llama3-8b"], num_layers=4)
    lm = build_model(cfg).impl
    params = lm.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    plan = RemapPlan(4, 2, 4, (0, 1, 2, 3), ())
    res, cyc, maps = split_blocks(params["blocks"], plan, pin_cycle=True)
    assert tuple(cyc[0]["norm1"].shape) == (4, cfg.d_model)
    assert cyc[0]["norm1"].is_pinned()
    page, n, b = 4, 4, 2
    shape = (lm.repeats, b * n + 1, page, cfg.num_kv_heads,
             cfg.resolved_head_dim)

    def decode(fetch):
        state = {"pool_k": torch.zeros(shape, device=cuda),
                 "pool_v": torch.zeros(shape, device=cuda),
                 "page_table": torch.arange(b * n, dtype=torch.int32,
                                            device=cuda).view(b, n),
                 "ctx": torch.zeros(b, dtype=torch.int32, device=cuda)}
        tokens = torch.tensor([3, 7], dtype=torch.int32, device=cuda)
        out = []
        for _ in range(5):
            logits, state = lm.decode_step_paged(
                params, state, tokens, fetch=fetch() if fetch else None)
            tokens = logits.argmax(-1).to(torch.int32)
            out.append(logits)
        return torch.stack(out)

    ref = decode(None)
    fetches = []

    def streamed():
        fetches.append(make_fetch(res, cyc, maps, slots=slots))
        return fetches[-1]
    got = decode(streamed)
    torch.cuda.synchronize()
    assert all(isinstance(f, StreamingFetch) for f in fetches)
    assert fetches[0].slots == slots
    assert sum(f.h2d_bytes for f in fetches) == 5 * 4 * fetches[0].layer_bytes
    assert torch.equal(got, ref)
    ident = split_blocks(params["blocks"], identity_plan(4), pin_cycle=True)
    assert not isinstance(make_fetch(*ident), StreamingFetch)


# B, T, H, dk, dv, chunk: tests/test_ssd_kernel.py CASES, then the xLSTM
# prefill (T 512, dk 512, dv 513), a ragged T and Mamba's widths; then T = 1
# and T = 65 (one token past a chunk), dv = 1, dk = 2048, B = 2 at xLSTM
# width, and key widths whose bf16 rows are not 16-byte (dk 12) or 4-byte
# (dk 5) aligned
SSD = [(2, 32, 3, 8, 8, 8), (1, 64, 2, 16, 8, 16), (2, 48, 1, 8, 16, 16),
       (1, 128, 4, 32, 32, 32), (2, 40, 2, 8, 8, 16),
       (1, 512, 4, 512, 513, 128), (1, 509, 4, 512, 513, 128),
       (1, 512, 128, 16, 64, 128),
       (1, 1, 4, 512, 513, 128), (1, 65, 4, 512, 513, 128),
       (2, 100, 3, 24, 1, 128), (1, 200, 2, 2048, 70, 128),
       (2, 512, 4, 512, 513, 128), (1, 70, 2, 12, 20, 128),
       (1, 30, 2, 5, 3, 128)]
# y and the final state within SSD_RTOL * max(1, max|plain|): f32
# arithmetic on both sides over the same inputs, in another chunking and
# summation order
SSD_RTOL = 1e-4


def _ssd_inputs(rng, case, qk_dt, dev):
    B, T, H, dk, dv, _ = case
    q = _randn(rng, (B, T, H, dk), torch.float32, dev) * dk ** -0.5
    k = _randn(rng, (B, T, H, dk), torch.float32, dev) * dk ** -0.25
    v = _randn(rng, (B, T, H, dv), torch.float32, dev)
    la = -torch.nn.functional.softplus(
        _randn(rng, (B, T, H), torch.float32, dev))
    return q.to(qk_dt), k.to(qk_dt), v, la


def _rel(out, ref) -> float:
    return _err(out, ref) / max(1.0, ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("qk_dt", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda, qk_dt):
    rng = np.random.default_rng(3)
    kernels.reset_launch_counts()
    for case in SSD:
        q, k, v, la = _ssd_inputs(rng, case, qk_dt, cuda)
        y, f = ssd_ops.ssd_scan(q, k, v, la, chunk=case[-1])
        ry, rf = ssd_scan_ref(q, k, v, la, chunk=case[-1])
        assert y.dtype == f.dtype == torch.float32
        assert y.shape == ry.shape and f.shape == rf.shape
        assert _rel(y, ry) <= SSD_RTOL and _rel(f, rf) <= SSD_RTOL, case
    assert kernels.launch_counts()["ssd_scan"] == len(SSD)


@pytest.mark.gpu
def test_ssd_scan_state_continues_the_recurrence(cuda):
    """Kernel over T tokens, one plain decode step, against the kernel
    over T + 1 (a ragged last chunk)."""
    rng = np.random.default_rng(4)
    B, T, H, dk, dv = 1, 512, 4, 512, 513
    q, k, v, la = _ssd_inputs(rng, (B, T + 1, H, dk, dv, 0), torch.bfloat16,
                              cuda)
    y_all, f_all = ssd_ops.ssd_scan(q, k, v, la)
    _, f_t = ssd_ops.ssd_scan(*(x[:, :T].contiguous() for x in (q, k, v, la)))
    y_step, f_step = ssd_decode_step(q[:, T], k[:, T], v[:, T], la[:, T], f_t)
    assert _rel(y_step, y_all[:, T]) <= SSD_RTOL
    assert _rel(f_step, f_all) <= SSD_RTOL


@pytest.mark.gpu
def test_ssd_scan_is_bitwise_reproducible(cuda):
    rng = np.random.default_rng(5)
    args = _ssd_inputs(rng, SSD[6], torch.bfloat16, cuda)
    a, b = ssd_ops.ssd_scan(*args), ssd_ops.ssd_scan(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_ssd_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 4, device=cuda)
    v = torch.zeros(1, 8, 2, 5, device=cuda)
    la = torch.zeros(1, 8, 2, device=cuda)
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(q, q, v, la.to(torch.bfloat16))
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(q, q.to(torch.bfloat16), v, la)
    with pytest.raises(TypeError):
        ssd_ops.ssd_scan(q, q, v.to(torch.bfloat16), la)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_scan(q.transpose(1, 2), q.transpose(1, 2), v, la)
    with pytest.raises(ValueError):
        ssd_ops.ssd_scan(q, q, v[:, :4], la)
    with pytest.raises(ValueError, match="mixed devices"):
        ssd_ops.ssd_scan(q, q, v.cpu(), la)


# ------------------------------------------------------------- training
def _rel_fro(a, b) -> float:
    """Relative Frobenius error of a against b."""
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


# lse of the kernel against the plain m + log(max(l, 1e-30)) over the same
# (bf16-rounded) inputs in f32: both take exp of f32 scores, the kernel in
# base 2 with ex2.approx (~2^-22 relative) and another summation order, so
# an lse near log(Sk) ~ 8 agrees to ~1e-5; a key tile left out moves it by
# log(1 - 64 / Sk) or more (> 1e-2 at these shapes)
LSE_TOL = 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_kernel_lse_matches_plain(cuda, dt):
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    rng = np.random.default_rng(7)
    for B, Sq, Sk, Hq, Hkv, D, causal, window in FLASH:
        q = _randn(rng, (B, Sq, Hq, D), dt, cuda)
        k = _randn(rng, (B, Sk, Hkv, D), dt, cuda)
        v = _randn(rng, (B, Sk, Hkv, D), dt, cuda)
        out, lse = flash_kernel.flash_attention(q, k, v, causal=causal,
                                                window=window, lse=True)
        alone = flash_kernel.flash_attention(q, k, v, causal=causal,
                                             window=window)
        pos = torch.arange(Sq, dtype=torch.int32, device=cuda)[None]
        kpos = torch.arange(Sk, dtype=torch.int32, device=cuda)[None]
        _, ref = plain.flash_fwd(
            q.float(), k.float(), v.float(), pos.expand(B, Sq),
            kpos.expand(B, Sk), torch.ones(B, Sk, dtype=torch.bool,
                                           device=cuda), causal, window, 512)
        assert lse.shape == (B, Sq, Hq) and lse.dtype == torch.float32
        assert torch.equal(out, alone), "the lse output moved the output"
        assert _err(lse, ref) < LSE_TOL, (B, Sq, Sk, D, causal, window)


# (B, S, Hq, Hkv, D, causal, window): GQA causal, a window, G = 1, a head
# dim off the 64-column blocks, bidirectional with Sq != Sk below
FLASH_GRAD = [(2, 300, 8, 2, 64, True, 0), (1, 400, 8, 2, 128, True, 100),
              (1, 257, 4, 4, 120, True, 0), (1, 512, 32, 8, 128, True, 0)]
# gradients of the FlashAttention Function (kernel forward, plain chunked
# backward) against autograd through the plain forward in f32 on the same
# inputs, relative Frobenius error: f32 runs the same arithmetic in another
# order (~1e-6); bf16 adds the rounding of the kernel's output and of the
# returned gradients to bf16 (2^-9 relative each)
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_grads(q, k, v, w, causal, window):
    """(dq, dk, dv) of sum(w * attention) through the dispatcher, and the
    same through autograd of the plain forward on the inputs in f32."""
    ins = [x.detach().requires_grad_() for x in (q, k, v)]
    out = flash_ops.flash_attention(*ins, causal=causal, window=window)
    got = torch.autograd.grad((out.float() * w).sum(), ins)
    ref_ins = [x.detach().float().requires_grad_() for x in (q, k, v)]
    b, sq = q.shape[:2]
    sk = k.shape[1]
    ref_out = plain.flash_fwd(
        *ref_ins,
        torch.arange(sq, dtype=torch.int32, device=q.device)[None]
        .expand(b, sq),
        torch.arange(sk, dtype=torch.int32, device=q.device)[None]
        .expand(b, sk),
        torch.ones(b, sk, dtype=torch.bool, device=q.device), causal, window,
        512)[0]
    ref = torch.autograd.grad((ref_out * w).sum(), ref_ins)
    return got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_match_autograd(cuda, dt):
    rng = np.random.default_rng(8)
    cases = [(B, S, S, Hq, Hkv, D, c, w) for B, S, Hq, Hkv, D, c, w
             in FLASH_GRAD] + [(1, 130, 250, 4, 2, 128, False, 0)]
    for B, Sq, Sk, Hq, Hkv, D, causal, window in cases:
        q = _randn(rng, (B, Sq, Hq, D), dt, cuda)
        k = _randn(rng, (B, Sk, Hkv, D), dt, cuda)
        v = _randn(rng, (B, Sk, Hkv, D), dt, cuda)
        w = _randn(rng, (B, Sq, Hq, D), torch.float32, cuda)
        kernels.reset_launch_counts()
        got, ref = _flash_grads(q, k, v, w, causal, window)
        assert kernels.launch_counts()["flash_attention"] == 1
        for name, g, r in zip("qkv", got, ref):
            assert g.dtype == dt and g.shape == r.shape
            e = _rel_fro(g, r)
            assert e < GRAD_RTOL[dt], (name, B, Sq, Sk, D, causal, window, e)


# the SsdScan Function against autograd through ssd_chunked (f32, the same
# inputs): its backward is that same autograd over a recompute, so the two
# agree to rounding; within 1e-4 * max(1, max|ref|) as the forward checks
SSD_GRAD = [(1, 512, 4, 512, 513, 128), (1, 512, 128, 16, 64, 128),
            (2, 100, 3, 24, 1, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("qk_dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_init", [False, True])
def test_ssd_function_gradients_match_autograd(cuda, qk_dt, with_init):
    from repro_torch.models.blocks import ssd_chunked
    rng = np.random.default_rng(9)
    for case in SSD_GRAD:
        B, T, H, dk, dv, chunk = case
        q, k, v, la = _ssd_inputs(rng, case, qk_dt, cuda)
        init = (_randn(rng, (B, H, dk, dv), torch.float32, cuda)
                if with_init else None)
        wy = _randn(rng, (B, T, H, dv), torch.float32, cuda)
        wf = _randn(rng, (B, H, dk, dv), torch.float32, cuda)
        xs = [q, k, v, la] + ([init] if with_init else [])

        def run(fn, ins):
            y, f = fn(*ins[:4], chunk=chunk,
                      init_state=ins[4] if with_init else None)
            return (y, f), torch.autograd.grad(
                (y * wy).sum() + (f * wf).sum(), ins)
        kernels.reset_launch_counts()
        (y, f), got = run(ssd_ops.ssd_scan,
                          [x.detach().requires_grad_() for x in xs])
        assert kernels.launch_counts()["ssd_scan"] == 1
        (ry, rf), ref = run(ssd_chunked,
                            [x.detach().requires_grad_() for x in xs])
        assert _rel(y, ry) <= SSD_RTOL and _rel(f, rf) <= SSD_RTOL, case
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype and g.shape == r.shape
            assert _rel(g, r) <= SSD_RTOL, (case, _rel(g, r))
