"""The hand-written CUDA kernels against their plain PyTorch versions on a
CUDA device (skipped elsewhere), at the kernel test cases' shapes plus head
dims that exercise the tensor-core path's padding. Imports neither JAX nor
``repro``, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.models import attention_ops as plain  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# B, Sq, Sk, Hq, Hkv, D, causal, window (tests/test_kernels.py FLASH_CASES,
# plus head dims 120 and 8)
FLASH = [(2, 64, 64, 4, 2, 32, True, 0), (1, 128, 128, 8, 8, 64, True, 0),
         (2, 60, 60, 4, 1, 32, True, 0), (2, 64, 64, 4, 2, 32, False, 0),
         (2, 64, 64, 4, 2, 32, True, 24), (1, 32, 32, 2, 2, 128, True, 0),
         (1, 200, 200, 8, 2, 120, True, 0), (1, 70, 70, 4, 4, 8, False, 0)]
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
