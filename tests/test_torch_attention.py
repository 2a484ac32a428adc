"""The port's attention ops against the JAX package on the same inputs:
plain versions against the jnp oracles over the kernel test cases, one case
per op against the Pallas kernel in interpret mode, and the CPU dispatch
(plain version, no launch). The CUDA kernels are held against the plain
versions in tests/test_torch_kernels_gpu.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention as flash_k  # noqa: E402
from repro.kernels.paged_attention.kernel import (  # noqa: E402
    paged_decode_attention as paged_k, paged_prefill_attention as prefill_k,
)
from repro.models import attention_ops as jops  # noqa: E402
from test_kernels import FLASH_CASES, PAGED_CASES  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.paged_attention import kernel as paged_kernel  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.models import attention_ops as tops  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a CPU tensor of dtype ``dt``
    (bf16 rounds from f32 the same way on both sides)."""
    jdt, tdt, _ = DTYPES[dt]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _maxdiff(j, t) -> float:
    return float(np.abs(np.asarray(jnp.asarray(j, jnp.float32))
                        - t.float().numpy()).max())


def _flash_inputs(case, seed=0):
    B, Sq, Sk, Hq, Hkv, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _paged_inputs(case, seed=1):
    B, Hq, Hkv, D, P, page, N, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    pt = rng.permutation(P)[:B * N].reshape(B, N).astype(np.int32)
    ctx = np.asarray([(N * page - 3) % (N * page) + 1, page + 1,
                      N * page][:B], np.int32)
    return q, kp, vp, pt, ctx


def _prefill_inputs(seed=0):
    B, Sq, Hq, Hkv, D, page, P, N = 2, 6, 4, 2, 8, 4, 11, 5
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, D)).astype(np.float32)
    pt = (1 + np.arange(B * N)).reshape(B, N).astype(np.int32)
    start = np.array([7, 3], np.int32)
    return q, kp, vp, pt, start, start + Sq


# ------------------------------------------------ plain versions vs JAX
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_flash_plain_matches_jax(case, dt):
    causal, win = case[6], case[7]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in _flash_inputs(case))
    ref = jops.flash_attention(jq, jk, jv, causal=causal, window=win)
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=win)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert _maxdiff(ref, out) < DTYPES[dt][2]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_paged_decode_plain_matches_jax(case, dt):
    q, kp, vp, pt, ctx = _paged_inputs(case)
    win = case[-1]
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, kp, vp))
    ref = jops.paged_decode_attention(jq, jk, jv, jnp.asarray(pt),
                                      jnp.asarray(ctx), window=win)
    out = tops.paged_decode_attention(tq, tk, tv, torch.from_numpy(pt),
                                      torch.from_numpy(ctx), window=win)
    assert _maxdiff(ref, out) < DTYPES[dt][2]


def test_paged_decode_single_token_context():
    """ctx = 1: only the first slot of the first page is live."""
    q, kp, vp, pt, _ = _paged_inputs(PAGED_CASES[0])
    ctx = np.ones((q.shape[0],), np.int32)
    ref = jops.paged_decode_attention(*(jnp.asarray(a) for a in
                                        (q, kp, vp, pt, ctx)))
    out = tops.paged_decode_attention(*(torch.from_numpy(a) for a in
                                        (q, kp, vp, pt, ctx)))
    assert _maxdiff(ref, out) < 1e-4


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("dt", DTYPES)
def test_paged_prefill_plain_matches_jax(window, dt):
    q, kp, vp, pt, start, ctx = _prefill_inputs()
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dt) for a in (q, kp, vp))
    ints = (pt, start, ctx)
    ref = jops.paged_prefill_attention(
        jq, jk, jv, *(jnp.asarray(a) for a in ints), window=window)
    out = tops.paged_prefill_attention(
        tq, tk, tv, *(torch.from_numpy(a) for a in ints), window=window)
    assert _maxdiff(ref, out) < DTYPES[dt][2]


# -------------------------------------- against the Pallas kernels (interpret)
def test_flash_plain_matches_pallas_interpret():
    case = FLASH_CASES[4]                     # sliding window, GQA
    causal, win, bq, bk = case[6:]
    q, k, v = _flash_inputs(case)
    ref = flash_k(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                  window=win, block_q=bq, block_k=bk, interpret=True)
    out = tops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               causal=causal, window=win)
    assert _maxdiff(ref, out) < 1e-4


def test_paged_decode_plain_matches_pallas_interpret():
    case = PAGED_CASES[3]                     # sliding window
    args = _paged_inputs(case)
    ref = paged_k(*(jnp.asarray(a) for a in args), window=case[-1],
                  interpret=True)
    out = tops.paged_decode_attention(*(torch.from_numpy(a) for a in args),
                                      window=case[-1])
    assert _maxdiff(ref, out) < 1e-4


@pytest.mark.parametrize("window", [0, 5])
def test_paged_prefill_plain_matches_pallas_interpret(window):
    args = _prefill_inputs()
    ref = prefill_k(*(jnp.asarray(a) for a in args), window=window,
                    interpret=True)
    out = tops.paged_prefill_attention(*(torch.from_numpy(a) for a in args),
                                       window=window)
    assert _maxdiff(ref, out) < 1e-4


# ----------------------------------------------------------- dispatch
def test_cpu_tensors_take_the_plain_version_without_launching():
    kernels.reset_launch_counts()
    q, kp, vp, pt, ctx = (torch.from_numpy(a)
                          for a in _paged_inputs(PAGED_CASES[0]))
    out = paged_ops.paged_decode_attention(q, kp, vp, pt, ctx)
    assert torch.equal(out, tops.paged_decode_attention(q, kp, vp, pt, ctx))
    pq, pk, pv, ppt, st, cl = (torch.from_numpy(a) for a in _prefill_inputs())
    out = paged_ops.paged_prefill_attention(pq, pk, pv, ppt, st, cl, window=5)
    assert torch.equal(out, tops.paged_prefill_attention(
        pq, pk, pv, ppt, st, cl, window=5))
    fq, fk, fv = (torch.from_numpy(a) for a in _flash_inputs(FLASH_CASES[0]))
    out = flash_ops.flash_attention(fq, fk, fv)
    assert torch.equal(out, tops.flash_attention(fq, fk, fv))
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never computes on the CPU: it raises before any launch."""
    q, kp, vp, pt, ctx = (torch.from_numpy(a)
                          for a in _paged_inputs(PAGED_CASES[0]))
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        paged_kernel.paged_decode_attention(q, kp, vp, pt, ctx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.WRAPPERS["flash_attention"](q[:, None], kp[:1], vp[:1])
    assert kernels.launch_counts() == {n: 0 for n in kernels.WRAPPERS}
