"""Gradients of the port against the JAX package on the CPU (f32): the
training loss and every parameter's gradient of ``Model.train_loss`` for
seven configs under the three remat policies, against ``jax.value_and_grad``
of the JAX facade's ``train_loss`` on bridged parameters and the same batch;
the ``FlashAttention`` Function against ``jax.grad`` of the JAX op (its
custom VJP); and the SSD recurrence's gradients (the ``SsdScan`` Function and
autograd through ``ssd_chunked``) against ``jax.grad`` through the JAX
``ssd_chunked``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.models import attention_ops as jops  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.training import batch_for_step as jax_batch  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import attention_ops as tops  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.blocks import ssd_chunked  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402

# f32 on both sides, the same algorithm in another summation order: the
# loss agrees to ~1e-7 relative and each gradient leaf to ~1e-7 of its
# largest value at these sizes
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4           # x max(1, max|g_jax|) of the leaf

# name -> (layers, seq): two layers of each family (xLSTM: 8, one sLSTM in
# its period; jamba: 8, one pattern of Mamba, attention and MoE layers);
# danube at S 96 past its scaled window of 64; llava with its 16 patches
MODELS = {"llama3-8b": (2, 32), "h2o-danube-3-4b": (2, 96),
          "moonshot-v1-16b-a3b": (2, 32), "jamba-v0.1-52b": (8, 32),
          "xlstm-1.3b": (8, 32), "whisper-medium": (2, 32),
          "llava-next-34b": (2, 40)}
POLICIES = ("none", "full", "dots_saveable")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(tree, prefix=""):
    """(path, leaf) pairs of a nested dict/tuple tree."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in _paths(v, f"{prefix}/[{i}]")]
    return [(prefix, tree)]


_CACHE = {}


def _setup(name):
    """JAX model, params and batch (B 2) and the port's model, the bridged
    params and the batch as tensors; built once per config."""
    if name not in _CACHE:
        layers, seq = MODELS[name]
        jm = jax_build(scaled_config(ARCHS[name], num_layers=layers))
        jp = jm.init(jax.random.PRNGKey(0))
        batch = jax_batch(jm, ShapeConfig("t", seq, 2, "train"), 0, 0)
        tm = build_model(tcfgs.scaled_config(tcfgs.ARCHS[name],
                                             num_layers=layers))
        tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
        _CACHE[name] = (jm, jp, batch, tm, tp, tb)
    return _CACHE[name]


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", list(MODELS))
def test_train_loss_and_grads_match_jax(name, policy):
    jm, jp, batch, tm, tp, tb = _setup(name)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.train_loss(p, b, remat_policy=policy)))(jp, batch)
    leaves = [x.detach().requires_grad_() for _, x in _paths(tp)]
    it = iter(leaves)
    loss = tm.train_loss(tree_map(lambda _: next(it), tp), tb,
                         remat_policy=policy)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(loss.item() - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    jg = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    assert set(jg) == {p for p, _ in _paths(tp)}
    for (path, p), g in zip(_paths(tp), grads):
        ref = jg[path]
        assert g.shape == p.shape and g.dtype == p.dtype, path
        lim = GRAD_TOL * max(1.0, float(np.abs(ref).max()))
        err = float(np.abs(g.numpy() - ref).max())
        assert err <= lim, (name, policy, path, err, lim)


# (B, Sq, Sk, Hq, Hkv, D, causal, window, chunk)
FLASH = {"causal_gqa": (2, 40, 40, 4, 2, 16, True, 0, 16),
         "window": (2, 40, 40, 4, 2, 16, True, 8, 16),
         "mha": (1, 33, 33, 4, 4, 8, True, 0, 11),
         "bidirectional_sq_ne_sk": (2, 24, 40, 4, 2, 16, False, 0, 16)}
# f32 on both sides; the JAX backward is the same chunked recompute
FLASH_TOL = 1e-5


@pytest.mark.parametrize("case", list(FLASH))
def test_flash_function_grads_match_jax(case):
    B, Sq, Sk, Hq, Hkv, D, causal, window, chunk = FLASH[case]
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    w = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)

    def f(q, k, v):
        out = jops.flash_attention(q, k, v, causal=causal, window=window,
                                   chunk=chunk)
        return (out * w).sum()
    jout = jops.flash_attention(q, k, v, causal=causal, window=window,
                                chunk=chunk)
    jg = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tops.flash_attention(*ins, causal=causal, window=window,
                               chunk=chunk)
    assert out.grad_fn is not None
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() < FLASH_TOL
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ins)
    for name, g, r in zip("qkv", grads, jg):
        assert np.abs(g.numpy() - np.asarray(r)).max() < FLASH_TOL, name


def test_flash_lse_is_the_reference_lse():
    """The forward's log-sum-exp is the JAX ``_flash_fwd`` residual."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(24, dtype=np.int32)[None], (2, 24))
    valid = np.ones((2, 24), bool)
    _, res = jops._flash_fwd(q, k, v, pos, pos, valid, True, 8, 8)
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v, pos,
                                                             pos, valid)]
    _, lse = tops.flash_fwd(*t, True, 8, 8)
    assert np.abs(lse.numpy() - np.asarray(res[-1]).reshape(2, 24, 4)
                  ).max() < FLASH_TOL


# (B, T, H, dk, dv, chunk, with an initial state)
SSD = {"zero_state": (2, 48, 3, 8, 5, 16, False),
       "init_state": (2, 48, 3, 8, 5, 16, True),
       "ragged_chunk": (1, 40, 2, 8, 9, 16, True)}
SSD_TOL = 1e-4


@pytest.mark.parametrize("how", ["function", "autograd"])
@pytest.mark.parametrize("case", list(SSD))
def test_ssd_grads_match_jax(case, how):
    """The SsdScan Function (the dispatcher under autograd: plain forward,
    recompute backward) and plain autograd through ``ssd_chunked``."""
    B, T, H, dk, dv, chunk, with_init = SSD[case]
    rng = np.random.default_rng(5)
    q, k = (rng.standard_normal((B, T, H, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((B, T, H))).astype(np.float32)
    s0 = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    wy = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    wf = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    xs = [q, k, v, la] + ([s0] if with_init else [])

    def f(*xs):
        y, fs = jblocks.ssd_chunked(*xs[:4], chunk,
                                    xs[4] if with_init else None)
        return (y * wy).sum() + (fs * wf).sum()
    jg = jax.jit(jax.grad(f, argnums=tuple(range(len(xs)))))(*xs)
    ins = [torch.from_numpy(x).requires_grad_() for x in xs]
    init = ins[4] if with_init else None
    if how == "function":
        y, fs = ssd_scan(*ins[:4], chunk=chunk, init_state=init)
    else:
        y, fs = ssd_chunked(*ins[:4], chunk, init_state=init)
    loss = (y * torch.from_numpy(wy)).sum() + (fs * torch.from_numpy(wf)).sum()
    for g, r in zip(torch.autograd.grad(loss, ins), jg):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= \
            SSD_TOL * max(1.0, float(np.abs(r).max()))


def test_ssd_grads_stay_finite_where_the_reference_overflows():
    """ROADMAP queue 3: a 128-token chunk that decays by 127 x 0.71 = 90.2
    (past ln of the f32 maximum, 88.7) overflows exp(cum_t - cum_s) on the
    masked pairs t < s; the JAX block's where() then gives the backward
    0 * inf = NaN. The port masks before the exp: the same forward, finite
    gradients, equal to the JAX gradients of the same recurrence in
    64-token chunks (which do not overflow)."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 128, 1, 4)).astype(np.float32)
               for _ in range(3))
    la = np.full((1, 128, 1), -0.71, np.float32)

    def jgrad(chunk):
        return np.asarray(jax.grad(
            lambda q: jblocks.ssd_chunked(q, k, v, la, chunk)[0].sum())(q))
    assert np.isnan(jgrad(128)).any()
    ref = jgrad(64)
    assert np.isfinite(ref).all()
    tq = torch.from_numpy(q).requires_grad_()
    y, _ = ssd_chunked(tq, *(torch.from_numpy(x) for x in (k, v, la)), 128)
    jy = np.asarray(jblocks.ssd_chunked(q, k, v, la, 128)[0])
    assert np.abs(y.detach().numpy() - jy).max() <= \
        SSD_TOL * max(1.0, float(np.abs(jy).max()))
    (g,) = torch.autograd.grad(y.sum(), tq)
    assert np.abs(g.numpy() - ref).max() <= \
        SSD_TOL * max(1.0, float(np.abs(ref).max()))
