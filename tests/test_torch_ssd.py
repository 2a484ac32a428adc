"""The port's chunked SSD recurrence and xLSTM mixers against the JAX
package (CPU): ``ssd_chunked`` / ``ssd_scan_ref`` against the JAX
``ssd_chunked`` and the Pallas ``ssd_scan`` in interpret mode over the
cases of tests/test_ssd_kernel.py, the state continuation, the one-token
``ssd_decode_step``, and ``MLSTM`` / ``SLSTM`` on bridged parameters."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_scan as pallas_ssd  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

# B, T, H, dk, dv, chunk (tests/test_ssd_kernel.py CASES)
CASES = [
    (2, 32, 3, 8, 8, 8),
    (1, 64, 2, 16, 8, 16),
    (2, 48, 1, 8, 16, 16),
    (1, 128, 4, 32, 32, 32),
    (2, 40, 2, 8, 8, 16),     # chunk doesn't divide T -> falls back to 8
]
# f32: both sides run the same f32 chunked algorithm, only the summation
# order of the products differs (~1e-6 relative at these sizes). bf16: the
# inputs are rounded to bf16 once, on both sides alike, and widened to f32
# before any arithmetic, so the f32 tolerance holds too.
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0):
    """numpy f32 inputs: q, k, v normal, log_a = -softplus(normal)."""
    B, T, H, dk, dv, _ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, T, H, dk)).astype(np.float32)
    v = rng.standard_normal((B, T, H, dv)).astype(np.float32)
    la = -np.logaddexp(0.0, rng.standard_normal((B, T, H))).astype(np.float32)
    return q, k, v, la


def _as(dtype, *arrays):
    """The same inputs on both sides in ``dtype`` (bf16 rounding by JAX,
    carried bit for bit to torch)."""
    jx = [jnp.asarray(a, dtype) for a in arrays]
    tx = params_from_jax([np.asarray(a) for a in jx], "cpu")
    return jx, tx


def _max(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax_and_pallas(case, dtype):
    chunk = case[-1]
    (jq, jk, jv, jla), (tq, tk, tv, tla) = _as(
        jnp.dtype(dtype), *_inputs(case))
    jy, jf = jblocks.ssd_chunked(jq, jk, jv, jla, chunk)
    py, pf = pallas_ssd(jq, jk, jv, jla, chunk=chunk, interpret=True)
    ty, tf = tblocks.ssd_chunked(tq, tk, tv, tla, chunk)
    ry, rf = ssd_scan_ref(tq, tk, tv, tla, chunk=chunk)
    assert ty.dtype == tf.dtype == torch.float32
    assert tuple(ty.shape) == tuple(jy.shape)
    assert tuple(tf.shape) == tuple(jf.shape)
    for y, f in ((jy, jf), (py, pf)):
        assert _max(ty, y) < TOL and _max(tf, f) < TOL
    assert torch.equal(ry, ty) and torch.equal(rf, tf)


def test_dispatcher_takes_the_plain_version_for_cpu_tensors():
    case = CASES[3]
    _, (tq, tk, tv, tla) = _as(jnp.float32, *_inputs(case, seed=4))
    kernels.reset_launch_counts()
    y, f = ssd_scan(tq, tk, tv, tla, chunk=case[-1])
    ry, rf = ssd_scan_ref(tq, tk, tv, tla, chunk=case[-1])
    assert torch.equal(y, ry) and torch.equal(f, rf)
    assert kernels.launch_counts()["ssd_scan"] == 0


def test_ssd_state_continues_recurrence():
    """tests/test_ssd_kernel.py:43 on the port: the final state over T
    tokens, one ``ssd_decode_step`` on, equals the scan over T + 1 tokens
    (and both agree with the JAX functions)."""
    B, T, H, dk, dv = 1, 32, 2, 8, 8
    (jq, jk, jv, jla), (tq, tk, tv, tla) = _as(
        jnp.float32, *_inputs((B, T + 1, H, dk, dv, 8), seed=3))
    y_all, f_all = tblocks.ssd_chunked(tq, tk, tv, tla, 11)
    _, f_t = tblocks.ssd_chunked(tq[:, :T], tk[:, :T], tv[:, :T],
                                 tla[:, :T], 8)
    y_step, f_step = tblocks.ssd_decode_step(tq[:, T], tk[:, T], tv[:, T],
                                             tla[:, T], f_t)
    assert _max(y_step, y_all[:, T]) < TOL
    assert _max(f_step, f_all) < TOL
    jy_all, jf_all = pallas_ssd(jq, jk, jv, jla, chunk=11, interpret=True)
    assert _max(y_all, jy_all) < TOL and _max(f_all, jf_all) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_matches_jax(dtype):
    rng = np.random.default_rng(5)
    B, H, dk, dv = 3, 2, 8, 9
    arrays = [rng.standard_normal(s).astype(np.float32) for s in
              ((B, H, dk), (B, H, dk), (B, H, dv))]
    la = -np.logaddexp(0.0, rng.standard_normal((B, H))).astype(np.float32)
    state = rng.standard_normal((B, H, dk, dv)).astype(np.float32)
    (jq, jk, jv), (tq, tk, tv) = _as(jnp.dtype(dtype), *arrays)
    jy, js = jblocks.ssd_decode_step(jq, jk, jv, jnp.asarray(la),
                                     jnp.asarray(state))
    ty, ts = tblocks.ssd_decode_step(tq, tk, tv, torch.from_numpy(la),
                                     torch.from_numpy(state))
    assert ty.dtype == ts.dtype == torch.float32
    assert _max(ty, jy) < TOL and _max(ts, js) < TOL


# ----------------------------------------------------------------- mixers
@pytest.fixture(scope="module")
def xlstm():
    """8 layers: the pattern period, so positions 0-6 are mLSTM and 7 is
    the sLSTM (scaled_config's default of 4 layers has no sLSTM)."""
    cfg = scaled_config(ARCHS["xlstm-1.3b"], num_layers=8)
    tcfg = tcfgs.scaled_config(tcfgs.ARCHS["xlstm-1.3b"], num_layers=8)
    jp = jax_build(cfg).init(jax.random.PRNGKey(7))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, tcfg, jp, tp


def _layer(params, pos):
    """Mixer params of pattern position ``pos`` in repeat 0."""
    return {k: v[0] for k, v in params["blocks"][pos]["mixer"].items()}


@pytest.mark.parametrize("pos,mixer", [(0, "MLSTM"), (7, "SLSTM")])
def test_mixers_match_jax(xlstm, pos, mixer):
    cfg, tcfg, jp, tp = xlstm
    jm, tm = getattr(jblocks, mixer)(), getattr(tblocks, mixer)()
    jl, tl = _layer(jp, pos), _layer(tp, pos)
    rng = np.random.default_rng(pos)
    x = rng.standard_normal((2, 21, cfg.d_model)).astype(np.float32)
    jout, jst = jm.fwd_seq(jl, jnp.asarray(x), None, cfg)
    tout, tst = tm.fwd_seq(tl, torch.from_numpy(x), None, tcfg)
    assert _max(tout, jout) < TOL
    assert sorted(tst) == sorted(jst)
    for key in jst:
        assert _max(tst[key], jst[key]) < TOL
    # one decode step from the prefill state
    xd = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    jo, jn = jm.fwd_dec(jl, jnp.asarray(xd), jst, None, cfg)
    to, tn = tm.fwd_dec(tl, torch.from_numpy(xd), tst, None, tcfg)
    assert _max(to, jo) < TOL
    for key in jn:
        assert _max(tn[key], jn[key]) < TOL
    spec = tm.init_state(tcfg, 2, 64)
    assert {k: s.shape for k, s in spec.items()} == \
        {k: tuple(v.shape) for k, v in tn.items()}


@pytest.mark.parametrize("t,dv,nc,slots,dvp", [
    (1, 1, 1, 1, 64), (64, 64, 1, 1, 64), (65, 513, 2, 1, 576),
    (512, 513, 8, 7, 576)])
def test_ssd_kernel_scratch_shapes(t, dv, nc, slots, dvp):
    """The CUDA wrapper's scratch: per chunk the transposed scores and
    decayed queries, and a state slot per chunk after the first (one when
    T fits a chunk), value columns padded to 64-column tiles."""
    from repro_torch.kernels.ssd_scan.kernel import scratch_shapes
    assert scratch_shapes(2, t, 3, 16, dv) == {
        "scores": (2, 3, nc, 64, 64), "qt": (2, 3, nc, 16, 64),
        "states": (2, 3, slots, 16, dvp)}
