"""The port's Mamba mixer against the JAX block on bridged parameters (f32,
CPU): the sequence forward (output, final SSD state and conv tail), decode
steps on that state, and the state's continuation: a prefill of T tokens
then one decode step gives what a prefill of T + 1 gives."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models.blocks import Mamba as JaxMamba  # noqa: E402
from repro.models.common import tree_init  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.blocks import Mamba  # noqa: E402

ARCH = "jamba-v0.1-52b"
# f32 on both sides; the recurrence runs chunked in another summation order
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mamba():
    jc = scaled_config(ARCHS[ARCH], num_layers=8)
    tc = tcfgs.scaled_config(tcfgs.ARCHS[ARCH], num_layers=8)
    jp = tree_init(JaxMamba().specs(jc), jax.random.PRNGKey(0))
    # non-trivial decay, step and skip (the specs start them at 0, 0, 1)
    rng = np.random.default_rng(1)
    h = JaxMamba().dims(jc)[1]
    jp = dict(jp, a_log=jnp.asarray(rng.standard_normal(h), jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(h), jnp.float32),
              d_skip=jnp.asarray(rng.standard_normal(h), jnp.float32))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = rng.standard_normal((2, 37, jc.d_model)).astype(np.float32)
    return jc, tc, jp, tp, x


def _close(j, t):
    return np.abs(np.asarray(j) - t.numpy()).max() < TOL


def _jseq(jc, jp, x):
    return jax.jit(lambda p, x: JaxMamba().fwd_seq(p, x, {}, jc))(
        jp, jnp.asarray(x))


def _jdec(jc, jp, x, st):
    return jax.jit(lambda p, x, s: JaxMamba().fwd_dec(p, x, s, {}, jc))(
        jp, jnp.asarray(x), st)


def test_specs_and_state_match_jax(mamba):
    jc, tc, *_ = mamba
    for jspec, tspec in ((JaxMamba().specs(jc), Mamba().specs(tc)),
                         (JaxMamba().init_state(jc, 3, 64),
                          Mamba().init_state(tc, 3, 64))):
        assert sorted(jspec) == sorted(tspec)
        for key in jspec:
            assert jspec[key].shape == tspec[key].shape
            assert jspec[key].init == tspec[key].init
    assert Mamba().dims(tc) == JaxMamba().dims(jc) == (256, 4, 8)


def test_fwd_seq_matches_jax(mamba):
    jc, tc, jp, tp, x = mamba
    jy, jst = _jseq(jc, jp, x)
    ty, tst = Mamba().fwd_seq(tp, torch.from_numpy(x), {}, tc)
    assert _close(jy, ty)
    assert tst["ssm"].shape == (2, 4, 8, 64)
    assert tst["conv"].shape == (2, tc.ssm.d_conv - 1, 256)
    assert _close(jst["ssm"], tst["ssm"]) and _close(jst["conv"], tst["conv"])


def test_decode_steps_match_jax(mamba):
    jc, tc, jp, tp, x = mamba
    _, jst = _jseq(jc, jp, x[:, :20])
    _, tst = Mamba().fwd_seq(tp, torch.from_numpy(x[:, :20]), {}, tc)
    for t in range(20, 24):
        jy, jst = _jdec(jc, jp, x[:, t], jst)
        ty, tst = Mamba().fwd_dec(tp, torch.from_numpy(x[:, t]), tst, {}, tc)
        assert _close(jy, ty)
        assert _close(jst["ssm"], tst["ssm"])
        assert _close(jst["conv"], tst["conv"])


@pytest.mark.parametrize("t", [4, 36])
def test_state_continues_the_prefill(mamba, t):
    """Prefill T, decode token T: the output and the state equal a prefill
    of T + 1 (ragged T + 1 = 37 against the chunk of 16 too)."""
    _, tc, _, tp, x = mamba
    m = Mamba()
    y_all, st_all = m.fwd_seq(tp, torch.from_numpy(x[:, :t + 1]), {}, tc)
    _, st = m.fwd_seq(tp, torch.from_numpy(x[:, :t]), {}, tc)
    y, st = m.fwd_dec(tp, torch.from_numpy(x[:, t]), st, {}, tc)
    assert (y - y_all[:, t]).abs().max().item() < TOL
    assert (st["ssm"] - st_all["ssm"]).abs().max().item() < TOL
    assert torch.equal(st["conv"], st_all["conv"])
