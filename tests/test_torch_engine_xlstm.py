"""The port's ServingEngine with dense (``paged=False``) xLSTM tenants
against the JAX engine (CPU, f32, bridged parameters): identical generated
tokens and event logs, with an ample KV budget and with a tight one where
the controller remaps a repeat of one tenant (whose decode then fetches it
through ``make_fetch``), and in a mixed engine beside a paged llama tenant.
16 layers: two repeats of the 8-layer pattern, so one repeat can move.

The JAX engine runs a dense tenant's prefill op by op, about 1.4 s a prompt
here; the JAX side below runs the same ``Model.prefill`` under one
``jax.jit`` per config, shared by every tenant and run of this module, and
initialises the weights under ``jax.jit`` too."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import TenantConfig as JaxTenant  # noqa: E402
from repro.serving import traces as jax_traces  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving import traces as torch_traces  # noqa: E402

# tenant -> (arch, layers, seed, paged)
TENANTS = {"X": ("xlstm-1.3b", 16, 0, False), "Y": ("xlstm-1.3b", 16, 1, False),
           "A": ("llama3-8b", 2, 2, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers per machine, and
    PyTorch's default of one thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JITTED = {}


def _jitted(cfg, what):
    """One jitted ``init`` or ``prefill`` of a JAX model per config."""
    if (cfg, what) not in _JITTED:
        fn = getattr(jax_build(cfg), what)
        _JITTED[cfg, what] = jax.jit(fn, static_argnums=(2,) if what ==
                                     "prefill" else ())
    return _JITTED[cfg, what]


@pytest.fixture(scope="module")
def weights():
    out = {}
    for name, (arch, layers, seed, paged) in TENANTS.items():
        cfg = scaled_config(ARCHS[arch], num_layers=layers)
        jp = _jitted(cfg, "init")(jax.random.PRNGKey(seed))
        tcfg = tcfgs.scaled_config(tcfgs.ARCHS[arch], num_layers=layers)
        out[name] = (cfg, jp, tcfg,
                     params_from_jax(jax.tree.map(np.asarray, jp), "cpu"),
                     paged)
    return out


def _run(side, weights, names, pages):
    jax_side = side == "jax"
    eng_cls, tenant_cls, traces = (
        (JaxEngine, JaxTenant, jax_traces) if jax_side else
        (ServingEngine, TenantConfig, torch_traces))
    tenants = {}
    for name in names:
        cfg, jp, tcfg, tp, paged = weights[name]
        tenants[name] = tenant_cls(cfg if jax_side else tcfg,
                                   jp if jax_side else tp, max_batch=4,
                                   max_context=64, paged=paged)
    kw = {} if jax_side else {"device": "cpu"}
    eng = eng_cls(tenants, mode="mirage", scheduler="temporal",
                  base_kv_pages=pages, page_size=4, quantum_steps=4,
                  watermark_tokens=4, **kw)
    if jax_side:
        for t in eng.tenants.values():
            if not t.paged:
                t.model.prefill = _jitted(t.cfg, "prefill")
    eng.submit(traces.tiny_trace(names, n_per_model=3, prompt_len=18,
                                 max_new=6, vocab=256))
    eng.run(max_steps=2000)
    eng.allocator.check_invariants()
    return {
        "generated": {r.rid: list(r.generated) for r in eng.finished},
        "events": list(eng.events),
        "segments": [(s.source, s.num_pages) for s in eng.allocator.segments],
        "page_id_bound": eng.allocator.page_id_bound,
        "stats": dataclasses.asdict(eng.xfer.stats),
    }


@pytest.mark.parametrize("pages", [64, 8], ids=["ample", "tight"])
def test_xlstm_engine_matches_jax_engine(weights, pages):
    ref = _run("jax", weights, ["X", "Y"], pages)
    out = _run("torch", weights, ["X", "Y"], pages)
    assert out == ref
    assert len(out["generated"]) == 6
    assert all(len(g) == 6 for g in out["generated"].values())
    kinds = [k for _, k, _ in out["events"]]
    assert kinds.count("prefill") == 6
    if pages == 8:
        assert "remap" in kinds and out["stats"]["stream_bytes"] > 0
    else:
        assert "remap" not in kinds


def test_mixed_paged_llama_and_dense_xlstm_engine_matches_jax(weights):
    ref = _run("jax", weights, ["A", "X"], 24)
    out = _run("torch", weights, ["A", "X"], 24)
    assert out == ref
    assert len(out["generated"]) == 6


def test_paged_recurrent_tenant_is_refused(weights):
    """The paged pool holds attention K/V: a recurrent stack is dense only
    (the JAX engine asserts the same)."""
    _, _, tcfg, tp, _ = weights["X"]
    with pytest.raises(ValueError, match="needs an attention stack"):
        ServingEngine({"X": TenantConfig(tcfg, tp, paged=True)},
                      device="cpu")
