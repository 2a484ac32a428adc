"""The port's ServingEngine against the JAX engine on the stacks this slice
adds (CPU, f32, bridged parameters): a dense sliding-window danube tenant
whose prompts wrap its ring, a dense jamba tenant (Mamba + attention, MoE;
8 layers = 2 repeats), a paged moonshot tenant (MoE on every layer, chunked
prefill), and jamba beside moonshot under a tight KV budget, where the
controller remaps a repeat and its decode fetches it through
``make_fetch``. Generated tokens, event logs, allocator segments, the
page-id bound and TransferStats must be identical.

The JAX engine runs a dense tenant's prefill and a paged tenant's prefill
chunks op by op; as in tests/test_torch_engine_xlstm.py the JAX side runs
them (``Model.prefill``, ``LM.prefill_chunk_paged``) under one ``jax.jit``
per config, and initialises the weights under ``jax.jit``."""
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
TENANTS = {"D": ("h2o-danube-3-4b", 2, 0, False),
           "J": ("jamba-v0.1-52b", 8, 1, False),
           "M": ("moonshot-v1-16b-a3b", 2, 2, True)}
# case -> (tenants, prompt tokens, KV pages, prefill chunk)
CASES = {"danube_ring": (["D"], 70, 96, 0),
         "jamba": (["J"], 18, 64, 0),
         "moonshot_chunked": (["M"], 18, 64, 7),
         "pressure": (["J", "M"], 18, 12, 7)}


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
    """One jitted ``init``, ``prefill`` or ``impl.prefill_chunk_paged`` (its
    slot and start traced) of a JAX model per config."""
    if (cfg, what) not in _JITTED:
        model = jax_build(cfg)
        fn = getattr(model.impl if what == "prefill_chunk_paged" else model,
                     what)
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


def _run(side, weights, case):
    names, prompt, pages, chunk = CASES[case]
    jax_side = side == "jax"
    eng_cls, tenant_cls, traces = (
        (JaxEngine, JaxTenant, jax_traces) if jax_side else
        (ServingEngine, TenantConfig, torch_traces))
    tenants = {}
    for name in names:
        cfg, jp, tcfg, tp, paged = weights[name]
        tenants[name] = tenant_cls(cfg if jax_side else tcfg,
                                   jp if jax_side else tp, max_batch=4,
                                   max_context=96, paged=paged)
    kw = {} if jax_side else {"device": "cpu"}
    eng = eng_cls(tenants, mode="mirage", scheduler="temporal",
                  base_kv_pages=pages, page_size=4, quantum_steps=4,
                  prefill_chunk_tokens=chunk, watermark_tokens=4, **kw)
    if jax_side:
        for t in eng.tenants.values():
            if t.paged:
                t.model.impl.prefill_chunk_paged = _jitted(
                    t.cfg, "prefill_chunk_paged")
            else:
                t.model.prefill = _jitted(t.cfg, "prefill")
    eng.submit(traces.tiny_trace(names, n_per_model=3, prompt_len=prompt,
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


@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax_engine(weights, case):
    ref = _run("jax", weights, case)
    out = _run("torch", weights, case)
    assert out == ref
    n = 3 * len(CASES[case][0])
    assert len(out["generated"]) == n
    assert all(len(g) == 6 for g in out["generated"].values())
    kinds = [k for _, k, _ in out["events"]]
    assert kinds.count("prefill") == n
    if case == "pressure":
        assert "remap" in kinds and out["stats"]["stream_bytes"] > 0
    else:
        assert "remap" not in kinds
