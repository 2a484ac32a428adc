"""The port's ServingEngine against the JAX engine on the tenants this slice
adds (CPU, f32, bridged parameters): a dense whisper tenant (encoder,
cross-attention), a dense llava tenant (16 patch rows ahead of each
prompt), and, under a tight KV budget where the controller remaps a
repeat, whisper beside a paged llama tenant (a llama repeat streams) and
two whisper tenants (a decoder repeat of one streams while its cross cache
stays in the decode state). Both engines run in one process: the
stub frontends' inputs are drawn from ``hash(rid)``, which Python salts per
process.

Held identical to the JAX engine: the event logs, allocator segments and
page-id bound, TransferStats and ServingMetrics; the generated tokens of
llava and llama. Whisper's tokens are held to a greedy loop over the JAX
model that keeps ``src_len`` in its state: the JAX engine drops it at slot
insertion and decodes against zero-padded cross rows, the port keeps it
(tests/test_torch_encdec.py pins both)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, scaled_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.serving import TenantConfig as JaxTenant  # noqa: E402
from repro.serving import traces as jax_traces  # noqa: E402

import repro_torch.configs as tcfgs  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serving import ServingEngine, TenantConfig  # noqa: E402
from repro_torch.serving import traces as torch_traces  # noqa: E402

MAXC, NEW = 96, 6
# tenant -> (arch, layers, seed, paged)
TENANTS = {"W": ("whisper-medium", 2, 0, False),
           "X": ("whisper-medium", 2, 3, False),
           "V": ("llava-next-34b", 2, 1, False),
           "A": ("llama3-8b", 2, 2, True)}
# case -> (tenants, prompt tokens, KV pages); under pressure the controller
# remaps a llama repeat beside whisper, and a whisper repeat beside whisper
CASES = {"whisper": (["W"], 18, 64),
         "llava": (["V"], 18, 64),
         "pressure": (["W", "A"], 18, 12),
         "whisper_pressure": (["W", "X"], 18, 12)}


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
    """One jitted ``init``, ``prefill`` or ``decode_step`` of a JAX model
    per config (``prefill``'s and ``decode_step``'s max_context static)."""
    if (cfg, what) not in _JITTED:
        fn = getattr(jax_build(cfg), what)
        _JITTED[cfg, what] = jax.jit(
            fn, static_argnums={"init": (), "prefill": (2,),
                                "decode_step": (3,)}[what])
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


def _metrics(m) -> str:
    """ServingMetrics' compared fields (repr, so that NaN equals NaN)."""
    return repr([(f.name, getattr(m, f.name))
                 for f in dataclasses.fields(m) if f.compare])


def _run(side, weights, case):
    names, prompt, pages = CASES[case]
    jax_side = side == "jax"
    eng_cls, tenant_cls, traces = (
        (JaxEngine, JaxTenant, jax_traces) if jax_side else
        (ServingEngine, TenantConfig, torch_traces))
    tenants = {}
    for name in names:
        cfg, jp, tcfg, tp, paged = weights[name]
        tenants[name] = tenant_cls(cfg if jax_side else tcfg,
                                   jp if jax_side else tp, max_batch=4,
                                   max_context=MAXC, paged=paged)
    kw = {} if jax_side else {"device": "cpu"}
    eng = eng_cls(tenants, mode="mirage", scheduler="temporal",
                  base_kv_pages=pages, page_size=4, quantum_steps=4,
                  watermark_tokens=4, **kw)
    if jax_side:
        for t in eng.tenants.values():
            if not t.paged:
                t.model.prefill = _jitted(t.cfg, "prefill")
    trace = traces.tiny_trace(names, n_per_model=3, prompt_len=prompt,
                              max_new=NEW, vocab=256)
    eng.submit(trace)
    eng.run(max_steps=2000)
    eng.allocator.check_invariants()
    return {
        "generated": {r.rid: list(r.generated) for r in eng.finished},
        "prompts": {r.rid: np.asarray(r.prompt) for r in trace},
        "events": list(eng.events),
        "segments": [(s.source, s.num_pages) for s in eng.allocator.segments],
        "page_id_bound": eng.allocator.page_id_bound,
        "stats": dataclasses.asdict(eng.xfer.stats),
        "metrics": _metrics(eng.metrics()),
    }


def _whisper_greedy(weights, rid, prompt):
    """The JAX model's greedy tokens for one whisper request, its
    ``src_len`` kept: the request's frames drawn as both engines draw them,
    prefill, then decode steps at the engine's max_context."""
    cfg, jp, _, _, _ = weights[rid.split("-")[0]]
    rng = np.random.default_rng(abs(hash(rid)) % (2**31))
    frames = jnp.asarray(rng.standard_normal(
        (1, min(cfg.max_source_len, 32), cfg.d_model)) * 0.02, jnp.float32)
    logits, state = _jitted(cfg, "prefill")(
        jp, {"frames": frames, "tokens": jnp.asarray(prompt[None])}, MAXC)
    assert "src_len" in state
    out = [int(jnp.argmax(logits[0]))]
    while len(out) < NEW:
        logits, state = _jitted(cfg, "decode_step")(
            jp, state, jnp.asarray([out[-1]], jnp.int32), MAXC)
        out.append(int(jnp.argmax(logits[0])))
    return out


@pytest.mark.parametrize("case", CASES)
def test_engine_matches_jax_engine(weights, case):
    ref = _run("jax", weights, case)
    out = _run("torch", weights, case)
    for key in ("events", "segments", "page_id_bound", "stats", "metrics"):
        assert out[key] == ref[key], key
    names = CASES[case][0]
    n = 3 * len(names)
    assert len(out["generated"]) == n
    assert all(len(g) == NEW for g in out["generated"].values())
    kinds = [k for _, k, _ in out["events"]]
    assert kinds.count("prefill") == n
    if case.endswith("pressure"):
        assert "remap" in kinds and out["stats"]["stream_bytes"] > 0
    else:
        assert "remap" not in kinds
    for rid, toks in out["generated"].items():
        if TENANTS[rid.split("-")[0]][0] == "whisper-medium":
            assert toks == _whisper_greedy(weights, rid, out["prompts"][rid])
        else:
            assert toks == ref["generated"][rid]
