"""Helpers of the port's fleet tests (``test_torch_fleet_hooks.py``,
``test_torch_cluster.py``, ``test_torch_simulator.py``): weights bridged
from the JAX package, and plain dumps of an engine's, a fleet's and a
metrics object's state that compare across the two packages with ``==``."""
import dataclasses
import math

import numpy as np

A = "llama3-8b"


def bridged(arch: str, layers: int, seed: int):
    """(JAX cfg, JAX params, port cfg, port params on the CPU): one set of
    weights, f32, converted leaf by leaf through numpy."""
    import jax

    import repro_torch.configs as tcfgs
    from repro.configs import ARCHS, scaled_config
    from repro.models import build_model
    from repro_torch.models import params_from_jax

    cfg = scaled_config(ARCHS[arch], num_layers=layers)
    jp = build_model(cfg).init(jax.random.PRNGKey(seed))
    tcfg = tcfgs.scaled_config(tcfgs.ARCHS[arch], num_layers=layers)
    return cfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")


def plain(x):
    """Dataclasses, containers and arrays as plain Python; NaN as a
    string, so that two NaN fields compare equal."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    return x


def trie(idx):
    """Every node of a ``PrefixIndex`` in depth-first order of insertion:
    block, page, refs, LRU stamp, content key and insertion sequence."""
    out, stack = [], sorted(idx.root.children.values(),
                            key=lambda n: -n.seq)
    while stack:
        nd = stack.pop()
        out.append((nd.block, nd.page, nd.refs, nd.last_use, nd.key,
                    nd.seq, nd.parent.seq))
        stack.extend(sorted(nd.children.values(), key=lambda n: -n.seq))
    return out


def allocator(a):
    return {"free": list(a.free_list), "refs": dict(a.refs),
            "cached": sorted(a.cached), "seq_pages": dict(a.seq_pages),
            "seq_tokens": dict(a.seq_tokens),
            "seq_shared": dict(a.seq_shared),
            "segments": [(s.start, s.num_pages, s.source)
                         for s in a.segments]}


def engine(eng):
    """What the port's engine must share with the JAX engine: tokens,
    events, the allocator's pages, every prefix index, the step clock,
    TransferStats and ServingMetrics."""
    return {"generated": {r.rid: list(r.generated) for r in eng.finished},
            "events": list(eng.events), "step": eng.step_idx,
            "allocator": allocator(eng.allocator),
            "tries": {n: trie(i) for n, i in eng.prefix.items()},
            "stats": plain(eng.xfer.stats),
            "metrics": plain(eng.metrics())}
