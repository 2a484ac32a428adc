"""Seeded random weights, made by the benchmark on the device in the type
they are served in (the configuration's ``dtype``), and handed alike to the program and to the reference.

The tree has the layout the port's ``LM`` reads (the JAX layouts: ``wq``
[L, d, Hq, hd], the experts' ``w_in`` [L, E, d, f], every layer stacked on
a leading axis); ``serve.check_layout`` holds it against the port's specs.
The leaves of each type are views into one flat buffer filled by a few large
``normal_`` calls from one generator per tenant, then scaled by
1/sqrt(fan-in) leaf by leaf; the norms are ones and the router is f32, as
the port declares them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_CHUNK = 1 << 28
_ALIGN = 128          # elements: every leaf starts 256-byte aligned


def layout(port: Dict) -> Dict:
    """name path -> (shape, dtype, fan_in or "ones") of every leaf."""
    L, d, hq, hkv, hd, v = (port["num_layers"], port["d_model"],
                            port["num_heads"], port["num_kv_heads"],
                            port["head_dim"], port["vocab_size"])
    bf = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        port["dtype"]]
    f32 = torch.float32
    leaves = {
        ("embed",): ((v, d), bf, d),
        ("final_norm",): ((d,), f32, "ones"),
        ("out",): ((d, v), bf, d),
        ("blocks", 0, "norm1"): ((L, d), f32, "ones"),
        ("blocks", 0, "norm2"): ((L, d), f32, "ones"),
        ("blocks", 0, "mixer", "wq"): ((L, d, hq, hd), bf, d),
        ("blocks", 0, "mixer", "wk"): ((L, d, hkv, hd), bf, d),
        ("blocks", 0, "mixer", "wv"): ((L, d, hkv, hd), bf, d),
        ("blocks", 0, "mixer", "wo"): ((L, hq, hd, d), bf, hq * hd),
    }
    moe = port.get("moe")
    if moe:
        e, f = moe["num_experts"], moe["d_expert"]
        leaves[("blocks", 0, "ffn", "router")] = ((L, d, e), f32, d)
        leaves[("blocks", 0, "ffn", "w_in")] = ((L, e, d, f), bf, d)
        leaves[("blocks", 0, "ffn", "w_gate")] = ((L, e, d, f), bf, d)
        leaves[("blocks", 0, "ffn", "w_out")] = ((L, e, f, d), bf, f)
    else:
        f = port["d_ff"]
        leaves[("blocks", 0, "ffn", "w_in")] = ((L, d, f), bf, d)
        leaves[("blocks", 0, "ffn", "w_gate")] = ((L, d, f), bf, d)
        leaves[("blocks", 0, "ffn", "w_out")] = ((L, f, d), bf, f)
    return leaves


def stream_seed(seed: int, tenant: int) -> int:
    """The generator seed of ``tenant``'s weights under run seed ``seed``."""
    return (int(seed) * 2654435761 + 97 * tenant + 1) % (1 << 63)


def _fill(buf: torch.Tensor, gen: torch.Generator) -> None:
    flat = buf.view(-1)
    for lo in range(0, flat.numel(), _CHUNK):
        flat[lo:lo + _CHUNK].normal_(generator=gen)


def make(port: Dict, seed: int, tenant: int, device) -> Dict:
    """The weight tree of one tenant (nested dicts, ``blocks`` a 1-tuple
    holding the stacked layer, as the port's ``LM`` has it)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, tenant))
    leaves = layout(port)
    spans: List[Tuple[tuple, int, int]] = []
    total: Dict[torch.dtype, int] = {}
    for path, (shape, dt, init) in leaves.items():
        if init == "ones":
            continue
        n = math.prod(shape)
        spans.append((path, total.get(dt, 0), n))
        total[dt] = total.get(dt, 0) + -(-n // _ALIGN) * _ALIGN
    bufs = {dt: torch.empty(n, dtype=dt, device=device)
            for dt, n in total.items()}
    for dt in sorted(bufs, key=str):
        _fill(bufs[dt], gen)
    tree: Dict = {}
    for path, (shape, dt, init) in leaves.items():
        if init == "ones":
            t = torch.ones(shape, dtype=dt, device=device)
        else:
            lo, n = next((lo, n) for p, lo, n in spans if p == path)
            t = bufs[dt][lo:lo + n].view(shape)
            t.mul_(1.0 / math.sqrt(init))
        _put(tree, path, t)
    tree["blocks"] = (tree["blocks"][0],)
    return tree


def _put(tree: Dict, path: tuple, t: torch.Tensor) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = t


def leaf(tree: Dict, path: tuple) -> torch.Tensor:
    node = tree
    for key in path:
        node = node[key]
    return node
