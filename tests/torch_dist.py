"""Inputs and rank functions of ``tests/test_torch_distributed_decode.py``:
the distributed flash-decode and ``Attention.fwd_dec`` on a ``DeviceMesh``
of gloo ranks on the CPU. This module imports no JAX, so that the spawned
ranks start from torch alone."""
from __future__ import annotations

import warnings

import numpy as np

# name -> (B, S, window, q_pos): B=1 (kv_seq_full: the sequence over every
# axis; from position 40 on the last ranks' slices hold no valid key), B=4
# (the batch over "data" on a 2 x 2 mesh, the sequence over "model"), and a
# sliding window
CASES = {"b1_full": (1, 64, 0, [40]),
         "b4_batch": (4, 32, 0, [31, 5, 17, 0]),
         "window": (2, 64, 24, [63, 40])}
HQ, HKV, D = 4, 2, 16
# fwd_dec: name -> (the dense cache's length, each row's position, rule
# overrides). 32 splits over every mesh; 34 over "model" on (1, 2) and over
# "data" alone on (2, 2) (4 does not divide it); 31 over no axis, and rules
# that map kv_seq to no axis keep the sequence whole: those two decode
# locally on every rank, as the reference does
FWD_CASES = {"fwd_b1": (32, [20], {}),
             "fwd_b4": (32, [31, 3, 16, 9], {}),
             "fwd_b1_partial": (34, [33], {}),
             "fwd_b2_whole": (31, [30, 7], {}),
             "fwd_b4_rules": (32, [31, 3, 16, 9], {"kv_seq": []})}


def fwd_cfg():
    from repro_torch.configs import ARCHS, scaled_config
    return scaled_config(ARCHS["llama3-8b"], num_layers=1)


def make_inputs(seed: int = 0) -> dict:
    """Every case's arrays (f32 values, int32 positions, bool validity),
    keyed "case/name", from one numpy generator."""
    rng = np.random.default_rng(seed)
    z = {}
    for name, (b, s, _w, qp) in CASES.items():
        z[f"{name}/q"] = rng.standard_normal((b, HQ, D), np.float32)
        for n in ("k", "v"):
            z[f"{name}/{n}"] = rng.standard_normal((b, s, HKV, D), np.float32)
        z[f"{name}/q_pos"] = np.asarray(qp, np.int32)
        kv_pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
        z[f"{name}/kv_pos"] = kv_pos
        z[f"{name}/kv_valid"] = kv_pos <= z[f"{name}/q_pos"][:, None]
    cfg = fwd_cfg()
    from repro_torch.models.blocks import Attention
    for w, spec in Attention().specs(cfg).items():
        z[f"params/{w}"] = (0.05 * rng.standard_normal(spec.shape)).astype(
            np.float32)
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    for name, (cache, pos, _rules) in FWD_CASES.items():
        b = len(pos)
        z[f"{name}/x"] = rng.standard_normal((b, cfg.d_model), np.float32)
        for n in ("k", "v"):
            z[f"{name}/{n}"] = rng.standard_normal((b, cache, hkv, hd),
                                                   np.float32)
        z[f"{name}/pos"] = np.asarray(pos, np.int32)
        kv_pos = np.tile(np.arange(cache, dtype=np.int32), (b, 1))
        z[f"{name}/kv_pos"] = kv_pos
        z[f"{name}/kv_valid"] = kv_pos <= z[f"{name}/pos"][:, None]
    return z


def fwd_dec(z: dict, name: str, rows=slice(None), seq=slice(None)):
    """``Attention.fwd_dec`` of case ``name`` on the CPU: x, pos, slot,
    the state and kv_pos/kv_valid cut to ``rows``, the state and kv_pos/
    kv_valid to ``seq`` (``cache_len`` the whole cache's, ``batch`` the
    whole batch). Returns (y of the rows, the state's k, v) as numpy
    arrays."""
    import torch
    from repro_torch.models.blocks import Attention
    t = {k: torch.from_numpy(np.array(v)) for k, v in z.items()
         if k.startswith((name + "/", "params/"))}
    p = {k.split("/")[1]: v for k, v in t.items() if k.startswith("params/")}
    state = {n: t[f"{name}/{n}"][rows, seq].contiguous() for n in ("k", "v")}
    pos = t[f"{name}/pos"][rows]
    shared = {"pos": pos, "slot": pos, "cache_len": FWD_CASES[name][0],
              "batch": len(FWD_CASES[name][1]),
              "kv_pos": t[f"{name}/kv_pos"][rows, seq],
              "kv_valid": t[f"{name}/kv_valid"][rows, seq]}
    y, _ = Attention().fwd_dec(p, t[f"{name}/x"][rows], state, shared,
                               fwd_cfg())
    return y.numpy(), state["k"].numpy(), state["v"].numpy()


def decode_rank(rank: int, inputs: str, out: str) -> None:
    """One gloo rank on the CPU: every case of ``CASES`` through
    ``distributed_decode_attention`` on the host mesh of (1, 2) ranks (2 in
    the world) or (2, 2) (4), then ``fwd_dec`` under that mesh and each
    case's rules; the mesh functions' layouts beside. Writes this rank's
    outputs with their row and sequence spans and their kv axes to
    ``out`` % rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (MeshLayout, ShardingRules,
                                                  mesh_context)
    from repro_torch.launch import mesh as lm
    from repro_torch.models.attention_ops import distributed_decode_attention
    from repro_torch.models.blocks import decode_cache_slices, decode_layout
    world = dist.get_world_size()
    host = lm.make_host_mesh("cpu")
    res = {"host_shape": np.asarray(host.shape),
           "host_names": np.asarray(host.mesh_dim_names)}
    try:
        lm.make_production_mesh(device_type="cpu")
    except ValueError as e:
        res["production_error"] = np.asarray(str(e))
    mesh = lm.make_mesh(MeshLayout(("data", "model"), (world // 2, 2)),
                        "cpu")
    z = dict(np.load(inputs))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for name, (b, s, window, _qp) in CASES.items():
            t = {n: torch.from_numpy(z[f"{name}/{n}"])
                 for n in ("q", "k", "v", "q_pos", "kv_pos", "kv_valid")}
            kv_axes, batch_axes = decode_layout(mesh, b, s)
            rows, seq = decode_cache_slices(mesh, b, s)
            o = distributed_decode_attention(
                mesh, kv_axes, t["q"][rows], t["k"][rows, seq],
                t["v"][rows, seq], t["q_pos"][rows], t["kv_pos"][rows, seq],
                t["kv_valid"][rows, seq], window=window)
            res[f"{name}/out"] = o.numpy()
            res[f"{name}/axes"] = np.asarray(
                [",".join(kv_axes), ",".join(batch_axes)])
            res[f"{name}/rows"] = np.asarray([rows.start, rows.stop])
        for name, (cache, pos, rules) in FWD_CASES.items():
            with mesh_context(mesh, ShardingRules.make(**rules)):
                rows, seq = decode_cache_slices(mesh, len(pos), cache)
                kv_axes, _ = decode_layout(mesh, len(pos), cache)
                y, k, v = fwd_dec(z, name, rows, seq)
            res.update({f"{name}/y": y, f"{name}/k": k, f"{name}/v": v,
                        f"{name}/rows": np.asarray([rows.start, rows.stop]),
                        f"{name}/seq": np.asarray([seq.start, seq.stop]),
                        f"{name}/axes": np.asarray(",".join(kv_axes))})
    np.savez(out % rank, **res)


def gather_cache(parts: list, name: str, n: str) -> np.ndarray:
    """The whole [batch, cache, ...] cache ``n`` of case ``name`` put
    together from the ranks' slices (each rank's ``{name}/{n}`` at its
    rows and span); ranks that hold the same span must hold the same
    values."""
    cache, pos, _rules = FWD_CASES[name]
    first = parts[0][f"{name}/{n}"]
    out = np.full((len(pos), cache) + first.shape[2:], np.nan, np.float32)
    for p in parts:
        r, s = p[f"{name}/rows"], p[f"{name}/seq"]
        block = out[r[0]:r[1], s[0]:s[1]]
        if not np.isnan(block).all():
            np.testing.assert_array_equal(block, p[f"{name}/{n}"])
        block[...] = p[f"{name}/{n}"]
    return out

