"""The port's distributed flash-decode on gloo ranks on the CPU against the
JAX package's on 4 forced host devices.

One spawn of 2 ranks (mesh (1, 2)) and one of 4 (mesh (2, 2)), each with
every case inside, meet through a file store in a temporary directory
(``launch.mesh.spawn_ranks``); one JAX subprocess, which alone sets
``XLA_FLAGS`` for its 4 host devices, runs the same seeded inputs through
``distributed_decode_attention`` under shard_map on a (2, 2) mesh, through
single-device ``decode_attention``, and through ``Attention.fwd_dec``
under that mesh's context. The cases: B=1 with the sequence over every
axis (``kv_seq_full``; some ranks' slices hold no valid key), B=4 with the
batch over "data", a sliding window. f32 throughout, held within 1e-5.
``fwd_dec`` under a mesh (on each rank's rows) must also equal the port's
own on one rank: its output within 1e-5, the cache the ranks' slices make
up exactly; beside
caches split over every axis, one split partly (over "data" alone) and
two that stay whole (a length no axis divides, rules that map kv_seq to
no axis), which decode locally as the reference's do."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist as td  # noqa: E402

from repro_torch.launch.mesh import host_layout, spawn_ranks  # noqa: E402
from repro_torch.models import attention_ops as tops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
WORLDS = (2, 4)

JAX_SNIPPET = r"""
import json, sys, warnings
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import ARCHS, scaled_config
from repro.distributed.sharding import ShardingRules, mesh_context
from repro.launch.mesh import make_auto_mesh
from repro.models import attention_ops as aops
from repro.models import blocks
warnings.simplefilter("ignore", RuntimeWarning)
assert len(jax.devices()) == 4, jax.devices()
z = dict(np.load(sys.argv[1]))
cases = json.loads(sys.argv[3])
mesh = make_auto_mesh((2, 2), ("data", "model"))
out = {}
for name, (b, s, window, _qp) in cases["decode"].items():
    a = {n: jnp.asarray(z[f"{name}/{n}"])
         for n in ("q", "k", "v", "q_pos", "kv_pos", "kv_valid")}
    kv = blocks._kv_shard_axes(mesh, a["k"].shape)
    ba = blocks._batch_shard_axes(mesh, b, kv)
    out[f"{name}/dist"] = np.asarray(aops.distributed_decode_attention(
        mesh, kv, a["q"], a["k"], a["v"], a["q_pos"], a["kv_pos"],
        a["kv_valid"], window=window, batch_axes=ba))
    out[f"{name}/single"] = np.asarray(aops.decode_attention(
        a["q"], a["k"], a["v"], a["q_pos"], a["kv_pos"], a["kv_valid"],
        window=window))
    out[f"{name}/axes"] = np.asarray([",".join(kv), ",".join(ba)])
cfg = scaled_config(ARCHS["llama3-8b"], num_layers=1)
p = {k.split("/")[1]: jnp.asarray(v) for k, v in z.items()
     if k.startswith("params/")}
for name, rules in cases["fwd"].items():
    with mesh_context(mesh, ShardingRules.make(**rules)):
        pos = jnp.asarray(z[f"{name}/pos"])
        shared = {"pos": pos, "slot": pos,
                  "kv_pos": jnp.asarray(z[f"{name}/kv_pos"]),
                  "kv_valid": jnp.asarray(z[f"{name}/kv_valid"])}
        state = {n: jnp.asarray(z[f"{name}/{n}"]) for n in ("k", "v")}
        y, st = blocks.Attention().fwd_dec(p, jnp.asarray(z[f"{name}/x"]),
                                           state, shared, cfg)
        out[f"{name}/axes"] = np.asarray(",".join(
            blocks._kv_shard_axes(mesh, state["k"].shape)))
    out[f"{name}/y"] = np.asarray(y)
    out[f"{name}/k"] = np.asarray(st["k"])
    out[f"{name}/v"] = np.asarray(st["v"])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns and the JAX subprocess (started first, run beside them):
    {"inputs", "jax", world: [each rank's results]}."""
    tmp = tmp_path_factory.mktemp("dist_decode")
    z = td.make_inputs(0)
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **z)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    cases = json.dumps({"decode": td.CASES,
                        "fwd": {name: rules for name, (_c, _p, rules)
                                in td.FWD_CASES.items()}})
    jax_out = str(tmp / "jax.npz")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SNIPPET, inputs, jax_out, cases],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    res = {"inputs": z}
    try:
        for world in WORLDS:
            out = str(tmp / f"w{world}_rank%d.npz")
            spawn_ranks(td.decode_rank, world, inputs, out)
            res[world] = [dict(np.load(out % r)) for r in range(world)]
    finally:
        log, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, log[-3000:]
    res["jax"] = dict(np.load(jax_out))
    return res


def _gathered(parts, name):
    """The whole batch's output: each row block from the rank that holds
    it; every rank of a block holds the same rows."""
    b = td.CASES[name][0]
    out = np.full((b, td.HQ, td.D), np.nan, np.float32)
    for p in parts:
        r0, r1 = p[f"{name}/rows"]
        if np.isnan(out[r0:r1]).all():
            out[r0:r1] = p[f"{name}/out"]
        else:
            np.testing.assert_array_equal(out[r0:r1], p[f"{name}/out"])
    return out


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(td.CASES))
def test_distributed_decode_matches_jax(runs, case, world):
    ref = runs["jax"]
    got = _gathered(runs[world], case)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, ref[f"{case}/dist"], atol=TOL, rtol=0)
    np.testing.assert_allclose(got, ref[f"{case}/single"], atol=TOL, rtol=0)
    # the port's single-device decode on the same inputs
    z = runs["inputs"]
    t = {n: torch.from_numpy(z[f"{case}/{n}"])
         for n in ("q", "k", "v", "q_pos", "kv_pos", "kv_valid")}
    one = tops.decode_attention(t["q"], t["k"], t["v"], t["q_pos"],
                                t["kv_pos"], t["kv_valid"],
                                window=td.CASES[case][2]).numpy()
    np.testing.assert_allclose(got, one, atol=TOL, rtol=0)
    # the 2 x 2 mesh splits as the reference's shard_map does
    if world == 4:
        assert list(runs[4][0][f"{case}/axes"]) == list(ref[f"{case}/axes"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(td.FWD_CASES))
def test_fwd_dec_under_a_mesh_matches_one_rank_and_jax(runs, case, world):
    z, ref, parts = runs["inputs"], runs["jax"], runs[world]
    # one rank, no mesh, on each block of rows a rank holds (the rows'
    # projections then round as the mesh's do)
    b = len(td.FWD_CASES[case][1])
    y1, k1, v1 = td.fwd_dec(z, case)
    for r0, r1 in {tuple(p[f"{case}/rows"]) for p in parts}:
        y1[r0:r1], k1[r0:r1], v1[r0:r1] = td.fwd_dec(z, case,
                                                     slice(r0, r1))[:3]
    for p in parts:                              # each rank's rows
        r0, r1 = p[f"{case}/rows"]
        np.testing.assert_allclose(p[f"{case}/y"], y1[r0:r1], atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(p[f"{case}/y"], ref[f"{case}/y"][r0:r1],
                                   atol=TOL, rtol=0)
    for n, whole in (("k", k1), ("v", v1)):
        cache = td.gather_cache(parts, case, n)
        np.testing.assert_array_equal(cache, whole)
        np.testing.assert_allclose(cache, ref[f"{case}/{n}"], atol=TOL,
                                   rtol=0)
    # the new row landed: each row's slot differs from the input cache
    rows = np.arange(b)
    pos = z[f"{case}/pos"]
    assert (k1[rows, pos] != z[f"{case}/k"][rows, pos]).all()
    # the route: the reference's kv axes on the 2 x 2 mesh; a cache that
    # no axis splits stays whole on every rank
    if world == 4:
        assert str(parts[0][f"{case}/axes"]) == str(ref[f"{case}/axes"])
    if case in ("fwd_b2_whole", "fwd_b4_rules"):
        assert all(str(p[f"{case}/axes"]) == "" for p in parts)
        assert all(list(p[f"{case}/seq"]) == [0, td.FWD_CASES[case][0]]
                   for p in parts)


@pytest.mark.parametrize("world", WORLDS)
def test_host_and_production_meshes_on_ranks(runs, world):
    layout = host_layout(world)
    for p in runs[world]:
        assert tuple(p["host_shape"]) == layout.sizes
        assert tuple(p["host_names"]) == layout.axis_names
        assert f"the world holds {world}" in str(p["production_error"])
