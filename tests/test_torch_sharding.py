"""The port's sharding rules against the JAX package's: every resolution case
of ``tests/test_sharding.py`` (the divisibility fallback, axis reuse,
multi-axis FSDP, ``kv_seq_full`` at batch 1, the property over random
shapes, the 512-device production layouts), ``serving_shard_degrees`` for
every architecture, the warn-once registry, the ambient mesh context and
the decode-cache layout of the model blocks. Both packages resolve against the same name-and-size mesh."""
import sys
import warnings
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).parent))
from hypcompat import given, settings, st  # noqa: E402

import repro.distributed.sharding as jsh  # noqa: E402
import repro.models.blocks as jblocks  # noqa: E402
from repro.configs import ARCHS  # noqa: E402

import repro_torch.distributed.sharding as tsh  # noqa: E402
import repro_torch.models.blocks as tblocks  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402


class FakeMesh:
    """Just enough Mesh interface for spec_for (axis names + sizes)."""
    def __init__(self, sizes):
        self._sizes = dict(sizes)
        self.axis_names = tuple(self._sizes)

    @property
    def shape(self):
        return self._sizes


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
RULES = {"train": (jsh.DEFAULT_RULES, tsh.DEFAULT_RULES),
         "serving": (jsh.SERVING_RULES, tsh.SERVING_RULES)}


def _both(logicals, shape, mesh, profile="train"):
    """(JAX spec as a tuple, the port's spec) on one mesh; the port also
    on the ``MeshLayout`` of the same names and sizes."""
    jr, tr = RULES[profile]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = tuple(jsh.spec_for(logicals, shape, mesh, jr))
        got = tsh.spec_for(logicals, shape, mesh, tr)
        layout = tsh.MeshLayout(tuple(mesh.shape), tuple(mesh.shape.values()))
        assert tsh.spec_for(logicals, shape, layout, tr) == got
    return ref, got


CASES = {
    "gqa_kv_heads_fallback": (("embed", "kv_heads", None), (4096, 8, 128),
                              MESH),
    "axis_reuse": (("vocab", "heads"), (163840, 64), MESH),
    "multi_axis_fsdp": (("experts", "embed", None), (384, 7168, 2048), MESH3),
    "kv_seq_full_batch_one": (("batch", "kv_seq_full", None, None),
                              (1, 524288, 8, 128), MESH3),
    "kv_seq_batch_eight": (("batch", "kv_seq", None, None),
                           (8, 32768, 8, 128), MESH3),
    "expert_mlp": (("experts", "expert_mlp", "expert_ff"),
                   (96, 7168, 2048), MESH3),
    "nothing_divides": (("batch", "heads", "mlp"), (3, 5, 7), MESH3),
}


@pytest.mark.parametrize("profile", sorted(RULES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_cases_match_jax(case, profile):
    ref, got = _both(*CASES[case], profile=profile)
    assert got == ref
    if case == "gqa_kv_heads_fallback" and profile == "train":
        assert got == ("data",)
    if case == "kv_seq_full_batch_one":
        assert got[0] is None and set(got[1]) == {"pod", "data", "model"}


@settings(max_examples=50, deadline=None)
@given(
    dims=st.lists(st.sampled_from([1, 2, 7, 8, 16, 64, 100, 4096]),
                  min_size=1, max_size=4),
    logicals=st.lists(st.sampled_from(
        ["batch", "embed", "heads", "kv_heads", "mlp", "vocab", "experts",
         "kv_seq", "kv_seq_full", None]), min_size=1, max_size=4),
)
def test_spec_property_matches_jax(dims, logicals):
    """Any (shape, logical) combination resolves to the same spec in both
    packages, and the port's divides the dims and never reuses an axis."""
    n = min(len(dims), len(logicals))
    dims, logicals = dims[:n], logicals[:n]
    ref, got = _both(logicals, dims, MESH3)
    assert got == ref
    used = []
    for dim, part in zip(dims, got + (None,) * (n - len(got))):
        axes = () if part is None else (
            part if isinstance(part, tuple) else (part,))
        size = 1
        for ax in axes:
            assert ax not in used
            used.append(ax)
            size *= MESH3.shape[ax]
        assert dim % size == 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_serving_shard_degrees_match_jax(arch):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for shards in (1, 2, 4, 8, 16):
            ref = jsh.serving_shard_degrees(ARCHS[arch], shards)
            got = tsh.serving_shard_degrees(TARCHS[arch], shards)
            assert vars(got) == vars(ref), shards
            if shards == 1:
                assert vars(got) == vars(tsh.ShardDegrees(1))


def test_drop_warning_fires_once_per_axis_and_mesh():
    """The same (axis, mesh) drop warns once in both packages; another mesh
    or another logical axis warns again."""
    counts = []
    for pkg in (jsh, tsh):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            for sizes in ({"data": 5, "model": 40}, {"data": 5, "model": 40},
                          {"data": 3, "model": 40}):
                pkg.spec_for(("kv_heads", None), (8, 64), FakeMesh(sizes))
            pkg.spec_for(("heads", None), (12, 64),
                         FakeMesh({"data": 5, "model": 40}))
            pkg.serving_shard_degrees(ARCHS["llama3-8b"], 40)
            pkg.serving_shard_degrees(ARCHS["llama3-8b"], 40)
        counts.append([str(x.message) for x in w
                       if issubclass(x.category, RuntimeWarning)])
    assert counts[1] == counts[0]
    # kv_heads on two meshes, heads on the first; the 40-way degrees drop
    # heads, kv_heads, mlp and vocab once (the second lowering is silent)
    assert len(counts[1]) == 2 + 1 + 4
    assert "40" in counts[1][0]


def test_mesh_helpers_and_context_match_jax():
    for mesh in (MESH, MESH3, FakeMesh({"model": 4})):
        for fn in ("batch_axis_names", "num_data_shards", "model_axis_size"):
            assert getattr(tsh, fn)(mesh) == getattr(jsh, fn)(mesh), fn
    assert tsh.get_mesh() is None and tsh.get_rules() is tsh.DEFAULT_RULES
    with tsh.mesh_context(MESH3, tsh.SERVING_RULES) as m:
        assert m is MESH3 and tsh.get_mesh() is MESH3
        assert tsh.get_rules() is tsh.SERVING_RULES
        x = object()
        assert tsh.with_sharding_constraint(x, ("batch",)) is x
    assert tsh.get_mesh() is None and tsh.get_rules() is tsh.DEFAULT_RULES
    assert tsh.ShardingRules.make(kv_seq=("data",)).lookup("kv_seq") == \
        jsh.ShardingRules.make(kv_seq=("data",)).lookup("kv_seq")


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 2},
                                   {"data": 2, "model": 2},
                                   {"data": 2, "model": 1},
                                   {"pod": 2, "data": 16, "model": 16}])
def test_decode_cache_axes_match_jax(sizes):
    """``decode_layout`` gives the reference's state layout for every
    batch and cache length, which the port's ``fwd_dec`` follows: the
    axes that split the sequence and the rows of the cache its
    ``init_state`` specifies; where the reference flash-decodes, those
    are the kv and batch axes its ``fwd_dec`` takes (``_kv_shard_axes``,
    ``_batch_shard_axes``)."""
    mesh = FakeMesh(sizes)
    cfg = ARCHS["llama3-8b"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for b in (1, 2, 3, 4, 8):
            for s in (31, 34, 48, 64, 1000, 4096, 131072):
                shape = (b, s, 8, 128)
                kv = jblocks._kv_shard_axes(mesh, shape)
                ba = jblocks._batch_shard_axes(mesh, b, kv)
                st = jblocks.Attention().init_state(cfg, b, s)["k"]
                spec = jsh.spec_for(st.logical, shape, mesh, jsh.DEFAULT_RULES)
                want = (tsh.spec_axes(spec, 1), tsh.spec_axes(spec, 0))
                assert tblocks.decode_layout(mesh, b, s) == want, (b, s)
                if kv:
                    assert want == (kv, ba), (b, s)


@pytest.mark.parametrize("cache,rules", [(31, {}), (32, {"kv_seq": ()})])
def test_fwd_dec_decodes_locally_where_the_mesh_keeps_the_cache_whole(
        cache, rules):
    """Under a mesh whose model axis is 2, a cache that no axis splits (a
    length 2 does not divide, or rules that map kv_seq to no axis) stays
    whole on the rank and decodes locally, as the reference's ``fwd_dec``
    does: output and cache equal those without a mesh. ``fwd_dec`` refuses
    a state without ``cache_len``, and one that is not the rank's slice."""
    import torch
    from repro_torch.configs import scaled_config
    cfg = scaled_config(TARCHS["llama3-8b"], num_layers=1)
    gen = torch.Generator().manual_seed(0)
    attn = tblocks.Attention()
    p = {w: 0.05 * torch.randn(spec.shape, generator=gen)
         for w, spec in attn.specs(cfg).items()}
    b, hkv, hd = 2, cfg.num_kv_heads, cfg.resolved_head_dim
    x = torch.randn(b, cfg.d_model, generator=gen)
    k, v = (torch.randn(b, cache, hkv, hd, generator=gen) for _ in range(2))
    pos = torch.tensor([cache - 1, 7], dtype=torch.int32)
    kv_pos = torch.arange(cache, dtype=torch.int32)[None].expand(b, cache)
    shared = {"pos": pos, "slot": pos, "kv_pos": kv_pos,
              "kv_valid": kv_pos <= pos[:, None]}
    ref = {"k": k.clone(), "v": v.clone()}
    y_ref, _ = attn.fwd_dec(p, x, ref, shared, cfg)
    state = {"k": k.clone(), "v": v.clone()}
    with warnings.catch_warnings(), tsh.mesh_context(
            FakeMesh({"data": 1, "model": 2}),
            tsh.ShardingRules.make(**rules)):
        warnings.simplefilter("ignore", RuntimeWarning)
        with pytest.raises(ValueError, match="cache_len"):
            attn.fwd_dec(p, x, state, shared, cfg)
        with pytest.raises(ValueError, match="slice"):
            attn.fwd_dec(p, x, {"k": k[:, 1:], "v": v[:, 1:]},
                         dict(shared, cache_len=cache), cfg)
        y, _ = attn.fwd_dec(p, x, state, dict(shared, cache_len=cache), cfg)
    assert torch.equal(y, y_ref)
    assert torch.equal(state["k"], ref["k"])
    assert torch.equal(state["v"], ref["v"])
