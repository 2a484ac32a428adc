"""The port's copy of the closed-form cost model against the JAX package's:
``cost_for`` (train, prefill and decode, at the data-shard counts of the
host, single-pod and multi-pod meshes and every remat policy) and the
collective terms, equal to the last bit for every (arch x shape) cell that
``shape_applicable`` admits."""
import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs.registry import shape_applicable  # noqa: E402
from repro.distributed import analytic_cost as jac  # noqa: E402

from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig as TShape  # noqa: E402
from repro_torch.configs.registry import (  # noqa: E402
    shape_applicable as t_shape_applicable,
)
from repro_torch.distributed import analytic_cost as tac  # noqa: E402

CELLS = [(arch, shape.name) for arch in sorted(ARCHS) for shape in SHAPES
         if shape_applicable(ARCHS[arch], shape)[0]]
SHAPE = {s.name: s for s in SHAPES}


def _t_shape(shape):
    return TShape(**dataclasses.asdict(shape))


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_cost_for_matches_jax(arch, shape):
    js, ts = SHAPE[shape], _t_shape(SHAPE[shape])
    jcfg, tcfg = ARCHS[arch], TARCHS[arch]
    assert t_shape_applicable(tcfg, ts) == shape_applicable(jcfg, js)
    kws = [{}]
    if js.kind == "train":
        kws = [{"remat_policy": p} for p in ("none", "dots_saveable", "full")]
    for data_shards in (1, 16, 32):
        for kw in kws:
            ref = jac.cost_for(jcfg, js, data_shards, **kw)
            got = tac.cost_for(tcfg, ts, data_shards, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)
            assert (got.total_flops, got.total_bytes, got.useful_fraction) \
                == (ref.total_flops, ref.total_bytes, ref.useful_fraction)
    # the collective terms at this cell's tokens: one per sequence at
    # decode, the whole prompt at prefill and train
    tokens = js.global_batch * (1 if js.kind == "decode" else js.seq_len)
    for shards in (1, 2, 4, 8, 16):
        for fn in ("decode_collective_bytes", "prefill_collective_bytes"):
            assert getattr(tac, fn)(tcfg, tokens, shards) == \
                getattr(jac, fn)(jcfg, tokens, shards), (fn, shards)
