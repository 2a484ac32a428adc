"""Multi-pod dry run (PyTorch counterpart of ``repro.launch.dryrun``): one
step of every (architecture x shape) cell as rank 0 of the production
meshes, on fake tensors, with its memory, FLOPs and collectives recorded in
the reference's artifact schema.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k --mesh multi_pod --force
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape decode_32k \\
      --remap-tier 0.25

Artifacts land in artifacts/dryrun_torch/<mesh>/<arch>__<shape>[...].json
(the reference's tags), which ``benchmarks/roofline.py`` reads with
``--dir artifacts/dryrun_torch``.

A cell joins a fake process group (``torch.testing``'s ``FakeStore``,
backend "fake": every collective returns at once) as rank 0 of the
mesh's 256 (``single_pod``) or 512 (``multi_pod``) ranks, builds the
``DeviceMesh`` of ``launch.mesh.production_layout`` on the CPU, makes the
rank's blocks of its arguments as fake tensors (shapes and dtypes, no
data) and runs one step on them inside ``mesh_context``. A train cell:
the params, the optimizer state (``opt_shardings``) and the batch
(``batch_shardings``; the reference's ``abstract_params``,
``opt_shardings`` and ``abstract_inputs``) through one
``make_train_step`` step. A prefill cell: the params and the prompt batch
through ``Model.prefill``; a decode cell: the params, the decode state
(``Model.decode_state_shardings``, the reference's
``abstract_decode_state``) and one token a row through
``Model.decode_step``. ``--remap-tier`` decodes at a MIRAGE tier: the
rank's blocks split into a resident and a cycle stack
(``core.transfer_engine.tier_split``, the reference's
``_lower_remap_decode`` plan), the cycle repeats fetched each step; an
enc-dec config remaps its cross K/V instead (``cross_kv_to_host``, the
reference's ``_lower_cross_kv_remap``). A kernel cannot run on a fake
tensor, so the dispatchers take the plain versions, as on any CPU tensor
(``"lowering": "torch-fake-cpu"``); the reference's dry run is a CPU tool
as well.

What a record holds: ``memory.argument_bytes``, the exact bytes of the
rank's arguments (a remap cell's cycle stack included: on a card it lies
in pinned host memory, which the reference's CPU analysis cannot see
either; ``mirage`` holds its bytes); ``temp_bytes``, the peak of the fake
storage the step allocates and holds at once; ``alias_bytes``, what the
step updates in place (the train state; the decode state, the
reference's donated argument); ``output_bytes``, what it returns; the
host and code fields 0. ``cost_analysis_raw``: the FLOPs of
``torch.utils.flop_counter``'s formulas and the bytes every op reads and
writes (each tensor argument and result once a call). ``collectives``:
``distributed.hlo_analysis``'s statistics of the step. ``analytic``:
``distributed.analytic_cost.cost_for``. ``mirage`` (remap cells): the
reference's extras, ``alpha``, ``m``, ``cycle_bytes_per_device`` and
``resident_bytes_per_device`` (and ``cross_kv_host_bytes_per_device``).

``--profile``: the reference's rule sets (``profile_rules``): ``train``
(FSDP x TP), ``serving`` (TP-only dense weights), ``train-ef`` (the
experts' d_ff FSDP-split) and ``head-tp`` (the serving rules with head_dim
split over "model" and the heads whole, the reference's variant for
xlstm's 4 heads: the blocks gather q and k over head_dim where they
contract over it). ``main`` exits 0 when no cell fails.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import (
    ARCHS, SHAPES, SHAPES_BY_NAME, get_arch, shape_applicable,
)
from repro_torch.distributed import collectives
from repro_torch.distributed.analytic_cost import cost_for
from repro_torch.distributed.hlo_analysis import collective_stats
from repro_torch.distributed.sharding import (
    DEFAULT_RULES, SERVING_RULES, ShardingRules, axis_sizes, mesh_context,
    mesh_group, num_data_shards,
)
from repro_torch.launch.mesh import make_mesh, production_layout
from repro_torch.launch.shardings import batch_shardings
from repro_torch.models import build_model
from repro_torch.core.transfer_engine import (
    cross_kv_to_host, make_fetch, tier_split,
)
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.training import (
    OptimizerConfig, make_optimizer, make_train_step,
)

ARTIFACT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")


def pick_optimizer(cfg) -> str:
    return "adafactor" if cfg.param_count() > 15e9 else "adamw"


def auto_microbatches(cfg, shape, mesh, carry_budget: float = 4 * 2**30) -> int:
    """Smallest power-of-two microbatch count keeping the remat carry
    (activations at layer boundaries) under ``carry_budget`` a rank."""
    shards = num_data_shards(mesh)
    tokens_dev = shape.global_batch * shape.seq_len / max(shards, 1)
    layers = cfg.num_layers + cfg.num_encoder_layers
    carry = tokens_dev * cfg.d_model * 2 * layers
    mb = 1
    while carry / mb > carry_budget and mb < shape.global_batch // shards:
        mb *= 2
    return mb


@contextlib.contextmanager
def fake_world(size: int):
    """This process as rank 0 of a fake process group of ``size`` ranks
    (every collective returns at once, its output left as it is), torn
    down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is up already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def profile_rules(profile: str) -> ShardingRules:
    """The rule set of a dry-run ``--profile`` (the reference's
    ``lower_cell``)."""
    if profile == "serving":
        return SERVING_RULES
    if profile == "train-ef":
        # the reference's variant: FSDP the per-expert d_ff dim instead of
        # d_model
        return ShardingRules.make(expert_ff=("pod", "data"), expert_mlp=())
    if profile == "head-tp":
        # the reference's variant (xlstm): 4 heads do not split over a
        # model axis of 16, so head_dim (512) splits over it instead
        return ShardingRules.make(profile="serving", head_dim=("model",),
                                  heads=())
    return DEFAULT_RULES


def _warm_groups(mesh) -> None:
    """Make the process group over every subset of the mesh's axes now:
    ``mesh_group`` reads the mesh's rank tensor, which would be a fake
    tensor under ``FakeTensorMode``."""
    names = tuple(mesh.mesh_dim_names)
    for n in range(2, len(names) + 1):
        for axes in itertools.combinations(names, n):
            mesh_group(mesh, axes)


def _fake(shape, dtype) -> torch.Tensor:
    """A tensor of ``shape`` (under ``FakeTensorMode``: no data)."""
    return torch.zeros(shape, dtype=dtype)


def _fake_tree(specs, shardings):
    """The rank's block of every leaf of a Spec tree under its sharding."""
    return tree_map(lambda s, sh: _fake(sh.local_shape(s.shape), s.dtype),
                    specs, shardings)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _tensors(x):
    """The tensors in an op's arguments or results (nested lists and
    tuples)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


class _Meter(TorchDispatchMode):
    """One pass over the step's ops: their FLOPs (``torch.utils.
    flop_counter``'s formulas, as ``FlopCounterMode`` counts them), the
    bytes every op reads and writes, and the bytes of the storage that ops
    allocate and that is alive at once (its peak)."""

    def __init__(self):
        super().__init__()
        self.flops = self.live = self.peak = self.op_bytes = 0
        self._seen = WeakIdKeyDictionary()

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        for t in _tensors(args) + _tensors(list(kwargs.values())) + outs:
            self.op_bytes += t.numel() * t.element_size()
        for t in outs:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)
        return out


def abstract_state(model, shape, mesh, rules=DEFAULT_RULES):
    """The rank's blocks of a train cell's state on ``mesh`` (a
    ``DeviceMesh`` or a ``MeshLayout``) under ``rules``: (params, the
    optimizer (``pick_optimizer``), its state, the batch's shardings, the
    batch), each block of the shape its sharding gives. Made under
    ``FakeTensorMode`` they hold no data: the reference's
    ``abstract_params``, ``opt_shardings`` and ``abstract_inputs``."""
    ps = model.param_shardings(mesh, rules)
    params = _fake_tree(model.specs(), ps)
    opt = make_optimizer(OptimizerConfig(name=pick_optimizer(model.cfg)))
    state = opt.init(params, ps)
    bs = batch_shardings(model, shape, mesh, rules)
    return params, opt, state, bs, _fake_tree(model.input_spec_tree(shape),
                                              bs)


def serving_state(model, shape, mesh, rules=DEFAULT_RULES):
    """The rank's blocks of a serving cell's arguments on ``mesh`` under
    ``rules``: (params, inputs), the inputs a prefill cell's batch
    (``batch_shardings``) or a decode cell's {"tokens" [B], "state"} (the
    decode state of ``shape.global_batch`` rows over a cache of
    ``shape.seq_len``, ``decode_state_shardings``). Made under
    ``FakeTensorMode`` they hold no data: the reference's
    ``abstract_params``, ``abstract_inputs`` and
    ``abstract_decode_state``."""
    params = _fake_tree(model.specs(), model.param_shardings(mesh, rules))
    inputs = _fake_tree(model.input_spec_tree(shape),
                        batch_shardings(model, shape, mesh, rules))
    if shape.kind == "decode":
        b, ctx = shape.global_batch, shape.seq_len
        inputs["state"] = _fake_tree(
            model.decode_state_specs(b, ctx),
            model.decode_state_shardings(b, ctx, mesh, rules))
    return params, inputs


def _serve(model, shape, params, inputs, remap_tier: float):
    """Run a serving cell's step on the rank's blocks: (its outputs, the
    aliased bytes, the ``mirage`` extras or None). A decode cell at a
    remap tier streams the repeats of ``tier_split``'s cycle stack through
    ``make_fetch`` (an enc-dec config remaps its cross K/V instead,
    ``cross_kv_to_host``), as the reference's ``_lower_remap_decode`` and
    ``_lower_cross_kv_remap``; the decode state is updated in place, the
    reference's donated argument (not in the cross-K/V cell, whose
    reference donates nothing)."""
    if shape.kind == "prefill":
        return model.prefill(params, inputs, shape.seq_len,
                             shape=shape), 0, None
    state, kw, extras, fetch = inputs["state"], {}, None, None
    alias = _nbytes(state)
    if remap_tier and model.cfg.is_encoder_decoder:
        blocks = state["blocks"][0]["mixer"]
        blocks["cross"], kw["cross_transform"] = cross_kv_to_host(
            blocks["cross"])
        cross = _nbytes(blocks["cross"])
        extras = {"cross_kv_host_bytes_per_device": cross, "alpha": 0,
                  "m": 0, "cycle_bytes_per_device": cross,
                  "resident_bytes_per_device": 0}
        alias = 0
    elif remap_tier:
        plan, res, cyc, maps = tier_split(params["blocks"], remap_tier)
        params = dict(params, blocks=None)
        fetch = make_fetch(res, cyc, maps, slots=plan.beta)
        extras = {"alpha": plan.alpha, "m": plan.m,
                  "cycle_bytes_per_device": _nbytes(cyc),
                  "resident_bytes_per_device": _nbytes(res)}
    out = model.decode_step(params, state, inputs["tokens"], shape.seq_len,
                            fetch=fetch, global_batch=shape.global_batch,
                            **kw)
    return out, alias, extras


def lower_cell(arch, shape, mesh, *, remap_tier: float = 0.0,
               microbatches: int = 0, remat_policy: str = "full",
               profile: str = "train"):
    """One step of the cell on ``mesh`` (a ``DeviceMesh`` of the world
    this process joined), on fake tensors: a train step, a prefill, or a
    decode step (at ``remap_tier``, the MIRAGE tier). ``arch``: a config
    or its name; ``shape``: a ``ShapeConfig`` or its name. Returns (its
    record without the cell's names, model, shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    rules = profile_rules(profile)
    model = build_model(cfg)
    train = shape.kind == "train"
    if train and remap_tier:
        raise ValueError("a remap tier applies to decode cells")
    if train and microbatches == 0:
        microbatches = auto_microbatches(cfg, shape, mesh)
    t0 = time.perf_counter()
    _warm_groups(mesh)
    with mesh_context(mesh, rules), FakeTensorMode():
        if train:
            params, opt, state, bs, batch = abstract_state(model, shape,
                                                           mesh, rules)
            step = make_train_step(model, opt, remat_policy=remat_policy,
                                   microbatches=microbatches,
                                   batch_shardings=bs)
            args = (params, state, batch)

            def run():
                # the train state is updated in place: the reference's
                # donated arguments
                return (step(params, state, batch),
                        _nbytes(params) + _nbytes(state), None)
        else:
            args = serving_state(model, shape, mesh, rules)

            def run():
                return _serve(model, shape, *args, remap_tier)
        arg_bytes = _nbytes(args)
        lower_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        collectives.reset_counts()
        meter = _Meter()
        with meter:
            out, alias, extras = run()
        stats = collective_stats()
    rec: Dict[str, Any] = {
        "lowering": "torch-fake-cpu",
        "compile_s": round(time.perf_counter() - t0, 2),
        "lower_s": round(lower_s, 2),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _nbytes(out),
            "temp_bytes": meter.peak,
            "alias_bytes": alias,
            "code_bytes": 0,
            "host_argument_bytes": 0,
            "host_temp_bytes": 0,
        },
        "cost_analysis_raw": {"flops": float(meter.flops),
                              "bytes": float(meter.op_bytes)},
        "collectives": {"bytes_by_op": stats.bytes_by_op,
                        "count_by_op": stats.count_by_op,
                        "total_bytes": stats.total_bytes},
    }
    if train:
        rec.update(microbatches=microbatches,
                   optimizer=pick_optimizer(cfg))
    if extras is not None:
        rec["mirage"] = extras
    return rec, model, shape


def analyze(rec: Dict[str, Any], model, shape, mesh) -> Dict[str, Any]:
    """``rec`` with the reference's analytic cost and the mesh."""
    cost = cost_for(model.cfg, shape, num_data_shards(mesh))
    rec["analytic"] = {
        "flops_by_component": cost.flops,
        "hbm_bytes_by_component": cost.hbm_bytes,
        "total_flops": cost.total_flops,
        "total_hbm_bytes": cost.total_bytes,
        "model_flops": cost.model_flops,
        "useful_fraction": cost.useful_fraction,
    }
    sizes = axis_sizes(mesh)
    rec["mesh"] = {"shape": sizes, "devices": mesh.size()}
    return rec


def cell_tag(arch: str, shape_name: str, *, remap_tier: float = 0.0,
             microbatches: int = 0, remat_policy: str = "full",
             profile: str = "train") -> str:
    """The reference's artifact name of a cell."""
    tag = f"{arch}__{shape_name}" + (
        f"__remap{remap_tier:g}" if remap_tier else "")
    if microbatches != 0:
        tag += f"__mb{microbatches}"
    if remat_policy != "full":
        tag += f"__remat-{remat_policy}"
    if profile != "train":
        tag += f"__{profile}"
    return tag


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             remap_tier: float = 0.0, force: bool = False,
             microbatches: int = 0, remat_policy: str = "full",
             profile: str = "train",
             out_dir: Optional[str] = None) -> Dict[str, Any]:
    out_dir = out_dir or os.path.abspath(ARTIFACT_DIR)
    tag = cell_tag(arch, shape_name, remap_tier=remap_tier,
                   microbatches=microbatches, remat_policy=remat_policy,
                   profile=profile)
    path = os.path.join(out_dir, mesh_name, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    layout = production_layout(multi_pod=mesh_name == "multi_pod")
    with fake_world(layout.size):
        mesh = make_mesh(layout, "cpu")
        rec, model, shape = lower_cell(
            arch, shape_name, mesh, remap_tier=remap_tier,
            microbatches=microbatches, remat_policy=remat_policy,
            profile=profile)
        rec = analyze(rec, model, shape, mesh)
    rec.update({
        "arch": arch, "shape": shape_name, "mesh_name": mesh_name,
        "remap_tier": remap_tier, "remat_policy": remat_policy,
        "profile": profile,
    })
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=[None, "single_pod",
                                                      "multi_pod"])
    ap.add_argument("--remap-tier", type=float, default=0.0)
    ap.add_argument("--microbatches", type=int, default=0,
                    help="0 = auto (carry-budget heuristic)")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--profile", default="train",
                    choices=["train", "serving", "train-ef", "head-tp"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHS)
    meshes = [args.mesh] if args.mesh else ["single_pod", "multi_pod"]
    ok = fail = 0
    t_all = time.perf_counter()
    for mesh_name in meshes:
        for arch in archs:
            cfg = get_arch(arch)
            shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
            for shape_name in shapes:
                runs, why = shape_applicable(cfg, SHAPES_BY_NAME[shape_name])
                if not runs:
                    print(f"SKIP  {mesh_name:10s} {arch:24s} {shape_name}: "
                          f"{why}")
                    continue
                t0 = time.perf_counter()
                try:
                    rec = run_cell(
                        arch, shape_name, mesh_name,
                        remap_tier=args.remap_tier, force=args.force,
                        microbatches=args.microbatches,
                        remat_policy=args.remat, profile=args.profile,
                        out_dir=args.out_dir)
                except Exception as e:  # noqa: BLE001 - a cell's failure
                    fail += 1
                    print(f"FAIL  {mesh_name:10s} {arch:24s} {shape_name}: "
                          f"{type(e).__name__}: {e}")
                    traceback.print_exc(limit=3)
                    continue
                m = rec["memory"]
                per_dev = (m["argument_bytes"] + m["temp_bytes"]
                           - m["alias_bytes"])
                print(f"OK    {mesh_name:10s} {arch:24s} {shape_name:12s} "
                      f"build {rec['lower_s']:6.1f}s step "
                      f"{rec['compile_s']:6.1f}s "
                      f"perdev {per_dev / 2**30:7.2f} GiB "
                      f"coll {rec['collectives']['total_bytes'] / 2**20:9.1f}"
                      f" MiB ({time.perf_counter() - t0:.1f} s)")
                ok += 1
    print(f"\ndry-run complete: {ok} ok, {fail} failed "
          f"({time.perf_counter() - t_all:.1f} s)")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
