"""Logical-axis sharding rules (MaxText-style) with divisibility fallback
(PyTorch counterpart of ``repro.distributed.sharding``).

Every parameter / activation dimension carries a *logical* axis name; rules
map logical names to (tuples of) mesh axes. ``spec_for`` resolves a logical
annotation against a mesh, dropping mesh axes that do not divide the
dimension or that are already consumed by an earlier dimension of the same
tensor. This is what makes e.g. GQA KV heads (8) on a model=16 axis degrade
gracefully to replication, and global_batch=1 long-context cells fall
through to pure context parallelism. A divisibility drop is *warned once*
per (logical axis, mesh): graceful degradation is by design, but a shard set
that silently serves a dimension unsharded is a misconfiguration the
operator must get to see.

A mesh here is anything that names its axes and their sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``shape``), a ``MeshLayout`` (names and sizes with no ranks behind them, so
a 512-device production layout resolves in one process), or any object
with ``axis_names`` and a ``shape`` mapping each name to its size. A
resolved spec is a tuple with one entry per leading dimension (``None``, a
mesh-axis name, or a tuple of names), trailing ``None``s stripped: the
counterpart of JAX's ``PartitionSpec``. On a live mesh it maps onto DTensor
``Shard``/``Replicate`` placements.

Mesh axes:
  pod    - slowest (data-center interconnect): DP gradient sync, optional FSDP
  data   - intra-pod DP/FSDP axis
  model  - TP/EP/CP axis (heads, mlp, experts, vocab, kv-sequence)
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Sequence, Set, Tuple

Spec = Tuple[object, ...]


# logical axis -> preferred mesh axes (in priority order; each is itself a
# tuple so one logical axis can map onto several mesh axes, e.g. fsdp).
#
# Two profiles:
#   train   — FSDP/ZeRO-3: every weight also sharded over the data(+pod)
#             axes; per-layer all-gathers amortize over the big train step.
#   serving — weights TP-only (replicated over data): decode steps are tiny,
#             so per-layer FSDP re-gathers dominated the collective term;
#             MoE experts shard over data (EP) + expert d_ff over model, so
#             the 1T MoE still fits while dense weights stop being gathered.
def default_rules(*, fsdp_over_pod: bool = True,
                  profile: str = "train") -> Dict[str, Tuple[str, ...]]:
    fsdp = ("pod", "data") if fsdp_over_pod else ("data",)
    if profile == "serving":
        return {
            "vocab": ("model",),
            "embed": (),                  # no FSDP re-gather per step
            "heads": ("model",),
            "kv_heads": ("model",),
            "head_dim": (),
            "mlp": ("model",),
            # experts keep train-style EP(model) x FSDP(data): a 1T MoE
            # cannot hold expert weights replicated over data (128 GiB/dev)
            "experts": ("model",),
            "expert_mlp": fsdp,
            "ssm_inner": ("model",),
            "ssm_state": (),
            "conv": (),
            "norm": (),
            "batch": ("pod", "data"),
            "seq": (),
            "seq_cp": ("model",),
            "kv_seq": ("model",),
            "kv_seq_full": ("pod", "data", "model"),
            "act_embed": (),
            "act_heads": ("model",),
            "stack": (),
            "pages": (),
            "expert_ff": (),
        }
    return {
        # ---- parameter axes
        "vocab": ("model",),
        "embed": fsdp,            # FSDP/ZeRO-3 shard of the d_model dim
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": (),
        "mlp": ("model",),
        "experts": ("model",),
        "expert_mlp": fsdp,       # FSDP shard inside each expert
        "ssm_inner": ("model",),
        "ssm_state": (),
        "conv": (),
        "norm": (),
        # ---- activation axes
        "batch": ("pod", "data"),
        "seq": (),                # sequence stays local by default
        "seq_cp": ("model",),     # context-parallel sequence (long prefill)
        "kv_seq": ("model",),     # decode KV-cache sequence (flash-decode)
        "kv_seq_full": ("pod", "data", "model"),  # b=1 long-context decode
        "act_embed": (),
        "act_heads": ("model",),
        "stack": (),              # stacked-layer leading dim
        "pages": (),
        "expert_ff": (),          # per-expert d_ff (sharded in serving profile)
    }


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, Tuple[str, ...]], ...]

    @staticmethod
    def make(profile: str = "train", **overrides) -> "ShardingRules":
        base = default_rules(profile=profile)
        base.update({k: tuple(v) for k, v in overrides.items()})
        return ShardingRules(tuple(sorted(base.items())))

    def lookup(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        d = dict(self.rules)
        if logical not in d:
            raise KeyError(f"unknown logical axis {logical!r}")
        return d[logical]


DEFAULT_RULES = ShardingRules.make()
SERVING_RULES = ShardingRules.make(profile="serving")


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axes as names and sizes, with no ranks behind them: what
    ``spec_for`` and the degree functions read."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                     # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return {ax: int(mesh.shape[ax]) for ax in mesh.axis_names}


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


# (logical axis, mesh signature) pairs already warned about — the
# divisibility fallback is by design, but each degradation surfaces once
# so a misconfigured shard set can't silently serve unsharded
_DROP_WARNED: Set[Tuple[str, Tuple[Tuple[str, int], ...]]] = set()


def _warn_divisibility_drop(logical: str, dim: int, axis: str, size: int,
                            mesh_sig: Tuple[Tuple[str, int], ...]) -> None:
    key = (logical, mesh_sig)
    if key in _DROP_WARNED:
        return
    _DROP_WARNED.add(key)
    warnings.warn(
        f"logical axis {logical!r} (dim {dim}) is not divisible by mesh "
        f"axis {axis!r} (size {size}); falling back to replication for "
        f"this dimension on mesh {dict(mesh_sig)}",
        RuntimeWarning, stacklevel=3)


def _mesh_signature(mesh) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted(axis_sizes(mesh).items()))


def spec_for(
    logical_axes: Sequence[Optional[str]],
    shape: Sequence[int],
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
) -> Spec:
    """Resolve logical axes -> a spec tuple honoring divisibility + axis
    reuse."""
    assert len(logical_axes) == len(shape), (logical_axes, shape)
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for logical, dim in zip(logical_axes, shape):
        chosen: list = []
        prod = 1
        for ax in rules.lookup(logical):
            if ax in used or ax not in sizes:
                continue
            size = sizes[ax]
            if size == 1:
                continue
            if dim % (prod * size) != 0:
                _warn_divisibility_drop(logical, dim, ax, size,
                                        _mesh_signature(mesh))
                continue
            chosen.append(ax)
            prod *= size
        used.update(chosen)
        if not chosen:
            out.append(None)
        elif len(chosen) == 1:
            out.append(chosen[0])
        else:
            out.append(tuple(chosen))
    # strip trailing Nones for tidiness
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardDegrees:
    """Per-logical-axis tensor-parallel degree a shard set actually achieves.

    Lowered from the serving-profile rules: a dimension splits over the
    set's ``model`` axis only when the rules map it there AND the degree
    divides it; otherwise it degrades to replication (degree 1, warned
    once through the same registry as ``spec_for``).
    """
    shards: int
    heads: int = 1
    kv_heads: int = 1
    mlp: int = 1
    vocab: int = 1
    experts: int = 1


def serving_shard_degrees(cfg, shards: int,
                          rules: ShardingRules = SERVING_RULES) -> ShardDegrees:
    """Lower a model config onto an N-way model-parallel shard set.

    This is the serving analogue of ``spec_for``: instead of resolving a
    spec against a live mesh, it reports the achieved split degree for each
    parameter dimension the serving rules place on ``model``, so the
    analytic perf model can divide bytes/FLOPs per shard. Degree-1 is the
    exact no-op lowering (every degree 1).
    """
    shards = max(int(shards), 1)
    sig = (("model", shards),)

    def degree(logical: str, dim: int) -> int:
        if shards == 1 or dim <= 0:
            return 1
        if "model" not in rules.lookup(logical):
            return 1
        if dim % shards != 0:
            _warn_divisibility_drop(logical, dim, "model", shards, sig)
            return 1
        return shards

    return ShardDegrees(
        shards=shards,
        heads=degree("heads", cfg.num_heads),
        kv_heads=degree("kv_heads", cfg.num_kv_heads),
        mlp=degree("mlp", cfg.d_ff),
        vocab=degree("vocab", cfg.vocab_size),
        experts=degree("experts", cfg.moe.num_experts if cfg.moe else 0),
    )


def batch_axis_names(mesh) -> Tuple[str, ...]:
    sizes = axis_sizes(mesh)
    return tuple(ax for ax in ("pod", "data") if ax in sizes)


def num_data_shards(mesh) -> int:
    n = 1
    for ax in batch_axis_names(mesh):
        n *= _axis_size(mesh, ax)
    return n


def model_axis_size(mesh) -> int:
    return _axis_size(mesh, "model")


# ---------------------------------------------------------------------------
# Ambient mesh context: model code needs the mesh for the distributed
# flash-decode; launch code installs it here. No mesh means "run pure local
# math" and is the default for unit tests.
# ---------------------------------------------------------------------------
_CONTEXT: dict = {"mesh": None, "rules": DEFAULT_RULES}


def set_mesh_context(mesh, rules: ShardingRules = DEFAULT_RULES):
    _CONTEXT["mesh"] = mesh
    _CONTEXT["rules"] = rules


def get_mesh():
    return _CONTEXT["mesh"]


def get_rules() -> ShardingRules:
    return _CONTEXT["rules"]


class mesh_context:
    """``with mesh_context(mesh):`` — installs and restores the ambient mesh."""

    def __init__(self, mesh, rules: ShardingRules = DEFAULT_RULES):
        self.mesh, self.rules = mesh, rules

    def __enter__(self):
        self.prev = (_CONTEXT["mesh"], _CONTEXT["rules"])
        set_mesh_context(self.mesh, self.rules)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh_context(*self.prev)
        return False


# ---------------------------------------------------------------------------
# A live DeviceMesh: the process group over some of its axes, and a rank's
# place along them
# ---------------------------------------------------------------------------
# (id(mesh), axes) -> (mesh, this rank's group over the product of axes);
# the mesh is kept so that its id is not reused while the entry stands
_GROUPS: Dict[Tuple[int, Tuple[str, ...]], tuple] = {}


def _check_axes(mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(axes)
    if not axes or [names.index(ax) for ax in axes] != sorted(
            names.index(ax) for ax in axes):
        raise ValueError(f"axes {axes} must be a non-empty subset of the "
                         f"mesh's {names}, in its order")
    return axes


def mesh_group(mesh, axes: Sequence[str]):
    """This rank's process group over the product of ``axes`` of a
    ``DeviceMesh``: the mesh's own group for one axis; for several, one
    group per combination of the other axes, made the first time (a
    collective call: every rank of the world makes it, as SPMD code
    does)."""
    axes = _check_axes(mesh, axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _GROUPS:
        import torch.distributed as dist
        names = tuple(mesh.mesh_dim_names)
        dims = [names.index(ax) for ax in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        ranks = mesh.mesh.permute(rest + dims).reshape(
            -1, math.prod(mesh.mesh.shape[i] for i in dims))
        group, _ = dist.new_subgroups_by_enumeration(ranks.tolist())
        _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def mesh_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index along the product of ``axes`` (row-major in their
    order, as a spec tuple of several axes splits a dimension): the block
    of a split dimension it holds; 0 for no axes."""
    if not axes:
        return 0
    axes = _check_axes(mesh, axes)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = axis_sizes(mesh)
    idx = 0
    for ax in axes:
        idx = idx * sizes[ax] + coord[ax]
    return idx


# ---------------------------------------------------------------------------
# A spec on a live mesh: the rank's block of a full tensor and back
# ---------------------------------------------------------------------------
def spec_axes(spec: Spec, dim: int) -> Tuple[str, ...]:
    """The mesh axes that split dimension ``dim`` of a spec (() where the
    dimension stays whole, trailing ``None``s stripped or not)."""
    part = spec[dim] if dim < len(spec) else None
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def _parts(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[ax] for ax in axes)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.
    NamedSharding``): a leaf under it is the rank's block, each dimension
    that the spec splits cut into equal contiguous blocks, row-major over
    the dimension's axes (``mesh_index``)."""
    mesh: object
    spec: Spec

    def axes(self, dim: int) -> Tuple[str, ...]:
        return spec_axes(self.spec, dim)

    def split_axes(self) -> Tuple[str, ...]:
        """Every axis that splits some dimension, in the mesh's order."""
        used = {ax for part in self.spec for ax in spec_axes((part,), 0)}
        return tuple(ax for ax in axis_sizes(self.mesh) if ax in used)

    def local_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n // _parts(self.mesh, self.axes(i))
                     for i, n in enumerate(shape))

    def full_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return tuple(n * _parts(self.mesh, self.axes(i))
                     for i, n in enumerate(shape))


def local_shard(x, spec: Spec, mesh):
    """This rank's block of the full tensor ``x`` under ``spec`` (a copy, so
    that the full tensor can be freed; ``x`` itself where no dimension is
    split). A dimension the divisibility fallback left whole stays whole."""
    out = x
    for dim in range(x.dim()):
        axes = spec_axes(spec, dim)
        if axes:
            n = x.shape[dim] // _parts(mesh, axes)
            out = out.narrow(dim, mesh_index(mesh, axes) * n, n)
    return out if out is x else out.clone()


def gather_full(x, spec: Spec, mesh):
    """The full tensor from each rank's block ``x`` under ``spec``: an
    all-gather over the axes of each split dimension (the inverse of
    ``local_shard``; a collective every rank of the mesh calls), contiguous."""
    from repro_torch.distributed.collectives import all_gather_dim
    for dim in range(x.dim()):
        axes = spec_axes(spec, dim)
        if axes:
            x = all_gather_dim(x, mesh_group(mesh, axes), dim, "reshard")
    return x.contiguous()


def with_sharding_constraint(x, logical_axes):
    """``x`` unchanged: in the port a tensor is one rank's local slice and
    collectives are written out where they run, so there is no layout to
    annotate (the JAX function constrains XLA's SPMD partitioner)."""
    return x
