"""Distributed support of the port: the logical-axis sharding rules, the
ambient mesh and a spec's blocks on a live mesh (``sharding``), mesh
training's collectives (``collectives``), the closed-form cost model
(``analytic_cost``), the collective statistics of a step
(``hlo_analysis``) and the fault-tolerance loop. The names below load on
first use, so that the model blocks can read the mesh context without
pulling in the training stack that ``fault_tolerance`` imports."""
_EXPORTS = {
    **{name: "sharding" for name in (
        "ShardingRules", "DEFAULT_RULES", "SERVING_RULES", "MeshLayout",
        "ShardDegrees", "default_rules", "spec_for", "serving_shard_degrees",
        "axis_sizes", "batch_axis_names", "num_data_shards",
        "model_axis_size", "set_mesh_context", "get_mesh", "get_rules",
        "mesh_context", "mesh_group", "mesh_index", "NamedSharding",
        "spec_axes", "local_shard", "gather_full",
        "with_sharding_constraint")},
    **{name: "analytic_cost" for name in (
        "StepCost", "cost_for", "decode_cost", "prefill_cost", "train_cost",
        "decode_collective_bytes", "prefill_collective_bytes")},
    **{name: "hlo_analysis" for name in (
        "COLLECTIVE_OPS", "CollectiveStats", "collective_stats")},
    **{name: "fault_tolerance" for name in (
        "StepWatchdog", "StragglerEvent", "TrainRunner", "elastic_reshard")},
}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(
            f"repro_torch.distributed.{_EXPORTS[name]}"), name)
    raise AttributeError(name)
