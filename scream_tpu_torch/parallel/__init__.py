"""The parallel layer over ``torch.distributed`` (port of
``scream_tpu/parallel``): process meshes and the launcher (``mesh``), data,
sequence, tensor, pipeline and expert parallelism (``dp``, ``sp``, ``tp``,
``pp`` with ``pp_flagship``, ``ep``) and a run of every mode (``dryrun``).

The JAX package's ``ops/partitioning.py`` has no counterpart: it lets
GSPMD run the fused Pallas kernels per batch shard with no collective on
data-only meshes, which one process per rank gives by construction (each
rank calls the kernels on its own rows)."""

from scream_tpu_torch.parallel.dp import (data_parallel_apply, data_parallel_arrays_step,
                                          data_parallel_step, data_seq_parallel_step)
from scream_tpu_torch.parallel.ep import (expert_parallel_moe_ffn, init_moe_ffn_params,
                                          make_expert_mesh, moe_ffn_reference,
                                          moe_params_from_numpy)
from scream_tpu_torch.parallel.mesh import (Mesh, is_data_only, launch, make_mesh,
                                            parse_mesh_spec, replicate, shard_batch,
                                            to_device_maybe_sharded)
from scream_tpu_torch.parallel.pp import (make_pipeline_mesh, pipeline_parallel_apply,
                                          pipeline_parallel_grads, pipeline_train_step,
                                          stack_stage_params)
from scream_tpu_torch.parallel.sp import (points_parallel, sequence_parallel_linear_attention,
                                          shard_points)
from scream_tpu_torch.parallel.tp import (shard_params_tensor_parallel, tensor_parallel_apply,
                                          tensor_parallel_specs, tensor_parallel_step)

__all__ = [
    "Mesh", "is_data_only", "launch", "make_mesh", "parse_mesh_spec", "replicate",
    "shard_batch", "to_device_maybe_sharded",
    "data_parallel_apply", "data_parallel_arrays_step", "data_parallel_step",
    "data_seq_parallel_step",
    "points_parallel", "sequence_parallel_linear_attention", "shard_points",
    "shard_params_tensor_parallel", "tensor_parallel_apply", "tensor_parallel_specs",
    "tensor_parallel_step",
    "make_pipeline_mesh", "pipeline_parallel_apply", "pipeline_parallel_grads",
    "pipeline_train_step", "stack_stage_params",
    "expert_parallel_moe_ffn", "init_moe_ffn_params", "make_expert_mesh",
    "moe_ffn_reference", "moe_params_from_numpy",
]
