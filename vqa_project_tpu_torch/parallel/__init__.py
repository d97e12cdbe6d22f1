"""Data and tensor parallelism over several ranks, one process per card:
the process group and its collectives (``multihost``), the mesh record,
the batch split and the flat gradient all-reduce (``mesh``), the feature
table split over the ranks (``sharded_cache``), and the (data, model)
grid with the rule-sharded Adam steps (``tp``). Counterpart of
``vqa_project_tpu/parallel``."""

from vqa_project_tpu_torch.parallel import multihost
from vqa_project_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads,
                                                 make_mesh, reduce_dtype,
                                                 shard_batch)
from vqa_project_tpu_torch.parallel.sharded_cache import ShardedFeatureCache
from vqa_project_tpu_torch.parallel.tp import (full_optimizer_state,
                                               make_mesh_2d, param_spec,
                                               shard_optimizer)

__all__ = ["multihost", "Mesh", "make_mesh", "shard_batch",
           "all_reduce_grads", "reduce_dtype", "ShardedFeatureCache",
           "make_mesh_2d", "param_spec", "shard_optimizer",
           "full_optimizer_state"]
