"""Data parallelism over several ranks, one process per card: the
process group and its collectives (``multihost``), the mesh record, the
batch split and the flat gradient all-reduce (``mesh``), and the feature
table split over the ranks (``sharded_cache``). Counterpart of
``vqa_project_tpu/parallel`` less ``tp.py``."""

from vqa_project_tpu_torch.parallel import multihost
from vqa_project_tpu_torch.parallel.mesh import (Mesh, all_reduce_grads,
                                                 make_mesh, reduce_dtype,
                                                 shard_batch)
from vqa_project_tpu_torch.parallel.sharded_cache import ShardedFeatureCache

__all__ = ["multihost", "Mesh", "make_mesh", "shard_batch",
           "all_reduce_grads", "reduce_dtype", "ShardedFeatureCache"]
