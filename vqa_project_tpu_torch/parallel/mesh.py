"""The data-parallel mesh: which rank of how many this process is, its
card, and the two things a step does across ranks.

Counterpart of ``vqa_project_tpu/parallel/mesh.py``. JAX builds a 1-D
device mesh and lets XLA insert the gradient all-reduce under SPMD; here
one process runs per card, so the mesh is a small record of the process
group (``make_mesh``) and the step owns its collective:

- ``shard_batch``: this rank's rows of a host batch (the batch is
  split on its leading axis, the model and optimizer state are
  replicated);
- ``all_reduce_grads``: every gradient summed over the ranks through ONE
  flat buffer, one collective a step, in float32 or in bfloat16 (JAX's
  ``_build_bf16_reduce_step``: each rank's contribution rounded to bf16,
  summed in bf16, widened back).

With tensor parallelism (``parallel/tp.py``) both act on the data axis
of a (data, model) grid: the batch splits over the data coordinates and
the gradient sums over the data group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from vqa_project_tpu_torch.config import resolve_device, torch_dtype
from vqa_project_tpu_torch.parallel import multihost
from vqa_project_tpu_torch.parallel.multihost import local_batch_rows


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Rank ``rank`` of ``world`` on ``device``; ``backend`` is the
    process group's ("nccl" or "gloo"), None without one.

    With tensor parallelism (``tp > 1``, ``parallel.tp.make_mesh_2d``)
    the ranks form a (data, model) grid, rank r at (r // tp, r % tp):
    ``data_group`` holds the ranks of this rank's model index (the batch
    is split over them, the gradient summed over them) and
    ``model_group`` those of its data index (they step on the same rows).
    At tp = 1 the data group is every rank (None: the default group) and
    the model group none."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    tp: int = 1
    data_group: Any = None
    model_group: Any = None

    @property
    def distributed(self) -> bool:
        """True inside a process group (of any size, 1 included)."""
        return self.backend is not None

    @property
    def data_rank(self) -> int:
        return self.rank // self.tp

    @property
    def data_world(self) -> int:
        return self.world // self.tp

    @property
    def model_rank(self) -> int:
        return self.rank % self.tp


def visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh of this process: the process group's rank and world when
    one is up, else rank 0 of 1.

    ``num_devices`` None takes the group as it is; another count than
    the group's world raises, as does a count above the cards this host
    shows for a CUDA device (JAX's ``make_mesh`` refuses a mesh larger
    than its devices rather than quietly use fewer), and a count above 1
    without a group (launch with ``torchrun --nproc_per_node N`` or a
    CLI's ``--num_devices N``)."""
    dev = resolve_device(device)
    if (dev.type == "cuda" and num_devices is not None
            and num_devices > visible_cards()):
        raise ValueError(f"requested a {num_devices}-card mesh but only "
                         f"{visible_cards()} CUDA device(s) are visible")
    if dist.is_initialized():
        n = dist.get_world_size()
        if num_devices is not None and num_devices != n:
            raise ValueError(f"requested a {num_devices}-rank mesh inside "
                             f"a process group of {n} ranks")
        return Mesh(dist.get_rank(), n, dev, dist.get_backend())
    if num_devices is not None and num_devices > 1:
        raise ValueError(
            f"a {num_devices}-rank mesh needs a process group: launch with "
            f"torchrun --nproc_per_node {num_devices}, or pass "
            f"--num_devices {num_devices} to a CLI")
    return Mesh(0, 1, dev, None)


def shard_batch(batch: Dict[str, np.ndarray], mesh: Mesh
                ) -> Dict[str, np.ndarray]:
    """This rank's rows of a host batch: every array whose leading size
    is the global batch size (``len(batch["mask"])``) sliced by
    ``local_batch_rows`` at the rank's data coordinates; other entries
    (the dense fields that a sharded Batcher already made for this rank
    alone) kept as they are. The batch itself on a data axis of one."""
    if mesh.data_world == 1:
        return batch
    b = len(batch["mask"])
    rows = local_batch_rows(b, mesh.data_rank, mesh.data_world)
    return {k: v[rows] if isinstance(v, np.ndarray) and v.ndim
            and v.shape[0] == b else v for k, v in batch.items()}


def data_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``x`` summed in place over the data group of ``mesh`` (every rank
    of the process group when ``mesh`` is None): each row of a global
    batch counted once. ``x`` itself on a mesh without a process group,
    which runs alone even inside one."""
    if mesh is not None and not mesh.distributed:
        return x
    return multihost.all_reduce_sum(x, None if mesh is None
                                    else mesh.data_group)


def data_rows(x: torch.Tensor, mesh: Mesh, axis: int = 0) -> np.ndarray:
    """The global array whose ``axis`` the data indices of ``mesh`` hold
    in equal slices, as numpy (``multihost.fetch_global`` over the data
    group); ``x`` on the host on a mesh without a process group."""
    if not mesh.distributed:
        return x.cpu().numpy()
    return multihost.fetch_global(x, axis, mesh.data_group)


def reduce_dtype(mesh: Mesh, dtype: str = "float32") -> Optional[str]:
    """The dtype the gradient all-reduce runs in on ``mesh``: None
    without a process group (no collective), float32 on a data axis of
    one rank (a bf16 request applies only across ranks, as in JAX)."""
    if not mesh.distributed:
        return None
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"grad_reduce_dtype must be float32|bfloat16, "
                         f"got {dtype!r}")
    return dtype if mesh.data_world > 1 else "float32"


def all_reduce_grads(model: torch.nn.Module, mesh: Mesh,
                     dtype: str = "float32", group=None) -> None:
    """Sum every parameter's gradient over the ranks of ``group`` (default
    every rank; a tensor-parallel step passes ``mesh.data_group``), in
    place, through one flat buffer in ``reduce_dtype(mesh, dtype)`` (one
    collective; every rank ran the same graph, so the same parameters
    have one). Nothing happens without a process group or in a group of
    one rank, where the sum is the gradient itself."""
    rdt = reduce_dtype(mesh, dtype)
    if rdt is None or dist.get_world_size(group) == 1:
        return
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1).to(torch_dtype(rdt)) for g in grads])
    dist.all_reduce(flat, group=group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view(g.shape))
        off += g.numel()
