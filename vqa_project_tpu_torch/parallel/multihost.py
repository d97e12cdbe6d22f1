"""Multi-process data parallelism: the process group, the ranks and the
collectives that training, evaluation and the CLIs use.

Counterpart of ``vqa_project_tpu/parallel/multihost.py`` in PyTorch's
idiom. One process (a rank) runs per card, started by ``torchrun
--nproc_per_node N`` or by the CLIs' ``--num_devices N`` (``spawn``
below), and joins ``torch.distributed`` from the torchrun environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``):

- every rank runs the same program on its rows of the same global batch:
  the Batcher's epoch order is a pure function of (seed, epoch), so every
  rank builds the same batch and takes its own slice of it
  (``local_batch_rows``);
- weights start equal on every rank (they are drawn from a CPU generator
  seeded alike), and the gradients are summed over the ranks, so they
  stay equal;
- only rank 0 writes artifacts (``is_primary``): checkpoints,
  ``metrics.jsonl``, ``result.json``, the medical grid's files and the
  synthetic data, the last behind a ``barrier`` that every rank reaches;
- the collectives are ``all_reduce``, ``broadcast`` and ``barrier``,
  which NCCL and gloo both take on CUDA tensors; a gather is an
  all_reduce of a zeroed global buffer in which each rank fills its rows
  (``fetch_global``).

The backend is an explicit choice: NCCL for ranks on cards of their own,
gloo on the CPU or for ranks that share one card (NCCL refuses two ranks
on one device). Nothing retries one backend on another.
"""

from __future__ import annotations

import importlib
import os
import socket
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def maybe_initialize_distributed(device="cuda",
                                 backend: Optional[str] = None) -> bool:
    """Join the process group that the torchrun environment describes.

    A no-op without ``WORLD_SIZE`` in the environment, or when the group
    is already up (a program may drive several entry points in one
    process). A CUDA rank first makes its card current:
    ``device``'s index when it names one (ranks that share a card),
    else ``LOCAL_RANK``, so that ``resolve_device("cuda")`` names the
    rank's own card. ``backend`` defaults to "nccl" for CUDA and "gloo"
    for the CPU.

    Returns True when this call created the group; the caller then ends
    it with ``shutdown``.
    """
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank} was asked for {device!r} but "
                               "CUDA is not available")
        torch.cuda.set_device(dev.index if dev.index is not None else local)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return True


def shutdown() -> None:
    """Leave the process group (after a last barrier)."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def world() -> int:
    """Ranks in the process group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    """True when more than one rank takes part."""
    return world() > 1


def is_primary() -> bool:
    """True on the rank that writes artifacts (rank 0)."""
    return rank() == 0


def barrier() -> None:
    """Every rank waits here for the others; a no-op without a group."""
    if dist.is_initialized():
        dist.barrier()


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (default every rank), in
    place; ``x`` itself without a group or in a group of one."""
    if dist.is_initialized() and dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x


def fetch_global(x: torch.Tensor, axis: int = 0, group=None) -> np.ndarray:
    """The global array whose ``axis`` every rank of ``group`` (default
    every rank) holds an equal slice of, in the group's rank order, as
    numpy on every rank.

    One all_reduce of a zeroed global buffer in which this rank filled its
    rows (adding zeros leaves every value as it is), then one copy to the
    host. Without a group, or in a group of one: ``x`` on the host.
    """
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x.cpu().numpy()
    n = dist.get_world_size(group)
    shape = list(x.shape)
    per = shape[axis]
    shape[axis] = per * n
    buf = torch.zeros(shape, dtype=x.dtype, device=x.device)
    buf.narrow(axis, dist.get_rank(group) * per, per).copy_(x)
    dist.all_reduce(buf, group=group)
    return buf.cpu().numpy()


def local_batch_rows(batch_size: int, rank_index: Optional[int] = None,
                     n_ranks: Optional[int] = None) -> slice:
    """The rows ``[r * B / n, (r + 1) * B / n)`` of a global batch of
    ``batch_size`` that rank r of n computes (default: this process in
    its group); a batch that does not divide raises."""
    r = rank() if rank_index is None else int(rank_index)
    n = world() if n_ranks is None else int(n_ranks)
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} not divisible by {n} "
                         "data-parallel ranks")
    per = batch_size // n
    return slice(r * per, (r + 1) * per)


def free_port() -> int:
    """A free TCP port on localhost for the process group's store."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def primary_first(fn: Callable):
    """``fn()`` on rank 0, then, after a barrier every rank reaches, on
    the others: for loaders that write a cache of their inputs on first
    use (the packed feature stores), which rank 0 alone then writes."""
    out = fn() if is_primary() else None
    barrier()
    return out if is_primary() else fn()


def _rank_main(local_rank: int, target: str, argv: Sequence[str],
               n: int, port: int) -> None:
    os.environ.update(RANK=str(local_rank), LOCAL_RANK=str(local_rank),
                      WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    module, name = target.split(":")
    getattr(importlib.import_module(module), name)(list(argv))


def spawn(target: str, argv: Sequence[str], n: int) -> None:
    """Run ``main(argv)`` of ``target`` ("package.module:main", a CLI
    whose main joins the group with ``maybe_initialize_distributed``) in
    ``n`` fresh processes: ranks 0..n-1 of one process group on this
    host, rank i on card i, as ``torchrun --nproc_per_node n`` would
    start them. Returns when every rank has ended; a rank that fails
    ends the others and raises here."""
    import torch.multiprocessing as mp

    mp.start_processes(_rank_main,
                       args=(target, list(argv), n, free_port()),
                       nprocs=n, join=True, start_method="spawn")


def ranks_to_spawn(num_devices: Optional[int], device) -> int:
    """How many ranks a CLI starts for ``--num_devices``: 0 when this
    process already is a rank (``WORLD_SIZE`` set by torchrun or by
    ``spawn``) or when one rank suffices. On CUDA None means every
    visible card, and a count above them raises; on the CPU None means
    one."""
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return 0
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = cards if num_devices is None else int(num_devices)
        if n > cards:
            raise ValueError(f"requested {n} ranks but only {cards} CUDA "
                             "device(s) are visible")
    else:
        n = 1 if num_devices is None else int(num_devices)
    return n if n > 1 else 0
