"""Tensor parallelism: a (data, model) grid of ranks, with the
rule-sharded parameters' Adam steps split over the model axis.

Counterpart of ``vqa_project_tpu/parallel/tp.py``. JAX places every
parameter and its Adam moments on a 2-D device mesh by suffix rules and
lets XLA's SPMD insert the collectives. Here one process runs per card:

- ``make_mesh_2d``: rank r sits at (data r // tp, model r % tp), the
  model axis innermost as in JAX; the mesh carries the two kinds of
  process group. The batch is split over the data axis only, so the
  ranks of one model group step on the same rows.
- ``param_spec``: JAX's rules, stated on the port's parameter names (the
  reference's, ``models/weights.py::state_dict_from_jax_params``). Every
  sharded dim is 0 in the port's layout: JAX's (in, out) weight-norm
  ``v`` and fused conv kernel are sharded by columns, which are the
  port's rows.
- ``shard_optimizer``: every kernel keeps its contract and reads whole
  weights, so each rank keeps the whole parameters; Adam steps only this
  rank's rows of each rule-sharded parameter (and whole replicated
  ones), and holds their moments alone. After ``backward()`` a step
  (``train.steps.train_step``) sums the gradient over the data group
  (``parallel.all_reduce_grads``), copies this rank's rows of each
  sharded gradient into its shard (``ModelShards.load_grads``; no sum
  over the model group: those ranks computed the same gradient), steps
  Adam, which is elementwise, so a slice steps as the whole does, and
  writes every rank's updated rows into the whole parameters with one
  flat all-gather over the model group (``ModelShards.gather``).
- Checkpoints keep the tp = 1 layout: ``full_optimizer_state`` gathers
  the moments over the model group, and a resume slices a tp = 1
  optimizer's state (``shard_optimizer`` after loading it).

A per-shard kernel contract (each rank aggregating only its own Gaussian
kernels, as JAX's placement lets XLA do) is not made.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from vqa_project_tpu_torch.parallel.mesh import Mesh, make_mesh

# (pattern on the port's name, fused): the first match wins. JAX's rule
# beside each. A fused pattern names one module of a group whose rows,
# concatenated in index order, are JAX's one fused matrix's columns.
_RULES: Tuple[Tuple[re.Pattern, bool], ...] = tuple(
    (re.compile(r"(?:^|\.)" + pattern + r"$"), fused) for pattern, fused in (
        # gru_w_ih / gru_w_hh P("model", None), gru_b_* P("model"): gate rows
        (r"q_gru\.(?:weight|bias)_(?:ih|hh)_l0", False),
        # wembed P("model", None): vocabulary rows
        (r"wembed\.weight", False),
        # conv_kernels (in, n*d) P(None, "model"): kernel i is column
        # block i, the port's conv_weights.i.weight (d, in)
        (r"conv_weights\.\d+\.weight", True),
        # mean_* / precision_* (n,) P("model"); the port's are (n, 1)
        (r"(?:mean|precision)_(?:rho|theta)", False),
        # weight-norm v (in, out) P(None, "model"), g and b P("model"),
        # only inside edge_layer_* / out_* (JAX's owner scoping): the
        # port's weight_v (out, in), weight_g (out, 1) and bias (out,)
        (r"(?:edge_layer_|out_)[^.]*\.(?:weight_v|weight_g|bias)", False),
    ))
_FUSED = re.compile(r"^(.*\bconv_weights)\.(\d+)\.weight$")


def make_mesh_2d(tp: int, num_devices: Optional[int] = None,
                 device="cuda") -> Mesh:
    """The (data, model) mesh of this process: ``tp``-way model
    parallelism, the rest data-parallel.

    ``make_mesh``'s refusals hold (more cards than visible, a count other
    than the group's); tp > 1 also needs a process group whose world tp
    divides. Every rank creates every data group (ranks m, m + tp, ...)
    and then every model group (ranks d tp .. d tp + tp - 1), in that
    order. At tp = 1 this is ``make_mesh``."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    base = make_mesh(num_devices, device)
    if tp == 1:
        return base
    if not base.distributed:
        raise ValueError(
            f"tensor parallelism (tp={tp}) needs a process group: launch "
            f"with torchrun, or pass --num_devices to a CLI")
    if base.world % tp:
        raise ValueError(f"{base.world} ranks not divisible by tp={tp}")
    groups = {}
    n_data = base.world // tp
    for m in range(tp):
        groups[("data", m)] = dist.new_group(
            [d * tp + m for d in range(n_data)])
    for d in range(n_data):
        groups[("model", d)] = dist.new_group(
            list(range(d * tp, (d + 1) * tp)))
    return dataclasses.replace(
        base, tp=tp, data_group=groups[("data", base.rank % tp)],
        model_group=groups[("model", base.rank // tp)])


def param_spec(name: str, shape: Sequence[int], tp: int,
               n_kernels: Optional[int] = None) -> Optional[int]:
    """The dim of parameter ``name`` (of ``shape``) that is sharded over
    ``tp`` model ranks, or None for a replicated one: JAX's ``param_spec``
    on the port's names. A dim that tp does not divide replicates. A
    conv kernel divides as its group's fused rows (``n_kernels`` modules
    of ``shape[0]`` rows each, which the caller gives)."""
    for pattern, fused in _RULES:
        if pattern.search(name):
            if not len(shape):
                return None
            rows = int(shape[0])
            if fused:
                if n_kernels is None:
                    raise ValueError(f"{name}: a conv kernel's spec needs "
                                     "its group's n_kernels")
                rows *= int(n_kernels)
            return 0 if rows % tp == 0 else None
    return None


def shard_rows(shapes: Dict[str, Sequence[int]], tp: int, model_rank: int
               ) -> Dict[str, Tuple[int, int]]:
    """Rows [lo, hi) of every rule-sharded parameter that model rank
    ``model_rank`` of ``tp`` owns, by name (``shapes``: every parameter's
    shape, in the model's order). A parameter owns rank r's equal share
    of its rows; a conv kernel the part of rank r's share of its group's
    concatenated rows that falls in it (JAX's fused column range), which
    may be none of it."""
    groups: Dict[str, List[str]] = {}
    for name in shapes:
        m = _FUSED.match(name)
        if m:
            groups.setdefault(m.group(1), []).append(name)
    out = {}
    for name, shape in shapes.items():
        m = _FUSED.match(name)
        members = ([name] if m is None else sorted(
            groups[m.group(1)], key=lambda k: int(_FUSED.match(k).group(2))))
        if param_spec(name, shape, tp, len(members) if m else None) is None:
            continue
        total = sum(int(shapes[k][0]) for k in members)
        lo, hi = model_rank * total // tp, (model_rank + 1) * total // tp
        start = 0
        for k in members:
            if k == name:
                break
            start += int(shapes[k][0])
        rows = int(shape[0])
        out[name] = (min(max(lo - start, 0), rows),
                     min(max(hi - start, 0), rows))
    return out


class ModelShards:
    """This rank's rows of every rule-sharded parameter of ``model`` on
    the model axis of ``mesh``, as views of one flat buffer (the
    all-gather's input), and the tensors Adam steps: in
    ``model.parameters()`` order, the shard of a sharded parameter (which
    may hold no rows) and a replicated parameter itself."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh):
        if mesh.tp < 2 or mesh.model_group is None:
            raise ValueError("ModelShards needs a mesh with tp > 1 "
                             "(parallel.make_mesh_2d)")
        self.mesh = mesh
        named = list(model.named_parameters())
        shapes = {k: tuple(p.shape) for k, p in named}
        ranges = [shard_rows(shapes, mesh.tp, r) for r in range(mesh.tp)]
        # per sharded parameter: (index, parameter, [(lo, hi) per rank])
        self.sharded = [(i, p, [rng[k] for rng in ranges])
                        for i, (k, p) in enumerate(named) if k in ranges[0]]
        self.names = [named[i][0] for i, _, _ in self.sharded]
        dtypes = {p.dtype for _, p, _ in self.sharded}
        if len(dtypes) > 1:
            raise ValueError(f"sharded parameters in several dtypes {dtypes}")
        # every rank's offset of each of its segments in its flat buffer;
        # the buffers are equal in size, each group's rows split evenly
        self.offsets = []
        size = [0] * mesh.tp
        for _, p, spans in self.sharded:
            row = _row_size(p)
            self.offsets.append(list(size))
            for r, (lo, hi) in enumerate(spans):
                size[r] += (hi - lo) * row
        if len(set(size)) > 1:
            raise ValueError(f"uneven shards over the model ranks: {size}")
        self.size = size[0]
        dev = next(model.parameters()).device
        dtype = dtypes.pop() if dtypes else torch.float32
        self.flat = torch.empty(self.size, dtype=dtype, device=dev)
        self.flat_grad = torch.zeros_like(self.flat)
        self.gathered = torch.empty(self.size * mesh.tp, dtype=dtype,
                                    device=dev)
        me = mesh.model_rank
        self.shards, self.grads, self.rows = [], [], []
        for (_, p, spans), offs in zip(self.sharded, self.offsets):
            lo, hi = spans[me]
            n = (hi - lo) * _row_size(p)
            shape = (hi - lo,) + tuple(p.shape[1:])
            self.shards.append(self.flat[offs[me]:offs[me] + n].view(shape))
            self.grads.append(
                self.flat_grad[offs[me]:offs[me] + n].view(shape))
            self.rows.append(p.detach()[lo:hi])
        index = {i: s for (i, _, _), s in zip(self.sharded, self.shards)}
        self.tensors = [index.get(i, p)
                        for i, p in enumerate(model.parameters())]
        # the all-gather's copies into the whole parameters, every rank's
        # rows of every sharded parameter (empty ones left out)
        self._dst, self._src = [], []
        for (_, p, spans), offs in zip(self.sharded, self.offsets):
            row = _row_size(p)
            for r, (lo, hi) in enumerate(spans):
                if hi > lo:
                    a = r * self.size + offs[r]
                    self._dst.append(p.detach()[lo:hi])
                    self._src.append(self.gathered[a:a + (hi - lo) * row]
                                     .view((hi - lo,) + tuple(p.shape[1:])))
        self.pull()

    @torch.no_grad()
    def pull(self) -> None:
        """Copy this rank's rows of the whole parameters into the shards
        (after the parameters were written from outside, as a resume
        does)."""
        _copy(self.shards, self.rows)

    @torch.no_grad()
    def load_grads(self) -> None:
        """Give each shard this rank's rows of its parameter's gradient
        (summed over the data group already), as its ``.grad``."""
        _copy(self.grads, [p.grad[lo:hi] for (_, p, spans) in self.sharded
                           for lo, hi in [spans[self.mesh.model_rank]]])
        for shard, grad in zip(self.shards, self.grads):
            shard.grad = grad

    @torch.no_grad()
    def gather(self) -> None:
        """Write every model rank's shards into the whole parameters: one
        all-gather of the flat buffers over the model group."""
        dist.all_gather_into_tensor(self.gathered, self.flat,
                                    group=self.mesh.model_group)
        _copy(self._dst, self._src)

    def full_state_dict(self, optimizer: torch.optim.Optimizer) -> dict:
        """``optimizer``'s state_dict in the tp = 1 layout (every
        parameter's whole moments, indexed as a tp = 1 Adam over
        ``model.parameters()``): one all-gather over the model group per
        moment, which every rank of the group must call."""
        sd = optimizer.state_dict()
        if not sd["state"] or not self.sharded:
            return sd
        state = {i: dict(s) for i, s in sd["state"].items()}
        tp = self.mesh.tp
        for key in ("exp_avg", "exp_avg_sq"):
            dtype = state[self.sharded[0][0]][key].dtype
            flat = torch.cat([state[i][key].reshape(-1).float()
                              for i, _, _ in self.sharded])
            out = torch.empty(self.size * tp, dtype=torch.float32,
                              device=flat.device)
            dist.all_gather_into_tensor(out, flat,
                                        group=self.mesh.model_group)
            for (i, p, spans), offs in zip(self.sharded, self.offsets):
                whole = torch.empty(p.shape, dtype=dtype, device=flat.device)
                row = _row_size(p)
                for r, (lo, hi) in enumerate(spans):
                    a = r * self.size + offs[r]
                    whole[lo:hi] = out[a:a + (hi - lo) * row].view(
                        (hi - lo,) + tuple(p.shape[1:]))
                state[i][key] = whole
        sd["state"] = state
        return sd

    def shard_state_dict(self, state_dict: dict) -> dict:
        """A tp = 1 Adam's state_dict (indexed over ``model.parameters()``)
        with each sharded parameter's moments cut to this rank's rows."""
        state = {i: dict(s) for i, s in state_dict["state"].items()}
        for i, _, spans in self.sharded:
            if i in state:
                lo, hi = spans[self.mesh.model_rank]
                for key in ("exp_avg", "exp_avg_sq"):
                    state[i][key] = state[i][key][lo:hi].clone()
        return {**state_dict, "state": state}


def _row_size(p: torch.Tensor) -> int:
    return math.prod(p.shape[1:])


def _copy(dst: List[torch.Tensor], src: List[torch.Tensor]) -> None:
    pairs = [(d, s) for d, s in zip(dst, src) if d.numel()]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def shard_optimizer(model: torch.nn.Module, mesh: Mesh, optimizer,
                    scheduler=None):
    """(Adam, MultiStepLR) stepping this rank's shards on ``mesh``, in
    place of a tp = 1 pair from ``train.make_optimizer`` (and a resume's
    state loaded into it): the Adam holds the given one's settings and
    moment dtypes, and its state cut to this rank's rows; the scheduler
    the given one's state. The returned Adam carries its ``shards``
    (``ModelShards``), which ``train_step`` and ``full_optimizer_state``
    read."""
    from vqa_project_tpu_torch.train.state import Adam

    shards = ModelShards(model, mesh)
    group = optimizer.param_groups[0]
    sharded = Adam(shards.tensors, lr=group["lr"], betas=group["betas"],
                   eps=group["eps"], mu_dtype=optimizer.mu_dtype,
                   nu_dtype=optimizer.nu_dtype)
    sharded.shards = shards
    sched = None
    if scheduler is not None:
        sched = torch.optim.lr_scheduler.MultiStepLR(
            sharded, milestones=sorted(scheduler.milestones.elements()),
            gamma=scheduler.gamma)
    sharded.load_state_dict(shards.shard_state_dict(optimizer.state_dict()))
    if sched is not None:
        sched.load_state_dict(scheduler.state_dict())
    return sharded, sched


def full_optimizer_state(optimizer) -> dict:
    """``optimizer.state_dict()`` in the tp = 1 layout: the state itself
    for a tp = 1 optimizer, gathered over the model group (a collective
    every rank calls) for one from ``shard_optimizer``."""
    shards = getattr(optimizer, "shards", None)
    if shards is None:
        return optimizer.state_dict()
    return shards.full_state_dict(optimizer)
