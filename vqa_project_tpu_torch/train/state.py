"""Optimizer, learning-rate schedule and checkpoints.

Counterpart of ``vqa_project_tpu/train/state.py``: Adam (betas 0.9 /
0.999, eps 1e-8, as torch's and optax's defaults) computed as optax
computes it, its moments stored in ``TrainConfig.adam_mu_dtype`` /
``adam_nu_dtype``, with the reference's MultiStepLR, and one checkpoint
format, a full dict with the weights under the reference's state_dict
names, written to a unique temporary name and renamed into place so a
reader never sees half a file (``async_save_checkpoint`` does the
writing on a thread).
``load_checkpoint`` also reads the reference's ``.pt`` (a bare
state_dict, or the full dict with torch Adam state keyed by parameter
index: ``reference_adam_state``) and the JAX package's flax-msgpack
checkpoint (``train/_msgpack.py``), telling the kinds apart by their
first bytes as the JAX package does.
"""

from __future__ import annotations

import collections
import dataclasses
import operator
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

import torch

from vqa_project_tpu_torch.config import TrainConfig, torch_dtype
from vqa_project_tpu_torch.ops.adam import AdamTable, adam_fused_step
from vqa_project_tpu_torch.models.weights import (reference_name,
                                                  reference_state_dict,
                                                  state_dict_from_jax_params)
from vqa_project_tpu_torch.train._msgpack import (migrate_conv_kernels,
                                                  read_flax_msgpack)


class _Moments:
    """A group's Adam state in buffers the optimizer owns: each
    parameter's moments as views of one buffer per moment (every view on
    a 16-byte boundary, contiguous), its count as a 0-d view of one
    float32 CPU tensor, so that one add advances every count. Each given
    state takes its views, with the values it held copied in (cast to
    the moment dtypes); a state without moments starts at zero."""

    ALIGN = 8   # elements: 16 bytes of bfloat16, 32 of float32

    def __init__(self, params: List[torch.Tensor], states: List[dict],
                 mu_dtype: torch.dtype, nu_dtype: torch.dtype):
        offsets, total = [], 0
        for p in params:
            offsets.append(total)
            total += -(-p.numel() // self.ALIGN) * self.ALIGN
        dev = params[0].device
        self.params = list(params)
        self.mu = torch.zeros(total, dtype=mu_dtype, device=dev)
        self.nu = torch.zeros(total, dtype=nu_dtype, device=dev)
        self.steps = torch.zeros(len(params), dtype=torch.float32)
        for i, (p, st, off) in enumerate(zip(params, states, offsets)):
            mu = self.mu[off:off + p.numel()].view(p.shape)
            nu = self.nu[off:off + p.numel()].view(p.shape)
            if "exp_avg" in st:
                mu.copy_(st["exp_avg"])
                nu.copy_(st["exp_avg_sq"])
                self.steps[i] = st["step"]
            st["step"], st["exp_avg"], st["exp_avg_sq"] = self.steps[i], mu, nu

    def holds(self, params: List[torch.Tensor]) -> bool:
        return len(params) == len(self.params) and all(
            map(operator.is_, params, self.params))


class Adam(torch.optim.Optimizer):
    """Adam with optax.adam's arithmetic and its moments stored in
    ``mu_dtype`` / ``nu_dtype`` (float32 or bfloat16).

    Per update, in f32 (optax's ``scale_by_adam`` op by op):
    ``mu = (1 - b1) g + b1 mu`` and ``nu = (1 - b2) g^2 + b2 nu``, the
    update ``-lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``.
    With bfloat16 mu, ``b1 mu`` is a bfloat16 product (b1 rounded to
    bfloat16, as a Python float meeting a bfloat16 array is in JAX),
    the sum and the update use the f32 mu, and bf16(mu) is stored. With
    bfloat16 nu, the stored nu is widened exactly, stepped in f32 and
    rounded back for storage (the JAX package's ``_with_nu_dtype``).

    The state has torch Adam's keys (``step``, ``exp_avg``,
    ``exp_avg_sq``), so the reference's Adam state and this one's load
    into each other; ``load_state_dict`` casts the moments to the
    configured dtypes, as the JAX package's resume does. The optimizer
    owns its state (``_Moments``: a group's moments as views of one
    buffer each, its counts as views of one CPU tensor; a loaded state
    is copied in) and updates it in place: each group's update is one
    ``ops.adam.adam_fused_step``, one kernel launch on the card and the
    plain ``torch._foreach`` version (``adam_reference``) on the CPU.

    Each step has a host part (``_advance``: the counts, then lr,
    1 - b1^t and 1 - b2^t in f32 into a (3,) float32 tensor on the
    card, by one copy) and the launch. ``train_step``'s CUDA graph
    captures the launch after the backward (``capture_update``) and runs
    the host part before each replay (``graph_host_step``).
    """

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, mu_dtype: torch.dtype = torch.float32,
                 nu_dtype: torch.dtype = torch.float32):
        for dt in (mu_dtype, nu_dtype):
            if dt not in (torch.float32, torch.bfloat16):
                raise ValueError(f"Adam moments in {dt}: float32 or "
                                 "bfloat16 only")
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps))
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype
        self._packs: Dict[int, _Moments] = {}       # by group index
        self._tables: Dict[int, AdamTable] = {}     # the eager launches'
        self._scalars: Dict[tuple, torch.Tensor] = {}

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        self._packs.clear()
        self._tables.clear()
        for gi, group in enumerate(self.param_groups):
            params = [p for p in group["params"]
                      if "exp_avg" in self.state.get(p, {})]
            if params:
                self._own(gi, params)

    def _own(self, gi: int, params: List[torch.Tensor]) -> None:
        """Give ``params`` (with or without a state) state that this
        optimizer owns: group ``gi``'s ``_Moments`` where they share a
        device, else tensors of their own (``_apart``)."""
        if len({p.device for p in params}) == 1:
            self._packs[gi] = _Moments(params, [self.state[p] for p in params],
                                       self.mu_dtype, self.nu_dtype)
        else:
            self._apart(params)

    def _apart(self, params: List[torch.Tensor]) -> None:
        for p in params:
            st = self.state[p]
            st["step"] = torch.tensor(float(st.get("step", 0.0)))
            for key, dt in (("exp_avg", self.mu_dtype),
                            ("exp_avg_sq", self.nu_dtype)):
                st[key] = (st[key].to(dt, copy=True) if key in st
                           else torch.zeros_like(p, dtype=dt))

    def _launch_lists(self, gi: int, params: List[torch.Tensor]):
        """(params, grads, mus, nus) of group ``gi``'s launch; parameters
        without a state get one, packed where the whole group is new."""
        fresh = [p for p in params if "exp_avg" not in self.state[p]]
        if len(fresh) == len(params) and gi not in self._packs:
            self._own(gi, params)
        elif fresh:
            self._apart(fresh)
        states = [self.state[p] for p in params]
        return (params, [p.grad for p in params],
                [st["exp_avg"] for st in states],
                [st["exp_avg_sq"] for st in states])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for gi, group in enumerate(self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lists = self._launch_lists(gi, params)
            table = self._tables.get(gi)
            if table is None or not table.matches(*lists):
                table = self._tables[gi] = AdamTable(*lists)
                table.upload()
            adam_fused_step(table, self._advance(gi, params),
                            group["betas"], group["eps"])
        return loss

    def _advance(self, gi: int, params: List[torch.Tensor]) -> torch.Tensor:
        """The host part of group ``gi``'s step over ``params``: each
        count + 1, then (lr, 1 - b1^t, 1 - b2^t) at the first one's count
        t, in f32, in the group's (3,) scalars tensor on the parameters'
        device: one copy from a host tensor of its own, queued on the
        current stream (the tensor itself on the CPU)."""
        group = self.param_groups[gi]
        pack = self._packs.get(gi)
        if pack is not None and pack.holds(params):
            pack.steps.add_(1.0)
        else:
            torch._foreach_add_([self.state[p]["step"] for p in params], 1.0)
        count = int(self.state[params[0]]["step"])
        b1, b2 = group["betas"]
        # optax's bias corrections: 1 - decay^count in f32
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        host = torch.tensor([group["lr"], bc1, bc2], dtype=torch.float32)
        dev = params[0].device
        if dev.type == "cpu":
            return host
        scalars = self._device_scalars(gi, dev)
        # a pageable source: the copy takes it before the call returns
        scalars.copy_(host, non_blocking=True)
        return scalars

    def _device_scalars(self, gi: int, dev: torch.device) -> torch.Tensor:
        """Group ``gi``'s (3,) float32 scalars on ``dev``, made once."""
        scalars = self._scalars.get((gi, dev))
        if scalars is None:
            scalars = self._scalars[(gi, dev)] = torch.empty(
                3, dtype=torch.float32, device=dev)
        return scalars

    def capture_buffers(self) -> dict:
        """Before a CUDA graph's capture: per group on the card, its
        scalars tensor and a table buffer with a row for every parameter
        (``capture_update``'s), made outside the capture: memory that a
        capture allocates may be memory that the graph's earlier kernels
        write at every replay."""
        out = {}
        for gi, group in enumerate(self.param_groups):
            params = group["params"]
            if params and params[0].is_cuda:
                self._device_scalars(gi, params[0].device)
                out[gi] = torch.empty((len(params) + 1, 6),
                                      dtype=torch.int64,
                                      device=params[0].device)
        return out

    @torch.no_grad()
    def capture_update(self, buffers: dict) -> list:
        """Inside a CUDA graph's capture, after the backward: each group's
        launch over its parameters with a gradient, reading its scalars
        tensor, from a table built into its buffer (``capture_buffers``,
        made before the capture). Returns [(group index, params, table)],
        whose tables the caller uploads once the capture has ended and
        which ``graph_host_step`` takes before every replay. A key's first
        call is an eager step, which gives every such parameter its
        state: one without a state, or off the card, raises before any
        launch."""
        groups = []
        for gi, group in enumerate(self.param_groups):
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            if gi not in buffers or any(
                    "exp_avg" not in self.state.get(p, {}) for p in params):
                raise RuntimeError(
                    f"Adam's group {gi} has a parameter with a gradient "
                    "but no state, or off the card: a graph captures the "
                    "update only after an eager step of this optimizer")
            groups.append((gi, params, AdamTable(
                *self._launch_lists(gi, params), out=buffers[gi])))
        for gi, _, table in groups:
            group = self.param_groups[gi]
            adam_fused_step(table, self._scalars[(gi, table.device)],
                            group["betas"], group["eps"])
        return groups

    def graph_host_step(self, captured: list) -> None:
        """The host part of the step whose launches ``capture_update``
        captured, before the graph's replay."""
        for gi, params, _ in captured:
            self._advance(gi, params)


def adam_step(optimizer) -> int:
    """The updates an Adam (this one or torch's) has made, 0 before the
    first: the step a checkpoint of it records."""
    return max((int(st["step"]) for st in optimizer.state.values()),
               default=0)


def make_optimizer(model: torch.nn.Module, cfg: TrainConfig,
                   steps_per_epoch: int):
    """(Adam, MultiStepLR) with the milestones in steps (epoch milestone
    x steps_per_epoch), stepped once per step: update u (1-based) uses
    lr * gamma^(number of milestones m with u > m), as the JAX package's
    optax piecewise-constant schedule does. The moments are stored in
    ``cfg.adam_mu_dtype`` / ``adam_nu_dtype``."""
    optimizer = Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                     eps=1e-8, mu_dtype=torch_dtype(cfg.adam_mu_dtype),
                     nu_dtype=torch_dtype(cfg.adam_nu_dtype))
    spe = max(int(steps_per_epoch), 1)
    scheduler = torch.optim.lr_scheduler.MultiStepLR(
        optimizer, milestones=[int(m) * spe for m in cfg.lr_milestones],
        gamma=cfg.lr_gamma)
    return optimizer, scheduler


def _payload(model: torch.nn.Module, optimizer, scheduler, *, step: int,
             epoch: int, generator, model_cfg, train_cfg, extra,
             host: bool = True, rank_generators=None,
             optimizer_state=None) -> dict:
    """The checkpoint's dict; the weights copied to the CPU with
    ``host``, else left where they are."""
    sched = None
    if scheduler is not None:
        sched = scheduler.state_dict()
        # a plain dict: torch.load(weights_only=True) refuses Counter
        sched["milestones"] = dict(sched["milestones"])
    return {
        "state_dict": {k: v.detach().cpu() if host else v.detach()
                       for k, v in model.state_dict().items()},
        "optimizer": (optimizer_state if optimizer_state is not None
                      else optimizer.state_dict() if optimizer else None),
        "scheduler": sched,
        "step": int(step),
        "epoch": int(epoch),
        "generator": generator.get_state() if generator else None,
        "model_config": (dataclasses.asdict(model_cfg)
                         if model_cfg is not None else None),
        "train_config": (dataclasses.asdict(train_cfg)
                         if train_cfg is not None else None),
        "extra": dict(extra or {}),
        # a data-parallel run's dropout generator state of every data
        # index, in order ("generator" is data index 0's)
        "rank_generators": rank_generators,
    }


def _write(path: str, payload: dict) -> None:
    """``torch.save`` to a temporary file of its own beside ``path`` (two
    writers of one path never share one), then renamed onto it."""
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    scheduler=None, *, step: int = 0, epoch: int = 0,
                    generator: Optional[torch.Generator] = None,
                    model_cfg=None, train_cfg=None,
                    extra: Optional[dict] = None,
                    rank_generators: Optional[list] = None,
                    optimizer_state: Optional[dict] = None) -> None:
    """One full dict: ``state_dict`` (CPU, reference names), optimizer
    and scheduler state, step, epoch (the next one to run), the dropout
    generator's state, both configs and ``extra``; a data-parallel run
    adds the generator state of every data index (``rank_generators``).
    ``optimizer_state`` stands for ``optimizer.state_dict()`` where the
    caller already has it in the tp = 1 layout
    (``parallel.tp.full_optimizer_state``). Written to a unique
    temporary file beside ``path``, then renamed onto it."""
    _write(path, _payload(model, optimizer, scheduler, step=step,
                          epoch=epoch, generator=generator,
                          model_cfg=model_cfg, train_cfg=train_cfg,
                          extra=extra, rank_generators=rank_generators,
                          optimizer_state=optimizer_state))


def _host_copy(obj):
    """``obj`` with every tensor copied to the host: a CUDA tensor into
    pinned memory on the current stream without waiting (the stream's
    order puts the copy before any later update of the tensor), a CPU
    tensor at once."""
    if torch.is_tensor(obj):
        if obj.is_cuda:
            host = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
            return host.copy_(obj.detach(), non_blocking=True)
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


_ASYNC_SAVES: List[Tuple[threading.Thread, list]] = []


def async_save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                          scheduler=None, *, step: int = 0, epoch: int = 0,
                          generator: Optional[torch.Generator] = None,
                          model_cfg=None, train_cfg=None,
                          extra: Optional[dict] = None) -> None:
    """``save_checkpoint`` that returns before the file is written: the
    device-to-host copies are queued on the caller's stream, then a
    daemon thread waits for them, serializes and writes (each call to
    its own temporary file, renamed into place). Training may go on at
    once. ``wait_for_async_saves`` joins the threads and raises what a
    save raised."""
    payload = _host_copy(_payload(
        model, optimizer, scheduler, step=step, epoch=epoch,
        generator=generator, model_cfg=model_cfg, train_cfg=train_cfg,
        extra=extra, host=False))
    copied = None
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        copied = torch.cuda.Event()
        copied.record()
    errors: list = []

    def work():
        try:
            if copied is not None:
                copied.synchronize()
            _write(path, payload)
        except BaseException as e:  # handed to wait_for_async_saves
            errors.append(e)

    thread = threading.Thread(target=work, daemon=True)
    thread.start()
    _ASYNC_SAVES.append((thread, errors))


def wait_for_async_saves() -> None:
    """Wait for every ``async_save_checkpoint`` begun; re-raise the first
    failure."""
    failures = []
    while _ASYNC_SAVES:
        thread, errors = _ASYNC_SAVES.pop(0)
        thread.join()
        failures += errors
    if failures:
        raise failures[0]


def load_checkpoint(path: str, model: Optional[torch.nn.Module] = None,
                    optimizer=None, scheduler=None,
                    generator: Optional[torch.Generator] = None) -> dict:
    """Read a checkpoint of any kind the port takes and restore whatever
    of model, optimizer, scheduler and generator is given. Returns the
    payload; for every kind it holds ``state_dict`` (float32, the
    reference's names), ``step``, ``epoch`` (the next one to run) and
    ``extra``.

    - The port's own (``save_checkpoint``): all of it, the dropout
      generator's state too.
    - A reference ``.pt``, a bare state_dict or the full dict: the
      weights; from a full dict also the epoch and the Adam moments with
      their step (``reference_adam_state``; unusable optimizer state is
      reported and the optimizer left fresh, as the JAX package does),
      and the scheduler at that step.
    - A JAX-package msgpack: the weights (a legacy ``(n, in, d)`` conv
      kernel migrated), Adam's moments (in the optimizer's moment
      dtypes, as JAX's resume casts to its template's) and its count, the
      scheduler at the schedule's count, the step, the epoch and
      ``extra`` (``step_in_epoch`` of a checkpoint written mid-epoch).
      Its dropout key (an rbg key) has no torch counterpart, so the
      generator is left as it is: ``fit`` seeds it from
      ``TrainConfig.seed``. Dropout bits never matched JAX's anyway.
    """
    if not is_torch_file(path):
        with open(path, "rb") as f:
            tree = read_flax_msgpack(f.read())
        return _restore_jax(tree, model, optimizer, scheduler)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if is_port_checkpoint(payload):
        _restore_port(payload, model, optimizer, scheduler, generator)
        return payload
    return _restore_reference(payload, model, optimizer, scheduler)


def _restore_port(payload: dict, model=None, optimizer=None,
                  scheduler=None, generator=None) -> None:
    """``load_checkpoint`` for the port's own payload already read. A
    checkpoint without scheduler state (``--trainval``'s named file)
    puts the scheduler at the checkpoint's step."""
    if model is not None:
        model.load_state_dict(payload["state_dict"])
    if optimizer is not None and payload.get("optimizer") is not None:
        optimizer.load_state_dict(payload["optimizer"])
    if scheduler is not None:
        if payload.get("scheduler") is not None:
            sched = dict(payload["scheduler"])
            sched["milestones"] = collections.Counter(sched["milestones"])
            scheduler.load_state_dict(sched)
        else:
            set_schedule_step(scheduler, int(payload.get("step", 0)))
    if generator is not None and payload.get("generator") is not None:
        generator.set_state(payload["generator"])


def is_torch_file(path: str) -> bool:
    """True for ``torch.save`` output: zip archives start with "PK",
    legacy pickles with the 0x80 PROTO opcode and a small protocol byte.
    The JAX package's msgpack checkpoints start with a fixmap whose
    second byte is a key string marker (>= 0xa0), so the two never
    collide."""
    with open(path, "rb") as f:
        head = f.read(2)
    return head[:2] == b"PK" or (len(head) == 2 and head[0] == 0x80
                                 and head[1] < 0x08)


def is_port_checkpoint(payload) -> bool:
    """True for a dict written by ``save_checkpoint`` (the reference's
    full dict has no "step" or "scheduler")."""
    return (isinstance(payload, dict) and "state_dict" in payload
            and "step" in payload and "scheduler" in payload)


def set_schedule_step(scheduler, step: int) -> None:
    """Put a MultiStepLR at ``step`` updates done, as if it had been
    stepped that many times (lr = base x gamma^(milestones <= step))."""
    passed = sum(c for m, c in scheduler.milestones.items() if m <= step)
    state = scheduler.state_dict()
    lrs = [base * scheduler.gamma ** passed for base in scheduler.base_lrs]
    state.update(last_epoch=int(step), _step_count=int(step) + 1,
                 _last_lr=lrs)
    scheduler.load_state_dict(state)
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr


def reference_adam_state(ckpt: dict, model: torch.nn.Module,
                         optimizer: torch.optim.Optimizer
                         ) -> Tuple[Dict, int]:
    """``optimizer``'s state_dict holding the Adam moments of a reference
    full-dict checkpoint, and their step count.

    torch keys Adam's state by the parameter's index in the reference's
    ``model.parameters()`` order, which (no buffers) is the order of the
    checkpoint's ``state_dict`` keys: index -> reference name -> the
    port's parameter of that name, wherever it sits in the port's own
    order. Raises ValueError (as the JAX package's reader does) when the
    state is missing, not Adam's, does not cover every parameter, or
    its per-parameter steps disagree."""
    opt_sd = ckpt.get("optimizer") or {}
    state = opt_sd.get("state") or {}
    if not state:
        raise ValueError("checkpoint carries no optimizer state")
    first = next(iter(state.values()))
    if "exp_avg" not in first:
        raise ValueError("optimizer state is not Adam-shaped "
                         f"(fields: {sorted(first)})")
    counts = {int(torch.as_tensor(s["step"]).reshape(()).item())
              for s in state.values()}
    if len(counts) > 1:
        raise ValueError(f"per-param Adam steps disagree: {sorted(counts)}")
    count = counts.pop()
    order = [reference_name(k) for k in ckpt["state_dict"]]
    moments = {}
    for i, s in state.items():
        if not 0 <= int(i) < len(order):
            raise ValueError(f"optimizer state for parameter index {i} of "
                             f"{len(order)}")
        moments[order[int(i)]] = (s["exp_avg"], s["exp_avg_sq"])
    return adam_state_by_name(model, optimizer, moments, count), count


def adam_state_by_name(model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer,
                       moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                       count: int) -> Dict:
    """``optimizer``'s state_dict with Adam's (first, second) moments given
    per parameter name, in float32 (``Adam.load_state_dict`` casts them
    to its moment dtypes), all at step ``count``. Raises
    ValueError for an unknown name, a shape that is not the parameter's,
    or a parameter left without moments."""
    named = dict(model.named_parameters())
    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    new_state = {}
    for name, (m, v) in moments.items():
        param = named.get(name)
        if param is None or id(param) not in index:
            raise ValueError(f"optimizer state for unknown parameter {name}")
        if m.shape != param.shape or v.shape != param.shape:
            raise ValueError(f"Adam moments of {name} have shape "
                             f"{tuple(m.shape)}, the parameter "
                             f"{tuple(param.shape)}")
        new_state[index[id(param)]] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": m.float().clone(), "exp_avg_sq": v.float().clone()}
    missing = sorted(set(index.values()) - set(new_state))
    if missing:
        raise ValueError(f"optimizer state lacks {len(missing)} parameters")
    out = optimizer.state_dict()
    out["state"] = new_state
    return out


def _restore_reference(ckpt: dict, model, optimizer, scheduler) -> dict:
    """``load_checkpoint`` for a reference ``.pt`` already read."""
    sd = reference_state_dict(ckpt)
    full = isinstance(ckpt.get("state_dict"), dict)
    step = 0
    if model is not None:
        model.load_state_dict(sd)
        if full and optimizer is not None:
            try:
                opt_state, step = reference_adam_state(ckpt, model,
                                                       optimizer)
            except (KeyError, ValueError) as e:
                print(f"torch checkpoint: optimizer state not imported "
                      f"({e}); optimizer restarts fresh", flush=True)
            else:
                optimizer.load_state_dict(opt_state)
    if scheduler is not None:
        set_schedule_step(scheduler, step)
    return {"state_dict": sd, "step": step,
            "epoch": int(ckpt.get("epoch", 0)) if full else 0, "extra": {}}


def _float32(tree):
    """The tree with its tensors as float32 numpy arrays (bfloat16 Adam
    moments widened exactly)."""
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    return tree.float().numpy() if torch.is_tensor(tree) else tree


def _restore_jax(tree, model, optimizer, scheduler) -> dict:
    """``load_checkpoint`` for a JAX-package msgpack tree already read:
    ``{params, opt_state, step, epoch, rng, extra}``, with ``opt_state``
    optax's (ScaleByAdamState(count, mu, nu), ScaleByScheduleState(count))
    stored as {"0": {...}, "1": {...}}."""
    if not isinstance(tree, dict) or "params" not in tree:
        raise ValueError("not a JAX-package checkpoint: no params at the top "
                         "level")
    if optimizer is not None and model is None:
        raise ValueError("restoring the optimizer needs the model")
    migrate_conv_kernels(tree)
    sd = state_dict_from_jax_params(_float32(tree["params"]))
    if model is not None:
        model.load_state_dict(sd)
    opt = tree.get("opt_state")
    if optimizer is not None or scheduler is not None:
        if not (isinstance(opt, dict) and {"count", "mu", "nu"}
                <= set(opt.get("0", {})) and "count" in opt.get("1", {})):
            raise ValueError("the checkpoint's optimizer state is not "
                             "(Adam, schedule)")
    if optimizer is not None:
        adam = opt["0"]
        mu = state_dict_from_jax_params(_float32(adam["mu"]))
        nu = state_dict_from_jax_params(_float32(adam["nu"]))
        optimizer.load_state_dict(adam_state_by_name(
            model, optimizer, {k: (mu[k], nu[k]) for k in mu},
            int(adam["count"])))
    if scheduler is not None:
        set_schedule_step(scheduler, int(opt["1"]["count"]))
    return {"state_dict": sd, "step": int(tree.get("step", 0)),
            "epoch": int(tree.get("epoch", 0)),
            "extra": dict(tree.get("extra") or {})}
