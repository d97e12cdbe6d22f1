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
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

import torch

from vqa_project_tpu_torch.config import TrainConfig, torch_dtype
from vqa_project_tpu_torch.models.weights import (reference_name,
                                                  reference_state_dict,
                                                  state_dict_from_jax_params)
from vqa_project_tpu_torch.train._msgpack import (migrate_conv_kernels,
                                                  read_flax_msgpack)


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
    configured dtypes, as the JAX package's resume does. Every operation
    runs over all parameters at once (``torch._foreach_*``).
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

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(self.mu_dtype)
                st["exp_avg_sq"] = st["exp_avg_sq"].to(self.nu_dtype)

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                self._update(group, params)
        return loss

    def _update(self, group, params: List[torch.Tensor]) -> None:
        b1, b2 = group["betas"]
        states = []
        for p in params:
            st = self.state[p]
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p, dtype=self.mu_dtype)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.nu_dtype)
            states.append(st)
        steps = [st["step"] for st in states]
        torch._foreach_add_(steps, 1.0)
        count = int(steps[0])
        grads = [p.grad for p in params]
        mus = [st["exp_avg"] for st in states]
        nus = [st["exp_avg_sq"] for st in states]
        # b1 as the moment's dtype holds it: a bfloat16 b1 times a
        # bfloat16 mu is exact in f32 and rounds once, to bfloat16
        b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
        mu = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(mus, b1_mu))
        nu = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(nu, 1.0 - b2)
        wide = nus if self.nu_dtype == torch.float32 else [
            v.float() for v in nus]
        torch._foreach_add_(nu, torch._foreach_mul(wide, b2))
        # optax's bias corrections: 1 - decay^count in f32
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
        update = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, group["eps"])
        torch._foreach_div_(update, denom)
        torch._foreach_mul_(update, -group["lr"])
        torch._foreach_add_(params, update)
        for st, m, v in zip(states, mu, nu):
            st["exp_avg"] = m.to(self.mu_dtype)
            st["exp_avg_sq"] = v.to(self.nu_dtype)


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
             host: bool = True, rank_generators=None) -> dict:
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
        "optimizer": optimizer.state_dict() if optimizer else None,
        "scheduler": sched,
        "step": int(step),
        "epoch": int(epoch),
        "generator": generator.get_state() if generator else None,
        "model_config": (dataclasses.asdict(model_cfg)
                         if model_cfg is not None else None),
        "train_config": (dataclasses.asdict(train_cfg)
                         if train_cfg is not None else None),
        "extra": dict(extra or {}),
        # a data-parallel run's every rank's dropout generator state, in
        # rank order ("generator" is rank 0's)
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
                    rank_generators: Optional[list] = None) -> None:
    """One full dict: ``state_dict`` (CPU, reference names), optimizer
    and scheduler state, step, epoch (the next one to run), the dropout
    generator's state, both configs and ``extra``; a data-parallel run
    adds every rank's generator state (``rank_generators``). Written to
    a unique temporary file beside ``path``, then renamed onto it."""
    _write(path, _payload(model, optimizer, scheduler, step=step,
                          epoch=epoch, generator=generator,
                          model_cfg=model_cfg, train_cfg=train_cfg,
                          extra=extra, rank_generators=rank_generators))


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
