"""Adam's update of every parameter as one CUDA launch.

Replaces no TPU kernel (the JAX package leaves optax to XLA); it takes
the place of the fourteen ``torch._foreach`` passes of
``adam_reference``, the plain version, which the CPU keeps.

- ``AdamTable(params, grads, mus, nus)``: the launch's device table, one
  row per tensor (the addresses of p, g, mu and nu, its element count,
  its first chunk of 4 elements) and a closing row holding the total. It
  is built on the host and written to the card by ``upload``, one copy
  from a host tensor that nothing rewrites. Inside a CUDA graph's capture
  it is built into ``out``, a buffer made before the capture (memory
  that the capture itself allocates may be what the graph's earlier
  kernels write), launched from, and uploaded once the capture has
  ended, since a capture takes no copy from the host. ``matches`` tells
  whether the tensors still lie where the table says.
- ``adam_fused_step(table, scalars, betas, eps)``: the update, in place,
  of every parameter and both moments in the table. ``scalars`` is a (3,)
  float32 tensor on the parameters' device holding lr, 1 - b1^t and
  1 - b2^t, read by the kernel when it runs, so that a captured launch
  replays with the values written before each replay. On CPU tensors it
  runs ``adam_reference`` and copies its moments back.

Parameters and gradients are float32; the moments float32 or bfloat16,
each list in one dtype. On the card every tensor must be contiguous (a
non-contiguous one raises) and empty ones are taken; there is no
fallback to the plain version.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from vqa_project_tpu_torch.config import device_guard
from vqa_project_tpu_torch.ops import _build

VEC = 4                      # elements a chunk: one 16-byte f32 vector
_MOMENT_CODE = {torch.float32: 0, torch.bfloat16: 1}


def adam_reference(params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor],
                   mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                   lr: float, bc1: float, bc2: float,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8
                   ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """The plain update, optax's ``scale_by_adam`` op by op over all
    tensors at once (``torch._foreach_*``), in f32: the parameters are
    updated in place; the new moments are returned in the dtypes of
    ``mus`` and ``nus``. A bfloat16 mu takes ``b1 mu`` as a bfloat16
    product (b1 rounded to bfloat16, as a Python float meeting a bfloat16
    array is in JAX); a bfloat16 nu is widened exactly, stepped in f32
    and rounded back (the JAX package's ``_with_nu_dtype``). ``bc1`` and
    ``bc2`` are 1 - b1^t and 1 - b2^t."""
    b1, b2 = betas
    mu_dtype, nu_dtype = mus[0].dtype, nus[0].dtype
    # b1 as the moment's dtype holds it: a bfloat16 b1 times a bfloat16
    # mu is exact in f32 and rounds once, to bfloat16
    b1_mu = float(torch.tensor(b1, dtype=mu_dtype))
    mu = torch._foreach_mul(grads, 1.0 - b1)
    torch._foreach_add_(mu, torch._foreach_mul(mus, b1_mu))
    nu = torch._foreach_mul(grads, grads)
    torch._foreach_mul_(nu, 1.0 - b2)
    wide = nus if nu_dtype == torch.float32 else [v.float() for v in nus]
    torch._foreach_add_(nu, torch._foreach_mul(wide, b2))
    update = torch._foreach_div(mu, bc1)
    denom = torch._foreach_div(nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_div_(update, denom)
    torch._foreach_mul_(update, -lr)
    torch._foreach_add_(params, update)
    return ([m.to(mu_dtype) for m in mu], [v.to(nu_dtype) for v in nu])


def _where(ts: Sequence[torch.Tensor]) -> tuple:
    return tuple(t.data_ptr() for t in ts)


class AdamTable:
    """One launch's tensors and, on the card, its device table (see the
    module's docstring); on the card it keeps the parameters and moments
    but not the gradients, whose addresses the table holds. Raises on
    lists of unequal length, shapes that differ, tensors on several
    devices, parameters or gradients other than float32, moments other
    than float32 or bfloat16 or in mixed dtypes, and on the card a
    non-contiguous tensor."""

    def __init__(self, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 mus: Sequence[torch.Tensor], nus: Sequence[torch.Tensor],
                 out: Optional[torch.Tensor] = None):
        self.params, self.grads = list(params), list(grads)
        self.mus, self.nus = list(mus), list(nus)
        lists = (self.params, self.grads, self.mus, self.nus)
        n = len(self.params)
        if n == 0 or any(len(x) != n for x in lists):
            raise ValueError("params, grads, mus and nus: one tensor each "
                             "per parameter, at least one")
        self.device = self.params[0].device
        for x in lists:
            if any(t.device != self.device for t in x):
                raise ValueError(f"tensors on several devices: "
                                 f"{sorted({str(t.device) for t in x})}")
        if any(t.dtype != torch.float32 for t in self.params + self.grads):
            raise TypeError("parameters and gradients must be float32")
        self.mu_dtype, self.nu_dtype = self.mus[0].dtype, self.nus[0].dtype
        for x, dt in ((self.mus, self.mu_dtype), (self.nus, self.nu_dtype)):
            if dt not in _MOMENT_CODE or any(t.dtype != dt for t in x):
                raise TypeError("each moment list in one dtype, float32 or "
                                "bfloat16")
        for p, g, m, v in zip(*lists):
            if not p.shape == g.shape == m.shape == v.shape:
                raise ValueError(f"shapes differ: {tuple(p.shape)}, "
                                 f"{tuple(g.shape)}, {tuple(m.shape)}, "
                                 f"{tuple(v.shape)}")
        self.key = None
        self.chunks = 0
        if self.device.type == "cpu":
            return
        if not all(t.is_contiguous() for x in lists for t in x):
            raise ValueError("adam_fused_step takes contiguous tensors only")
        self.key = self._key(*lists)
        rows, start = [], 0
        for p, g, m, v in zip(*lists):
            rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), p.numel(), start])
            start += -(-p.numel() // VEC)
        rows.append([0, 0, 0, 0, 0, start])
        self.chunks = start
        # the addresses are the table's; a table kept for reuse must not
        # keep a step's gradients alive
        self.grads = None
        # never rewritten: the source of every upload
        self.host = torch.tensor(rows, dtype=torch.int64)
        if out is None:
            self.table = torch.empty_like(self.host, device=self.device)
        elif (out.dtype != torch.int64 or out.device != self.device
              or out.dim() != 2 or out.shape[0] < n + 1 or out.shape[1] != 6
              or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous int64 (>= {n + 1}, "
                             f"6) tensor on {self.device}")
        else:
            self.table = out[:n + 1]

    @staticmethod
    def _key(params, grads, mus, nus) -> tuple:
        return (_where(params), _where(grads), _where(mus), _where(nus),
                tuple(p.numel() for p in params))

    def matches(self, params, grads, mus, nus) -> bool:
        """True where tensors at the same addresses and of the same sizes
        on the card would make this table again. A CPU table, which holds
        the tensors themselves and costs nothing to make, never does."""
        return self.key is not None and self.key == self._key(
            params, grads, mus, nus)

    def upload(self) -> None:
        """Write the table to the card: one copy on the current stream
        (none on the CPU)."""
        if self.key is not None:
            self.table.copy_(self.host, non_blocking=True)


def adam_fused_step(table: AdamTable, scalars: torch.Tensor,
                    betas: Tuple[float, float] = (0.9, 0.999),
                    eps: float = 1e-8) -> None:
    """One Adam update, in place, of every tensor in ``table`` (one
    launch on the card; ``adam_reference`` on the CPU). ``scalars``: (3,)
    float32 on the tensors' device, lr, 1 - b1^t and 1 - b2^t."""
    if (scalars.dtype != torch.float32 or tuple(scalars.shape) != (3,)
            or scalars.device != table.device):
        raise ValueError(f"scalars must be a (3,) float32 tensor on "
                         f"{table.device}")
    if table.key is None:
        lr, bc1, bc2 = scalars.tolist()
        mu, nu = adam_reference(table.params, table.grads, table.mus,
                                table.nus, lr, bc1, bc2, betas, eps)
        torch._foreach_copy_(table.mus, mu)
        torch._foreach_copy_(table.nus, nu)
        return
    if not scalars.is_contiguous():
        raise ValueError("scalars must be contiguous")
    b1, b2 = betas
    b1_mu = float(torch.tensor(b1, dtype=table.mu_dtype))
    lib = _build.load("adam")
    with device_guard(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.adam_fused_step(
            table.table.data_ptr(), table.chunks, scalars.data_ptr(),
            1.0 - b1, b1_mu, 1.0 - b2, b2, eps,
            _MOMENT_CODE[table.mu_dtype], _MOMENT_CODE[table.nu_dtype],
            stream)
    _build.check(rc, "adam_fused_step")
    adam_fused_step.launches += 1


_build.counted(adam_fused_step)
