"""Fused Gaussian-weight neighbourhood aggregation (graph-conv tail).

Counterpart of ``vqa_project_tpu/ops/pallas/edge_aggregate.py::
fused_sel_aggregate_act``, inference forward. On CUDA tensors the
wrapper launches the hand-written kernel in ``csrc/edge_aggregate.cu``;
on CPU tensors it runs ``sel_aggregate_act_reference``, the plain
PyTorch version of the same function.
"""

from __future__ import annotations

import torch

from vqa_project_tpu_torch.ops import _build
from vqa_project_tpu_torch.ops.gaussian import gaussian_kernel_weights

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def sel_aggregate_act_reference(sel: torch.Tensor, pseudo: torch.Tensor,
                                proj: torch.Tensor, gparams: torch.Tensor,
                                relu: bool = False) -> torch.Tensor:
    """Plain version: Gaussian kernel weights times ``sel``, aggregated
    over neighbours per kernel in float32, then relu, in ``proj.dtype``.

    Args:
      sel:     (B, K, K) selected edge weights (alpha or the 0/1 mask).
      pseudo:  (B, K, K, 2) polar pseudo-coordinates.
      proj:    (B, K, n*d) per-kernel projected node features; column
               block n*d:(n+1)*d is kernel n.
      gparams: (4, n) [mu_rho; mu_theta; prec_rho; prec_theta].
    Returns: (B, K, n*d) in proj.dtype.
    """
    n_kernels = gparams.shape[1]
    b, k, nd = proj.shape
    gw = gaussian_kernel_weights(pseudo, gparams[0], gparams[1],
                                 gparams[2], gparams[3])   # (B, K, K, n)
    edge_w = gw * sel.float()[..., None]
    proj4 = proj.float().reshape(b, k, n_kernels, nd // n_kernels)
    out = torch.einsum("bijn,bjnd->bind", edge_w, proj4).reshape(b, k, nd)
    if relu:
        out = torch.relu(out)
    return out.to(proj.dtype)


def _check_cuda_inputs(sel, pseudo, proj, gparams):
    dev = proj.device
    for name, t in (("sel", sel), ("pseudo", pseudo), ("gparams", gparams)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, proj on {dev}")
    if proj.dtype not in _DTYPE_CODE:
        raise TypeError(f"proj must be float32 or bfloat16, got {proj.dtype}")
    for name, t in (("sel", sel), ("pseudo", pseudo), ("gparams", gparams)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if proj.dim() != 3:
        raise ValueError(f"proj must be (B, K, n*d), got {tuple(proj.shape)}")
    b, k, nd = proj.shape
    if gparams.dim() != 2 or gparams.shape[0] != 4:
        raise ValueError(f"gparams must be (4, n), got {tuple(gparams.shape)}")
    n_kernels = gparams.shape[1]
    if nd % n_kernels:
        raise ValueError(f"proj width {nd} is not a multiple of n={n_kernels}")
    if tuple(sel.shape) != (b, k, k):
        raise ValueError(f"sel must be {(b, k, k)}, got {tuple(sel.shape)}")
    if tuple(pseudo.shape) != (b, k, k, 2):
        raise ValueError(
            f"pseudo must be {(b, k, k, 2)}, got {tuple(pseudo.shape)}")
    for name, t in (("sel", sel), ("pseudo", pseudo), ("proj", proj),
                    ("gparams", gparams)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, k, n_kernels, nd // n_kernels


def fused_sel_aggregate_act(sel: torch.Tensor, pseudo: torch.Tensor,
                            proj: torch.Tensor, gparams: torch.Tensor,
                            relu: bool = False,
                            dropout_rate: float = 0.0) -> torch.Tensor:
    """Aggregation over pre-selected edge weights with an optional relu.

    Same layout as the JAX entry: sel (B, K, K) f32, pseudo (B, K, K, 2)
    f32, proj (B, K, n*d) in the compute dtype, gparams (4, n) f32;
    returns (B, K, n*d) in proj.dtype. Dropout comes with the training
    slice.
    """
    if dropout_rate > 0:
        raise NotImplementedError(
            "in-kernel dropout is part of the training path")
    if proj.device.type == "cpu":
        return sel_aggregate_act_reference(sel, pseudo, proj, gparams, relu)
    b, k, n_kernels, d = _check_cuda_inputs(sel, pseudo, proj, gparams)
    lib = _build.load("edge_aggregate")
    out = torch.empty_like(proj)
    stream = torch.cuda.current_stream(proj.device).cuda_stream
    rc = lib.edge_aggregate_fwd(
        sel.data_ptr(), pseudo.data_ptr(), proj.data_ptr(),
        gparams.data_ptr(), out.data_ptr(), b, k, n_kernels, d,
        int(bool(relu)), _DTYPE_CODE[proj.dtype], stream)
    _build.check(rc, "edge_aggregate_fwd")
    fused_sel_aggregate_act.launches += 1
    return out


fused_sel_aggregate_act.launches = 0
