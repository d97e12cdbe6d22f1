"""Model configuration and device resolution.

``ModelConfig`` carries the field names and defaults of
``vqa_project_tpu/config.py::ModelConfig``. There is no switch between
kernel and plain code: the device of the tensors decides (CUDA tensors
launch the kernels, CPU tensors take the plain versions).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ModelConfig:
    """Hyper-parameters of the conditioned-graph VQA model (VQA v2
    defaults: hid 1024, 8 Gaussian kernels, 16 neighbours, 36 objects)."""

    vocab_size: int = 0            # set from dataset (q_words)
    emb_dim: int = 300             # --emb
    feat_dim: int = 2052           # 2048 RCNN + 4 bbox
    hid_dim: int = 1024            # --hid
    out_dim: int = 3001            # n_answers (top-3000 vocab + 1)
    combined_dim: int = 512        # graph-learner joint embedding
    n_kernels: int = 8             # --n_kernels
    neighbourhood_size: int = 16   # --neighbourhood_size
    n_obj: int = 36                # --n_obj (K region features per image)
    dropout: float = 0.5           # --dropout
    max_qlen: int = 16             # fixed question length after padding
    # Numerics policy: params + reductions fp32, matmul compute bf16.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


def resolve_device(device="cuda") -> torch.device:
    """The torch device for ``device``; asking for CUDA without a usable
    GPU raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` -> the torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
