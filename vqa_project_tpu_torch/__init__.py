"""PyTorch/CUDA port of the conditioned-graph VQA framework.

Sits beside ``vqa_project_tpu`` (the JAX reference) and mirrors its
layout. It imports ``torch`` and never JAX or the JAX package. The
serving path's two graph kernels are hand-written CUDA for Hopper
(``csrc/``); each has a plain PyTorch version beside it that serves CPU
tensors. Entry points take a ``device`` argument that defaults to
``"cuda"``.
"""

from vqa_project_tpu_torch.config import ModelConfig, resolve_device

__all__ = ["ModelConfig", "resolve_device"]
