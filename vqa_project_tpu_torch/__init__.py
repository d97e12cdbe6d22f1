"""PyTorch/CUDA port of the conditioned-graph VQA framework.

Sits beside ``vqa_project_tpu`` (the JAX reference) and mirrors its
layout. It imports ``torch`` and never JAX or the JAX package. The
serving and training paths' kernels (the graph aggregation forward and
backward, the GRU scan and its backward) are hand-written CUDA for
Hopper (``csrc/``); each has a plain PyTorch version beside it that
serves CPU tensors. Entry points (``serve.InferenceServer``,
``train.fit``, the CLI ``python -m vqa_project_tpu_torch.cli.run``) take
a device that defaults to ``"cuda"``.
"""

from vqa_project_tpu_torch.config import (ModelConfig, TrainConfig,
                                          resolve_device)

__all__ = ["ModelConfig", "TrainConfig", "resolve_device"]
