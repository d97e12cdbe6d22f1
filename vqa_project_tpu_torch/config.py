"""Model and training configuration, and device resolution.

``ModelConfig`` and ``TrainConfig`` carry the field names and defaults
of ``vqa_project_tpu/config.py``. There is no switch between
kernel and plain code: the device of the tensors decides (CUDA tensors
launch the kernels, CPU tensors take the plain versions).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

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
    # both graph convolutions, their projections and the neighbourhood
    # selection in one merged block per direction (ops/graph_block.py,
    # kernels H and I); the counterpart of the JAX package's
    # VQAX_MERGED_BLOCK=1, off by default as there
    merged_block: bool = False
    # serving only: int8 projections of both graph convolutions and of
    # the weight-norm layers (ops/quant.py); build the model with this on
    # and load quantize_state_dict_for_serving of a float state_dict
    quantized_inference: bool = False
    # the architecture: "graph" (models/graph_vqa.py) or "mcan", the
    # deep modular co-attention network (models/mcan.py, arXiv:1906.10770)
    # on hid_dim, emb_dim, the regions' feat_dim - 4 features, n_obj,
    # max_qlen, out_dim - 1 answers and dropout
    arch: str = "graph"


@dataclasses.dataclass
class TrainConfig:
    """Training-harness settings; the fields and defaults of
    ``vqa_project_tpu/config.py::TrainConfig`` that the port's trainer
    uses (reference run.py defaults)."""

    lr: float = 1e-4               # --lr
    epochs: int = 40               # --ep
    batch_size: int = 64           # --bsize
    lr_milestones: Tuple[int, ...] = (30,)   # MultiStepLR milestones (epochs)
    lr_gamma: float = 0.5
    seed: int = 1000               # weights, shuffle and dropout streams
    log_interval: int = 40         # steps per logged loss/accuracy window
    eval_interval: int = 400       # steps between mini-validations + ckpts
    save_dir: str = "./save"
    name: str = "model"
    prefetch: int = 2              # host->device prefetch depth (batches)
    # device-resident feature cache (train/loop.py::make_feature_cache):
    # used when the table in the cache dtype fits this budget, else
    # batches carry dense images from the host
    device_cache_bytes: int = 8 << 30
    # dtype of the cached feature table: "auto" follows the compute
    # dtype (exactly the model's inputs); "int8" quantizes each box row
    # (ops/quant.py) and dequantizes in the gather kernel
    feature_cache_dtype: str = "auto"  # auto | float32 | bfloat16 | int8
    # storage dtypes of Adam's first and second moments
    # (train/state.py::Adam): "float32" is the exact optax / torch Adam;
    # "bfloat16" halves a moment's memory and traffic. The update math
    # stays f32: mu rounds b1 * mu to bf16 inside its update, as optax's
    # mu_dtype does, and nu is widened exactly, stepped in f32 and
    # rounded back for storage, as the JAX package's nu_dtype does
    adam_mu_dtype: str = "float32"  # float32 | bfloat16
    adam_nu_dtype: str = "float32"  # float32 | bfloat16
    # data parallelism (parallel/): one rank per card, each on its share
    # of the global batch. num_devices None takes every rank of the
    # process group (one without a group); a count other than the
    # group's world raises. data_axis is JAX's name of the mesh axis the
    # batch is split on, kept so that a checkpoint's train_config holds
    # JAX's fields; a 1-D data mesh has no other axis to name
    data_axis: str = "data"
    num_devices: Optional[int] = None
    # model-parallel factor: tp > 1 puts the ranks on a (data, model)
    # grid and splits the Adam step of the rule-sharded parameters over
    # the model axis (parallel/tp.py); the batch splits over the data
    # axis only, so num_devices / tp ranks share it
    tp: int = 1
    # dtype of the data-parallel gradient all-reduce over one flat
    # buffer: "float32" is exact up to the order of the sum; "bfloat16"
    # rounds each rank's contribution to bf16, sums in bf16 and widens
    # back, halving the bytes. Only at world > 1, and refused for the
    # sharded feature cache and at tp > 1 (train.steps.supports_bf16_reduce)
    grad_reduce_dtype: str = "float32"  # float32 | bfloat16


def resolve_device(device="cuda") -> torch.device:
    """The torch device for ``device``, "cuda" with its index (the
    current card), so that it compares equal to a tensor's device;
    asking for CUDA without a usable GPU raises instead of quietly
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_guard(device: torch.device):
    """A context in which ``device`` is the current CUDA device, a no-op
    for the CPU. The hand kernels launch on the current device, on the
    stream of their tensors' device: a process that drives several cards
    (serving split over devices) must make each one current first, or a
    kernel runs on the wrong card, out of order with its inputs."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` -> the torch dtype."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt
