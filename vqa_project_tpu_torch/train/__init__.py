"""Training: steps, optimizer and checkpoints, metrics, the loop."""

from vqa_project_tpu_torch.train.loop import build_model, fit
from vqa_project_tpu_torch.train.metrics import MetricLogger
from vqa_project_tpu_torch.train.state import (load_checkpoint,
                                               make_optimizer,
                                               save_checkpoint)
from vqa_project_tpu_torch.train.steps import (densify_labels, eval_step,
                                               sparse_vqa_score, train_step)

__all__ = ["fit", "build_model", "MetricLogger", "make_optimizer",
           "save_checkpoint", "load_checkpoint", "densify_labels",
           "sparse_vqa_score", "train_step", "eval_step"]
