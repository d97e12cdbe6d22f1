"""Training: steps, optimizer and checkpoints, metrics, the loop, the
device feature cache and evaluation."""

from vqa_project_tpu_torch.data.feature_cache import QuantizedFeatureCache
from vqa_project_tpu_torch.train.loop import (build_model, evaluate, fit,
                                              make_feature_cache)
from vqa_project_tpu_torch.train.metrics import MetricLogger
from vqa_project_tpu_torch.train.state import (load_checkpoint,
                                               make_optimizer,
                                               save_checkpoint)
from vqa_project_tpu_torch.train.steps import (densify_labels, eval_epoch,
                                               eval_step, make_image_fn,
                                               sparse_vqa_score,
                                               stack_epoch_batches,
                                               train_step,
                                               unpack_index_batch)

__all__ = ["fit", "evaluate", "build_model", "make_feature_cache",
           "MetricLogger", "make_optimizer", "save_checkpoint",
           "load_checkpoint", "QuantizedFeatureCache", "densify_labels",
           "sparse_vqa_score", "make_image_fn", "unpack_index_batch",
           "train_step", "eval_step", "stack_epoch_batches", "eval_epoch"]
