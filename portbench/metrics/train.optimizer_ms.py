"""train.optimizer_ms: host ms a step of the untraced window spends
issuing the optimizer's step and the schedule's. The program's span
``train_step.optimizer``, from its ring (``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "train", "train_step.optimizer")
