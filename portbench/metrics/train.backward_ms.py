"""train.backward_ms: host ms a step of the untraced window spends in
the gradients' zeroing and autograd's backward (over ranks, the all-
reduce too). The program's span ``train_step.backward``, from its ring
(``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "train", "train_step.backward")
