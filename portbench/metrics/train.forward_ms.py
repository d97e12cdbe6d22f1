"""train.forward_ms: host ms a step of the untraced window spends
issuing the forward pass: the model, the labels' densify and the loss.
The program's span ``train_step.forward``, from its ring
(``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "train", "train_step.forward")
