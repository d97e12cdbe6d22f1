"""train.inputs_ms: host ms a step of the untraced window spends in the
step's input assembly: the copy in, the unpack and the image gather. The
program's span ``train_step.inputs``, from its ring (``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "train", "train_step.inputs")
