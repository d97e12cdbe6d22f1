"""eval.epoch_issue_ms: host ms an evaluate call of the untraced window
spends in eval_epoch's issue loop. The program's span
``evaluate.epoch``, from its ring (``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "eval", "evaluate.epoch")
