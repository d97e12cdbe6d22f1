"""eval.emit_ms: host ms an evaluate call of the untraced window spends
building the result list. The program's span ``evaluate.emit``, from its
ring (``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "eval", "evaluate.emit")
