"""eval.assemble_ms: host ms an evaluate call of the untraced window
spends building its batches and their one copy to the card. The
program's span ``evaluate.assemble``, from its ring (``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "eval", "evaluate.assemble")
