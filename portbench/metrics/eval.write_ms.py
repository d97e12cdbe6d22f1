"""eval.write_ms: host ms an evaluate call of the untraced window spends
writing result.json. The program's span ``evaluate.write``, from its
ring (``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "eval", "evaluate.write")
