"""eval.fetch_ms: host ms an evaluate call of the untraced window waits
for the score and the predictions. The program's span
``evaluate.fetch``, from its ring (``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "eval", "evaluate.fetch")
