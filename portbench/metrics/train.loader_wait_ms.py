"""train.loader_wait_ms: host ms a step of the untraced window waits on
the prefetch worker's queue. The program's span ``loader.wait``, from
its ring (``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "train", "loader.wait")
