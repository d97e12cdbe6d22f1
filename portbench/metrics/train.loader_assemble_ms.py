"""train.loader_assemble_ms: host ms a step of the untraced window that
the prefetch worker's thread spends assembling batches (next, part, the
pack into pinned memory); it shares the interpreter's lock with the
step. The program's span ``loader.assemble``, from its ring
(``_spans``)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "train", "loader.assemble")
