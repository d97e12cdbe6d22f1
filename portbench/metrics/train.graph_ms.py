"""train.graph_ms: host ms a step of the untraced window spends replaying
the step's CUDA graph and copying out its results. The program's span
``train_step.graph``, from its ring (``_spans``); None where no step of
the window replayed (a program without the graph path, or off the
card)."""

from portbench.metrics import _spans


def read(rec):
    return _spans.ms_per_unit(rec, "train", "train_step.graph")
