"""adam.graphed_share: the share (%) of the untraced window's steps whose
Adam ran inside the step's replayed CUDA graph: the program's count
``adam.graphed`` (one record a ``train_step``, 1 or 0,
``train.profiling.count``) over the records made inside the window of
the ring's ``train_step`` records (``_spans.window``). None where the
program keeps no such count (a program whose Adam never enters the
graph)."""

from portbench.metrics import _spans

NAME, VALUE, T = 0, 1, 2


def counts():
    from vqa_project_tpu_torch.train import profiling
    recent = getattr(profiling, "recent_counts", None)
    return None if recent is None else recent()


def read(rec):
    if not rec or rec.get("family") != "train":
        return None
    made, spans = counts(), _spans.ring()
    if not made or not spans:
        return None
    w = _spans.window(spans, "train_step", rec["units"])
    if w is None:
        return None
    inside = [c[VALUE] for c in made
              if c[NAME] == "adam.graphed" and w[0] <= c[T] < w[1]]
    if not inside:
        return None
    return 100.0 * sum(inside) / len(inside)
