"""eval.graph_share: the share (%) of the untraced window's eval batches
whose forward replayed the eval CUDA graph: the program's count
``eval.graphed`` (one record a batch of ``eval_epoch``, 1 or 0,
``train.profiling.count``) over the records made inside the window of
the ring's ``evaluate`` records (``_spans.window``). None where the
program keeps no such count (a program whose eval forward never enters
a graph)."""

from portbench.metrics import _spans

NAME, VALUE, T = 0, 1, 2


def counts():
    from vqa_project_tpu_torch.train import profiling
    recent = getattr(profiling, "recent_counts", None)
    return None if recent is None else recent()


def read(rec):
    if not rec or rec.get("family") != "eval":
        return None
    made, spans = counts(), _spans.ring()
    if not made or not spans:
        return None
    w = _spans.window(spans, "evaluate", rec["units"])
    if w is None:
        return None
    inside = [c[VALUE] for c in made
              if c[NAME] == "eval.graphed" and w[0] <= c[T] < w[1]]
    if not inside:
        return None
    return 100.0 * sum(inside) / len(inside)
