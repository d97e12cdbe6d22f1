"""mcan.padded_row_share: of the token and region rows that MCAN
computes in the untraced window's steps, the share that are padding
(%): the program's counts ``batch.padded_rows`` over ``batch.rows``,
which the loader's Batcher keeps for each batch it makes for MCAN
(``train.profiling.count``), those made inside the window of the ring's
``train_step`` records (``_spans.window``). None where the program keeps
no such counts."""

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
    total = {"batch.rows": 0, "batch.padded_rows": 0}
    for c in made:
        if c[NAME] in total and w[0] <= c[T] < w[1]:
            total[c[NAME]] += c[VALUE]
    if total["batch.rows"] <= 0:
        return None
    return 100.0 * total["batch.padded_rows"] / total["batch.rows"]
