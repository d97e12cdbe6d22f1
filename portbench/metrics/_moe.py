"""The MoE row counts of the untraced window: the sums that the
program's ``window_sums`` records at each fetch (``moe.routed_rows``,
``moe.held_rows``, ``moe.max_expert_rows``; ``train.profiling.count``),
those made inside the window of the ring's ``train_step`` records
(``_spans.window``). None where the program keeps no such counts (a
program or model without them)."""

from portbench.metrics import _spans

NAME, VALUE, T = 0, 1, 2
NAMES = ("moe.routed_rows", "moe.held_rows", "moe.max_expert_rows")


def sums(rec):
    if not rec or rec.get("family") != "train":
        return None
    from vqa_project_tpu_torch.train import profiling
    recent = getattr(profiling, "recent_counts", None)
    made, spans = (recent() if recent else None), _spans.ring()
    if not made or not spans:
        return None
    w = _spans.window(spans, "train_step", rec["units"])
    if w is None:
        return None
    total = dict.fromkeys(NAMES, 0)
    seen = False
    for c in made:
        if c[NAME] in total and w[0] <= c[T] < w[1]:
            total[c[NAME]] += c[VALUE]
            seen = True
    return total if seen else None
