"""train.graph_share: the share (%) of the untraced window's train_step
records that replayed the step's CUDA graph, counted by the program's
span ``train_step.graph`` nested in them, from its ring (``_spans``).
None where the program never ran that span (a program without the graph
path, or off the card)."""

from portbench.metrics import _spans

PARENT = 1


def read(rec):
    if not rec or rec.get("family") != "train":
        return None
    spans = _spans.ring()
    if not spans or not any(s[_spans.NAME] == "train_step.graph"
                            for s in spans):
        return None
    w = _spans.window(spans, "train_step", rec["units"])
    if w is None:
        return None
    graphed = sum(1 for s in spans
                  if s[_spans.NAME] == "train_step.graph"
                  and s[PARENT] == "train_step" and w[0] <= s[_spans.T0] < w[1])
    return 100.0 * graphed / rec["units"]
