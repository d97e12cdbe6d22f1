"""train.issue_ms: host ms a step of the untraced window spends inside
the train_step call (forward, loss, backward, Adam and the schedule
enqueued, with no sync), by the harness's span on the host clock; read
it against the step's wall time."""

from portbench.metrics import _common


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None or "train_step" not in rec["span_totals"]:
        return None
    return 1e3 * rec["span_totals"]["train_step"] / rec["units"]
