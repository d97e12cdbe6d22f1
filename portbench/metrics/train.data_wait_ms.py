"""train.data_wait_ms: host ms a step of the untraced window waits in
the prefetch iterator's next() (the loader's layer: Batcher,
prefetch_to_device), by the harness's span on the host clock."""

from portbench.metrics import _common


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None or "data_wait" not in rec["span_totals"]:
        return None
    return 1e3 * rec["span_totals"]["data_wait"] / rec["units"]
