"""device.idle_share.train: the share of a step's time in the untraced
window in which no operation runs on the card: 1 - the device's busy
time a step in the profiled stretch (the union of kernels, copies and
fills) over the window's time a step, %."""

from portbench.metrics import _common


def read(rec):
    return _common.idle_share(rec, "train")
