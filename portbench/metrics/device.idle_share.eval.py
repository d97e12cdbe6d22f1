"""device.idle_share.eval: the share of an evaluate call's time in the
untraced window in which no operation runs on the card: 1 - the
device's busy time of the profiled call (the union of kernels, copies
and fills) over the window's time a call, %."""

from portbench.metrics import _common


def read(rec):
    return _common.idle_share(rec, "eval")
