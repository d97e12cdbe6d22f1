"""kernels.roofline.eval: the least time of the traced stretch's work
(portbench/counts/ops.py: every operation these inputs need, at the
H100's published peaks) as a share of the device's busy time there, %."""

from portbench.metrics import _common


def read(rec):
    return _common.roofline(rec, "eval")
