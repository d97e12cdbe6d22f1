"""mfu.eval: the model's product operations an evaluate call
(portbench/counts/ops.py::model_flops over the rows filled) times the
window's calls, over the untraced window's time times the H100's bf16
peak, %."""

from portbench.metrics import _common


def read(rec):
    return _common.mfu(rec, "eval")
