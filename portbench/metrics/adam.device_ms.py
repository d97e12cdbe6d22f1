"""adam.device_ms: device ms a profiled step spends in the optimizer's
multi-tensor (foreach) kernels, from the profiler's trace."""

from portbench.metrics import _common


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None:
        return None
    s = sum(t for name, t in rec["device_ops"] if "multi_tensor_apply" in name)
    return 1e3 * s / rec["traced_units"] if s > 0 else None
