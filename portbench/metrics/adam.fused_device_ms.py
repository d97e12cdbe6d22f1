"""adam.fused_device_ms: device ms a profiled step spends in the fused
Adam kernel (names with ``adam_fused``), from the profiler's trace. None
where no such kernel ran (a program that steps Adam otherwise)."""

from portbench.metrics import _common


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None:
        return None
    s = sum(t for name, t in rec["device_ops"] if "adam_fused" in name)
    return 1e3 * s / rec["traced_units"] if s > 0 else None
