"""moe.expert_gemm.device_ms: device ms a profiled step spends in the
held experts' grouped product kernel (names with ``grouped_kernel``,
``csrc/moe_grouped_gemm.cu``), from the profiler's trace. None where no
such kernel ran."""

from portbench.metrics import _common


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None:
        return None
    s = sum(t for name, t in rec["device_ops"] if "grouped_kernel" in name)
    return 1e3 * s / rec["traced_units"] if s > 0 else None
