"""moe.expert_gemm.roofline: the least time of the profiled stretch's
held-expert products (portbench/counts/nemotron_h.py::expert_ops over
the rows the program counted, at the H100's published peaks) as a share
of the grouped kernel's device time there (names with
``grouped_kernel``), %."""

from portbench.metrics import _common


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None or "expert_gemm_least_s" not in rec:
        return None
    s = sum(t for name, t in rec["device_ops"] if "grouped_kernel" in name)
    return 100.0 * rec["expert_gemm_least_s"] / s if s > 0 else None
