"""nemotron.products.device_ms: device ms a profiled Nemotron-H training
step spends in the library's product kernels (``_nemotron``): every
product but the held experts'; from the profiler's trace; None outside
Nemotron-H's cells (no ``nemotron_products_least_s``)."""

from portbench.metrics import _common, _nemotron


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None or "nemotron_products_least_s" not in rec:
        return None
    s = _nemotron.library_seconds(rec)
    return 1e3 * s / rec["traced_units"] if s > 0 else None
