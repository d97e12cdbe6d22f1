"""mcan.products.device_ms: device ms a profiled MCAN training step
spends in the product kernels (``_products``), from the profiler's
trace; None outside MCAN's cells (no ``products_least_s``)."""

from portbench.metrics import _common, _products


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None or "products_least_s" not in rec:
        return None
    s = _products.product_seconds(rec)
    return 1e3 * s / rec["traced_units"] if s > 0 else None
