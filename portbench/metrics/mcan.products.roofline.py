"""mcan.products.roofline: the least time of the profiled stretch's
products (portbench/counts/mcan.py: over each image's live regions and
each question's live tokens only, at the H100's published peaks) as a
share of the product kernels' device time there (``_products``), %."""

from portbench.metrics import _common, _products


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None or "products_least_s" not in rec:
        return None
    s = _products.product_seconds(rec)
    return 100.0 * rec["products_least_s"] / s if s > 0 else None
