"""nemotron.products.roofline: the least time of the profiled stretch's
products but the held experts' (portbench/counts/nemotron_h.py::
library_least_seconds: over each sequence's live positions, at the
H100's published peaks) as a share of the library's product kernels'
device time there (``_nemotron``), %."""

from portbench.metrics import _common, _nemotron


def read(rec):
    rec = _common.of(rec, "train")
    if rec is None or "nemotron_products_least_s" not in rec:
        return None
    s = _nemotron.library_seconds(rec)
    return 100.0 * rec["nemotron_products_least_s"] / s if s > 0 else None
