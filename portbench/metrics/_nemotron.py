"""The device time of a traced Nemotron-H training stretch's library
product kernels (``_products``' names): every product but the held
experts', whose grouped kernel (names with ``grouped_kernel``) the
``moe.expert_gemm`` readers read."""

from portbench.metrics import _products


def library_seconds(rec) -> float:
    return sum(t for name, t in rec["device_ops"]
               if any(k in name.lower() for k in _products.PRODUCT)
               and "grouped_kernel" not in name)
