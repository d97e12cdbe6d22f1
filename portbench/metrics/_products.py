"""The device time of a traced training stretch's product kernels: the
cuBLAS and CUTLASS kernels of the products (GEMM, GEMV and cuBLASLt's
split-K reductions, under the names the H100's libraries give them)."""

PRODUCT = ("gemm", "gemv", "nvjet", "cutlass", "xmma", "splitkreduce")


def product_seconds(rec) -> float:
    return sum(t for name, t in rec["device_ops"]
               if any(k in name.lower() for k in PRODUCT))
