"""Least times of the port's hand kernels, from their shapes alone.

The bound arithmetic that ``chip_smoke.py`` applies to each kernel,
rewritten as functions of integers (element sizes in bytes: 2 for
bfloat16, 4 for float32), so that a traced run can put a kernel's
device time beside its bound by name. Each returns (bytes, seconds of
operations); ``least_ms`` turns that into the least time. The
operations count what the kernel's algorithm does (dense K x K
aggregation, as the kernels compute it), as ``chip_smoke.py`` does.
"""

from __future__ import annotations

from typing import Tuple

from portbench.counts import peaks

GAUSS_FLOPS = 25      # per (edge, Gaussian kernel): two exp, two divides, ~20 more
GATE_FLOPS = 20       # per (row, unit, step): two sigmoid, tanh, blend
PHILOX_MULS = 28      # 32-bit multiplies per Philox4x32-10 word
# Hopper issues 64 32-bit integer multiplies per clock per SM: 132 SMs at
# the H100 SXM's 1,980 MHz top clock
INT_MULS_PER_S = 64 * 132 * 1.98e9


def _rate(el: int) -> float:
    return peaks.BF16_FLOPS if el == 2 else peaks.F32_FLOPS


def least_ms(nbytes: float, ops_s: float) -> float:
    return max(nbytes / peaks.HBM_BYTES, ops_s) * 1e3


def edge_bound(b: int, k: int, nd: int, n: int, el: int) -> Tuple[float, float]:
    """Kernel A: sel, pseudo and gparams read (f32), proj read and out
    written in proj's dtype; the K x K x n d product and the Gaussians."""
    nbytes = b * k * k * 4 + b * k * k * 2 * 4 + 4 * n * 4 + 2 * b * k * nd * el
    ops_s = (2 * b * k * k * nd / _rate(el)
             + GAUSS_FLOPS * b * k * k * n / peaks.F32_FLOPS)
    return nbytes, ops_s


def gru_bound(t: int, b: int, h: int, steps: int, el: int) -> Tuple[float, float]:
    """Kernel B: xp (f32), W_hh, b_hh, qlen read, the final state written;
    ``steps`` is the sum of the rows' lengths (no work past qlen)."""
    nbytes = t * b * 3 * h * 4 + 3 * h * h * el + 3 * h * 4 + b * 4 + b * h * 4
    ops_s = (2 * steps * h * 3 * h / _rate(el)
             + GATE_FLOPS * steps * h / peaks.F32_FLOPS)
    return nbytes, ops_s


def residual_bound(b: int, k: int, nd: int, n: int, el: int,
                   dropout: bool) -> Tuple[float, float]:
    """Kernel C: kernel A's work, the residuals ghat (n K x K) and denom
    written, the seeds read, and with dropout one Philox word an output
    element at the integer multiply rate."""
    nbytes, ops_s = edge_bound(b, k, nd, n, el)
    nbytes += (n + 1) * b * k * k * 4 + (b * 4 if dropout else 0)
    if dropout:
        ops_s += PHILOX_MULS * b * k * nd / INT_MULS_PER_S
    return nbytes, ops_s


def vjp_bound(b: int, k: int, nd: int, n: int, el: int,
              epilogue: bool) -> Tuple[float, float]:
    """Kernel D: g, proj (and out) in, dproj out in proj's dtype; sel,
    ghat, denom, pseudo in and dsel, dpseudo out in f32; two K x K x n d
    products and ~40 operations an edge and Gaussian kernel."""
    slabs = 4 if epilogue else 3
    nbytes = (slabs * b * k * nd * el + b * k * k * 4 * (1 + n + 1 + 2 + 1 + 2)
              + 2 * 4 * n * 4)
    ops_s = (2 * 2 * b * k * k * nd / _rate(el)
             + 40 * b * k * k * n / peaks.F32_FLOPS)
    return nbytes, ops_s


def sweep_bound(t: int, b: int, h: int, steps: int, late_steps: int,
                el: int) -> Tuple[float, float]:
    """Kernel E's reverse sweep: xp, hs, W once, dxp (f32) and dhp (W's
    dtype) out; the hp product for each active (row, step) and dhp @ W
    for the ``late_steps`` rows active one step later, ~30 operations a
    unit."""
    nbytes = (t * b * 3 * h * 4 * 2 + 3 * h * h * el + t * b * h * 4
              + b * h * 4 + 3 * h * 4 + b * 4 + t * b * 3 * h * el)
    ops_s = (2 * h * 3 * h * (steps + late_steps) / _rate(el)
             + 30 * h * steps / peaks.F32_FLOPS)
    return nbytes, ops_s


def wgrad_bound(t: int, b: int, h: int, late_steps: int,
                el: int) -> Tuple[float, float]:
    """Kernel E's dW/db: dhp and hs in, dW and db out (f32); products
    only where dhp and h_prev are both non-zero."""
    nbytes = t * b * 3 * h * el + t * b * h * el + 3 * h * h * 4 + 3 * h * 4
    return nbytes, 2 * 3 * h * h * late_steps / _rate(el)


def image_bytes(b: int, k: int, f: int, ld: int, table_el: int,
                node_el: int) -> int:
    """The image gather: each table row, box row, row index and (int8)
    scale read once, the node rows (``ld`` wide, pad included) and the
    f32 boxes written once."""
    return (b * k * f * table_el + b * k * 16 + b * 4
            + (b * k * 4 if table_el == 1 else 0)
            + b * k * ld * node_el + b * k * 16)


def block_bound(b: int, k: int, f1: int, nd1: int, nd2: int, n: int,
                el: int) -> Tuple[float, float]:
    """Kernel H: inputs read once (adjacency, pseudo, feats, both
    weights, gparams, seeds), out, h1, alpha, mask, both denominators and
    both ghat written; the projections at the operands' rate, the two
    K x K aggregations, the Gaussians and the K^3 rank at the f32 rate."""
    nbytes = (b * k * k * 4 * 3 + b * k * f1 * el + (f1 * nd1 + nd1 * nd2) * el
              + 2 * 4 * n * 4 + b * 4 + b * k * (nd1 + nd2) * el
              + b * k * k * 4 * (4 + 2 * n))
    ops_s = (2 * b * k * (f1 * nd1 + nd1 * nd2) / _rate(el)
             + (2 * b * k * k * (nd1 + nd2) + 2 * GAUSS_FLOPS * b * k * k * n
                + b * k * k * k) / peaks.F32_FLOPS)
    return nbytes, ops_s
