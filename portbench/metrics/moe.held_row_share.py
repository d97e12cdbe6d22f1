"""moe.held_row_share: of the live (token, slot) pairs that the MoE
blocks routed in the untraced window, the share whose expert is held on
this card (%): the program's counts ``moe.held_rows`` over
``moe.routed_rows`` (``_moe``). Near 100 x held / router experts where
the routing is even (12.5% for 16 of 128)."""

from portbench.metrics import _moe


def read(rec):
    s = _moe.sums(rec)
    if s is None or s["moe.routed_rows"] <= 0:
        return None
    return 100.0 * s["moe.held_rows"] / s["moe.routed_rows"]
