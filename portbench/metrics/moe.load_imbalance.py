"""moe.load_imbalance: the busiest held expert's rows over the held
experts' mean, over the untraced window's steps and MoE blocks: the
program's counts ``moe.max_expert_rows`` over ``moe.held_rows`` /
``held`` (``_moe``; ``held``, the experts a block holds, from the
configuration's ``n_routed_experts``, which ``rec`` carries). 1 is an
even load; the grouped kernel's time follows the busiest expert's."""

from portbench.metrics import _moe


def read(rec):
    s = _moe.sums(rec)
    if s is None or s["moe.held_rows"] <= 0 or not rec.get("held_experts"):
        return None
    return s["moe.max_expert_rows"] * rec["held_experts"] / s["moe.held_rows"]
