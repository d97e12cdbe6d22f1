"""The numbers that decide ``correct``, each beside its limit.

Training cells compare the first steps' losses, the first gradient as
the optimizer got it and the parameters' change over the steps, leaf by
leaf by the gap between the program's norm and the reference's, taken
against the reference's norm of that leaf or of the median leaf,
whichever is larger, and the first step's logits. Evaluation compares
answers: how far the reference's logit of each answered class
lies from the reference's own logit of that rank (rank 1: below its
best).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam
STILL = 1e-3


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return 0.5 * (s[(n - 1) // 2] + s[n // 2]) if n else 0.0


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Optional[List[str]] = None) -> Dict[str, float]:
    """Each leaf's | ||prog|| - ||ref|| | / max(||ref||, median leaf
    ||ref||); a leaf the program lacks has the norm 0."""
    names = list(ref) if names is None else names
    rn = {n: float(ref[n].double().norm()) for n in names}
    pn = {n: float(prog[n].double().norm()) if n in prog else 0.0
          for n in names}
    med = _median(list(rn.values()))
    out = {}
    for n in names:
        den = max(rn[n], med)
        out[n] = abs(pn[n] - rn[n]) / den if den > 0 else 0.0
        if not math.isfinite(pn[n]):
            out[n] = math.inf
    return out


def moving_leaves(grad_ref: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding:
    norm at least STILL x the median leaf's."""
    norms = {n: float(g.double().norm()) for n, g in grad_ref.items()}
    med = _median(list(norms.values()))
    return [n for n, v in norms.items() if v >= STILL * med]


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The median over rows of ||prog_row - ref_row|| / ||ref_row||: the
    typical row's relative gap, which a few rows whose neighbour
    selection flipped do not move."""
    if prog is None or prog.shape != ref.shape:
        return math.inf
    d = (prog.double() - ref.double()).norm(dim=1)
    v = float((d / ref.double().norm(dim=1).clamp(min=1e-30)).median())
    return v if math.isfinite(v) else math.inf


def train_numbers(losses_p, grad_p, change_p, logits_p, losses_r, grad_r,
                  change_r, logits_r, log=None) -> Dict[str, float]:
    """loss_gap: the largest relative gap of a step's loss; grad_gap and
    change_gap: the worst leaf's of ``leaf_gaps``; grad_median_gap: the
    median leaf's gap of the first gradient; logit_gap: ``row_gap`` of
    the first step's logits. ``log`` receives the worst leaves."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-12)
                   for p, r in zip(losses_p, losses_r))
    if len(losses_p) != len(losses_r) or not all(
            math.isfinite(x) for x in losses_p):
        loss_gap = math.inf
    grads = leaf_gaps(grad_p, grad_r)
    g_leaf = max(grads, key=grads.get)
    moving = moving_leaves(grad_r)
    changes = leaf_gaps(change_p, change_r, moving)
    c_leaf = max(changes, key=changes.get)
    if log is not None:
        whole = math.inf
        if logits_p is not None and logits_p.shape == logits_r.shape:
            whole = float((logits_p.double() - logits_r.double()).norm()
                          / logits_r.double().norm())
        log(f"first logits' relative gap, all rows {whole!r}")
        log(f"losses {list(losses_p)} reference {list(losses_r)}; worst "
            f"gradient leaf {g_leaf}, worst change leaf {c_leaf}; median "
            f"change gap {_median(list(changes.values()))!r}; "
            f"{len(grad_r) - len(moving)} leaves still in the reference: "
            f"{sorted(set(grad_r) - set(moving))}")
    return {"loss_gap": loss_gap, "grad_gap": grads[g_leaf],
            "grad_median_gap": _median(list(grads.values())),
            "change_gap": changes[c_leaf],
            "logit_gap": row_gap(logits_p, logits_r)}


def rank_gaps(ref_logits: torch.Tensor, answered: torch.Tensor
              ) -> torch.Tensor:
    """|ref sorted_i - ref[answer at rank i]| for each row r and rank i:
    how far the reference's logit of each answered class lies from the
    reference's own logit of that rank (rank 1: below its best).
    ``ref_logits`` (N, C) with excluded classes at -inf, ``answered``
    (N, k) class ids; an id out of range counts as infinite."""
    k, c = answered.shape[1], ref_logits.shape[1]
    bad = (answered < 0) | (answered >= c)
    picked = ref_logits.gather(1, answered.clamp(0, c - 1).long())
    best = torch.topk(ref_logits, k, dim=1).values
    gap = (best - picked).abs()
    return torch.where(bad | ~torch.isfinite(gap),
                       torch.full_like(gap, math.inf), gap)


def rank_gap(ref_logits: torch.Tensor, answered: torch.Tensor) -> float:
    """The widest of ``rank_gaps``."""
    if answered.numel() == 0:
        return 0.0
    return float(rank_gaps(ref_logits, answered).max())


def rank_gap_rms(ref_logits: torch.Tensor, answered: torch.Tensor) -> float:
    """The root mean square of ``rank_gaps`` over every answered (row,
    rank): how often answers depart from the reference's order and by
    how much, together."""
    if answered.numel() == 0:
        return 0.0
    return float(rank_gaps(ref_logits, answered).double().pow(2).mean().sqrt())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(all within limits, {name: {value, limit}}). A number without a
    limit, or one that is not finite, fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits.get(name)
        good = lim is not None and math.isfinite(value) and value <= lim
        ok = ok and good
        out[name] = {"value": value, "limit": lim}
    return ok, out
