"""Per-layer times from the program's own spans: the ring that
``vqa_project_tpu_torch.train.profiling.annotate`` keeps in memory, read
after the cell's run has returned, in its process.

The window is the untraced one: the last ``rec["units"]`` records of the
family's top-level span (``train_step``, ``evaluate``) that no profiler
saw; the warm-up lies before them, the profiled stretch after. It runs
from the end of the top-level record before them (the warm-up's last;
else the first one's start), so that the first unit's wait for its
batch falls inside, to the last one's end. A metric is its span's total
time over the records that start inside the window, per unit of work,
in ms. None for another family, a ring with fewer top-level
records than units, a span that never ran, or a program without the
ring."""

TOP = {"train": "train_step", "eval": "evaluate"}
NAME, T0, T1, PROFILED = 0, 4, 5, 6


def ring():
    """The program's ring of spans, or None where it keeps none."""
    from vqa_project_tpu_torch.train import profiling
    recent = getattr(profiling, "recent_spans", None)
    return None if recent is None else recent()


def window(spans, top: str, units: int):
    """(t0_ns, t1_ns) of the window of the last ``units`` unprofiled
    ``top`` records, or None."""
    tops = [s for s in spans if s[NAME] == top and not s[PROFILED]]
    if units <= 0 or len(tops) < units:
        return None
    last = tops[-units:]
    start = tops[-units - 1][T1] if len(tops) > units else last[0][T0]
    return start, last[-1][T1]


def ms_per_unit(rec, family: str, name: str, spans=None):
    if not rec or rec.get("family") != family:
        return None
    spans = ring() if spans is None else spans
    w = None if not spans else window(spans, TOP[family], rec["units"])
    if w is None:
        return None
    inside = [s[T1] - s[T0] for s in spans
              if s[NAME] == name and w[0] <= s[T0] < w[1]]
    return 1e-6 * sum(inside) / rec["units"] if inside else None
