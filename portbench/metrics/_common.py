"""Shared arithmetic of the per-layer readers. Each reader takes the
records of a traced run and returns its number, or None where the run
holds nothing for it to read (another family of cell, no device time)."""

from portbench.counts import peaks


def of(rec, family):
    """``rec`` if it is a traced run of ``family`` with device time."""
    if not rec or rec.get("family") != family or rec.get("busy_s", 0) <= 0:
        return None
    return rec


def roofline(rec, family):
    rec = of(rec, family)
    return None if rec is None else 100.0 * rec["least_s"] / rec["busy_s"]


def per_unit(rec):
    """(device busy s per unit of work in the trace, the untraced
    window's s per unit), or None."""
    if rec.get("units", 0) <= 0 or rec.get("elapsed_s", 0) <= 0:
        return None
    return (rec["busy_s"] / rec["traced_units"],
            rec["elapsed_s"] / rec["units"])


def idle_share(rec, family):
    rec = of(rec, family)
    pu = None if rec is None else per_unit(rec)
    return None if pu is None else 100.0 * (1.0 - pu[0] / pu[1])


def mfu(rec, family):
    rec = of(rec, family)
    pu = None if rec is None else per_unit(rec)
    return (None if pu is None
            else 100.0 * rec["unit_flops"] / (pu[1] * peaks.BF16_FLOPS))
