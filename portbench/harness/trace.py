"""The traced part of a ``--trace 1`` run, read back into records that
the per-layer metric readers take.

The window of a traced run is measured as an untraced one is, with the
harness's spans around its calls into each layer timed on the host
clock (``Spans``). Once the window has closed, torch.profiler (CPU and
CUDA) records a short stretch of the same work, in which each span is
also a ``record_function`` named ``pb.<layer>``. The device's operations
(kernels, copies, fills) come from that trace; shares of the window's
time (idle, MFU) put the trace's device time per unit of work over the
untraced window's time per unit, so the profiler's own host cost does
not enter them.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host-clock totals of the harness's spans, kept while ``on``; with
    ``record`` each span is also a ``record_function`` in the trace."""

    def __init__(self, on: bool):
        self.on = on
        self.record = False
        self.total: Dict[str, float] = collections.defaultdict(float)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        if self.record:
            with torch.profiler.record_function(f"pb.{name}"):
                yield
        else:
            yield
        self.total[name] += time.perf_counter() - t0


class Profile:
    """Start and stop of the profiler around the traced stretch; the
    stretch is bracketed by device synchronizations and a ``pb.window``
    span."""

    def __init__(self, device, tmpdir: str):
        self.device = device
        self.path = os.path.join(tmpdir, "portbench_trace.json")
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._sync()
        self._window = torch.profiler.record_function("pb.window")
        self._window.__enter__()
        self.t0 = time.perf_counter()

    def stop(self):
        self._sync()
        self.t1 = time.perf_counter()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.prof.export_chrome_trace(self.path)
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def records(self) -> dict:
        with open(self.path) as f:
            events = json.load(f).get("traceEvents", [])
        os.remove(self.path)
        return read_events(events, self.t1 - self.t0)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def read_events(events: List[dict], host_window_s: float) -> dict:
    """Records of the traced stretch: its length, the device's busy
    time (the union of its operations' intervals), the device operations
    by name, the spans, and the longest idle gaps labelled by what the
    host was doing."""
    win = [e for e in events if e.get("name") == "pb.window"
           and e.get("cat") == "user_annotation"]
    if win:
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
    else:
        w0, w1 = 0.0, host_window_s * 1e6
    dev, spans, ops = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        s = float(e.get("ts", 0.0))
        d = float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(s + d, w1)
            if t > s:
                dev.append((e.get("name", "?"), s, t))
        elif cat == "user_annotation" and e["name"].startswith("pb.") \
                and e["name"] != "pb.window":
            spans.append((e["name"][3:], s, s + d))
        elif cat == "cpu_op":
            ops.append((e.get("name", "?"), s, s + d))
    busy = _union([(s, t) for _, s, t in dev])
    by_name: Dict[str, float] = collections.defaultdict(float)
    for name, s, t in dev:
        by_name[name] += (t - s) * 1e-6
    gaps = []
    prev = w0
    for s, t in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    gaps.sort(key=lambda g: g[0] - g[1])
    spans.sort(key=lambda x: x[1])
    ops.sort(key=lambda x: x[1])
    op_starts = [o[1] for o in ops]

    def label(t: float) -> str:
        open_spans = [n for n, s, e in spans if s <= t < e]
        i = bisect.bisect_right(op_starts, t)
        op = next((ops[j][0] for j in range(i - 1, max(-1, i - 2000), -1)
                   if ops[j][2] > t), "host")
        return f"{open_spans[-1] if open_spans else 'harness'} | {op}"

    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "spans": spans,
        "idle_gaps": [(label(s), (t - s) * 1e-6) for s, t in gaps[:10]],
    }


def breakdown(rec: dict) -> Optional[dict]:
    if not rec:
        return None
    return {"device_ops": [[n[:160], s] for n, s in rec["device_ops"][:10]],
            "idle_gaps": [[n[:160], s] for n, s in rec["idle_gaps"][:10]]}
