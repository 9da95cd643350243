"""The traced run: fenced spans around the calls into each layer, and the
device's activity from ``torch.profiler``.

A span wraps a method of an object the configuration built (a dotted path
from the SLAM facade) or a module's function (``module:pkg.mod:func``).
It synchronises the device before and after the call, so the host time
it takes holds all the device work the call queued, and it opens a
``record_function`` range so that the profiler's trace places every
kernel inside it.  Per-layer metrics read :class:`TraceData`.
"""
from __future__ import annotations

import bisect
import importlib
import time
from collections import defaultdict

import torch

PREFIX = "slam_bench/"


def resolve(root, target: str):
    """(object, attribute name) that ``target`` names."""
    if target.startswith("module:"):
        mod, name = target[len("module:"):].split(":")
        return importlib.import_module(mod), name
    *path, name = target.split(".")
    obj = root
    for part in path:
        obj = getattr(obj, part)
    return obj, name


class TraceData:
    """Span totals of the window's fenced half, its counts (keyframes,
    seconds) and what the profiler saw there; ``unfenced``, the device
    summary of the unfenced half (:func:`device_summary` with its
    ``keyframes``)."""

    def __init__(self, device):
        self.device = device
        self.active = False
        self.span_s = defaultdict(float)
        self.span_n = defaultdict(int)
        self.work_ms = defaultdict(float)
        self.counts = {}
        self.profile = None
        self.unfenced = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name, fn, work=None):
        def call(*a, **k):
            if not self.active:
                return fn(*a, **k)
            self._sync()
            with torch.profiler.record_function(PREFIX + name):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self._sync()
                t1 = time.perf_counter()
            self.span_s[name] += t1 - t0
            self.span_n[name] += 1
            if work is not None:
                self.work_ms[name] += work(*a, **k)
            return out
        return call

    def install(self, slam, spans):
        """``spans``: [(name, [targets], work or None)].  A target that
        does not resolve is skipped; a span none of whose targets resolves
        raises, so that a metric never goes missing unseen."""
        for name, targets, work in spans:
            found = 0
            for target in targets:
                try:
                    obj, attr = resolve(slam, target)
                    fn = getattr(obj, attr)
                except AttributeError:
                    continue
                setattr(obj, attr, self.span(name, fn, work))
                found += 1
            if targets and not found:
                raise AttributeError(
                    f"span {name!r}: none of {targets} resolves on the "
                    "system under test")


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    return f() if f is not None else getattr(ev, f"{what}_us")() * 1000


def read_profile(prof) -> dict:
    """Device intervals, kernel names and the spans' ranges from a
    finished profile, in ns of the profiler's clock."""
    events = prof.profiler.kineto_results.events()
    dev, spans = [], []
    for ev in events:
        kind = str(ev.device_type())
        if kind.endswith("CUDA"):
            name = ev.name()
            if name.startswith(PREFIX):
                continue  # a span's range mirrored on the device's timeline
            start = _ns(ev, "start")
            dev.append((start, start + _ns(ev, "duration"), name,
                        not name.startswith(("Memcpy", "Memset"))))
        elif ev.name().startswith(PREFIX):
            start = _ns(ev, "start")
            spans.append((start, start + _ns(ev, "duration"),
                          ev.name()[len(PREFIX):]))
    dev.sort()
    spans.sort()
    return dict(device=dev, spans=spans)


def _innermost(spans, starts, t, look_back=64):
    """Name of the latest-starting span (of ``spans``, sorted by start)
    that holds ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for s0, s1, name in spans[max(0, i - look_back):i + 1][::-1]:
        if s1 >= t:
            return name
    return None


def device_summary(profile: dict, window: str = "window") -> dict:
    """busy and window seconds, kernel launches, each span's device time
    (the device operations whose midpoint falls in it, the innermost span
    counting), the 10 costliest device operations and the idle time by the
    host span it fell in."""
    spans = profile["spans"]
    win = [(s0, s1) for s0, s1, n in spans if n == window]
    if not win or not profile["device"]:
        return {}
    w0, w1 = win[0]
    inner = [s for s in spans if s[2] != window and w0 <= s[0] <= w1]
    starts = [s[0] for s in inner]
    busy, launches, cur, gap0 = 0, 0, None, w0
    by_name = defaultdict(float)
    in_span = defaultdict(float)
    idle = defaultdict(float)

    def where(t):
        return _innermost(inner, starts, t) or "outside layers"

    for d0, d1, name, is_kernel in profile["device"]:
        if d1 <= w0 or d0 >= w1:
            continue
        d0, d1 = max(d0, w0), min(d1, w1)
        launches += is_kernel
        by_name[name] += (d1 - d0) / 1e9
        in_span[where((d0 + d1) / 2)] += (d1 - d0) / 1e9
        if cur is not None and d0 <= cur[1]:
            cur[1] = max(cur[1], d1)
            continue
        if cur is not None:
            busy += cur[1] - cur[0]
            gap0 = cur[1]
        if d0 > gap0:
            idle[where((gap0 + d0) / 2)] += (d0 - gap0) / 1e9
        cur = [d0, d1]
    if cur is not None:
        busy += cur[1] - cur[0]
        if w1 > cur[1]:
            idle[where((cur[1] + w1) / 2)] += (w1 - cur[1]) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy / 1e9, window_s=(w1 - w0) / 1e9,
                launches=launches, span_device_s=dict(in_span),
                device_ops=[[n[:120], s] for n, s in top],
                idle_gaps=[[f"idle in {n}", s] for n, s in gaps])
