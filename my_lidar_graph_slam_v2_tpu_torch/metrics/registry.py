# The port's own copy of my_lidar_graph_slam_v2_tpu/metrics/registry.py (the
# port imports nothing of the JAX package), with the port's spans added.
"""Metric registry: counters, gauges, distributions, histograms, sequences,
and the spans that time the program's steps.

Re-implements the reference's observability subsystem
(``metric/metric.hpp:60-901``): a process-wide ``MetricManager`` registry
of named metrics and the dominant per-frame ``ValueSequence`` type.
``to_dict()`` emits the reference's sectioned
property-tree layout (``metric/metric.hpp:646-686`` ToPropertyTree +
``slam_launcher.cpp:171-181``): top-level ``Counters`` / ``Gauges`` /
``Distributions`` / ``Histograms`` / ``ValueSequences`` sections keyed by
flat dotted metric names, Counter/Gauge -> {"Value"}, ValueSequence ->
{"NumOfSamples", "Values" (space-separated)} — so a reference-vs-ours
metric JSON can be diffed mechanically (scripts/metric_diff.py).

Times are recorded in microseconds (integer), matching the reference's
boost cpu_timer wall-ns / 1000 convention.

Spans (:meth:`MetricManager.span`) are the one timer of the program.  With
tracing off (the default) a span with a series observes its block's
elapsed microseconds into it, and one without a series does nothing.
With tracing on (:meth:`MetricManager.start_tracing`) every span also
opens a ``torch.profiler.record_function`` range of its name, so a profile
nests the device's kernels under the program's steps, and it appends
``(name, parent, t0_ns, t1_ns, thread)`` to the open trace record, its
ends on ``time.time_ns()``, the clock the profiler stamps host events
with.  ``parent`` is the path of the spans open around it on its thread,
outermost first and joined by ``/`` ("" for none).  The facade closes a
record per keyframe (:meth:`MetricManager.close_record`); a record also
holds every counter's value and every sequence's length at its close.
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from typing import Dict, List, NamedTuple, Optional


class Counter:
    def __init__(self):
        self.value = 0.0

    def increment(self, val: float = 1.0):
        self.value += max(0.0, val)

    def reset(self):
        self.value = 0.0

    def to_dict(self):
        return {"Value": f"{self.value:.6f}"}


class Gauge:
    def __init__(self):
        self.value = 0.0

    def set_value(self, val: float):
        self.value = val

    def increment(self, val: float = 1.0):
        self.value += val

    def reset(self):
        self.value = 0.0

    def to_dict(self):
        return {"Value": f"{self.value:.6f}"}


class Distribution:
    """Running mean/stdev via Welford, matching ``metric.cpp:126-200``."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.n = 0
        self.sum = 0.0
        self.mean = 0.0
        self.scaled_var = 0.0
        self.max = -math.inf
        self.min = math.inf

    def observe(self, val: float):
        self.n += 1
        self.sum += val
        if self.n == 1:
            self.mean = val
            self.scaled_var = 0.0
        else:
            d = val - self.mean
            self.mean += d / self.n
            self.scaled_var += d * (val - self.mean)
        self.max = max(self.max, val)
        self.min = min(self.min, val)

    @property
    def std(self):
        return math.sqrt(self.scaled_var / self.n) if self.n > 0 else 0.0

    def to_dict(self):
        return {
            "NumOfSamples": self.n,
            "Sum": self.sum,
            "Mean": self.mean,
            "StandardDeviation": self.std,
            "Maximum": self.max if self.n else 0.0,
            "Minimum": self.min if self.n else 0.0,
        }


class Histogram:
    def __init__(self, bucket_boundaries: List[float]):
        self.boundaries = list(bucket_boundaries)
        self.counts = [0] * (len(self.boundaries) + 1)
        self.sum = 0.0
        self.n = 0

    def observe(self, val: float):
        self.n += 1
        self.sum += val
        for i, b in enumerate(self.boundaries):
            if val < b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def reset(self):
        self.counts = [0] * (len(self.boundaries) + 1)
        self.sum = 0.0
        self.n = 0

    def to_dict(self):
        return {
            "NumOfSamples": self.n,
            "SumValues": self.sum,
            "BucketBoundaries": self.boundaries,
            "BucketCounts": self.counts,
        }


class ValueSequence:
    """Append-only per-frame series — the dominant metric type in the
    reference (``metric.hpp:569-604``)."""

    def __init__(self):
        self.values: List[float] = []

    def observe(self, val):
        self.values.append(float(val))

    def reset(self):
        self.values.clear()

    def to_dict(self):
        return {
            "NumOfSamples": str(len(self.values)),
            "Values": " ".join(_fmt(v) for v in self.values),
        }


def _fmt(v: float) -> str:
    """Compact numeric formatting for the space-separated Values string
    (integers stay integers; floats keep 6 significant digits like the
    reference's property-tree writer)."""
    if not math.isfinite(v):
        return str(v)
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return f"{v:.6g}"


class _Timed:
    """A span with tracing off: observes its block's microseconds into
    ``series`` (not when the block raises, nor after :meth:`drop`)."""

    __slots__ = ("series", "t0")

    def __init__(self, series):
        self.series = series

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.series is not None:
            self.series.observe(self.us())

    def us(self) -> int:
        """Microseconds since the block opened."""
        return int((time.perf_counter() - self.t0) * 1e6)

    def drop(self):
        """End the block without a sample in the series."""
        self.series = None


class _Traced(_Timed):
    """A span with tracing on: besides what :class:`_Timed` does, a
    ``record_function`` range of its name and an entry in the open trace
    record, both on the profiler's clock, ``time.time_ns()``."""

    __slots__ = ("mm", "name", "parent", "range")

    def __init__(self, mm, name, series):
        self.mm, self.name, self.series = mm, name, series

    def __enter__(self):
        stack = self.mm._stack()
        self.parent = stack[-1] if stack else ""
        stack.append(f"{self.parent}/{self.name}" if self.parent else self.name)
        self.t0 = time.time_ns()
        ranges = self.mm._record_function
        self.range = ranges(self.name) if ranges is not None else None
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        t1 = time.time_ns()
        self.mm._stack().pop()
        self.mm._spans.append((self.name, self.parent, self.t0, t1,
                               threading.current_thread().name))
        if exc_type is None and self.series is not None:
            self.series.observe((t1 - self.t0) // 1000)

    def us(self) -> int:
        return (time.time_ns() - self.t0) // 1000


_NO_SPAN = contextlib.nullcontext()


class TraceRecord(NamedTuple):
    """What the program did between two closes: its spans, each
    ``(name, parent, t0_ns, t1_ns, thread)`` in the order they ended, and
    every counter's value and sequence's length at the close."""

    spans: list
    counters: Dict[str, float]
    lengths: Dict[str, int]


class MetricManager:
    """Singleton registry (``metric/metric.hpp:646-686``)."""

    _instance: Optional["MetricManager"] = None

    def __init__(self):
        self.metrics: Dict[str, object] = {}
        self.tracing = False
        self._record_function = None
        self._records: List[TraceRecord] = []
        self._spans: list = []
        self._local = threading.local()

    @classmethod
    def instance(cls) -> "MetricManager":
        if cls._instance is None:
            cls._instance = MetricManager()
        return cls._instance

    def _get(self, name, factory):
        if name not in self.metrics:
            self.metrics[name] = factory()
        return self.metrics[name]

    def counter(self, name) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name) -> Gauge:
        return self._get(name, Gauge)

    def distribution(self, name) -> Distribution:
        return self._get(name, Distribution)

    def histogram(self, name, boundaries) -> Histogram:
        return self._get(name, lambda: Histogram(boundaries))

    def value_sequence(self, name) -> ValueSequence:
        return self._get(name, ValueSequence)

    # ---- spans ---------------------------------------------------------
    def span(self, name: str, series: Optional[ValueSequence] = None):
        """A context manager timing its block as the step ``name`` (see
        the module docstring): into ``series`` when one is given, and with
        tracing on into the trace record and the profiler too.  The object
        it yields has ``us()``, the microseconds so far, and ``drop()``,
        which ends the block without a sample, when a series is given or
        tracing is on."""
        if self.tracing:
            return _Traced(self, name, series)
        return _NO_SPAN if series is None else _Timed(series)

    def start_tracing(self, ranges: bool = True):
        """Turn tracing on (kept on, as it is, if it is); records start
        empty.  ``ranges=False`` leaves out the ``record_function``
        ranges, for a profile that reads its own ranges alone."""
        if self.tracing:
            return
        import torch.profiler

        self._record_function = (torch.profiler.record_function if ranges
                                 else None)
        self._records, self._spans = [], []
        self.tracing = True

    def stop_tracing(self):
        """Turn tracing off; the closed records stay readable."""
        self.tracing = False

    def close_record(self):
        """Close the open trace record (the facade calls this once per
        keyframe); a span that ends on another thread meanwhile may land
        in either record."""
        if not self.tracing:
            return
        spans, self._spans = self._spans, []
        metrics = list(self.metrics.items())
        self._records.append(TraceRecord(
            spans,
            {n: m.value for n, m in metrics if type(m) is Counter},
            {n: len(m.values) for n, m in metrics
             if type(m) is ValueSequence}))

    def trace_records(self) -> List[TraceRecord]:
        """The closed trace records, oldest first."""
        return self._records

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    _SECTIONS = (
        ("Counters", Counter),
        ("Gauges", Gauge),
        ("Distributions", Distribution),
        ("Histograms", Histogram),
        ("ValueSequences", ValueSequence),
    )

    def to_dict(self):
        """Sectioned export matching the reference's metric JSON layout
        (``slam_launcher.cpp:171-181``): one top-level object per metric
        type, flat dotted names inside, ``""`` for empty sections (the
        property-tree writer's quirk, kept for mechanical diffability)."""
        out = {}
        for section, cls in self._SECTIONS:
            entries = {
                name: m.to_dict()
                for name, m in sorted(self.metrics.items())
                if type(m) is cls
            }
            out[section] = entries if entries else ""
        return out

    def save_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    def reset_all(self):
        for m in self.metrics.values():
            m.reset()
