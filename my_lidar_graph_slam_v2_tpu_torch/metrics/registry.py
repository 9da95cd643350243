# The port's own copy of my_lidar_graph_slam_v2_tpu/metrics/registry.py, logic
# unchanged: the port imports nothing of the JAX package.
"""Metric registry: counters, gauges, distributions, histograms, sequences.

Re-implements the reference's observability subsystem
(``metric/metric.hpp:60-901``): a process-wide ``MetricManager`` registry
of named metrics, the dominant per-frame ``ValueSequence`` type, and a
``Timer`` convenience.  ``to_dict()`` emits the reference's sectioned
property-tree layout (``metric/metric.hpp:646-686`` ToPropertyTree +
``slam_launcher.cpp:171-181``): top-level ``Counters`` / ``Gauges`` /
``Distributions`` / ``Histograms`` / ``ValueSequences`` sections keyed by
flat dotted metric names, Counter/Gauge -> {"Value"}, ValueSequence ->
{"NumOfSamples", "Values" (space-separated)} — so a reference-vs-ours
metric JSON can be diffed mechanically (scripts/metric_diff.py).

Times are recorded in microseconds (integer), matching the reference's
boost cpu_timer wall-ns / 1000 convention.
"""
from __future__ import annotations

import json
import math
import time
from typing import Dict, List, Optional


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


class Timer:
    """Wall-clock timer matching ``Metric::Timer`` semantics."""

    def __init__(self):
        self.start_time = time.perf_counter()
        self.running = True
        self._accum = 0.0

    def start(self):
        self.start_time = time.perf_counter()
        self.running = True

    def stop(self):
        if self.running:
            self._accum += time.perf_counter() - self.start_time
            self.running = False

    def elapsed(self) -> float:
        if self.running:
            return self._accum + (time.perf_counter() - self.start_time)
        return self._accum


class MetricManager:
    """Singleton registry (``metric/metric.hpp:646-686``)."""

    _instance: Optional["MetricManager"] = None

    def __init__(self):
        self.metrics: Dict[str, object] = {}

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
