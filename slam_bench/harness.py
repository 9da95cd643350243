"""The benchmark's engine, driven by data.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness finds ``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` by those names, so a new configuration, mix,
per-layer metric or cell needs new files only.

A run: set-up (build the kernels, generate the course from the seed,
build the configuration's system, run the mix's warm-up), then the
measured window, a closed loop that feeds the next scan when
``process_scan`` returns, then the check against the plain reference.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import course, trace
from .record import Recorder
from .reference import judge as judge_mod
from .reference import raster as ref_raster

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def load_traffic(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def load_metric(name: str):
    """The reader of a per-layer metric: ``SPANS`` ([(span, [targets])]),
    optionally ``WORK`` ({span: fn(*call args) -> bound ms}), and
    ``read(td) -> value or None``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "slam_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"slam_bench: no workload named {name!r} in "
                     "BENCHMARK.json")


def metrics_of(entries, cell: str):
    return [m for m in entries if cell in m.get("workloads", [cell])]


def build_system(config: dict, device):
    """The configuration's SLAM facade on ``device``."""
    from my_lidar_graph_slam_v2_tpu_torch.pipeline import factory

    sysc = config["system"]
    if sysc["kind"] == "factory":
        backend = factory.create_default_backend(device=device,
                                                 **sysc["backend"])
        return factory.create_default_slam(device=device, backend=backend,
                                           **sysc["slam"])
    if sysc["kind"] == "settings":
        from my_lidar_graph_slam_v2_tpu_torch.config.settings import (
            create_slam_from_settings,
        )
        settings = json.loads((BENCH / "configs" / sysc["settings"]).read_text())
        return create_slam_from_settings(settings, device=device,
                                         **sysc["kwargs"])
    raise ValueError(f"unknown system kind {sysc['kind']!r}")


def to_scan(d: dict):
    from my_lidar_graph_slam_v2_tpu_torch.sensor.data import ScanData
    return ScanData(**d)


class Run:
    """One run of one cell: set-up in the constructor, then
    :meth:`window` and :meth:`check`."""

    def __init__(self, cell_name: str, seed: int, device, *, trace_on=False,
                 t_start=None, faults=(), bench=None, config=None,
                 traffic=None):
        t_start = time.perf_counter() if t_start is None else t_start
        self.bench = bench or load_benchmark()
        self.cell = find_cell(self.bench, cell_name) if cell_name else None
        self.config = config or load_config(self.cell["config"])
        self.traffic = traffic or load_traffic(self.cell["traffic"])
        self.seed = int(seed)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from my_lidar_graph_slam_v2_tpu_torch.ops import cuda_build
            cuda_build.build(*self.config["kernels"])
            torch.cuda.init()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.raw, self.gt, self.warm_end = course.make(self.traffic, self.seed)
        self.scans = [to_scan(d) for d in self.raw]
        self.slam = build_system(self.config, self.device)
        self.td = trace.TraceData(self.device)
        self.layer_metrics = []
        if trace_on:
            per = metrics_of(self.bench["per_layer"], cell_name)
            self.layer_metrics = [(m, load_metric(m["name"])) for m in per]
            spans = [("process_scan", ["process_scan"], None)]
            for _, mod in self.layer_metrics:
                work = getattr(mod, "WORK", {})
                spans += [(n, t, work.get(n)) for n, t in mod.SPANS]
            self.td.install(self.slam, spans)
        for fault in faults:
            fault(self.slam)
        ref_map = self.config["reference"]["map"]
        self.rec = Recorder(self.slam, ref_map["num_scans_for_latest_map"],
                            ref_map["num_overlapped_scans"])
        self.trace_on = trace_on
        for i in range(self.warm_end):
            self.rec.current_raw = i
            self.slam.process_scan(self.scans[i], self.scans[i].odom_pose)
        self._sync()
        self.setup_s = time.perf_counter() - t_start

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _failure_count() -> int:
        from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
            MetricManager,
        )
        return int(MetricManager.instance().counter(
            "Frontend.MatcherFailureCount").value)

    def window(self, seconds: float) -> dict:
        """Feed scans back to back for ``seconds``; the call in flight at
        the deadline counts.  With tracing the window runs in two halves:
        the first unfenced under a device-only profile (the idle share and
        the launches), the second with the layers' fenced spans under the
        full profile (the layer times and the kernels' device time)."""
        self.rec.in_window = True
        fails0 = self._failure_count()
        self.kf_ms, self.raised, self.next_scan = [], 0, self.warm_end
        gc.collect()
        gc.freeze()
        t0 = time.perf_counter()
        if self.trace_on:
            self.td.unfenced = self._unfenced_half(seconds / 2)
            self.td.profile, self.td.counts = self._fenced_half(seconds / 2)
        else:
            self._feed(t0 + seconds)
        self._sync()
        t1 = time.perf_counter()
        gc.unfreeze()
        self.rec.in_window = False
        self.window_s = t1 - t0
        self.attempted = self.next_scan - self.warm_end
        self.failed = self.raised + self._failure_count() - fails0
        self.peak_bytes = (torch.cuda.max_memory_allocated(self.device)
                           if self.device.type == "cuda" else 0)
        return self.end_to_end()

    def _feed(self, deadline: float):
        """Closed loop until ``deadline``: each scan when the previous
        ``process_scan`` call returns; a keyframe's wall time is kept."""
        while True:
            i = self.next_scan
            if i >= len(self.scans):
                raise RuntimeError(
                    f"the course ran out after {i - self.warm_end} scans in "
                    "the window: make the traffic's course_keyframes larger")
            self.rec.current_raw = i
            c0 = time.perf_counter()
            try:
                kf = self.slam.process_scan(self.scans[i],
                                            self.scans[i].odom_pose)
            except Exception as e:  # noqa: BLE001 - a failed call is counted
                print(f"slam_bench: scan {i} raised {e!r}", file=sys.stderr)
                self.raised += 1
                kf = False
            c1 = time.perf_counter()
            if kf:
                self.kf_ms.append((c1 - c0) * 1e3)
            self.next_scan = i + 1
            if c1 >= deadline:
                return

    def _unfenced_half(self, seconds: float):
        """The device's busy time, launches and costliest operations over
        ``seconds`` of the window with no fence, under a device-only
        profile (its start-up before the clock starts), with the keyframes
        and seconds of that stretch; None off a CUDA device."""
        if self.device.type != "cuda":
            self._feed(time.perf_counter() + seconds)
            return None
        n0 = len(self.kf_ms)
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
        self._sync()
        a0 = time.perf_counter()
        self._feed(a0 + seconds)
        self._sync()
        a1 = time.perf_counter()
        prof.__exit__(None, None, None)
        dev = trace.read_profile(prof)["device"]
        if not dev:
            return None
        first = dev[0][0]
        out = trace.device_summary(dict(
            device=dev, spans=[(first, first + int((a1 - a0) * 1e9),
                                "window")]))
        out.update(keyframes=len(self.kf_ms) - n0, window_s=a1 - a0)
        return out

    def _fenced_half(self, seconds: float):
        """``seconds`` of the window with the layers' spans on, under the
        profiler's host and device tracing (its start-up before the clock
        starts): (what :func:`trace.read_profile` reads, the stretch's
        keyframes and seconds)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        n0 = len(self.kf_ms)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        self.td.active = True
        with torch.profiler.record_function(trace.PREFIX + "window"):
            f0 = time.perf_counter()
            self._feed(f0 + seconds)
            self._sync()
            f1 = time.perf_counter()
        self.td.active = False
        prof.__exit__(None, None, None)
        return (trace.read_profile(prof),
                dict(keyframes=len(self.kf_ms) - n0, window_s=f1 - f0))

    def end_to_end(self) -> dict:
        n = len(self.kf_ms)
        out = dict(
            keyframes_per_s=n / self.window_s,
            keyframe_p95_ms=float(np.percentile(self.kf_ms, 95)) if n else None,
            setup_s=self.setup_s,
        )
        self.info = dict(keyframes=n, window_s=self.window_s,
                         keyframe_median_ms=statistics.median(self.kf_ms) if n else None,
                         scans=self.attempted, ate_m=self.ate())
        if self.trace_on:
            un = self.td.unfenced or {}
            fe = self.td.counts
            self.info.update(
                unfenced_keyframes_per_s=(un["keyframes"] / un["window_s"]
                                          if un.get("window_s") else None),
                fenced_keyframes_per_s=fe["keyframes"] / fe["window_s"])
        return out

    def ate(self) -> float:
        times, poses = self.slam.get_poses_with_times()
        idx = np.clip(np.round(times / 0.1).astype(int), 0, len(self.gt) - 1)
        return course.ate_rmse(poses, self.gt[idx])

    def check(self, control: bool = False) -> dict:
        """The judged numbers (see ``reference/judge.py``), worked out
        after the program's state is freed: only the local maps the check
        judges are kept, on the device.  A second call (the control)
        reuses them."""
        if self.slam is not None:
            *_, ids = judge_mod.selection(self.rec, self.config["reference"],
                                          self.seed)
            self.program_maps = {k: self._program_map(k) for k in ids}
            self.slam = None
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        return judge_mod.judge(self.rec, self.raw, self.config["reference"],
                               self.program_maps, self.seed, self.device,
                               control=control)

    def _program_map(self, map_id):
        lm = self.slam.builder.local_maps[map_id]
        if lm.compacted:
            return lm.prob_q, lm.observed
        return ref_raster.quantize(lm.logodds, lm.observed), lm.observed

    def layer_values(self) -> dict:
        summary = {}
        if self.td.profile is not None:
            summary = trace.device_summary(self.td.profile)
        self.td.device_summary = summary
        out = {}
        for m, mod in self.layer_metrics:
            v = mod.read(self.td)
            if v is not None:
                out[m["name"]] = dict(value=float(v), unit=m["unit"])
        return out


# The count in the window's ``mix`` that is 0 where a number's layer did
# nothing, for the numbers a traffic file may leave unjudged.
IDLE_WHEN = dict(loop_moved="edges", detect_wrong="queries",
                 lm_gap_m="lm_calls", lm_gap_rad="lm_calls")


def verdict(numbers: dict, limits: dict, nothing_to_judge=()):
    """(correct, checks): every number at or under its limit.  A number
    the run found nothing to judge for (None) fails: every output a
    limit names is due in every run of the cell.  The one exception is a
    course with no loop, whose traffic file lists under
    ``nothing_to_judge`` the numbers of the layers it gives no work: such
    a number may be None where the window's ``mix`` shows its layer did
    nothing (:data:`IDLE_WHEN`), and its check says so under
    ``unjudged``.  On such a course an accepted loop edge is false by
    construction, so the window's edges are a check of their own
    (``loop_edges``, limit 0)."""
    unknown = set(nothing_to_judge) - set(IDLE_WHEN)
    if unknown:
        raise ValueError(f"no rule to leave {sorted(unknown)} unjudged")
    mix = numbers.get("mix") or {}
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        checks[name] = dict(value=v, limit=limit)
        idle = IDLE_WHEN.get(name)
        if v is None and name in nothing_to_judge and mix.get(idle) == 0:
            checks[name]["unjudged"] = (f"a course with no loop, and the "
                                        f"window's {idle} are 0")
        elif v is None or not v <= limit:
            ok = False
    if nothing_to_judge:
        edges = mix.get("edges")
        checks["loop_edges"] = dict(value=edges, limit=0)
        if edges is None or edges > 0:
            ok = False
    return ok, checks
