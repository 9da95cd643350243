"""Checks of the port's spans on the card, beside ``slam_bench``.

    python3 span_audit.py syncs [--seconds S] [--seed N] CELL [CELL ...]
    python3 span_audit.py run on|off ARGS...
    python3 span_audit.py ranges
    python3 span_audit.py coverage ARGS...

``syncs`` runs each ``slam_bench`` cell once with its window untraced,
as the benchmark runs it, under ``torch.cuda.set_sync_debug_mode("warn")``
with the program's span tracing on, and prints one JSON line per cell:
every synchronising operation the window made, counted by the port's
source line that made it and the span path open there, and how many of
them no ``fetch`` span held.

``run on|off ARGS`` is ``python3 -m slam_bench.run ARGS`` with the
program's span tracing on or off (the cost of tracing: compare the two).

``coverage ARGS`` is ``python3 -m slam_bench.run ARGS`` (with
``--trace 1``), then one JSON line from the program's spans of the
traced window's unfenced half: for each of ``frontend.match``,
``loop.detect`` and ``graph.optimize`` its ms and the share of it its
step spans (``match.*``, ``graph.prepare``, ``graph.solve``, ``fetch``)
cover, each span name's ms per keyframe, and ``refines``: the
``match.refine`` spans of that half (under ``frontend.match`` and under
``loop.detect``) beside the rise of ``GaussNewton.KernelRefines`` over
it, equal when every refinement ran the CUDA kernel.

``ranges`` profiles a few device operations inside ``record_function``
ranges, once with device activity only and once with host and device
activity, and prints which range names ``slam_bench/trace.py`` reads as
device operations, and how far each range's start in the profile lies
from ``time.time_ns()`` taken just before it opened.
"""
from __future__ import annotations

import os
import sys

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
PKG = str(ROOT / "my_lidar_graph_slam_v2_tpu_torch")


def _manager():
    from my_lidar_graph_slam_v2_tpu_torch.metrics.registry import (
        MetricManager,
    )
    return MetricManager.instance()


def syncs(cells, seconds: float, seed: int) -> int:
    import torch

    from slam_bench import harness

    mm = _manager()
    mm.start_tracing()
    counts = collections.Counter()
    shown = warnings.showwarning

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        stack = mm._stack()
        site = next((f"{Path(f.filename).relative_to(ROOT)}:{f.lineno}"
                     for f in reversed(traceback.extract_stack())
                     if f.filename.startswith(PKG)), f"{filename}:{lineno}")
        counts[(site, stack[-1] if stack else "")] += 1

    for cell in cells:
        run = harness.Run(cell, seed, "cuda:0")
        counts.clear()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                e2e = run.window(seconds)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        outside = {f"{s} [{p}]": n for (s, p), n in counts.items()
                   if "fetch" not in p.split("/")}
        print(json.dumps(dict(
            cell=cell, keyframes=len(run.kf_ms),
            keyframes_per_s=e2e["keyframes_per_s"],
            syncs=sum(counts.values()), outside_fetch=outside,
            sites={f"{s} [{p}]": n for (s, p), n in sorted(counts.items())},
            card=torch.cuda.get_device_name(0))), flush=True)
    return 0


def run_traced(mode: str, args) -> int:
    from slam_bench import run

    if mode == "on":
        _manager().start_tracing()
    return run.main(args)


STEPS = {"frontend.match": ("match.fold", "match.search", "match.refine",
                             "fetch"),
         "loop.detect": ("match.search", "match.refine", "fetch"),
         "graph.optimize": ("graph.prepare", "graph.solve", "fetch")}


def coverage(args) -> int:
    from slam_bench import harness, program_spans, run

    seen = {}
    layer_values = harness.Run.layer_values

    def keep(self):
        seen["td"] = self.td
        return layer_values(self)

    harness.Run.layer_values = keep
    rc = run.main(args)
    got = program_spans.unfenced(seen["td"]) if "td" in seen else None
    if rc or got is None:
        return rc or 1
    spans, kf = got
    out = dict(keyframes=kf)
    for layer, steps in STEPS.items():
        total = program_spans.total_ms(spans, layer)
        parts = {s: program_spans.total_ms(spans, s, layer) for s in steps}
        out[layer] = dict(
            ms=total, calls=program_spans.count(spans, layer),
            steps_ms=parts,
            share=sum(parts.values()) / total if total else None)
    names = collections.Counter()
    for s in spans:
        names[s[0]] += (s[3] - s[2]) / 1e6 / kf
    out["ms_per_keyframe"] = dict(names.most_common(40))
    out["refines"] = refines(seen["td"], spans)
    print(json.dumps(out), flush=True)
    return 0


def refines(td, spans) -> dict:
    """The unfenced half's ``match.refine`` spans and the rise of
    ``GaussNewton.KernelRefines`` over the same records."""
    from slam_bench import program_spans

    records = _manager().trace_records()
    U, F = td.unfenced["keyframes"], (td.counts or {}).get("keyframes", 0)
    end = len(records) - F
    counter = "GaussNewton.KernelRefines"

    def value(i):
        return records[i].counters.get(counter, 0.0) if i >= 0 else 0.0

    return dict(
        spans=program_spans.count(spans, "match.refine"),
        frontend=program_spans.count(spans, "match.refine",
                                     "frontend.match"),
        loop=program_spans.count(spans, "match.refine", "loop.detect"),
        kernel_refines=value(end - 1) - value(end - U - 1))


def ranges() -> int:
    import torch

    from slam_bench import trace

    x = torch.ones(1 << 16, device="cuda")
    out = {}
    for acts in (["CUDA"], ["CPU", "CUDA"]):
        prof = torch.profiler.profile(activities=[
            getattr(torch.profiler.ProfilerActivity, a) for a in acts])
        opened = []
        with prof:
            for i in range(20):
                opened.append(time.time_ns())
                with torch.profiler.record_function(f"probe.{i % 2}"):
                    for _ in range(5):
                        x = x * 1.0001
            torch.cuda.synchronize()
        dev = trace.read_profile(prof)["device"]
        starts = sorted(trace._ns(ev, "start")
                        for ev in prof.profiler.kineto_results.events()
                        if ev.name().startswith("probe.")
                        and not str(ev.device_type()).endswith("CUDA"))
        out["+".join(acts)] = dict(
            device_ops=len(dev),
            ranges_read_as_device_ops=sorted({d[2] for d in dev
                                              if d[2].startswith("probe.")}),
            host_ranges=len(starts),
            start_minus_time_ns_us=[(s - t) / 1e3 for s, t in
                                    zip(starts, opened)][:5])
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["run"]:
        return run_traced(argv[1], argv[2:])
    if argv[:1] == ["coverage"]:
        return coverage(argv[1:])
    if argv[:1] == ["ranges"]:
        return ranges()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=["syncs"])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--seed", type=int, default=2**31 + 11)
    a = ap.parse_args(argv)
    return syncs(a.cells, a.seconds, a.seed)


if __name__ == "__main__":
    sys.exit(main())
