"""Run one cell of the benchmark once and print its result line.

    python3 -m slam_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with its limit), and the last lines of standard error
give the same numbers and limits.  With ``--trace 1`` the window runs
in two halves: the first unfenced under a device-only profile (idle
share, launches, ``busy_s``, ``window_s``, the costliest device
operations), the second with every layer's fenced spans under the full
profile (layer times, the sweep's roofline, idle time by host span).
Without a CUDA device, or with fewer
than the cell asks for, it exits with code 3 and prints no result; if
JAX or the JAX package was loaded, with code 4.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# One host thread for BLAS and PyTorch's CPU operators, set before either
# loads: the run's host work is dispatch, and a pool of threads on a shared
# host only adds to the spread of its times.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# Every build and kernel cache at a fixed path inside the checkout.
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "slam_bench" / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "my_lidar_graph_slam_v2_tpu")


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slam_bench import harness

    bench = harness.load_benchmark()
    cell = harness.find_cell(bench, args.workload)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"slam_bench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); none or too few found", file=sys.stderr)
        return 3
    run = harness.Run(args.workload, args.seed, "cuda:0",
                      trace_on=bool(args.trace), t_start=T_START, bench=bench)
    e2e = run.window(args.seconds)
    layer = run.layer_values() if args.trace else {}
    t_check = time.perf_counter()
    numbers = run.check()
    t_check = time.perf_counter() - t_check
    correct, checks = harness.verdict(
        numbers, run.config["limits"],
        run.traffic.get("nothing_to_judge", ()))
    info = dict(run.info, judged=numbers.get("judged"), mix=numbers.get("mix"),
                widest=numbers.get("widest"), check_s=t_check)
    print("slam_bench: " + json.dumps(info), file=sys.stderr)

    if args.trace:
        metrics = layer
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        metrics = {name: dict(value=e2e[name], unit=units[name])
                   for name in units if e2e.get(name) is not None
                   and name in {m["name"] for m in harness.metrics_of(
                       bench["end_to_end"], args.workload)}}
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell["chips"], memory_peak_bytes=int(run.peak_bytes))
    result = dict(correct=correct, attempted=run.attempted, failed=run.failed,
                  metrics=metrics, device=device)
    if args.trace:
        un, fenced = run.td.unfenced, run.td.device_summary
        if un:
            device.update(busy_s=un["busy_s"], window_s=un["window_s"])
            result["breakdown"] = dict(
                device_ops=un["device_ops"],
                idle_gaps=fenced.get("idle_gaps", []) if fenced else [])
    result["checks"] = checks

    bad = loaded_forbidden()
    if bad:
        print(f"slam_bench: loaded {', '.join(bad)} in the measuring process",
              file=sys.stderr)
        return 4
    for name, c in checks.items():
        why = f", unjudged: {c['unjudged']}" if "unjudged" in c else ""
        print(f"check {name}: {c['value']} (limit {c['limit']}{why})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
