"""Readings that set the check's limits: for each seed, one short window
of a cell at its own load, then the judged numbers of the program, of the
control (the reference one precision down in the program's place) and,
with ``--faults``, of each named planted fault (``faults.py``; ``all``
names every one) on the first ``--fault-seeds`` seeds.  The benchmark's
own runs never run this.

    python3 -m slam_bench.proof --workload ref_batched.revisit \\
        --seeds 11 12 13 --seconds 10 [--faults all] [--out FILE]

Writes one JSON object (to ``--out`` too, where given) and needs a CUDA
device unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from . import faults as faults_mod
from . import harness


def readings(workload, seed, seconds, device, faults=(), control=True) -> dict:
    t0 = time.perf_counter()
    run = harness.Run(workload, seed, device,
                      faults=[faults_mod.FAULTS[f] for f in faults])
    e2e = run.window(seconds)
    out = dict(seed=seed, faults=list(faults), e2e=e2e, info=run.info,
               program=run.check())
    if control:
        out["control"] = run.check(control=True)
    out["seconds"] = time.perf_counter() - t0
    del run
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, default=None)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("slam_bench.proof: no CUDA device", file=sys.stderr)
        return 3
    names = (sorted(faults_mod.FAULTS) if args.faults == ["all"]
             else args.faults)
    res = dict(workload=args.workload, runs=[])
    for k, seed in enumerate(args.seeds):
        r = readings(args.workload, seed, args.seconds, args.device)
        res["runs"].append(r)
        print(json.dumps(r), file=sys.stderr, flush=True)
        if args.fault_seeds is None or k < args.fault_seeds:
            for name in names:
                r = readings(args.workload, seed, args.seconds, args.device,
                             faults=[name], control=False)
                res["runs"].append(r)
                print(json.dumps(r), file=sys.stderr, flush=True)
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
