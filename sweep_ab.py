#!/usr/bin/env python3
"""Device time of the CSM sweep kernel of one source tree, at every shape
of ``chip_smoke.py``, so two versions of the kernel can be compared on one
card in one command:

    python3 sweep_ab.py OLD_TREE && python3 sweep_ab.py . && \
        python3 sweep_ab.py . && python3 sweep_ab.py OLD_TREE

``TREE`` is the root of a checkout (a ``git archive`` of another commit
unpacked into a directory that ``.gitignore`` lists, or ``.``) whose
wrapper takes tile origins (``csm_sweep(win, hr, hc, ok, origins, *,
tile_h, tile_w, stride)``).  The script builds that tree's
``csrc/csm_sweep.cu``, checks its output at each shape against that tree's
own plain sweep (``torch.equal``), and prints one JSON line per shape with
the device ms per call from ``chip_smoke._graph_ms`` (20 launches in one
CUDA graph, median of 20 replays) and the bound from
``chip_smoke.sweep_bound``.  The shapes and inputs come from this
checkout's ``chip_smoke.py`` (seeded), so every tree gets the same inputs.

Imports nothing of JAX.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import torch


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep_ab: CUDA is not available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    tree = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(here))
    import chip_smoke

    sys.path.insert(0, str(tree))
    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda

    if not Path(csm.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {csm.__file__}, not {tree}'s package")
    device = torch.device("cuda", 0)
    label = os.path.relpath(tree, here)
    print(f"device: {chip_smoke._nvidia_smi()}; tree {label}", flush=True)
    rng = np.random.default_rng(0)
    for s in chip_smoke.kernel_shapes():
        win, hr, hc, ok = chip_smoke.sweep_inputs(rng, s)
        th, tw, stride = s["tile"]
        kw = dict(tile_h=th, tile_w=tw, stride=stride)
        args = tuple(torch.as_tensor(a, device=device) for a in (
            win.transpose(0, 2, 3, 1).copy(), hr, hc, ok, s["origins"]))
        ref = csm.sweep_tiles_plain(*args, **kw)
        got = csm_cuda.csm_sweep(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: kernel != plain at {s['shape']}")
        ms = chip_smoke._graph_ms(lambda: csm_cuda.csm_sweep(*args, **kw))
        bound_ms, bound_by = chip_smoke.sweep_bound(s, ok)
        print("sweep_ab " + json.dumps(dict(
            tree=label, shape=s["shape"], ms=ms, bound_ms=bound_ms,
            bound_by=bound_by, pct_of_bound=100 * bound_ms / ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
