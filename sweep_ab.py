#!/usr/bin/env python3
"""Device time of the CSM sweep kernel of one source tree, at every shape
the system runs (``tests/torch_card_cases.py``), so two versions of the
kernel can be compared on one card in one command:

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
``scripts/common.py:sweep_bound``.  The shapes and inputs come from this
checkout's ``tests/torch_card_cases.py`` (seeded), so every tree gets the
same inputs.

``python3 sweep_ab.py --f32 TREE`` does the same for the f32 form
(``csrc/csm_sweep_f32.cu``, ``csm_cuda.csm_sweep_f32``) at
``torch_card_cases.F32_SHAPES``, on ``torch_card_cases.f32_window``
rounded as precision "split" rounds it.

Imports nothing of JAX.  Exits non-zero without CUDA.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

import torch


def main() -> int:
    argv = sys.argv[1:]
    f32 = argv[:1] == ["--f32"]
    if f32:
        argv = argv[1:]
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("sweep_ab: CUDA is not available", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parent
    tree = Path(argv[0]).resolve()
    # The tree's package first on the path, so this checkout's
    # chip_smoke.py (loaded by its path) runs on it too; chip_smoke.py puts
    # this checkout's tests/ on the path for torch_card_cases.
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  here / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    import torch_card_cases as cases

    from my_lidar_graph_slam_v2_tpu_torch.ops import csm, csm_cuda
    from my_lidar_graph_slam_v2_tpu_torch.scripts.common import sweep_bound

    if not Path(csm.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {csm.__file__}, not {tree}'s package")
    device = torch.device("cuda", 0)
    label = os.path.relpath(tree, here)
    print(f"device: {chip_smoke._nvidia_smi()}; tree {label}", flush=True)
    kernel = csm_cuda.csm_sweep_f32 if f32 else csm_cuda.csm_sweep
    for s in cases.kernel_shapes():
        if f32 and s["shape"] not in cases.F32_SHAPES:
            continue
        win, hr, hc, ok, origins, (th, tw, stride), _ = cases.tile_case(
            s["shape"])
        if f32:
            win = cases.f32_window(win, cases.ALL_CASES.index(s["shape"]),
                                   "split")
        kw = dict(tile_h=th, tile_w=tw, stride=stride)
        args = tuple(torch.as_tensor(a, device=device) for a in (
            win, hr, hc, ok, origins))
        ref = csm.sweep_tiles_plain(*args, **kw)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: kernel != plain at {s['shape']}")
        ms = chip_smoke._graph_ms(lambda: kernel(*args, **kw))
        bound_ms, bound_by = sweep_bound(s, args[3], f32=f32)
        print("sweep_ab " + json.dumps(dict(
            tree=label, f32=f32, shape=s["shape"], ms=ms, bound_ms=bound_ms,
            bound_by=bound_by, pct_of_bound=100 * bound_ms / ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
