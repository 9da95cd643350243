"""A cell cut to a size the CPU runs in seconds, for the benchmark's own
tests: 384^2 maps, 512 beams, 128 samples per beam, 48 thetas, crop 256,
on a 12 m office or the traffic's own corridor, 200 keyframes long."""
from __future__ import annotations

import copy

from slam_bench import harness

SIZE = dict(map_rows=384, map_cols=384)


def small(config_name: str, traffic_name: str = "revisit"):
    """(config, traffic) of a cell at the test size."""
    cfg = copy.deepcopy(harness.load_config(config_name))
    sysc = cfg["system"]
    ref_map = cfg["reference"]["map"]
    ref_map.update(SIZE)
    cfg["reference"]["detect"].update(n_theta_max=48, crop=256)
    if sysc["kind"] == "factory":
        sysc["slam"] = dict(SIZE, beam_capacity=512, samples_per_beam=128,
                            n_theta_max=48, crop=256)
        sysc["backend"].update(beam_capacity=512, n_theta_max=48, crop=256)
        ref_map.update(beam_capacity=512, samples_per_beam=128)
    else:
        sysc["kwargs"].update(SIZE, n_theta_max=48, crop=256, loop_crop=256)
    traffic = dict(harness.load_traffic(traffic_name), course_keyframes=200)
    if "world" not in traffic:
        traffic["size"] = 12.0
    return cfg, traffic


def run(config_name, seed, seconds, faults=(), trace_on=False,
        traffic_name="revisit"):
    cfg, traffic = small(config_name, traffic_name)
    r = harness.Run(f"{config_name}.{traffic_name}", seed, "cpu", config=cfg,
                    traffic=traffic, faults=faults, trace_on=trace_on)
    r.window(seconds)
    return r
