"""What decides ``correct``: the program's outputs of a run, held against
the plain reference of this package.

The reference takes the raw scans the benchmark generated and the poses
the program reports, filters the scans again, and works out again every
raster the program matched against.  It then reads, for each judged
output, one number:

- ``map_cells``: the share of a local map's observed cells whose u8 value
  or observed flag differs from the reference's rebuild of that map from
  the same scans at the poses it was built at (largest over the judged
  maps);
- ``match_moved``: the share of a sample of the window's frontend matches
  that the reference's damped Gauss-Newton, run in float64 on its own
  latest map with the configuration's iteration count and convergence
  threshold, moves by more than ``moved_m`` or ``moved_rad`` from the pose
  the program returned; a pose where the configuration's refinement has
  converged does not move.  A few sound matches move (the largest move
  is reported under ``widest``), so a share is compared, not the
  largest;
- ``loop_moved``: the same for a sample of the accepted loop edges, on
  the reference's rebuild of each edge's map;
- ``detect_wrong``: the share of a sample of the window's loop-detection
  queries on which the program's verdict contradicts the reference's
  search of the whole window (``detect.py``): a query that some pose
  passes both thresholds on by ``margin`` and that has no accepted edge,
  or one that no pose comes within ``margin`` of the score threshold on
  and that has one;
- ``lm_calls_missing``: how far the window's optimisations fall short of
  (or exceed) its backend steps that accepted a loop edge: each such step
  optimises once;
- ``lm_gap_m`` / ``lm_gap_rad``: the largest difference between the
  program's optimised poses and the reference LM's from the same graph,
  over every optimisation of the run (lambda is carried from call to call,
  so every call is replayed in order).

The reference follows the program step by step: each map is rebuilt at
the poses the program held when it drew it, each detection query is
searched from the poses the program held when it asked, and each LM call
starts from the graph the program handed its optimiser.  The control puts
the reference in the program's place one precision down: bfloat16
rasters, Gauss-Newton and search, a float32 LM.
"""
from __future__ import annotations

import numpy as np
import torch

from . import detect, filters, gn, lm, raster
from .pose import compound, inverse_compound

NUMBERS = ("map_cells", "match_moved", "loop_moved", "detect_wrong",
           "lm_calls_missing", "lm_gap_m", "lm_gap_rad")


class Scans:
    """The reference's filtered scan of each pose-graph node, made once."""

    def __init__(self, raw, node_raw, filt):
        self.raw, self.node_raw, self.filt = raw, node_raw, filt
        self._cache = {}

    def __getitem__(self, node_id):
        if node_id not in self._cache:
            self._cache[node_id] = filters.filtered(
                self.raw[self.node_raw[node_id]], self.filt)
        return self._cache[node_id]


def _beams(scan, capacity, usable_min, usable_max, device):
    r, a, _ = filters.pad_scan(scan, capacity, usable_min, usable_max)
    n = min(len(scan["ranges"]), capacity)
    mask = np.zeros(capacity, bool)
    mask[:n] = True
    return (torch.as_tensor(r, device=device), torch.as_tensor(a, device=device),
            torch.as_tensor(mask, device=device))


def _move(ref: gn.Raster, pose, beams, iterations, convergence):
    end = gn.refine(ref, pose, *beams, iterations, convergence)
    d = end - np.asarray(pose, np.float64)
    return float(np.hypot(d[0], d[1])), float(abs(d[2]))


def map_draws(rec, k, n_overlap):
    """What local map ``k`` holds, by the configuration's rule: from the
    second map on, the ``n_overlap`` nodes before its first, at the poses
    they had when it was started; then every node appended to it, at the
    poses it and the map had then.  [(map pose, [(node, pose)])]."""
    draws = []
    if k > 0:
        made = rec.maps[k]
        draws.append((made["pose"], made["before"][-n_overlap:]))
    for nid, (mid, pose, map_pose) in enumerate(rec.nodes):
        if mid == k:
            draws.append((map_pose, [(nid, pose)]))
    return draws


def sample(items, k, rng):
    if len(items) <= k:
        return list(items)
    idx = np.sort(rng.choice(len(items), k, replace=False))
    return [items[i] for i in idx]


def window_queries(rec):
    """Every detection query of the window with whether the program
    accepted an edge for it."""
    out = []
    for call in rec.detects:
        if not call["in_window"]:
            continue
        taken = {(e["map_id"], e["node_id"]) for e in call["edges"]}
        out += [dict(q, accepted=(q["map_id"], q["node_id"]) in taken)
                for q in call["queries"]]
    return out


def selection(rec, ref: dict, seed: int):
    """What the check judges, drawn from the seed: (rng for the rest,
    loop edges, detection queries, local-map ids)."""
    rng = np.random.default_rng([seed, 9176])
    loops = sample([e for e in rec.loops if e["in_window"]],
                   ref["judged_loops"], rng)
    queries = sample(window_queries(rec), ref["judged_queries"], rng)
    window_maps = sorted(k for k, v in rec.maps.items() if v["in_window"])
    maps = sorted(set([e["map_id"] for e in loops]
                      + [q["map_id"] for q in queries]
                      + sample(window_maps, ref["judged_maps"], rng)
                      + window_maps[-1:]))
    return rng, loops, queries, maps


def mix(rec) -> dict:
    """What the window's backend did: steps, steps that ran detection and
    that accepted an edge, queries, accepted edges and LM calls."""
    calls = [c for c in rec.detects if c["in_window"]]
    return dict(steps=sum(rec.steps), detect_steps=len(calls),
                edge_steps=sum(1 for c in calls if c["edges"]),
                queries=sum(len(c["queries"]) for c in calls),
                edges=sum(len(c["edges"]) for c in calls),
                lm_calls=sum(1 for c in rec.lm if c["in_window"]))


def judge(rec, raw_scans, ref: dict, program_maps: dict, seed: int, device,
          control: bool = False) -> dict:
    """The numbers of ``NUMBERS`` for the program's outputs in ``rec``
    (or, with ``control``, for the control's answers to the same inputs).
    ``program_maps[map_id]`` is the program's (u8, observed) raster of
    each local map :func:`selection` names.  A number with nothing to
    judge is None."""
    m = ref["map"]
    rng, loops, queries, judged_maps = selection(rec, ref, seed)
    scans = Scans(raw_scans, rec.node_raw, ref["filters"])
    low = torch.bfloat16
    out = dict.fromkeys(NUMBERS)
    moves = dict(match=[], loop=[])
    gn_iters = ref["judge_iterations"]
    conv = ref["judge_convergence"]
    rel_sensor = np.asarray(raw_scans[0]["relative_sensor_pose"], np.float64)

    res = m["resolution"]
    off = raster.map_offset(m["map_rows"], m["map_cols"], res)
    ref_maps = {}
    for k in judged_maps:
        calls = map_draws(rec, k, m["num_overlapped_scans"])
        lo, obs = raster.rasterize_calls(calls, scans, m, device)
        ref_maps[k] = (raster.quantize(lo, obs), obs)
        if control:
            lo_c, obs_c = raster.rasterize_calls(calls, scans, m, device, low)
            mine = (raster.quantize(lo_c, obs_c), obs_c)
        else:
            mine = program_maps[k]
        theirs = ref_maps[k]
        diff = (mine[1] != theirs[1]) | (mine[1] & theirs[1]
                                         & (mine[0] != theirs[0]))
        share = float(diff.sum()) / max(1, int((mine[1] | theirs[1]).sum()))
        out["map_cells"] = max(out["map_cells"] or 0.0, share)

    # Frontend matches on the reference's latest map.
    fe = sample([r for r in rec.matches if r["in_window"] and r["found"]],
                ref["judged_matches"], rng)
    for r in fe:
        lm_ = raster.latest_map(r["window"], scans, m, device)
        if lm_ is None:
            continue
        prob, obs, _, lm_off = lm_
        beams = _beams(filters.filtered(raw_scans[r["raw"]], ref["filters"]),
                       m["beam_capacity"], m["usable_range_min"],
                       m["usable_range_max"], device)
        pose = compound(r["est"], rel_sensor)
        if control:
            pose = gn.refine(gn.Raster(prob, obs, lm_off, res, low), pose,
                             *beams, gn_iters, conv)
        dm, dr = _move(gn.Raster(prob, obs, lm_off, res, torch.float64), pose,
                       beams, gn_iters, conv)
        moves["match"].append((dm, dr))

    # Accepted loop edges on the reference's rebuild of their maps.
    for e in loops:
        prob, obs = ref_maps[e["map_id"]]
        beams = _beams(scans[e["node_id"]], m["beam_capacity"], 0.0, np.inf,
                       device)
        pose = compound(e["rel"], rel_sensor)
        if control:
            pose = gn.refine(gn.Raster(prob, obs, off, res, low), pose,
                             *beams, gn_iters, conv)
        dm, dr = _move(gn.Raster(prob, obs, off, res, torch.float64), pose,
                       beams, gn_iters, conv)
        moves["loop"].append((dm, dr))

    widest = {}
    for kind, got in moves.items():
        if got:
            got = np.asarray(got)
            moved = (got[:, 0] > ref["moved_m"]) | (got[:, 1] > ref["moved_rad"])
            out[f"{kind}_moved"] = float(moved.mean())
            widest[f"{kind}_move_m"], widest[f"{kind}_move_rad"] = (
                float(v) for v in got.max(axis=0))

    # Detection queries: the reference's search of the whole window.
    d = ref["detect"]
    wrong, judged_q = 0, 0
    for q in queries:
        prob, obs = ref_maps[q["map_id"]]
        beams = _beams(scans[q["node_id"]], d["beam_capacity"], 0.0, np.inf,
                       device)
        pose = compound(inverse_compound(q["map_pose"], q["node_pose"]),
                        rel_sensor)
        score, known = detect.search(prob, obs, off, res, pose, *beams, d)
        says = detect.verdict(score, known, d, d["margin"])
        if says is None:
            continue
        judged_q += 1
        if control:
            accepted = detect.found(*detect.search(
                prob, obs, off, res, pose, *beams, d, dtype=low), d)
        else:
            accepted = q["accepted"]
        wrong += (says == "found") != accepted
    if judged_q:
        out["detect_wrong"] = wrong / judged_q

    # Each step that accepted an edge optimises once.
    window = mix(rec)
    out["lm_calls_missing"] = float(abs(window["edge_steps"]
                                        - window["lm_calls"]))

    # Every LM call in order, lambda carried.
    lam_ref = lam_low = ref["lm"]["initial_lambda"]
    for c in rec.lm:
        mp, sp, lam_ref = lm.optimize(ref["lm"], c["map_poses"],
                                      c["scan_poses"], c["edges"], lam_ref,
                                      device)
        if control:
            mine_mp, mine_sp, lam_low = lm.optimize(
                ref["lm"], c["map_poses"], c["scan_poses"], c["edges"],
                lam_low, device, torch.float32)
        else:
            mine_mp, mine_sp = c["out_map"], c["out_scan"]
        if not c["in_window"]:
            continue
        gap = np.concatenate([np.asarray(mine_mp) - mp,
                              np.asarray(mine_sp) - sp])
        out["lm_gap_m"] = max(out["lm_gap_m"] or 0.0,
                              float(np.abs(gap[:, :2]).max(initial=0.0)))
        out["lm_gap_rad"] = max(out["lm_gap_rad"] or 0.0,
                                float(np.abs(gap[:, 2]).max(initial=0.0)))
    out["widest"] = widest
    out["judged"] = dict(maps=len(judged_maps), matches=len(moves["match"]),
                         matches_full_map=sum(
                             1 for r in rec.matches if r["in_window"]
                             and r["path"] == "optimize_pose"),
                         loops=len(loops), queries=judged_q,
                         queries_near_threshold=len(queries) - judged_q,
                         lm_calls=window["lm_calls"])
    out["mix"] = window
    return out
