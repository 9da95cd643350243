# The port's own copy of scripts/metric_diff.py, its logic unchanged: it
# imports only the standard library.
"""Mechanical metric-JSON diff: reference vs ours.

Both files use the sectioned layout (Counters/Gauges/Distributions/
Histograms/ValueSequences with flat dotted series names,
``metric/metric.hpp:646-686`` / ``slam_launcher.cpp:171-181``).  Reports,
per section, the series present in the reference but missing from ours
(parity gaps -> nonzero exit) and the extra series ours adds (reported,
allowed).  Sample counts are printed for shared series so gross cadence
mismatches are visible.

Usage: python -m my_lidar_graph_slam_v2_tpu_torch.scripts.metric_diff \
       <ref.metric.json> <ours.metric.json>
"""
import argparse
import json
import sys

SECTIONS = ("Counters", "Gauges", "Distributions", "Histograms",
            "ValueSequences")


def names(doc, section):
    v = doc.get(section, "")
    return set(v.keys()) if isinstance(v, dict) else set()


def n_samples(entry):
    if "NumOfSamples" in entry:
        return int(entry["NumOfSamples"])
    if "NumOfValues" in entry:
        return int(entry["NumOfValues"])
    return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("reference")
    ap.add_argument("ours")
    ap.add_argument("--verbose", action="store_true",
                    help="print per-series sample counts")
    args = ap.parse_args(argv)

    ref = json.load(open(args.reference))
    ours = json.load(open(args.ours))

    missing_total = 0
    for section in SECTIONS:
        rn, on = names(ref, section), names(ours, section)
        missing = sorted(rn - on)
        extra = sorted(on - rn)
        shared = sorted(rn & on)
        print(f"[{section}] reference={len(rn)} ours={len(on)} "
              f"shared={len(shared)} missing={len(missing)} "
              f"extra={len(extra)}")
        for name in missing:
            print(f"  MISSING  {name}")
        for name in extra:
            print(f"  extra    {name}")
        if args.verbose and section == "ValueSequences":
            for name in shared:
                nr = n_samples(ref[section][name])
                no = n_samples(ours[section][name])
                flag = "" if nr == no else "  <- count differs"
                print(f"  shared   {name}: ref={nr} ours={no}{flag}")
        missing_total += len(missing)

    if missing_total:
        print(f"FAIL: {missing_total} reference series missing from ours")
        return 1
    print("OK: every reference series is present")
    return 0


if __name__ == "__main__":
    sys.exit(main())
