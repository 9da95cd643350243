"""mapping.update_ms: fenced ms per keyframe of appending a node to the
pose graph and drawing its scan into the local map, with the next match's
latest-map delta (``grid/builder.py``, ``ops/rasterize.py``)."""

SPANS = [("mapping.update", ["append_first_node_and_edge",
                             "append_node_and_edge"])]


def read(td):
    kf = td.counts.get("keyframes", 0)
    if not kf or "mapping.update" not in td.span_s:
        return None
    return 1e3 * td.span_s["mapping.update"] / kf
