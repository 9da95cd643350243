# The port's own copy of my_lidar_graph_slam_v2_tpu/io/graph_plot.py, logic
# unchanged: the port imports nothing of the JAX package.
"""Live pose-graph view as dependency-free SVG.

TPU-native replacement for the reference's ``IO::GnuplotHelper`` live
viewer (``src/my_lidar_graph_slam/io/gnuplot_helper.cpp:22-77``), which
pipes the pose graph to ``popen("gnuplot")`` every N frames with odometry
edges in black and loop edges in blue.  Instead of a gnuplot process we
render the same picture to an SVG file (atomic replace), which any
browser / image viewer can watch and auto-refresh; the CLI launcher
rewrites it every ``--draw-every`` keyframes like the reference's
``drawFrameInterval`` (``slam_launcher.cpp:298-302``).
"""
from __future__ import annotations

import os

import numpy as np

ODOMETRY_COLOR = "#000000"  # black, like gnuplot_helper.cpp:52
LOOP_COLOR = "#1f6fd0"  # blue, like gnuplot_helper.cpp:53


def pose_graph_svg(pose_graph, width: int = 640, margin: float = 1.0) -> str:
    """Render scan-node trajectory + edges to an SVG string.

    Edge endpoints are the *global* poses of the two nodes of each edge
    (local-map node and scan node), exactly what the reference plots.
    """
    sp = pose_graph.scan_poses()
    mp = pose_graph.local_map_poses()
    if len(sp) == 0:
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
            f'height="{width}"/>'
        )
    pts = np.vstack([sp[:, :2], mp[:, :2]]) if len(mp) else sp[:, :2]
    lo = pts.min(axis=0) - margin
    hi = pts.max(axis=0) + margin
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    height = width
    scale = (width - 20) / span

    def to_px(xy):
        x = 10 + (xy[0] - lo[0]) * scale
        y = height - 10 - (xy[1] - lo[1]) * scale  # y up
        return x, y

    lines = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}">',
        f'<rect width="{width}" height="{height}" fill="#ffffff"/>',
    ]
    # Edges: odometry black under loop blue (same z-order as the reference)
    for want_loop, color, sw in ((False, ODOMETRY_COLOR, 1.0),
                                 (True, LOOP_COLOR, 1.5)):
        seg = []
        for e in pose_graph.edges:
            if e.is_loop != want_loop:
                continue
            a = to_px(mp[e.local_map_node_id])
            b = to_px(sp[e.scan_node_id])
            seg.append(
                f'M{a[0]:.1f} {a[1]:.1f}L{b[0]:.1f} {b[1]:.1f}'
            )
        if seg:
            lines.append(
                f'<path d="{"".join(seg)}" stroke="{color}" '
                f'stroke-width="{sw}" fill="none"/>'
            )
    # Scan-node trajectory as a polyline + node dots
    pix = [to_px(p) for p in sp[:, :2]]
    poly = " ".join(f"{x:.1f},{y:.1f}" for x, y in pix)
    lines.append(
        f'<polyline points="{poly}" stroke="#c03030" stroke-width="1" '
        f'fill="none"/>'
    )
    x, y = pix[-1]
    lines.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" fill="#c03030"/>')
    lines.append("</svg>")
    return "\n".join(lines)


def draw_pose_graph(pose_graph, path: str, width: int = 640) -> None:
    """Write the SVG atomically so a watching viewer never sees a torn
    frame (the gnuplot pipe had the same property per-plot)."""
    svg = pose_graph_svg(pose_graph, width=width)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(svg)
    os.replace(tmp, path)
