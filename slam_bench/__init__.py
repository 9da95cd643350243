"""The benchmark of my_lidar_graph_slam_v2_tpu_torch: run one cell with
``python3 -m slam_bench.run`` (see ``run.py``); cells, metrics and bounds
are in ``BENCHMARK.json`` at the checkout's root."""
