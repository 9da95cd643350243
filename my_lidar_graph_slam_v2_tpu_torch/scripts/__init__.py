"""The port's measurement and evaluation entry points, each run as
``python -m my_lidar_graph_slam_v2_tpu_torch.scripts.<name>``:
``bench_csm`` (CSM matches/s against the C++ baseline), ``bench_e2e``
(keyframes/s, ATE and loop edges at Intel scale), ``eval_ate`` (the four
BASELINE configurations), ``head_to_head`` (the reference binary's
recorded runs in ``h2h/``) and ``metric_diff``."""
