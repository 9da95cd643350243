"""The port's measurement and evaluation entry points, each run as
``python -m my_lidar_graph_slam_v2_tpu_torch.scripts.<name>``:
``bench_csm`` (CSM matches/s against the C++ baseline), ``bench_e2e``
(keyframes/s, ATE and loop edges at Intel scale), ``eval_ate`` (the four
BASELINE configurations), ``head_to_head`` (the reference binary's
recorded runs in ``h2h/``), ``metric_diff``, ``eval_bb_pyramid`` (the
dense sweep against branch-and-bound at the loop window), ``eval_scaling``
(the loop fan-out and the distributed LM over a mesh of cards) and
``eval_scaling_pipeline`` (the multi-process pipeline at P = 1 and 2)."""
