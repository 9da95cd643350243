"""PyTorch + CUDA port of the 2D LiDAR graph-SLAM engine.

Each module pairs with the module of the same path in the JAX package
``my_lidar_graph_slam_v2_tpu`` and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package never imports JAX.
The CSM sweep runs as a hand-written CUDA kernel on the card
(``ops/csm_cuda.py``, ``csrc/csm_sweep.cu``); every other device op is
plain PyTorch.
"""
