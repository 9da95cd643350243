"""PyTorch + CUDA port of the 2D LiDAR graph-SLAM engine.

Each module pairs with the module of the same path in the JAX package
``my_lidar_graph_slam_v2_tpu`` and is held against it by the
``tests/test_torch_*.py`` parity tests.  This package never imports JAX.
Two hand-written CUDA kernels run on the card: the CSM sweep
(``ops/csm_cuda.py``, ``csrc/csm_sweep.cu``) and branch-and-bound's
hit-image build (``ops/hit_images_cuda.py``, ``csrc/hit_images.cu``);
every other device op is plain PyTorch.
"""
