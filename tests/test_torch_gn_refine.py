"""``ops/gauss_newton.py:refine``, the matchers' one refinement entry, on
the CPU: its plain path gives the bits of the chain the matchers ran
before it (``gn_refine``, then ``covariance`` at the refined pose, and
``cost`` at the start), and the fused frontend match and the final
linear-solver matcher return what they returned with that chain.  The
covariance now comes from the H the loop kept, not from a fifth
evaluation, and the initial cost is still ``cost``'s (residuals squared
in f32, summed in f64), not the GN's exact-product sum.

On the course inputs of ``torch_gn_cases.py``; ``tests/test_torch_cuda.py``
holds the CUDA kernel to the same plain path.
"""
import numpy as np
import pytest
import torch

import torch_gn_cases as cases
from my_lidar_graph_slam_v2_tpu_torch.matching import linear_solver
from my_lidar_graph_slam_v2_tpu_torch.matching.correlative import (
    CorrelativeConfig,
)
from my_lidar_graph_slam_v2_tpu_torch.matching.linear_solver import (
    LinearSolverConfig,
)
from my_lidar_graph_slam_v2_tpu_torch.models import fused_matcher
from my_lidar_graph_slam_v2_tpu_torch.ops import gauss_newton

CASES = ["frontend", "loop"]


def old_chain(prob, observed, ranges, angles, mask, sensor_pose0,
              resolution, offset_xy, max_iterations=10,
              convergence_threshold=1e-4, initial_lambda=1e-4,
              covariance_scale=1e4):
    """The refinement as the matchers ran it before ``refine``."""
    cost0 = gauss_newton.cost(prob, observed, ranges, angles, mask,
                              sensor_pose0, resolution, offset_xy)
    pose, cost, iters = gauss_newton.gn_refine(
        prob, observed, ranges, angles, mask, sensor_pose0, resolution,
        offset_xy, max_iterations=max_iterations,
        convergence_threshold=convergence_threshold,
        initial_lambda=initial_lambda,
    )
    cov = gauss_newton.covariance(prob, observed, ranges, angles, mask, pose,
                                  resolution, offset_xy, covariance_scale)
    return pose, cost, iters, cov, cost0


@pytest.mark.parametrize("f32", [False, True], ids=["u8", "f32"])
@pytest.mark.parametrize("name", CASES)
def test_refine_equals_the_old_chain(name, f32):
    args = cases.case(name, f32=f32)
    cases.assert_same_bits(gauss_newton.refine(*args), old_chain(*args))


@pytest.mark.parametrize("kw", [
    dict(max_iterations=0),
    dict(max_iterations=3, convergence_threshold=0.5),
    dict(initial_lambda=10.0, covariance_scale=3.0),
], ids=["no steps", "early stop", "lambda and scale"])
def test_refine_equals_the_old_chain_at_other_settings(kw):
    args = cases.case("frontend", start_seed=1)
    cases.assert_same_bits(gauss_newton.refine(*args, **kw),
                           old_chain(*args, **kw))


@pytest.fixture
def old_refine(monkeypatch):
    """Puts the old chain in place of ``refine`` for the matchers."""
    def use():
        monkeypatch.setattr(gauss_newton, "refine", old_chain)
    return use


@pytest.mark.parametrize("name", CASES)
def test_fused_body_is_unchanged(name, old_refine):
    prob, obs, ranges, angles, mask, start, res, off = cases.case(name)
    ccfg = CorrelativeConfig(resolution=res, n_theta_max=48, crop_rows=256,
                             crop_cols=256)
    lcfg = LinearSolverConfig(resolution=res)

    def body():
        return fused_matcher.fused_body(
            ccfg, lcfg, prob, obs, None, None, ranges, angles, mask, start,
            off, 0.0, 0.0)

    new = body()
    old_refine()
    old = body()
    assert len(new) == 12
    cases.assert_same_bits(new, old)


@pytest.mark.parametrize("name", CASES)
def test_refine_core_is_unchanged(name, old_refine):
    prob, obs, ranges, angles, mask, start, res, off = cases.case(name)
    cfg = LinearSolverConfig(resolution=res)

    def core():
        return linear_solver.refine_core(cfg, prob, obs, ranges, angles,
                                         mask, start, off)

    new = core()
    old_refine()
    old = core()
    assert len(new) == 5
    cases.assert_same_bits(new, old)
    assert np.isfinite(new[1].item()) and new[1] < new[4]


def test_kernel_wrapper_raises_on_what_it_does_not_take():
    """The CUDA wrapper checks before it builds or launches anything: a
    raster of another dtype or rank, a mask that is not bool, and CPU
    tensors are refused (the plain version is ``refine``'s CPU path)."""
    from my_lidar_graph_slam_v2_tpu_torch.ops import gauss_newton_cuda

    args = cases.case("frontend")
    kw = dict(max_iterations=10, convergence_threshold=1e-4,
              initial_lambda=1e-4, covariance_scale=1e4)
    before = gauss_newton_cuda.LAUNCHES
    for prob in (args[0].to(torch.int16), args[0].to(torch.float64),
                 args[0][None]):
        with pytest.raises(ValueError, match="prob must be u8 or f32"):
            gauss_newton_cuda.refine(prob, *args[1:], **kw)
    with pytest.raises(ValueError, match="mask must be"):
        gauss_newton_cuda.refine(*args[:4], args[4].float(), *args[5:], **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        gauss_newton_cuda.refine(*args, **kw)
    assert gauss_newton_cuda.LAUNCHES == before
