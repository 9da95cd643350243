"""Module factory: build the SLAM system on a given device.

Port of ``my_lidar_graph_slam_v2_tpu/pipeline/factory.py:create_default_slam``
(``slam_module_factory.cpp``): the reference's default configuration,
real-time correlative local matcher + linear-solver final matcher,
outlier filter + interpolator, with the same signature and defaults plus
``device``, which the factory hands to every module.  The loop-closing
backend (``create_default_backend``) is ROADMAP item 1.10.
"""
from __future__ import annotations

from typing import Optional

import torch

from my_lidar_graph_slam_v2_tpu.metrics.registry import MetricManager

from ..grid.builder import GridMapBuilder, GridMapBuilderConfig
from ..matching.correlative import CorrelativeConfig, ScanMatcherCorrelative
from ..matching.linear_solver import LinearSolverConfig, ScanMatcherLinearSolver
from ..models.fused_matcher import FusedCorrelativeGNMatcher
from ..sensor.filters import ScanAccumulator, ScanInterpolator, ScanOutlierFilter
from .frontend import FrontendConfig, LidarGraphSlamFrontend
from .slam import LidarGraphSlam


def create_default_slam(
    *,
    device,
    resolution: float = 0.05,
    map_rows: int = 1024,
    map_cols: int = 1024,
    beam_capacity: int = 512,
    samples_per_beam: int = 768,
    usable_range_max: float = 20.0,
    n_theta_max: int = 208,
    crop: int = 320,
    backend=None,
    fused_matcher: bool = True,
    frontend_overrides: Optional[dict] = None,
    builder_overrides: Optional[dict] = None,
    matcher_overrides: Optional[dict] = None,
) -> LidarGraphSlam:
    """The reference's default configuration on ``device`` ("cuda",
    "cuda:0", "cpu", ...).  There is no default device: a CUDA run that
    silently fell back to the CPU would measure the wrong machine.

    f32 matrix products stay full f32 on the card: TF32 is switched off
    for both cuBLAS and cuDNN here (process-wide PyTorch flags)."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    builder_cfg = GridMapBuilderConfig(
        resolution=resolution,
        local_map_rows=map_rows,
        local_map_cols=map_cols,
        latest_map_rows=map_rows,
        latest_map_cols=map_cols,
        beam_capacity=beam_capacity,
        samples_per_beam=samples_per_beam,
        usable_range_max=usable_range_max,
        **(builder_overrides or {}),
    )
    matcher_cfg = dict(
        resolution=resolution,
        n_theta_max=n_theta_max,
        crop_rows=crop,
        crop_cols=crop,
        **(matcher_overrides or {}),
    )
    if fused_matcher:
        scan_matcher = FusedCorrelativeGNMatcher(
            CorrelativeConfig(**matcher_cfg),
            LinearSolverConfig(resolution=resolution),
            device,
            name="LocalSlam.ScanMatcherCorrelative",
            final_name="LocalSlam.FinalScanMatcherLinearSolver",
        )
    else:
        scan_matcher = ScanMatcherCorrelative(
            CorrelativeConfig(**matcher_cfg), device,
            name="LocalSlam.ScanMatcherCorrelative",
        )
    final_matcher = ScanMatcherLinearSolver(
        LinearSolverConfig(resolution=resolution), device,
        name="LocalSlam.FinalScanMatcherLinearSolver",
    )
    fe_cfg = FrontendConfig(
        beam_capacity=beam_capacity,
        usable_range_max=usable_range_max,
        **(frontend_overrides or {}),
    )
    frontend = LidarGraphSlamFrontend(
        fe_cfg,
        scan_matcher,
        final_matcher,
        device,
        outlier_filter=ScanOutlierFilter(valid_range_max=usable_range_max),
        interpolator=ScanInterpolator(dist_scans=resolution),
        accumulator=ScanAccumulator() if fe_cfg.use_scan_accumulator else None,
        metrics=MetricManager.instance(),
    )
    builder = GridMapBuilder(builder_cfg, device)
    return LidarGraphSlam(frontend, backend, builder)
