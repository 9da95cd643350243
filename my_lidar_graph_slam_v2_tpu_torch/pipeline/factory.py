"""Module factory: build the SLAM system on a given device.

Port of ``my_lidar_graph_slam_v2_tpu/pipeline/factory.py``
(``slam_module_factory.cpp``): matchers selected by the reference's type
names, the default loop-closing backend (batched or serial detector), the
multi-device backend, and the reference's default system, with the JAX
package's signatures and defaults plus ``device`` (or ``mesh``), which the
factory hands to every module.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..graph.optimizer import OptimizerConfig, PoseGraphOptimizer
from ..grid.builder import GridMapBuilder, GridMapBuilderConfig
from ..loop.detector import (
    LoopDetectorBranchBound,
    LoopDetectorConfig,
    LoopDetectorCorrelative,
)
from ..loop.searcher import LoopSearcherConfig, LoopSearcherNearest
from ..matching.branch_bound import BranchBoundConfig, ScanMatcherBranchBound
from ..matching.correlative import CorrelativeConfig, ScanMatcherCorrelative
from ..matching.grid_search import GridSearchConfig, ScanMatcherGridSearch
from ..matching.hill_climbing import HillClimbingConfig, ScanMatcherHillClimbing
from ..matching.linear_solver import LinearSolverConfig, ScanMatcherLinearSolver
from ..metrics.registry import MetricManager
from ..models.fused_matcher import FusedCorrelativeGNMatcher
from ..parallel.distributed import DistributedPoseGraphOptimizer, RankSum
from ..parallel.loop_sharded import (
    LoopDetectorShardedBranchBound,
    LoopDetectorShardedCorrelative,
)
from ..parallel.mesh import make_mesh
from ..parallel.multihost import MultiHostLoopDetector
from ..sensor.filters import ScanAccumulator, ScanInterpolator, ScanOutlierFilter
from .backend import LidarGraphSlamBackend
from .frontend import FrontendConfig, LidarGraphSlamFrontend
from .slam import LidarGraphSlam


def create_scan_matcher(type_name: str, *, device, **kw):
    """A scan matcher by the reference's type name, on ``device``."""
    if type_name == "RealTimeCorrelative":
        return ScanMatcherCorrelative(CorrelativeConfig(**kw), device)
    if type_name == "LinearSolver":
        return ScanMatcherLinearSolver(LinearSolverConfig(**kw), device)
    if type_name == "BranchBound":
        return ScanMatcherBranchBound(BranchBoundConfig(**kw), device)
    if type_name == "GridSearch":
        return ScanMatcherGridSearch(GridSearchConfig(**kw), device)
    if type_name == "HillClimbing":
        return ScanMatcherHillClimbing(HillClimbingConfig(**kw), device)
    raise ValueError(f"unknown scan matcher type: {type_name}")


def _backend(device, make_detector, make_optimizer, *,
             resolution: float = 0.05,
             beam_capacity: int = 512,
             usable_range_max: float = 20.0,
             n_theta_max: int = 208,
             crop: int = 448,
             score_threshold: float = 0.55,
             known_rate_threshold: float = 0.6,
             searcher_overrides: Optional[dict] = None,
             optimizer_overrides: Optional[dict] = None,
             inline: bool = True):
    """The default backend's parts at the JAX package's defaults, matching
    ``launcher_settings_default.json`` /Backend: the nearest searcher, the
    correlative loop detector (2.5 m x 2.5 m x 0.5 rad, crop 448, T 208,
    512 beams) that ``make_detector(detector_cfg, matcher_cfg,
    final_matcher, resolution)`` builds around a linear-solver final
    matcher on ``device``, and the LM that ``make_optimizer(cfg)`` builds."""
    matcher_cfg = CorrelativeConfig(
        range_x=2.5,
        range_y=2.5,
        range_theta=0.5,
        resolution=resolution,
        n_theta_max=n_theta_max,
        crop_rows=crop,
        crop_cols=crop,
    )
    detector_cfg = LoopDetectorConfig(
        score_threshold=score_threshold,
        known_rate_threshold=known_rate_threshold,
        beam_capacity=beam_capacity,
        usable_range_max=usable_range_max,
    )
    final_matcher = ScanMatcherLinearSolver(
        LinearSolverConfig(resolution=resolution), device,
        name="LoopDetector.FinalScanMatcherLinearSolver",
    )
    searcher = LoopSearcherNearest(
        LoopSearcherConfig(**(searcher_overrides or {}))
    )
    detector = make_detector(detector_cfg, matcher_cfg, final_matcher,
                             resolution)
    optimizer = make_optimizer(OptimizerConfig(**(optimizer_overrides or {})))
    return LidarGraphSlamBackend(searcher, detector, optimizer, inline=inline)


def create_default_backend(*, device, sharded: Optional[bool] = None,
                           loop_detector: str = "Correlative", **kw):
    """Default backend on ``device``: nearest searcher + the correlative
    loop detector + LM optimizer; the keywords and defaults of
    :func:`_backend`.

    ``sharded=None`` (the default) and ``True`` run all of a backend
    step's candidates as one batch on ``device``
    (``parallel/loop_sharded.py``: one coarse and one fine sweep launch per
    step), as the JAX package's default does on one device; ``False``
    runs the serial fused detector, one candidate at a time.

    ``loop_detector="BranchBound"`` puts the reference's
    ``LoopDetectorBranchBound`` group in its place (NodeHeightMax 6, the
    same window, crop, thetas, gates and final matcher): batched, one
    branch-and-bound batch per step (``LoopDetectorShardedBranchBound``),
    or with ``sharded=False`` the serial ``LoopDetectorBranchBound``."""
    if loop_detector not in ("Correlative", "BranchBound"):
        raise ValueError(f"unknown loop detector: {loop_detector}")
    branch_bound = loop_detector == "BranchBound"

    def bb_cfg(m: CorrelativeConfig) -> BranchBoundConfig:
        return BranchBoundConfig(
            range_x=m.range_x, range_y=m.range_y, range_theta=m.range_theta,
            resolution=m.resolution, n_theta_max=m.n_theta_max,
            crop_rows=m.crop_rows, crop_cols=m.crop_cols)

    if sharded is not False:
        def detector(detector_cfg, matcher_cfg, final_matcher, resolution):
            if branch_bound:
                return LoopDetectorShardedBranchBound(
                    detector_cfg, bb_cfg(matcher_cfg), final_matcher, device,
                    resolution=resolution)
            return LoopDetectorShardedCorrelative(
                detector_cfg, matcher_cfg, final_matcher, device,
                resolution=resolution)
    else:
        def detector(detector_cfg, matcher_cfg, final_matcher, resolution):
            if branch_bound:
                return LoopDetectorBranchBound(
                    detector_cfg,
                    ScanMatcherBranchBound(bb_cfg(matcher_cfg), device),
                    final_matcher, resolution=resolution)
            return LoopDetectorCorrelative(
                detector_cfg,
                FusedCorrelativeGNMatcher(
                    matcher_cfg, LinearSolverConfig(resolution=resolution),
                    device, name="LoopDetector.ScanMatcherCorrelative",
                    final_name="LoopDetector.FinalScanMatcherLinearSolver",
                ),
                final_matcher,
                resolution=resolution,
            )
    return _backend(device, detector,
                    lambda cfg: PoseGraphOptimizer(cfg, device=device), **kw)


def create_distributed_backend(mesh, *, ranks: Optional[RankSum] = None,
                               **kw):
    """Multi-device backend of one process on ``mesh``
    (``parallel/mesh.py``): a backend step's loop candidates split over the
    mesh's devices, one batch each (``parallel/loop_sharded.py``), and the
    Schur-complement LM over edge shards, one per device
    (``parallel/distributed.py``); the final matcher on the mesh's first
    device.  The keywords and defaults of :func:`_backend`.  With
    ``ranks``, the processes of a ``torch.distributed`` group share the
    work: loop candidates are routed to their map's owner and the LM sums
    over the ranks (``parallel/multihost.py:create_multihost_backend``)."""
    mesh = make_mesh(mesh)

    def detector(detector_cfg, matcher_cfg, final_matcher, resolution):
        if ranks is None:
            return LoopDetectorShardedCorrelative(
                detector_cfg, matcher_cfg, final_matcher, mesh,
                resolution=resolution)
        return MultiHostLoopDetector(detector_cfg, matcher_cfg, final_matcher,
                                     mesh, resolution, ranks=ranks)

    return _backend(
        mesh[0], detector,
        lambda cfg: DistributedPoseGraphOptimizer(mesh, cfg, ranks=ranks),
        **kw)


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
