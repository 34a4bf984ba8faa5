"""Options of the ported stages (the port's own copy).

Same fields and defaults as glomap_tpu/config.py InlierThresholds,
OptimizationBase, TrackEstablishmentOptions, GlobalPositionerOptions and
BundleAdjusterOptions, which mirror the reference's InlierThresholdOptions
(glomap/types.h), OptimizationBaseOptions
(glomap/estimators/optimization_base.h), TrackEstablishmentOptions
(glomap/controllers/track_establishment.h), GlobalPositionerOptions
(glomap/estimators/global_positioning.h) and BundleAdjusterOptions
(glomap/estimators/bundle_adjustment.h).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class InlierThresholds:
    max_angle_error: float = 1.0            # deg, global positioning filter
    max_reprojection_error: float = 1e-2    # normalized, BA filter
    min_triangulation_angle: float = 1.0    # deg
    max_epipolar_error_E: float = 1.0       # px
    max_epipolar_error_F: float = 4.0       # px
    max_epipolar_error_H: float = 4.0       # px
    min_inlier_num: int = 30
    min_inlier_ratio: float = 0.25
    max_rotation_error: float = 10.0        # deg


@dataclass
class OptimizationBase:
    """Shared solver knobs (reference OptimizationBaseOptions)."""
    thres_loss_function: float = 1e-1
    max_num_iterations: int = 100
    function_tolerance: float = 1e-5


@dataclass
class TrackEstablishmentOptions:
    thres_inconsistency: float = 10.0
    min_num_tracks_per_view: int = -1
    min_num_view_per_track: int = 3
    max_num_view_per_track: int = 100
    max_num_tracks: int = 10_000_000


@dataclass
class GlobalPositionerOptions(OptimizationBase):
    constraint_type: str = "ONLY_POINTS"  # ONLY_CAMERAS, POINTS_AND_CAMERAS[_BALANCED]
    constraint_reweight_scale: float = 1.0
    generate_random_positions: bool = True
    generate_random_points: bool = True
    generate_scales: bool = True
    optimize_positions: bool = True
    optimize_points: bool = True
    optimize_scales: bool = True
    min_num_view_per_track: int = 3
    seed: int = 1
    thres_loss_function: float = 1e-1  # Huber
    # forcing tolerance of the inner Jacobi-PCG on the frame system (the
    # role of BundleAdjusterOptions.cg_relative_tolerance)
    cg_relative_tolerance: float = 1e-2
    # inner-PCG iteration cap per LM step
    cg_max_iterations: int = 30


@dataclass
class BundleAdjusterOptions(OptimizationBase):
    optimize_rig_poses: bool = False
    optimize_rotations: bool = True
    optimize_translation: bool = True
    optimize_intrinsics: bool = True
    optimize_principal_point: bool = False
    optimize_points: bool = True
    min_num_view_per_track: int = 3
    thres_loss_function: float = 1.0  # Huber, px
    max_num_iterations: int = 200
    # inexact-Newton forcing tolerance of the inner CG on the reduced
    # camera system (Ceres Solver::Options::eta; its ITERATIVE_SCHUR
    # default is 1e-1 -- this one is tighter)
    cg_relative_tolerance: float = 1e-2
    # cap on inner-CG iterations per LM step (Ceres
    # max_linear_solver_iterations)
    cg_max_iterations: int = 30
