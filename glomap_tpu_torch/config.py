"""Bundle-adjustment options (the port's own copy).

Same fields and defaults as glomap_tpu/config.py OptimizationBase and
BundleAdjusterOptions, which mirror the reference's
OptimizationBaseOptions (glomap/estimators/optimization_base.h) and
BundleAdjusterOptions (glomap/estimators/bundle_adjustment.h).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class OptimizationBase:
    """Shared solver knobs (reference OptimizationBaseOptions)."""
    thres_loss_function: float = 1e-1
    max_num_iterations: int = 100
    function_tolerance: float = 1e-5


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
