"""The mapper's option tree (the port's own copy).

Same classes, fields and defaults as glomap_tpu/config.py, which mirrors
the reference's OptionManager (glomap/controllers/option_manager.{h,cc})
and its option structs:
  GlobalMapperOptions        glomap/controllers/global_mapper.h
  InlierThresholdOptions     glomap/types.h
  RotationEstimatorOptions   glomap/estimators/global_rotation_averaging.h
  GlobalPositionerOptions    glomap/estimators/global_positioning.h
  BundleAdjusterOptions      glomap/estimators/bundle_adjustment.h
  ViewGraphCalibratorOptions glomap/estimators/view_graph_calibration.h
  TrackEstablishmentOptions  glomap/controllers/track_establishment.h
  TriangulatorOptions        glomap/controllers/track_retriangulation.h
  RelativePoseEstimationOptions glomap/estimators/relpose_estimation.h
  GravityRefinerOptions      glomap/estimators/gravity_refinement.h
  OptimizationBaseOptions    glomap/estimators/optimization_base.h
The options of stages the port does not run yet are data only: they
exist so that the same dotted flags parse (cli.py).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


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
class ViewGraphCalibratorOptions(OptimizationBase):
    thres_lower_ratio: float = 0.1
    thres_higher_ratio: float = 10.0
    thres_two_view_error: float = 2.0
    thres_loss_function: float = 1e-2  # Cauchy loss scale


@dataclass
class RelPoseEstimationOptions:
    # adaptive RANSAC budget (relpose_estimation.h:14 sets
    # ransac_options.max_iterations = 50000): hypotheses are spent in
    # fixed-size batched chunks over the active pairs only; a pair leaves
    # the active set once its spent budget passes the stopping number
    # log(1-conf)/log(1-r^8) for its best inlier ratio r (clamped to
    # [num_hypotheses, max_iterations])
    max_iterations: int = 50000
    max_epipolar_error: float = 1.0  # px (PoseLib default for E)
    num_hypotheses: int = 1024       # per-pair minimum
    refine_num_lm_iters: int = 10
    # hypothesis scoring and refinement use at most this many matches per
    # pair; the full match set is classified afterwards by the inlier sweep
    score_match_cap: int = 512


@dataclass
class RotationEstimatorOptions:
    max_num_l1_iterations: int = 5
    l1_step_convergence_threshold: float = 0.001
    max_num_irls_iterations: int = 100
    irls_step_convergence_threshold: float = 0.001
    axis: tuple = (0.0, 1.0, 0.0)
    irls_loss_parameter_sigma: float = 5.0  # deg
    weight_type: str = "GEMAN_MCCLURE"      # or "HALF_NORM"
    skip_initialization: bool = False
    use_weight: bool = False
    use_gravity: bool = False


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


@dataclass
class TriangulatorOptions:
    tri_complete_max_reproj_error: float = 15.0
    tri_merge_max_reproj_error: float = 15.0
    tri_min_angle: float = 1.0
    min_num_matches: int = 15
    # colmap IncrementalTriangulator::Options::create_max_angle_error, the
    # angular support threshold of the RANSAC triangulation
    tri_create_max_angle_error: float = 2.0
    tri_ransac_hypotheses: int = 16
    # generations of split-and-retrack for keypoints the previous
    # generation's points left unexplained
    tri_num_generations: int = 3


@dataclass
class GravityRefinerOptions(OptimizationBase):
    max_outlier_ratio: float = 0.5
    max_gravity_error: float = 1.0  # deg
    min_num_neighbors: int = 7


@dataclass
class GlobalMapperOptions:
    opt_vgcalib: ViewGraphCalibratorOptions = field(
        default_factory=ViewGraphCalibratorOptions)
    opt_relpose: RelPoseEstimationOptions = field(
        default_factory=RelPoseEstimationOptions)
    opt_ra: RotationEstimatorOptions = field(
        default_factory=RotationEstimatorOptions)
    opt_track: TrackEstablishmentOptions = field(
        default_factory=TrackEstablishmentOptions)
    opt_gp: GlobalPositionerOptions = field(
        default_factory=GlobalPositionerOptions)
    opt_ba: BundleAdjusterOptions = field(default_factory=BundleAdjusterOptions)
    opt_triangulator: TriangulatorOptions = field(
        default_factory=TriangulatorOptions)
    opt_gravity_refiner: GravityRefinerOptions = field(
        default_factory=GravityRefinerOptions)
    inlier_thresholds: InlierThresholds = field(default_factory=InlierThresholds)

    num_iteration_bundle_adjustment: int = 3
    num_iteration_retriangulation: int = 1

    # expected degree of the view graph's optional sparsification
    # (ViewGraphManipulater::SparsifyGraph); <= 0 leaves it off
    sparsify_expected_degree: int = -1

    skip_preprocessing: bool = False
    skip_view_graph_calibration: bool = False
    skip_relative_pose_estimation: bool = False
    skip_rotation_averaging: bool = False
    skip_track_establishment: bool = False
    skip_global_positioning: bool = False
    skip_bundle_adjustment: bool = False
    skip_retriangulation: bool = False
    skip_pruning: bool = True

    # no reference counterpart: the JAX package's solver dtype and device
    # mesh (the port takes its dtype from GlobalMapper's caller and has no
    # mesh yet), and stage-boundary checkpoints: when set, GlobalMapper
    # writes <dir>/stage_NN.npz after every stage and resumes from the
    # latest one on the next run
    solver_dtype: str = "float64"
    device_mesh_shape: Optional[tuple] = None
    checkpoint_dir: str = ""


def mapper_resume_options() -> GlobalMapperOptions:
    """Preset of `mapper_resume` (reference option_manager.cc:103-127):
    skip every stage before global positioning, and retriangulation."""
    opt = GlobalMapperOptions()
    opt.skip_preprocessing = True
    opt.skip_view_graph_calibration = True
    opt.skip_relative_pose_estimation = True
    opt.skip_rotation_averaging = True
    opt.skip_track_establishment = True
    opt.skip_retriangulation = True
    return opt


def _iter_flat(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _iter_flat(v, prefix + f.name + ".")
        else:
            yield prefix + f.name, v


def flatten_options(opt) -> dict:
    """Dotted-name view of a nested options dataclass (CLI and --help)."""
    return dict(_iter_flat(opt))


def set_option(opt, dotted_name: str, value: str):
    """Set a field by dotted name from its string form (CLI flags)."""
    parts = dotted_name.split(".")
    target = opt
    for p in parts[:-1]:
        target = getattr(target, p)
    name = parts[-1]
    cur = getattr(target, name)
    if isinstance(cur, bool):
        parsed = value.lower() in ("1", "true", "yes", "on")
    elif isinstance(cur, int):
        parsed = int(value)
    elif isinstance(cur, float):
        parsed = float(value)
    elif isinstance(cur, tuple):
        parsed = tuple(float(x) for x in value.split(","))
    else:
        parsed = value
    setattr(target, name, parsed)
