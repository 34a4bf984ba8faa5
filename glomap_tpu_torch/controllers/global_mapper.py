"""GlobalMapper: the global SfM pipeline's controller.

Counterpart of glomap_tpu/controllers/global_mapper.py (GlobalMapper.solve),
itself the counterpart of glomap/controllers/global_mapper.{h,cc}
(GlobalMapper::Solve, :19-361). The port runs stage 0 (preprocessing:
sparsification, the pair-configuration update and the relative-pose
decomposition), stage 1 (view-graph calibration), stage 2 (relative pose
estimation: the batched LO-RANSAC, the inlier sweep, the two inlier
filters and the largest connected component), stage 3 (rotation
averaging: two solves, each followed by the rotation filter and the
largest connected component), stage 4 (track
establishment), stage 5 (global positioning and its filters), stage 6
(iterated staged bundle adjustment with progressive filtering and the
early exit under 0.1% of the tracks filtered), stage 7 (retriangulation
with its BA refinement rounds and their exit under 0.05% of the valid
observations changed), the deregistration of frames left without
observations, and stage 8 (pruning), with the same thresholds and
budgets, and stage-boundary checkpoints: with options.checkpoint_dir set,
stage_NN.npz holds the exact state after stage NN, and the next run
resumes at NN + 1. The multi-device solvers (device_mesh_shape) raise
NotImplementedError before any stage runs, naming the ROADMAP item.
"""

from __future__ import annotations

import copy
import dataclasses
import glob
import logging
import os

import numpy as np
import torch

from glomap_tpu_torch.config import GlobalMapperOptions
from glomap_tpu_torch.controllers import track_establishment as te
from glomap_tpu_torch.controllers.retriangulation import (
    merge_tracks, retriangulate_tracks)
from glomap_tpu_torch.controllers.rotation_averager import (
    RotationAveragerOptions, solve_rotation_averaging)
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.estimators import global_positioning as gpm
from glomap_tpu_torch.estimators.bundle_adjustment import (
    solve_bundle_adjustment)
from glomap_tpu_torch.estimators.relpose import estimate_relative_poses
from glomap_tpu_torch.estimators.view_graph_calibration import (
    calibrate_view_graph)
from glomap_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from glomap_tpu_torch.processors import pair_inliers
from glomap_tpu_torch.processors import relpose_filter as rpf
from glomap_tpu_torch.processors import track_filter as tf
from glomap_tpu_torch.processors import view_graph_manipulation as vgm
from glomap_tpu_torch.processors.normalization import normalize_reconstruction
from glomap_tpu_torch.processors.pruning import prune_weakly_connected_images
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.scene.view_graph import ViewGraph
from glomap_tpu_torch.utils.profiling import StageTimer, device_clock

logger = logging.getLogger(__name__)

# stage 7's refinement rounds (colmap ba_global_max_refinements) and their
# exit: the net change of the valid observations under this share
RETRIANGULATION_ROUNDS = 5
RETRIANGULATION_CHANGE = 5e-4


class GlobalMapper:
    """The pipeline on one device: CUDA unless `device` says otherwise
    (device=None without CUDA raises). `dtype` None means float64 on the
    CPU and float32 on CUDA, whose kernels take f32. After a run,
    `timer.stages` holds the seconds of each stage and `reports` what each
    ported stage did, by stage name."""

    def __init__(self, options: GlobalMapperOptions | None = None,
                 device=None, dtype: torch.dtype | None = None):
        self.options = options or GlobalMapperOptions()
        self.device = resolve_device(device)
        self.dtype = dtype or (torch.float64 if self.device.type == "cpu"
                               else torch.float32)
        self.timer = StageTimer(self.device)
        self.reports = {}

    def solve(self, scene: Scene, view_graph: ViewGraph,
              tracks: Tracks | None = None) -> Tracks | None:
        """Run the pipeline; mutates scene and view_graph, returns the
        tracks (None on failure)."""
        opt = self.options
        if opt.device_mesh_shape:
            raise NotImplementedError(
                "the multi-device solvers are not ported (ROADMAP A12)")
        start_stage, state = 0, None
        if opt.checkpoint_dir:
            start_stage, state = _latest_checkpoint(opt.checkpoint_dir)
        if state is not None:
            tracks = _resume_into(state, scene, view_graph, tracks)
        if start_stage <= 7 and not opt.skip_retriangulation:
            _require_view_graph(view_graph)

        def ckpt(idx):
            if opt.checkpoint_dir:
                _write_stage_checkpoint(opt.checkpoint_dir, idx, scene,
                                        view_graph, tracks)

        # 0. Preprocessing
        if start_stage <= 0 and not opt.skip_preprocessing:
            with self.timer.stage("preprocessing"):
                self.preprocessing(scene, view_graph)
        ckpt(0)

        # 1. View graph calibration
        if start_stage <= 1 and not opt.skip_view_graph_calibration:
            with self.timer.stage("view graph calibration"):
                if not self.view_graph_calibration(scene, view_graph):
                    return None
        ckpt(1)

        # 2. Relative pose estimation
        if start_stage <= 2 and not opt.skip_relative_pose_estimation:
            with self.timer.stage("relative pose estimation"):
                if not self.relative_pose_estimation(scene, view_graph):
                    return None
        ckpt(2)

        # 3. Rotation averaging (a filter pass and a final pass)
        if start_stage <= 3 and not opt.skip_rotation_averaging:
            with self.timer.stage("rotation averaging"):
                if not self.rotation_averaging(scene, view_graph):
                    return None
        ckpt(3)

        # 4. Track establishment and selection
        if start_stage <= 4 and not opt.skip_track_establishment:
            with self.timer.stage("track establishment"):
                tracks = self.establish_tracks(scene, view_graph)
        if tracks is None:
            tracks = Tracks()
        ckpt(4)

        # 5. Global positioning
        if start_stage <= 5 and not opt.skip_global_positioning:
            with self.timer.stage("global positioning"):
                if not self.global_positioning(scene, view_graph, tracks):
                    return None
        ckpt(5)

        # 6. Iterated staged bundle adjustment
        if start_stage <= 6 and not opt.skip_bundle_adjustment:
            with self.timer.stage("bundle adjustment"):
                if not self.bundle_adjustment(scene, tracks):
                    return None
        ckpt(6)

        # 7. Retriangulation
        if start_stage <= 7 and not opt.skip_retriangulation:
            with self.timer.stage("retriangulation"):
                tracks = self.retriangulation(scene, view_graph, tracks)
            if tracks is None:
                return None
        ckpt(7)

        # frames that end with no valid observation carry no geometric
        # support: drop them from the output instead of writing a junk pose
        deregister_unsupported(scene, tracks)

        # 8. Pruning
        if start_stage <= 8 and not opt.skip_pruning:
            with self.timer.stage("pruning"):
                prune_weakly_connected_images(scene, tracks)

        logger.info("stage summary:\n%s", self.timer.summary())
        return tracks

    def preprocessing(self, scene: Scene, vg: ViewGraph) -> None:
        """Stage 0: sparsify the view graph (when
        sparsify_expected_degree > 0), promote the UNCALIBRATED pairs
        between majority-calibrated cameras, and re-derive the relative
        poses from E and H."""
        opt, dev = self.options, self.device
        t0 = device_clock(dev)
        rep = {"sparsified_pairs": 0}
        if opt.sparsify_expected_degree > 0:
            rep["sparsified_pairs"] = vgm.sparsify_graph(
                vg, scene, opt.sparsify_expected_degree)
        rep["promoted_pairs"] = vgm.update_image_pairs_config(scene, vg)
        rep["decomposition"] = {}
        vgm.decompose_rel_pose(scene, vg, device=dev, dtype=self.dtype,
                               stats=rep["decomposition"])
        rep["seconds"] = device_clock(dev) - t0
        self.reports["preprocessing"] = rep

    def view_graph_calibration(self, scene: Scene, vg: ViewGraph) -> bool:
        """Stage 1: the focals of the cameras without a prior, from the F
        matrices; False when the solve diverges."""
        dev = self.device
        t0 = device_clock(dev)
        rep = {}
        ok = calibrate_view_graph(scene, vg, self.options.opt_vgcalib,
                                  dtype=self.dtype, device=dev, stats=rep)
        rep["seconds"] = device_clock(dev) - t0
        self.reports["view graph calibration"] = rep
        return ok

    def relative_pose_estimation(self, scene: Scene, vg: ViewGraph) -> bool:
        """Stage 2: lift the keypoints, estimate every pair's relative
        pose, classify every match (the inlier sweep), filter the pairs
        by inlier count and ratio, and keep the largest connected
        component; False when no component is left."""
        opt, dev = self.options, self.device
        thr = opt.inlier_thresholds
        t0 = device_clock(dev)
        undistort_images(scene, device=dev)
        t1 = device_clock(dev)
        relpose = {}
        estimate_relative_poses(scene, vg, opt.opt_relpose, dtype=self.dtype,
                                device=dev, stats=relpose)
        t2 = device_clock(dev)
        pair_inliers.image_pairs_inlier_count(scene, vg, thr, device=dev,
                                              dtype=self.dtype)
        t3 = device_clock(dev)
        filtered = {"inlier_num": rpf.filter_inlier_num(
                        vg, thr.min_inlier_num),
                    "inlier_ratio": rpf.filter_inlier_ratio(
                        vg, thr.min_inlier_ratio)}
        valid = int(vg.pair_valid.sum())
        num_img = vg.keep_largest_connected_component(scene)
        filtered["largest_component"] = valid - int(vg.pair_valid.sum())
        self.reports["relative pose estimation"] = {
            "seconds": device_clock(dev) - t0, "undistort_s": t1 - t0,
            "estimate_s": t2 - t1, "inlier_count_s": t3 - t2,
            "relpose": relpose, "pairs_filtered": filtered,
            "component_images": num_img}
        if num_img == 0:
            logger.error("no connected components are found")
            return False
        return True

    def rotation_averaging(self, scene: Scene, vg: ViewGraph) -> bool:
        """Stage 3: rotation averaging, the rotation filter and the
        largest connected component, twice. As in the JAX package, the
        first solve's result is not checked; a component of no image, or
        a failed second solve, fails the stage."""
        opt, dev = self.options, self.device
        max_err = opt.inlier_thresholds.max_rotation_error
        ra_opts = RotationAveragerOptions(**dataclasses.asdict(opt.opt_ra))
        t0 = device_clock(dev)
        passes = []

        def solve() -> bool:
            st = {"solves": []}
            t1 = device_clock(dev)
            st["ok"] = solve_rotation_averaging(
                scene, vg, ra_opts, device=dev, dtype=self.dtype,
                stats=st["solves"])
            st["seconds"] = device_clock(dev) - t1
            passes.append(st)
            return st["ok"]

        def filter_and_keep_component() -> int:
            st = passes[-1]
            st["filtered_pairs"] = rpf.filter_rotations(scene, vg, max_err)
            st["component_images"] = vg.keep_largest_connected_component(
                scene)
            if st["component_images"] == 0:
                logger.error("no connected components are found")
            return st["component_images"]

        solve()
        if filter_and_keep_component() == 0:
            return False
        if not solve():
            return False
        num_img = filter_and_keep_component()
        if num_img == 0:
            return False
        logger.info("%d / %d images within the connected component",
                    num_img, scene.num_images)
        self.reports["rotation averaging"] = {
            "seconds": device_clock(dev) - t0, "passes": passes}
        return True

    def establish_tracks(self, scene: Scene, vg: ViewGraph) -> Tracks:
        """Stage 4: every track of the inlier matches, then the selection
        for the problem."""
        opt = self.options
        t0 = device_clock(self.device)
        full = te.establish_full_tracks(scene, vg, opt.opt_track)
        tracks = te.find_tracks_for_problem(scene, full, opt.opt_track)
        logger.info("Before filtering: %d, after filtering: %d",
                    full.num_tracks, tracks.num_tracks)
        self.reports["track establishment"] = {
            "seconds": device_clock(self.device) - t0,
            "tracks_full": full.num_tracks, "tracks": tracks.num_tracks,
            "observations": tracks.num_obs}
        return tracks

    def global_positioning(self, scene: Scene, vg: ViewGraph,
                           tracks: Tracks) -> bool:
        """Stage 5: global positioning, its three filters, normalization,
        and the rescue of frames the solve left without observations."""
        opt, dev = self.options, self.device
        thr = opt.inlier_thresholds
        if opt.opt_gp.constraint_type != "ONLY_POINTS":
            logger.error("Only points are used for camera positions")
            return False
        t0 = device_clock(dev)
        undistort_images(scene, device=dev)
        gp = {}
        t1 = device_clock(dev)
        if not gpm.solve_global_positioning(scene, vg, tracks, opt.opt_gp,
                                            dtype=self.dtype, device=dev,
                                            stats=gp):
            return False
        gp["seconds"] = device_clock(dev) - t1
        removed = {
            "angle_obs": tf.filter_tracks_by_angle(
                scene, tracks, thr.max_angle_error),
            "triangulation_angle_tracks":
                tf.filter_tracks_by_triangulation_angle(
                    scene, tracks, thr.min_triangulation_angle),
            "reprojection_obs": tf.filter_tracks_by_reprojection(
                scene, tracks, 10 * thr.max_reprojection_error)}
        normalize_reconstruction(scene, tracks)
        # GP's random init can leave a frame that LM never pulled in
        # failing every filter above, with no observation left: place it
        # from its neighbors' pair directions
        removed["rescued_frames"] = gpm.rescue_unplaced_frames(scene, vg,
                                                               tracks)
        self.reports["global positioning"] = {
            "seconds": device_clock(dev) - t0, "gp": gp, "removed": removed}
        return True

    def bundle_adjustment(self, scene: Scene, tracks: Tracks) -> bool:
        """Stage 6: rounds of BA (position only, then full), each followed
        by normalization, the ray refresh and the progressive reprojection
        filter with its early exit; then the final filters."""
        opt, dev = self.options, self.device
        thr = opt.inlier_thresholds
        rounds = opt.num_iteration_bundle_adjustment
        t0 = device_clock(dev)
        ba, progressive = [], []

        def solve(ba_opts) -> bool:
            st = {}
            t1 = device_clock(dev)
            ok = solve_bundle_adjustment(scene, tracks, ba_opts,
                                         dtype=self.dtype, device=dev,
                                         stats=st)
            st["seconds"] = device_clock(dev) - t1
            ba.append(st)
            return ok

        ite = 0
        while ite < rounds:
            prev_cam_params = scene.cam_params.copy()
            ba_opts_tr = copy.deepcopy(opt.opt_ba)
            ba_opts_tr.optimize_rotations = False
            if not solve(ba_opts_tr):
                return False
            logger.info("BA iter %d/%d stage 1 done (position only)",
                        ite + 1, rounds)
            if opt.opt_ba.optimize_rotations and not solve(opt.opt_ba):
                return False
            logger.info("BA iter %d/%d stage 2 done", ite + 1, rounds)
            normalize_reconstruction(scene, tracks)
            # BA moved the intrinsics: re-lift the rays before the
            # normalized-space filter (global_mapper.cc:237-238)
            _refresh_rays(scene, prev_cam_params, dev)
            # progressive filtering with early exit (<0.1% filtered)
            status, filtered = True, 0
            while status and ite < rounds:
                n = tf.filter_tracks_by_reprojection(
                    scene, tracks,
                    max(3 - ite, 1) * thr.max_reprojection_error)
                progressive.append(n)
                filtered += n
                if filtered > 1e-3 * max(tracks.num_tracks, 1):
                    status = False
                else:
                    ite += 1
            if status:
                logger.info("fewer than 0.1%% tracks filtered, stop")
                break

        # final filters at the tight threshold, against rays lifted with
        # the final intrinsics (global_mapper.cc:263-264)
        final = {
            "reprojection_obs": tf.filter_tracks_by_reprojection(
                scene, tracks, thr.max_reprojection_error),
            "triangulation_angle_tracks":
                tf.filter_tracks_by_triangulation_angle(
                    scene, tracks, thr.min_triangulation_angle)}
        self.reports["bundle adjustment"] = {
            "seconds": device_clock(dev) - t0, "ba": ba,
            "progressive_obs_removed": progressive, "final_removed": final}
        return True

    def retriangulation(self, scene: Scene, vg: ViewGraph,
                        tracks: Tracks) -> Tracks | None:
        """Stage 7: each of num_iteration_retriangulation iterations
        rebuilds the tracks from every inlier match and triangulates them
        (controllers/retriangulation.py), then runs up to
        RETRIANGULATION_ROUNDS refinement rounds (colmap's
        ba_global_max_refinements loop, track_retriangulation.cc:99-122):
        BA, the ray refresh, completion, merging and the reprojection
        filter, until the net change of the valid observations falls under
        RETRIANGULATION_CHANGE. Then normalization and the final filters.
        Returns the new tracks (None when a BA fails); `tracks`, the
        previous set, is not read."""
        opt, dev = self.options, self.device
        thr, tri = opt.inlier_thresholds, opt.opt_triangulator
        _require_matches(vg)
        t0 = device_clock(dev)
        iterations = []
        for _ in range(opt.num_iteration_retriangulation):
            retri = {}
            t1 = device_clock(dev)
            tracks = retriangulate_tracks(scene, vg, tracks, tri, device=dev,
                                          dtype=self.dtype, stats=retri)
            retri["seconds"] = device_clock(dev) - t1
            rounds, prev_keys = [], None
            for _ in range(RETRIANGULATION_ROUNDS):
                prev_cam_params = scene.cam_params.copy()
                ba = {}
                t1 = device_clock(dev)
                if not solve_bundle_adjustment(scene, tracks, opt.opt_ba,
                                               dtype=self.dtype, device=dev,
                                               stats=ba):
                    return None
                ba["seconds"] = device_clock(dev) - t1
                # BA moved the intrinsics: re-lift the rays before the
                # complete, merge and filter passes (global_mapper.cc:
                # 237-238)
                _refresh_rays(scene, prev_cam_params, dev)
                num_obs = max(int(tracks.obs_valid.sum()), 1)
                rnd = {"ba": ba,
                       "completed": tf.complete_tracks(
                           scene, tracks, tri.tri_complete_max_reproj_error),
                       "merged": merge_tracks(
                           scene, vg, tracks, tri.tri_merge_max_reproj_error),
                       "filtered": tf.filter_tracks_by_reprojection(
                           scene, tracks, thr.max_reprojection_error)}
                rounds.append(rnd)
                # the NET change of the round, as the set of valid (track,
                # keypoint) keys: the reference counts gross complete,
                # merge and filter events, which double-counts the
                # observations that oscillate between the loose completion
                # and the tight filter every round, and never converges
                keys = _valid_obs_keys(scene, tracks)
                if prev_keys is not None:
                    rnd["changed"] = len(np.setxor1d(keys, prev_keys,
                                                     assume_unique=True))
                    if rnd["changed"] < RETRIANGULATION_CHANGE * num_obs:
                        break
                prev_keys = keys
            iterations.append({**retri, "rounds": rounds})
        normalize_reconstruction(scene, tracks)
        final = {
            "reprojection_obs": tf.filter_tracks_by_reprojection(
                scene, tracks, thr.max_reprojection_error),
            "triangulation_angle_tracks":
                tf.filter_tracks_by_triangulation_angle(
                    scene, tracks, thr.min_triangulation_angle)}
        self.reports["retriangulation"] = {
            "seconds": device_clock(dev) - t0, "iterations": iterations,
            "final_removed": final}
        return tracks


def _require_view_graph(vg: ViewGraph) -> None:
    """Before any stage, with stage 7 on: a view graph without pairs or
    matches is a model read without its database (ROADMAP C.7), which
    stage 7 cannot rebuild tracks from; the JAX package returns None
    without a reason. A graph whose pairs are all invalid is not this
    case: it fails where the JAX package fails, by solve returning None
    (rotation averaging finds no pair)."""
    if vg.num_pairs == 0 or vg.num_matches == 0:
        raise ValueError(
            "stage 7 (retriangulation) rebuilds the tracks from the view "
            "graph's matches, and the view graph has no pairs or no "
            "matches (a model read without its database); set "
            "skip_retriangulation")


def _require_matches(vg: ViewGraph) -> None:
    """Stage 7 rebuilds the tracks from the view graph's inlier matches:
    without any it would leave no track, and BA would fail."""
    if not (vg.pair_valid[vg.match_pair] & vg.match_inlier).any():
        raise ValueError(
            "stage 7 (retriangulation) rebuilds the tracks from the view "
            "graph's inlier matches, and the view graph has none (a model "
            "read without its database has no view graph); set "
            "skip_retriangulation")


def _valid_obs_keys(scene: Scene, tracks: Tracks) -> np.ndarray:
    """The valid observation set as sorted unique (track, keypoint) keys,
    invariant under the re-sorts of completion and merging."""
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
    kp = (scene.kp_offset[tracks.obs_image[ok]] +
          tracks.obs_feature[ok]).astype(np.int64)
    return np.unique(tracks.obs_track[ok].astype(np.int64) *
                     np.int64(scene.num_keypoints) + kp)


def deregister_unsupported(scene: Scene, tracks: Tracks) -> int:
    """The deregistration after stage 7 (global_mapper.py:336), skipped
    when the tracks are empty: the reference keeps its frames then, where
    the JAX package drops every one (ROADMAP C.1)."""
    if tracks.num_obs == 0:
        return 0
    return gpm.deregister_unsupported_frames(scene, tracks)


def _refresh_rays(scene: Scene, prev_cam_params: np.ndarray, device) -> None:
    """Re-lift the keypoint rays when BA moved the intrinsics: the
    normalized-space filters read scene.kp_ray, which must be lifted with
    the current camera parameters (global_mapper.cc:237-238, 263-264)."""
    if np.array_equal(prev_cam_params, scene.cam_params):
        return
    undistort_images(scene, device=device)


def _write_stage_checkpoint(ckpt_dir: str, stage_idx: int, scene, vg,
                            tracks) -> None:
    """stage_NN.npz = the exact pipeline state after stage NN."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"stage_{stage_idx:02d}.npz")
    save_checkpoint(path, scene, vg, tracks,
                    next_stage=np.int64(stage_idx + 1))
    logger.info("checkpoint written: %s", path)


def _latest_checkpoint(ckpt_dir: str):
    """(stage to resume at, load_checkpoint's result) of the latest
    stage_NN.npz in ckpt_dir; (0, None) when there is none."""
    found = sorted(glob.glob(os.path.join(ckpt_dir, "stage_*.npz")))
    if not found:
        return 0, None
    state = load_checkpoint(found[-1])
    start_stage = int(state[3].get("next_stage", 0))
    logger.info("resuming from checkpoint %s at stage %d", found[-1],
                start_stage)
    return start_stage, state


def _copy_state_into(dst, src) -> None:
    """Rebind every dataclass field of dst to src's arrays, and drop every
    other attribute: the caches derived from the old arrays
    (scene._kp_dev, the rays on the device; vg._match_kp_cache and
    vg._full_tracks_cache, stage 4's endpoints and tracks)."""
    names = {f.name for f in dataclasses.fields(dst)}
    for name in names:
        setattr(dst, name, getattr(src, name))
    for name in [k for k in vars(dst) if k not in names]:
        delattr(dst, name)


def _resume_into(state, scene: Scene, vg: ViewGraph,
                 tracks: Tracks | None) -> Tracks | None:
    """Load a checkpoint's state into the caller's scene and view graph;
    returns the tracks to go on with."""
    scene2, vg2, tracks2, _ = state
    _copy_state_into(scene, scene2)
    if vg2 is not None:
        _copy_state_into(vg, vg2)
    return tracks2 if tracks2 is not None else tracks
