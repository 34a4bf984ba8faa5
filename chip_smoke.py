#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's global bundle adjustment, stage-2 inlier
sweep, stages 0-7 of the mapper, its mapper, mapper_resume and
rotation_averager commands, its partitioned BA and GP and its
multi-device mapper on one NVIDIA card, check every kernel against its
plain PyTorch version, and time it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (each raises on failure; the exit code is then non-zero):

1. device  -- the card's name and power limit (nvidia-smi); build the
              eight kernels with nvcc for sm_90a (all at once) and time it.
2. kernels -- one LM iteration of the slice on the committed
              .bench_cache.npz problem (100 frames, 1001 points, 100,100
              observations, f32) records every distinct input each kernel
              wrapper receives on the main path. Each is then run through
              the kernel and its plain version on the card and compared
              (tolerances below); reductions are also run on small-integer
              inputs, whose f32 sums are exact in any order, and must match
              bit for bit. Kernel, plain version and, where one PyTorch
              call computes the same function, that call (library_ms) are
              timed as CUDA graphs of repeated launches, so host launch
              cost is excluded. B4 at each one-segment (camera) input, and
              B3 on that axis, must give the camera segment the same bits
              with a dummy segment in front of it (offset_invariance).
              B2 also runs its own inputs (gather_extra_cases: every
              O % 4, and a 53-column table larger than shared memory
              under unsorted ids), each bit for bit its plain version.
3. slice   -- the launch counters are zeroed, _solve_ba runs 30 LM
              iterations with bench.py's settings, and the counters are
              read: every kernel must have launched. The cost must be
              finite and below the initial cost. Two more timed runs show
              the spread of the host clock. Three LM iterations on the
              card must match three on the CPU's plain path (f32, and f64
              for scale), and two runs on the card must agree bit for bit.
              Last, the user's entry point, solve_bundle_adjustment, runs
              the same problem as a Scene and Tracks on the card, with the
              counters zeroed before and read after, and must match
              _solve_ba.

4. inlier sweep -- stage 2's inlier classification at Gerrard-Hall
              scale: the port's synthetic generator makes 100 frames and
              2,500 points (10,238,895 matches over 4,950 pairs, 224,824
              keypoints), and a seeded draw makes about 10% of the pairs
              UNCALIBRATED and 5% PLANAR (infinite homography K_j R K_i^-1).
              One sweep records every input of the Sampson kernel (B7), the
              gather (B2) and the row sums (B3); each is checked against its
              plain version in f64 (B7 within the first-order bound of its
              own f32 operations, sampson_bound) and timed like phase 2.
              Then undistort_images + image_pairs_inlier_count run three
              times on the card (counters zeroed before the first: sampson
              must launch twice per chunk, gather and rowsum must launch).
              Two runs must agree bit for bit, a run in chunks of ceil(M/3)
              must equal the one-shot run bit for bit, and against the CPU's
              plain f32 path every match classified differently must have
              its f64 error within B7's bound of its threshold. Last, the
              relative-pose filters and keep_largest_connected_component run
              on the card's result.
5. stages 4-6 -- the mapper's track establishment, global positioning
              and iterated bundle adjustment on phase 4's filtered result,
              through the controller's stage code
              (glomap_tpu_torch/controllers/global_mapper.py; stage_4,
              stage_5, stage_6 below, default options, ONLY_POINTS, three
              BA rounds with the progressive filter and its early exit,
              then the deregistration). The scene's
              rotations are the generator's, as after rotation averaging.
              Every kernel input of one GP LM iteration and one BA LM
              iteration is checked and timed like phase 2 (the offset
              check included): B5
              (gather_dot) within the first-order bound of its k-term f32
              dot, B6 (huber_irls, the fused IRLS step) bit for bit
              against its plain f32 version and within its rounding bound
              of f64. Three GP LM
              iterations on the card must match the CPU's plain f32 path
              (cost to 1e-4 relative), and GP's cost at its initial state
              an f64 evaluation within a bound derived from its order of
              operations (gp_cost_at_start). Stage 5 runs twice and must agree
              bit for bit; counters zeroed before stage 5 must show B2,
              B3, B5 and B6, and before stage 6 B1-B6. After stage 5 and
              after stage 6 the registered frame centers, Sim3-aligned to
              the generator's, must lie within the JAX package's GP oracle
              (0.15 on a ring of radius 5), stage 6 no worse than stage 5.
6. mapper_resume -- stage 6's result (100 frames, one PINHOLE camera,
              ~2,500 points, ~224k observations) is written as a binary
              COLMAP model with write_reconstruction and read back with
              read_model, which must give scene_to_model's model exactly.
              Then `cli.main(["mapper_resume", ...])` runs on the card as
              a user runs it (stages 5 and 6 from the model's rotations,
              the deregistration and, with --skip_pruning 0, stage 8):
              once with the counters zeroed (B1-B6 must launch; every
              kernel input of its GP and BA is recorded, then checked and
              timed like phase 2), a second time, once with
              --checkpoint_dir, and once resumed from that run's
              stage_05.npz with the later checkpoints deleted. All four
              must write the same bytes. The output must keep every image
              registered, its points finite, and its image centers,
              Sim3-aligned and matched by image name, within 0.15 of the
              generator's.
7. stage 7  -- retriangulation on phase 5's result after stage 6 (copied
              before phase 6; 100 frames, 224,824 keypoints, ~2,490
              tracks, the 10.2M-match view graph), through the
              controller's stage method (stage_7): every B2 and B3 input
              of its triangulation calls (the 3-column hypothesis gather,
              the 2-row support sums, the 9-row normal equations) and of
              one LM iteration of its first refinement BA is recorded,
              checked and timed like phase 2 (B2 bit for bit; B3 within
              _sum_bound and bit for bit on small integers); the counted
              run must launch B1-B6; a second run must agree bit for bit;
              retriangulate_tracks on the card must match the CPU's plain
              f32 path within the measured RETRI_* bounds; the centers
              must lie within 0.15 of the generator's and valid
              observations explain at least 98% of the keypoints (the
              reference's oracle). The batched 3x3 solves are timed, a
              retriangulate_tracks call is profiled, and
              GlobalMapper.solve runs stages 4-7 on phase 4's filtered
              scene (stages 0-3 skipped: the generator's rotations).

8. stage 3  -- rotation averaging on phase 4's filtered scene, its
              relative rotations perturbed by 1 deg of noise and 15%
              random-rotation outliers (a seeded draw), every frame
              started at the identity. (a) The controller's stage code
              (stage_3: two solves, each followed by the rotation filter
              and the largest component) on the card, counted (B3 must
              launch; every B2 and B3 input is recorded, then checked and
              timed like phase 2), a second time bit for bit, and on the
              CPU's plain path in f32 (within the measured
              RA_CPU_F32_RAD, the same pairs filtered) and in f64 for
              scale; pairwise errors against the
              generator under 2 deg, 1 deg on average. (b) Gravity priors
              with 30% outliers on 80% of the frames, refine_gravity
              (within 1e-2 deg of the truth), then the stratified gravity
              solve (the 1-DoF solve and the full one, both on the
              projected CG: B2 and B3 must launch): pairwise errors under
              1.5 deg, the constrained frames on their manifold. (c)
              `cli.main(["rotation_averager", ...])` on the JAX package's
              component graph (2,000 frames, ~40,000 edges, 1 deg noise)
              written by pose_io.write_rel_poses: two runs write the same
              bytes, sampled pairwise errors under 2 deg. (d)
              estimate_rotations on the JAX package's city graph (20,000
              frames, ~1.06M edges, beyond the 12,288-frame dense
              ceiling: the CG path), counted and recorded: sampled
              pairwise errors under 3 deg; one Laplacian apply on its
              axes timed whole and as its B2 and B3 launches alone. (e) GlobalMapper.solve runs
              stages 3-6 on (a)'s scene: centers within 0.15.
9. mapper   -- the `mapper` command from a COLMAP database. (a) Phase
              4's sweep scene, its two-view geometries kept (config, E,
              F, H, relative pose) and every frame pose reset, written by
              write_database under build/mapper/ (seconds, bytes). (b)
              The front end on the card against the CPU's plain f32 path
              from the same input: decompose_rel_pose (the same
              configurations and PANORAMIC pairs), calibrate_view_graph
              with the prior cleared and the focal at 1.3x (within 1% of
              the generator's, the same pairs kept; B3 carries its
              normal equations, and the card's run is counted and its
              kernel inputs recorded: the `view_graph_calibration` path
              of the kernels line), one RANSAC round of 64 hypotheses on
              every pair with the same draws (best counts), and the LO
              step from the same start (rotations, translations), within
              the measured FRONT_* bounds. (c) estimate_relative_poses on
              the card: twice bit for bit, once profiled (the device's
              busy share), one round profiled (launches a round); pose
              errors against the generator within tests/test_relpose.py's
              noisy oracle. (d) `cli.main(["mapper", ...])` with the
              counters zeroed (B1-B8 must launch; every kernel input of
              stages 0-7 is recorded, checked and timed like phase 2,
              the `mapper` path of the kernels line), again, with
              --checkpoint_dir, and resumed from that run's stage_02.npz
              with the later checkpoints deleted: the same bytes four
              times; at least 99 of the 100 images registered, finite
              points, centers within 0.15 of the generator's by image
              name, and the keypoint oracle (98%).

10. partitioned -- the partition-aware solvers (glomap_tpu_torch/
              parallel/) at the 1DSfM scale. (a) The sequential capture
              at its defaults (800 frames, 60,000 points, 3,000
              keypoints an image, seed 1) with 0.5 px of noise; stage 4's
              tracks triangulated on the card; BA's poses and points
              perturbed as tests/test_bundle_adjustment.py's _prepare
              does, GP from the generator's rotations; the spectral
              partition into 4 parts timed. (b) BA, 10 LM iterations with
              no early exit, three ways: solve_bundle_adjustment; 4 parts
              on a world of one rank under NCCL (twice, bit for bit);
              4 parts on two ranks under gloo, two processes on the one
              card (NCCL runs no two ranks on one device), whose results
              must have the same bits on both ranks. The cost at the
              shared start within a bound derived from its order of
              operations, the final costs within PART_BA_COST_RTOL, the
              Sim3-aligned centers within 1e-3 of the span; LM it/s,
              parts, cut fraction, points and observations per part, and
              the all_reduce bytes per LM iteration counted beside the
              JAX package's formula. (c) GP the same three ways: centers
              within 1e-3 of the span. (d) Every kernel input of one
              partitioned BA and one partitioned GP LM iteration is
              recorded, checked and timed like phase 2 (the `partitioned`
              path of the kernels line); B1-B6 must launch on the counted
              partitioned runs; each kernel on an empty axis gives zeros.
11. mesh    -- the multi-device mapper (files under build/mesh/). (a)
              `cli.main(["mapper", "--distributed", ...])` on phase 9's
              database in a world of one NCCL rank (GLOMAP_* and a file
              store; counted: B1-B7 must launch), then two gloo ranks on
              the one card (dryrun.run_world, `--solver mapper`): their
              models byte-identical and the primary's CLI the same
              bytes; each model against phase 9's oracles and phase 9's
              one-device model (centers, both aligned to the
              generator's, within MESH_MODEL_CENTER_BOUND); seconds by
              stage. (b) Stages 3-6 on phase 10's capture from the
              identity through GlobalMapper with device_mesh_shape=(4,)
              on one NCCL rank and on one device (counted: B1-B6 must
              launch; stage 3's B2 and B3 inputs recorded, the
              `mesh_capture` path): rotations within 2 deg of the
              generator's, centers within PART_CENTER_SPAN of each
              other, LM it/s, all_reduce calls and bytes per RA sweep
              and LM iteration; then the replicated-point BA
              (solve_ba_sharded) on its result, counted and its inputs
              recorded (the `sharded_ba` path), against one block with no
              group within PART_BA_COST_RTOL. (c) solve_rotations_sharded
              on phase 8's city graph in 4 parts on one NCCL rank
              (counted and recorded, the `sharded_ra` path; sampled
              errors under 3 deg) and on its component graph on two gloo
              ranks (the same bits on both), each within MESH_RA_RAD of
              the one-device solve; all_reduce calls per sweep.
12. ransac  -- B8 (csrc/ransac.cu, a chunk of stage 2's RANSAC in one
              launch) on two tiles recorded from stage 2 of the
              benchmark's loop cell at seed 1 (sfm_bench's generator; files
              under build/ransac/; the mapper stops once both are
              recorded): the first chunk's first tile and the first tile
              of fewer than 100 pairs. Each: one launch, two launches bit
              for bit, best counts within [incoming, unmasked slots], and
              against the plain chain (ransac_chunk_plain, f32 on the card)
              and the plain chain in f64 on the same tables: the share of
              pairs whose best count differs, by how much, and the same of
              the plain chain against f64; device ms (a CUDA graph), the
              plain chain's ms, summed kernel time and launches, and the
              bound (operations counted from ransac.cu). Then the tail tile
              cut to 200 slots (odd pairs at 100 distinct slots, masked on
              a third), checked the same way untimed, and the tie rule: a
              pair whose two rounds tie keeps the earlier round's E.

Output: the {"kernels": [...]} line (seven kernels; each path's numbers
under "paths"), a {"slice": ...} line, an {"inlier_sweep": ...} line, a
{"stages_4_6": ...} line, a {"mapper_resume": ...} line, a {"stage_7":
...} line, a {"stage_3": ...} line, a {"mapper": ...} line (its runs'
StageTimer seconds: read database, stages 0-7, write model), a
{"partitioned": ...} line, a {"mesh": ...} line, a {"ransac": ...}
line (B8's cases: its row of PERF.md's kernel table), the card's name and
power limit, and last
{"ok": true, "device": {...}}. Without a CUDA device it prints no result
and exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from glomap_tpu_torch import cli
from glomap_tpu_torch.config import (BundleAdjusterOptions,
                                     GlobalPositionerOptions,
                                     InlierThresholds)
from glomap_tpu_torch.config import GlobalMapperOptions
from glomap_tpu_torch.controllers.global_mapper import (
    GlobalMapper, deregister_unsupported)
from glomap_tpu_torch.controllers.retriangulation import retriangulate_tracks
from glomap_tpu_torch.controllers.track_establishment import (
    establish_full_tracks, find_tracks_for_problem)
from glomap_tpu_torch.controllers.rotation_averager import (
    RotationAveragerOptions, solve_rotation_averaging)
from glomap_tpu_torch.estimators import bundle_adjustment as tba
from glomap_tpu_torch.estimators import global_positioning as gpm
from glomap_tpu_torch.estimators.bundle_adjustment import (
    _solve_ba, solve_bundle_adjustment)
from glomap_tpu_torch.estimators.gravity_refinement import refine_gravity
from glomap_tpu_torch.estimators import relpose
from glomap_tpu_torch.estimators.rotation_averaging import (
    build_edge_ops, estimate_rotations)
from glomap_tpu_torch.estimators.view_graph_calibration import (
    calibrate_view_graph)
from glomap_tpu_torch.io import pose_io
from glomap_tpu_torch.io.checkpoint import save_checkpoint
from glomap_tpu_torch.io.colmap_model import read_model
from glomap_tpu_torch.io.convert import (database_to_scene, scene_to_model,
                                         write_reconstruction)
from glomap_tpu_torch.io.database import read_database, write_database
from glomap_tpu_torch.math import gravity as gravm
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.math.rotation import pose_center
from glomap_tpu_torch.math.sim3 import apply_sim3, umeyama_alignment
from glomap_tpu_torch.ops import _build, kernels, linear
from glomap_tpu_torch.ops import triangulation as tri
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.parallel import dryrun, multihost
from glomap_tpu_torch.parallel.partitioned_ba import partition_points
from glomap_tpu_torch.parallel.sharded_ba import solve_ba_sharded
from glomap_tpu_torch.parallel.sharded_ra import solve_rotations_sharded
from glomap_tpu_torch.processors import pair_inliers, relpose_filter
from glomap_tpu_torch.processors import view_graph_manipulation as vgmp
from glomap_tpu_torch.processors.undistortion import undistort_images
from glomap_tpu_torch.scene import view_graph as vgm
from glomap_tpu_torch.scene.arrays import Scene, Tracks
from glomap_tpu_torch.utils.carry import ba_inputs_from_arrays
from glomap_tpu_torch.utils.profile_sweep import SWEEP_OPTIONS, sweep_problem
from glomap_tpu_torch.utils.synthetic import (
    SequentialCaptureOptions, synthesize_gravity,
    synthesize_sequential_dataset)

BENCH_CACHE = Path(__file__).resolve().parent / ".bench_cache.npz"
# bench.py's settings: the throughput run forces every LM iteration
SETTINGS = dict(huber_delta=1.0, function_tol=0.0, cg_iters=30,
                optimize_points=True, max_rejections=1 << 30)
LM_ITERS = 30
CPU_ITERS = 3

# Each kernel (f32) is held against its plain version evaluated in f64 on
# the same f32 inputs, on the card, so the error measured is the kernel's
# own rounding.
# projection: elementwise closed forms. The residual cancels ~1000 px
#   terms (fx*u + cx - uv): 2e-3 px is ~30 f32 ulps of 1000. Jacobian
#   entries: 1e-5 of the largest value in their row.
PROJ_R_ATOL = 2e-3
PROJ_J_RTOL = 1e-5
# reductions: the first-order worst-case bound of the kernel's own order
#   of f32 operations, 2^-24 * depth * sum(|terms|) per output, where depth
#   counts the roundings on one term's path: a lane's chain over its
#   observations of a chunk (with B4's fused products), the 5-level lane
#   butterfly, B4's warp-group adds and the adds of the chunk partials
#   (see _sum_bound). Not a tuned number: a kernel inside it sums what the
#   plain version sums.
# gather: an exact copy, compared bit for bit.
# sampson: every f32 operation of sampson.cu rounds once (relative error
#   u = 2^-24 at most; no FMA contraction). First order, each point
#   coordinate divided by its z carries 2u; a line value L = e0 p + e1 q + e2
#   carries 5u * (|e0 p| + |e1 q| + |e2|); C = Ex0 b0 + Ex1 b1 + Ex2 adds
#   the lines' errors weighted by |b| and 5u of its own terms; the
#   denominator D = sum L^2 carries sum(2 |L| dL + dL^2) + 4u D. Then
#   |r_f32 - r| <= (2 |C| dC + dC^2) / D_lo + r (dD / D_lo + 2u), with
#   D_lo = max(D - dD, 1e-12), keeping dC^2 because C cancels to ~0 on an
#   inlier. See sampson_bound. Not a tuned number. The f64 reference's own
#   rounding is 2^-29 of it, covered by 5u where 4u would do.
# CPU plain path vs the card after CPU_ITERS LM iterations, f32: the
#   reduction orders differ and the CG carries the rounding on. Measured on
#   an H100 (700 W): cost at most 1.6e-7 relative, parameters at most
#   1.9e-5 of their largest magnitude (points); the bounds leave 60x and 5x.
SLICE_COST_RTOL = 1e-5
SLICE_PARAM_RTOL = 1e-4

# published peaks (NVIDIA data sheets, dense, at the full power limit)
PEAKS = {  # name substring -> (bytes/s, f32 FLOP/s outside tensor cores)
    "H200": (4.8e12, 67e12),
    "H100": (3.35e12, 67e12),
}

REPLACES = {
    "projection_resid_jac": ("glomap_tpu_torch/csrc/projection.cu",
                             "glomap_tpu/ops/pallas_kernels.py:302"),
    "gather": ("glomap_tpu_torch/csrc/gather.cu",
               "glomap_tpu/ops/pallas_kernels.py:514"),
    "rowsum": ("glomap_tpu_torch/csrc/rowsum.cu",
               "glomap_tpu/ops/pallas_kernels.py:431"),
    "pair_rowsum": ("glomap_tpu_torch/csrc/pair_rowsum.cu",
                    "glomap_tpu/ops/pallas_kernels.py:762"),
    "gather_dot": ("glomap_tpu_torch/csrc/gather_dot.cu",
                   "glomap_tpu/ops/pallas_kernels.py:849"),
    "huber_irls": ("glomap_tpu_torch/csrc/huber.cu",
                   "glomap_tpu/ops/pallas_kernels.py:904"),
    "sampson_score": ("glomap_tpu_torch/csrc/sampson.cu",
                      "glomap_tpu/ops/pallas_kernels.py:949"),
}
# wrapper name -> its counter in kernels.LAUNCHES
COUNTER = {"sampson_score": "sampson", "huber_irls": "huber",
           "ransac_chunk": "ransac"}
# the kernels each path must launch
BA_KERNELS = ("projection_resid_jac", "gather", "rowsum", "pair_rowsum",
              "gather_dot", "huber_irls")
SWEEP_KERNELS = ("gather", "rowsum", "sampson_score")
GP_KERNELS = ("gather", "rowsum", "gather_dot", "huber_irls")
# f32 operations per observation of the projection kernel, counted from
# projection.cu (all kinds' base maps are evaluated, then selected)
PROJ_OPS = {25: 420, 31: 520}
# f32 operations per match of the Sampson kernel, counted from sampson.cu
SAMPSON_OPS = 40
# per observation of the Huber kernel beside its k squares, k - 1 adds and
# the two weight products: clamp, sqrt, compare, division, product,
# difference (huber.cu)
HUBER_OPS = 6
# the ground-truth oracle of stage 5 and 6: the JAX package's own GP test
# at 1 px noise (tests/test_global_positioning.py:44-51), max center error
# after Sim3 alignment on a ring of radius 5
GP_CENTER_BOUND = 0.15
# card vs the CPU's plain f32 path after CPU_ITERS GP LM iterations, from
# the random [-100, 100]^3 init: the reduction orders differ (the kernels'
# chunked CSR sums against index_add_) and the CG carries the rounding on.
# Measured on an H100 80GB HBM3 (700 W): the cost 8.6e-5 relative with
# the split-segment row sums (6.4e-5 before them), and the same 8.6e-5,
# bit for bit, with the fused Huber step, whose squares add in the order
# the card's torch.sum took; both sides are deterministic, so the 1e-4
# bound on the cost is met the same way on every run of this input. A measured bound, not a derived one: beside it,
# gp_cost_at_start holds the cost at the shared initial state, before any
# CG iteration, within a bound derived from its order of operations.
GP_COST_RTOL = 1e-4
# the dummy segment of the offset check: a length that is no multiple of
# 32 or of either chunk length, so every CSR entry behind it moves
DUMMY_OBS = 1237
# the reference's observation-recovery oracle (global_mapper_test.cc:
# 213-217, tests/test_global_mapper.py): after stage 7, valid observations
# explain at least this share of the keypoints
KEYPOINT_ORACLE = 0.98
# retriangulate_tracks on the card against the CPU's plain f32 path from
# the same input (phase 7): the share of valid (track, keypoint) keys in
# one and not the other, and the largest point difference of the tracks
# alike in both over the extent of the frame centers. The sources differ
# in the order of the 2-row and 9-row sums (B3's chunks against
# index_add_) and in the batched 3x3 solves (cuSOLVER against LAPACK);
# the supports are integer sums, exact in any order. A measured bound,
# not a derived one: on an NVIDIA H100 80GB HBM3 (700 W) 0 of 224,824
# keys differed and the points 9.06e-8 of the extent; both sides are
# deterministic. The bounds leave 224 keys and 11x on the points.
RETRI_KEYS_SHARE = 1e-3
RETRI_POINT_REL = 1e-6
# the torch.linalg calls of midpoint_triangulate, by profiler op name
SOLVER_OPS = ("aten::linalg_solve_ex", "aten::linalg_eigvalsh")
# phase 6's models and checkpoints (under build/, which git ignores)
MAPPER_RESUME_DIR = Path(__file__).resolve().parent / "build" / "mapper_resume"
MODEL_FILES = ("cameras.bin", "images.bin", "points3D.bin")
# phase 8: the kernels of rotation averaging, and its scenes. The stage
# scene's relative rotations get 1 deg of noise and 15% random-rotation
# outliers (tests/test_rotation_averaging.py:28-41, :65-75), and its
# oracle is the reference's: pairwise errors against the generator at
# most 2 deg, 1 deg on average (rotation_averager_test.cc:305)
RA_KERNELS = ("gather", "rowsum")
RA_SEED = 8
RA_NOISE_DEG, RA_OUTLIERS = 1.0, 0.15
RA_MAX_DEG, RA_MEAN_DEG = 2.0, 1.0
# gravity priors: 30% outliers (tests/test_gravity.py:79-99), refined to
# 1e-2 deg of the truth (rotation_averager_test.cc:404-407); priors on
# 80% of the frames, so that the pairs whose frames both carry one are
# under the 95% at which the stratified 1-DoF solve is skipped; pairwise
# errors under 1.5 deg (rotation_averager_test.cc:354-361)
GRAVITY_OUTLIERS, GRAVITY_PRIOR_SHARE = 0.3, 0.8
GRAVITY_REFINED_DEG, GRAVITY_MAX_DEG = 1e-2, 1.5
# a constrained frame's up axis against its prior after the solve: the f32
# retractions about the up axis keep it on the manifold to their rounding
# (the f64 tests hold 1e-5 deg); a frame off it by more has left it
GRAVITY_MANIFOLD_DEG = 1e-2
# the JAX package's RA benchmark graphs: its component graph
# (scripts/bench_components.py:32-48, the dense path) through the
# rotation_averager command, and its city graph (scripts/ra_quality_ab.py:
# 177-181, beyond the 12,288-frame dense ceiling: the CG path), with their
# sampled oracles (ra_quality_ab.py:64-78): the reference's 2 deg for the
# noise-only component graph and the 3 deg that ra_quality_ab.py:10-11
# cites for the city graph
COMPONENT_GRAPH = dict(frames=2000, degree=20, span=30, noise_deg=1.0,
                       outliers=0.0, seed=3, dedupe=False)
CITY_GRAPH = dict(frames=20000, degree=80, span=90, noise_deg=1.0,
                  outliers=0.05, seed=3, dedupe=True)
COMPONENT_MAX_DEG, CITY_MAX_DEG = 2.0, 3.0
# stage 3 on the card against the CPU's plain f32 path from the same input
# (phase 8): the largest rotation between their frame rotations, and no
# pair filtered differently. The sources differ in the order of B3's sums
# against index_add_ and in the dense Cholesky (cuSOLVER against LAPACK);
# the ADMM's and the IRLS's exit tests read those sums, and took the same
# branches and counts on both. A measured bound, not a derived one: on an
# NVIDIA H100 80GB HBM3 (700 W) the frames differed by 2.67e-7 rad (the
# f64 CPU path by 1.97e-7), with the same pairs; both sides are
# deterministic. The bound leaves 11x.
RA_CPU_F32_RAD = 3e-6
RA_DIR = Path(__file__).resolve().parent / "build" / "rotation_averager"
# phase 9: the mapper from a COLMAP database (under build/). The front end
# on the card against the CPU's plain f32 path from the same input. The
# sources differ in the order of the sums (B3's chunks, cuBLAS's batched
# products and triangular solves against the CPU's) and the SVD (cuSOLVER
# against LAPACK). Measured bounds, not derived ones, from this phase's
# first run on an NVIDIA H100 80GB HBM3 (700 W); both sides are
# deterministic:
# * decompose_rel_pose's poses: 4.3e-7 rad;
# * calibrate_view_graph's focal: 1.76e-4 relative (the LM took 7 steps on
#   the card, 9 on the CPU); 3 of the 4,695 pairs kept on one side only,
#   pairs whose two-view residual is f32 rounding (FRONT_CALIB_F64 counts
#   the card's kept pairs against the CPU's f64 path beside it);
# * one RANSAC round: in f32 the 8-point system's shift 1e-8 tr(AtA) is
#   below the rounding of tr(AtA), so near-degenerate samples give other
#   nullspaces on the card and the CPU: 1,293 of 4,950 pairs had another
#   best count (up to 433 slots), and each f32 side ~1,700 against the
#   CPU's f64 round; the summed best counts differ by 1.3e-3 (card
#   1,131,816, CPU 1,133,339, f64 1,127,268). The bounds are on that share
#   and on the sums. With B8 on the card: 1,332 pairs (up to 499
#   slots), 1,683 against f64, the card's sum 1,134,220;
# * the LO step from the same start: 1.88e-4 rad and 7.6e-5.
MAPPER_DIR = Path(__file__).resolve().parent / "build" / "mapper"
FRONT_DECOMPOSE_RAD = 1e-5
FRONT_FOCAL_REL = 1e-3
FRONT_CALIB_PAIRS = 10
FRONT_COUNT_PAIRS_SHARE = 0.35
FRONT_COUNT_SUM_REL = 0.01
FRONT_REFINE_RAD = 1e-3
FRONT_REFINE_TRANS = 1e-3
# the generator's focal from a 1.3x start, without a prior
# (tests/test_view_graph_calibration.py's oracle)
CALIB_START, CALIB_FOCAL_REL = 1.3, 0.01
# tests/test_relpose.py's noisy oracle: median rotation error and the
# share of pairs under 2 deg
RELPOSE_MEDIAN_DEG, RELPOSE_UNDER_2DEG = 0.5, 0.85
MAPPER_MIN_IMAGES = 99
# the kernels on the mapper's path (B1-B7; B8, which replaces no TPU
# kernel, is required beside them in (d))
MAPPER_KERNELS = tuple(REPLACES)
# phase 12: B8 (csrc/ransac.cu) on two tiles of stage 2 of the benchmark's
# loop cell at seed 1 (its database under build/ransac/): the first
# ransac_chunk call and the first of fewer than RANSAC_TAIL_PAIRS pairs
RANSAC_DIR = Path(__file__).resolve().parent / "build" / "ransac"
RANSAC_CELL = "1dsfm-loop-800.mapper"
RANSAC_SEED = 1
RANSAC_TAIL_PAIRS = 100
# f32 operations of B8, counted from ransac.cu (an FMA counts 2, a square
# root, division, arccos or cosine 1): solving one hypothesis (its 8
# epipolar rows 72, Gram matrix 675, min_eigvec9 ~1,870, essential
# projection ~245), scoring one table slot (lines 16, C 16, denominator
# 7, the clamped quotient and the compare 5), and lifting one slot in a
# block (12)
RANSAC_SOLVE_OPS = 2860
RANSAC_SLOT_OPS = 44
RANSAC_LIFT_OPS = 12
# the derived case of phase 12: the tail tile cut to this cap
RANSAC_SHORT_CAP = 200
# B8 against the plain chain in f64 on the same f32 tables, beside the
# plain f32 chain against it. The 8-point solve in f32 is fragile: its
# shift of 1e-8 tr(AtA) is below the rounding of the Gram diagonal, and
# the loop's short baselines (1,920 pure rotations at seed 1) leave
# nullspaces of more than one dimension, which the rounding picks. Two
# f32 orders of the same arithmetic then give other best counts on most
# pairs: on an NVIDIA H100 80GB HBM3 (700 W) the plain chain's best
# counts equal the f64 chain's on 23.7% of the first tile's 8,192 pairs
# (76.0% of the tail's 79, 15.2% at cap 200), B8's on 23.1% (82.3%,
# 19.0%), and B8's equal the plain chain's on 35.1% (79.7%, 34.2%). The
# summed best counts of the plain chain stand 9.7% (3.7%, 77.5%) above
# the f64 chain's, B8's 9.4% (1.5%, 70.5%). The checks: B8 differs from
# the f64 chain on at most RANSAC_DIFFER_SLACK of the pairs more than the
# plain chain does (measured: 0.006 more, then fewer), and its sum lies
# at most RANSAC_SUM_SLACK of the f64 sum farther from it than the plain
# chain's (measured: nearer on all three). Measured bounds, not derived
# ones; both sides are deterministic.
RANSAC_DIFFER_SLACK = 0.02
RANSAC_SUM_SLACK = 0.02
# phase 10: the partitioned solvers on the sequential capture at its
# defaults (800 frames, 60,000 points, 3,000 keypoints an image, seed 1)
# with bench_e2e.py's 0.5 px, on 4 parts; BA 10 LM iterations with no early
# exit (function tolerance 0, as bench.py), GP with its defaults from the
# generator's rotations. Files under build/ (git-ignored).
PART_OPTIONS = dict(point2D_stddev=0.5)
PART_PARTS = 4
PART_BA_ITERS = 10
# GP's LM cap: runs that round in other orders must each stop on the
# function tolerance to be compared, and the default 100 can cut one short
# (on the card the three runs stopped after 98, 102 and 100 iterations; a
# 40-frame capture in f32 on the CPU after ~220, at 100 still 0.29-0.86
# from the generator's centers on a ring of radius 50, converged 0.0087)
PART_GP_ITERS = 1000
PART_DIR = Path(__file__).resolve().parent / "build" / "partitioned"
PART_WORLD_TIMEOUT = 600.0
# the runs' frame centers, Sim3-aligned, against the unpartitioned run's:
# within this share of the span of its centers (tests/test_parallel.py:215
# compares GP's unaligned in f64; in f32 converged runs part along GP's
# gauge of scale and translation, so the unaligned gap is reported beside)
PART_CENTER_SPAN = 1e-3
# partitioned BA's cost after PART_BA_ITERS LM iterations against the
# unpartitioned run's. The two differ only in the order of their sums (the
# points' order, a rank's stack, the all_reduce of the ranks' partials),
# which the CG and the LM steps carry on. A measured bound, not a derived
# one: on an NVIDIA H100 80GB HBM3 (700 W) one rank under NCCL gave the
# same f32 cost, two ranks under gloo 1.1e-7 relative; both sides are
# deterministic; the bound leaves 9x. Beside it, ba_cost_at_start holds
# the cost at the shared initial state within a bound derived from its
# order of operations (sum_depth_bound).
PART_BA_COST_RTOL = 1e-6
# phase 11: the multi-device mapper (files under build/mesh/). (a) `mapper
# --distributed` on phase 9's database; (b) stages 3-6 on phase 10's
# capture in MESH_PARTS parts on one NCCL rank, BA with the JAX package's
# dry-run budget (one round of MESH_BA_ITERS LM iterations), and the
# replicated-point BA on its result; (c) the sharded RA on phase 8's city
# graph (one NCCL rank) and component graph (two gloo ranks).
MESH_DIR = Path(__file__).resolve().parent / "build" / "mesh"
MESH_PARTS = 4
MESH_BA_ITERS = 20
MESH_SHARDED_BA_ITERS = 5
MESH_WORLD_TIMEOUT = 900.0
# (a) the models' image centers against the one-device model's, both
# Sim3-aligned to the generator's: each model is held to GP_CENTER_BOUND of
# the generator's centers (model_check), so by the triangle inequality two
# of them lie within twice that of each other (model_center_gap)
MESH_MODEL_CENTER_BOUND = 2 * GP_CENTER_BOUND
# (c) the sharded RA's rotations against the one-device solve's on the
# same graph. The two add in other orders (a rank's edges in part order,
# the all_reduce of the ranks' partials), and the component graph's sweeps
# are projected CG where the one-device solve's are dense. A measured
# bound, not a derived one: on an NVIDIA H100 80GB HBM3 (700 W) the city
# graph on one NCCL rank differed by 4.28e-5 rad, the component graph on
# two gloo ranks by 4.0e-7; both sides are deterministic. The bound
# leaves 11x.
MESH_RA_RAD = 5e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def load_bench(device, dtype=torch.float32) -> dict:
    """_solve_ba's keyword arguments for the committed bench problem."""
    return ba_inputs_from_arrays(dict(np.load(BENCH_CACHE)), None, device,
                                 dtype)


def solve(inputs: dict, iters: int):
    return _solve_ba(**inputs, max_iters=iters, **SETTINGS)


def bench_scene():
    """The bench problem as a Scene and Tracks: image f is frame f, and
    its keypoints are its observations in their order."""
    d = dict(np.load(BENCH_CACHE))
    of, op = d["o_frame"], d["o_point"]
    F, P, O = len(d["frame_quat"]), len(d["points"]), len(of)
    order = np.argsort(of, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(of, minlength=F))])
    f64 = {k: d[k].astype(np.float64) for k in (
        "cam_params", "sensor_quat", "sensor_trans", "frame_quat",
        "frame_trans", "points")}
    scene = Scene(
        camera_ids=np.array([1]),
        cam_model_id=np.array([cm.PINHOLE], np.int32),
        cam_params=f64["cam_params"], cam_kind=np.zeros(1, np.int32),
        sensor_quat=f64["sensor_quat"], sensor_trans=f64["sensor_trans"],
        sensor_is_ref=np.array([True]), frame_ids=np.arange(1, F + 1),
        frame_quat=f64["frame_quat"], frame_trans=f64["frame_trans"],
        frame_registered=np.ones(F, bool), image_ids=np.arange(1, F + 1),
        image_frame=np.arange(F, dtype=np.int32),
        image_camera=np.zeros(F, np.int32),
        image_sensor=np.zeros(F, np.int32),
        kp_xy=d["o_uv"][order].astype(np.float64), kp_offset=offsets)
    tracks = Tracks(
        xyz=f64["points"], valid=np.ones(P, bool),
        color=np.zeros((P, 3), np.uint8),
        obs_track=op[order].astype(np.int32),
        obs_image=of[order].astype(np.int32),
        obs_feature=(np.arange(O) - offsets[of[order]]).astype(np.int32),
        obs_valid=np.ones(O, bool))
    return scene, tracks


# ----------------------------------------------------------------------------
# phase 2: the kernels at the main path's inputs
# ----------------------------------------------------------------------------


def sampson_bound(E9, x1T, x2T):
    """(r, bound): the squared Sampson error in f64 of the f32 inputs, and
    the bound on the kernel's f32 rounding derived above."""
    u = 2.0 ** -24
    eps = kernels.SAMPSON_EPS
    E, x1, x2 = E9.double(), x1T.double(), x2T.double()
    z1, z2 = x1[2] + eps, x2[2] + eps
    a0, a1, b0, b1 = x1[0] / z1, x1[1] / z1, x2[0] / z2, x2[1] / z2

    def line(e0, e1, e2, p, q):
        return (e0 * p + e1 * q + e2,
                5 * u * ((e0 * p).abs() + (e1 * q).abs() + e2.abs()))
    Ex0, dEx0 = line(E[0], E[1], E[2], a0, a1)
    Ex1, dEx1 = line(E[3], E[4], E[5], a0, a1)
    Ex2, dEx2 = line(E[6], E[7], E[8], a0, a1)
    Et0, dEt0 = line(E[0], E[3], E[6], b0, b1)
    Et1, dEt1 = line(E[1], E[4], E[7], b0, b1)
    C = Ex0 * b0 + Ex1 * b1 + Ex2
    dC = b0.abs() * dEx0 + b1.abs() * dEx1 + dEx2 + 5 * u * (
        (Ex0 * b0).abs() + (Ex1 * b1).abs() + Ex2.abs())
    den = Ex0 * Ex0 + Ex1 * Ex1 + Et0 * Et0 + Et1 * Et1
    dden = sum(2 * L.abs() * dL + dL * dL for L, dL in (
        (Ex0, dEx0), (Ex1, dEx1), (Et0, dEt0), (Et1, dEt1))) + 4 * u * den
    D = torch.clamp(den, min=eps)
    D_lo = torch.clamp(den - dden, min=eps)
    r = C * C / D
    return r, (2 * C.abs() * dC + dC * dC) / D_lo + r * (dden / D_lo + 2 * u)


def _key(name, args):
    if name == "projection_resid_jac":
        return (name, args[7] is not None, args[0].shape[1])
    if name == "huber_irls":
        return (name, tuple(args[0].shape), args[1], args[2] is not None)
    axis = args[-1]
    if name == "pair_rowsum":
        return (name, id(axis), args[2])
    if name == "gather_dot":
        return (name, id(axis), args[0].shape[1], args[1].shape[0])
    return (name, id(axis), args[0].shape[0] if name == "rowsum"
            else args[0].shape[1])


def record_cases(run) -> dict:
    """Call run() with every kernel wrapper wrapped; returns
    {key: [args of the first call, number of calls]}."""
    cases = {}
    originals = {n: getattr(kernels, n) for n in REPLACES}

    def wrap(name, fn):
        def recorded(*args):
            if name == "projection_resid_jac" and len(args) == 7:
                args = args + (None,)  # the cost evaluation's call
            if name == "huber_irls" and len(args) == 2:
                args = args + (None,)  # no weight
            # each Sampson call is a case of its own: E on rays, F on
            # pixels, per chunk
            k = (name, sum(c[0] == name for c in cases)) \
                if name == "sampson_score" else _key(name, args)
            if k not in cases:
                copies = {}  # keeps U is V (a Gram) as one tensor
                cases[k] = [tuple(
                    copies.setdefault(id(a), a.clone())
                    if isinstance(a, torch.Tensor) else a
                    for a in args), 0]
            cases[k][1] += 1
            return fn(*args)
        return recorded
    try:
        for n, fn in originals.items():
            setattr(kernels, n, wrap(n, fn))
        run()
    finally:
        for n, fn in originals.items():
            setattr(kernels, n, fn)
    return cases


def _plain(name, args):
    if name == "projection_resid_jac":
        return kernels.projection_resid_jac_plain(*args)
    if name == "sampson_score":
        return kernels.sampson_score_plain(*args)
    if name == "huber_irls":
        return kernels.huber_irls_plain(*args)
    axis = args[-1]
    if name == "gather":
        return kernels.gather_plain(args[0], axis.ids)
    if name == "gather_dot":
        return kernels.gather_dot_plain(args[0], args[1], axis.ids)
    if name == "rowsum":
        return kernels.rowsum_plain(args[0], axis.ids, axis.n_seg)
    return kernels.pair_rowsum_plain(*args[:3], axis.ids, axis.n_seg)


def _library(name, args):
    """One PyTorch call computing the same function, or None; for B5 the
    pair index_select + einsum, timed together. For B4 on a one-segment
    axis (the camera axis), the Gram U @ V.T (f32, TF32 off), whose
    entries hold every output; on a many-segment axis no one call forms
    per-segment pair sums without the (R, O) product rows, so None."""
    if name in ("sampson_score", "huber_irls"):
        return None
    axis = args[-1]
    if name == "pair_rowsum":
        if axis.n_seg != 1:
            return None
        U, V = args[0], args[1]

        def call():
            return U @ V.T
        return call
    if name == "gather_dot":
        tab, U, ids = args[0], args[1], axis.ids
        k = tab.shape[1]
        U3 = U.view(U.shape[0] // k, k, U.shape[1])

        def call():
            return torch.einsum("rko,ko->ro", U3, tab.T.index_select(1, ids))
        return call
    if name == "gather":
        tab, ids = args[0], axis.ids

        def call():
            return tab.T.index_select(1, ids)
        return call
    if name == "rowsum":
        vals, ids = args[0], axis.ids
        out = torch.zeros((axis.n_seg, vals.shape[0]), dtype=vals.dtype,
                          device=vals.device)

        def call():
            return out.index_add_(0, ids, vals.T)
        return call
    return None


def _f64(args):
    return tuple(a.double() if isinstance(a, torch.Tensor)
                 and a.is_floating_point() else a for a in args)


def _sum_bound(name, args):
    """Per output, 2^-24 * depth * sum(|terms|): the first-order bound on
    the rounding of the kernel's f32 sum, plus that of the f64 reference.
    depth counts the roundings on one term's path in the kernels' order
    (the headers of rowsum.cu and pair_rowsum.cu), at the longest segment:
    a lane's chain over its observations of a chunk of L (one add each for
    B3; T fused multiply-adds each for B4, whose WG warp groups split a
    chunk by rows of 32), the 5 levels of the 32-lane butterfly, WG - 1
    adds of the group partials, and nc - 1 adds of the chunk partials."""
    axis = args[-1]
    x = _f64(args)
    if name == "rowsum":
        abs_sum = kernels.rowsum_plain(x[0].abs(), axis.ids, axis.n_seg)
        L, per_obs, groups = kernels.ROWSUM_CHUNK, 1, 1
    else:
        abs_sum = kernels.pair_rowsum_plain(x[0].abs(), x[1].abs(), x[2],
                                            axis.ids, axis.n_seg)
        n, m, per_obs = kernels.product_form(x[2], x[0].shape[0],
                                             x[1].shape[0])[:3]
        L, groups = kernels.PAIR_CHUNK, kernels.pair_tiles(n, m)[2]
    rows32 = -(-min(axis.longest, L) // 32)  # rows of 32 in a chunk
    chain = per_obs * -(-rows32 // groups)
    chunks = max(1, -(-axis.longest // L))
    depth = chain + 5 + (groups - 1) + (chunks - 1)
    return (2.0 ** -24 * depth + 2.0 ** -53 * axis.num_obs) * abs_sum


def _f32(v) -> float:
    return float(np.float32(v))


def huber_bounds(x, bx, delta, f32_constants=True):
    """(w, c, bound_w, bound_c) of Huber's weight and cost at the f64
    values x >= 0 whose f32 counterparts the kernel holds within bx (first
    order), with the kernel's f32 constants (delta, delta^2, 2 delta and
    the 1e-30 clamp as f32 values). The bound takes the kernel's own
    roundings at x (each at most u = 2^-24 relative: w = d / sqrt(x) the
    square root's and the division's, 2u |w|; c = 2d sqrt(x) - d^2 the
    square root's and the product's on 2d sqrt(x), and the difference's on
    |c|) and what x's error carries: over [x - bx, x + bx], c moves by at
    most max(1, 2d / (2 sqrt(x - bx))) bx and w by d / (2 (x - bx)^1.5) bx
    outside delta, plus the step of each output at the branch (the f32
    constants make it |2d sqrt(d^2) - 2 d^2| and |d / sqrt(d^2) - 1|)
    where the interval holds delta^2. Inside delta with margin both
    outputs are exact (1 and x). Not a tuned number. With f32_constants
    False the outputs take the f64 constants of an f64 solve."""
    u = 2.0 ** -24
    d, d2, two_d = (_f32(delta), _f32(delta * delta), _f32(2.0 * delta)) \
        if f32_constants else (delta, delta * delta, 2.0 * delta)
    rn = torch.sqrt(torch.clamp(x, min=_f32(1e-30)))
    inside = x <= d2
    zero = torch.zeros_like(x)
    w = torch.where(inside, torch.ones_like(x), d / rn)
    c = torch.where(inside, x, two_d * rn - d2)
    lo = torch.clamp(x - bx, min=_f32(1e-30))
    out_part = x + bx > d2  # some of the interval lies outside delta
    edge = (x - bx <= d2) & out_part
    lc = torch.where(out_part, torch.clamp(two_d / (2 * lo.sqrt()), min=1.0),
                     torch.ones_like(x))
    lw = torch.where(out_part, d / (2 * lo ** 1.5), zero)
    step_c = abs(two_d * math.sqrt(d2) - 2 * d2)
    step_w = abs(d / math.sqrt(d2) - 1.0)
    # plus the f64 reference's own few roundings
    bw = torch.where(inside, zero, (2 * u + 2.0 ** -50) * w) + lw * bx \
        + torch.where(edge, step_w, zero)
    bc = torch.where(inside, zero, (2 * u + 2.0 ** -50) * two_d * rn
                     + (u + 2.0 ** -50) * c.abs()) + lc * bx \
        + torch.where(edge, step_c, zero)
    return w, c, bw, bc


def huber_reference(r, delta, weight=None):
    """(w, c, bound_w, bound_c): B6's outputs in f64 of the f32 inputs
    and the first-order bound on the kernel's own roundings. The kernel
    adds the k squares in row order, each product and add rounded once:
    the sum of non-negative terms carries at most k u x (x = |r|^2, u =
    2^-24); Huber's step then as huber_bounds; the weight product adds
    u |o_w w| and u |o_w c|. Not a tuned number."""
    u = 2.0 ** -24
    k = r.shape[0]
    x = (r.double() ** 2).sum(0)
    w, c, bw, bc = huber_bounds(x, (k * u + 2.0 ** -50) * x, delta)
    if weight is not None:
        W = weight.double()
        w, c, bw, bc = (W * w, W * c, W * bw + (u + 2.0 ** -50) * (W * w).abs(),
                        W * bc + (u + 2.0 ** -50) * (W * c).abs())
    return w, c, bw, bc


def _dot_bound(args):
    """Per output of B5, 2^-24 * k * sum_j |U[r*k + j] tab[ids, j]|: the
    kernel sums its k products left to right from 0, each product and add
    rounded once, so the first product passes k roundings; plus the f64
    reference's own 2^-53 * k. Not a tuned number."""
    tab, U, axis = _f64(args)
    k = tab.shape[1]
    return (2.0 ** -24 + 2.0 ** -53) * k * kernels.gather_dot_plain(
        tab.abs(), U.abs(), axis.ids)


def _same_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _integer_args(name, args, gen):
    """The same shapes and axis, values small integers (exact f32 sums)."""
    lim = 8 if name == "rowsum" else 4

    def ints(t):
        return torch.randint(-lim, lim + 1, tuple(t.shape), generator=gen,
                             device="cpu").to(t.device, t.dtype)
    if name == "rowsum":
        return (ints(args[0]), args[1])
    return (ints(args[0]), ints(args[1]), args[2], args[3])


def check_case(name, args, gen) -> float:
    """Kernel (through its wrapper) vs the plain version in f64 on the
    same inputs; raises outside the stated tolerance. Returns the largest
    absolute difference."""
    got = getattr(kernels, name)(*args)
    if name == "huber_irls":
        plain = _plain(name, args)  # f32, on the card
        if not all(_same_bits(a, b) for a, b in zip(got, plain)):
            raise AssertionError(f"{name} {case_label(name, args)}: not bit "
                                 "for bit the plain f32 version")
        w, c, bw, bc = huber_reference(*args)
        err_w, err_c = (got[0].double() - w).abs(), (got[1].double() - c).abs()
        if bool((err_w > bw).any()) or bool((err_c > bc).any()):
            raise AssertionError(f"{name} {case_label(name, args)}: error "
                                 f"{float(err_w.max())}, "
                                 f"{float(err_c.max())} above the rounding "
                                 "bound")
        return max(float(err_w.max()), float(err_c.max()))
    if name == "gather_dot":
        err = (got.double() - _plain(name, _f64(args))).abs()
        if not bool(torch.isfinite(got).all()) \
                or bool((err > _dot_bound(args)).any()):
            raise AssertionError(f"{name} {case_label(name, args)}: error "
                                 f"{float(err.max())} above the rounding "
                                 "bound, or non-finite")
        return float(err.max())
    if name == "sampson_score":
        r, bound = sampson_bound(*args)
        err = (got.double() - r).abs()
        if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
            raise AssertionError(f"{name}: error {float(err.max())} above "
                                 "the rounding bound, or non-finite")
        return float(err.max())
    want = _plain(name, _f64(args))
    if name == "projection_resid_jac":
        (r, J), (r0, J0) = got, want
        if not (bool(torch.isfinite(r).all())
                and bool(torch.isfinite(J).all())):
            raise AssertionError(f"{name}: non-finite output")
        err_r = float((r.double() - r0).abs().max())
        err_J = (J.double() - J0).abs()
        bad_J = int((err_J > PROJ_J_RTOL * J0.abs().amax(
            dim=1, keepdim=True)).sum())
        if err_r > PROJ_R_ATOL or bad_J:
            raise AssertionError(f"{name}: residual error {err_r} px "
                                 f"(bound {PROJ_R_ATOL}), {bad_J} "
                                 "Jacobian entries outside the bound")
        return max(err_r, float(err_J.max()))
    if name == "gather":
        if not (_same_bits(got, _plain(name, args))
                and torch.equal(got.double(), want)):
            raise AssertionError(f"gather {case_label(name, args)}: not an "
                                 "exact copy")
        return 0.0
    err = (got.double() - want).abs()
    if bool((err > _sum_bound(name, args)).any()):
        raise AssertionError(f"{name} {case_label(name, args)}: error "
                             f"{float(err.max())} above the rounding bound")
    iargs = _integer_args(name, args, gen)
    if not torch.equal(getattr(kernels, name)(*iargs), _plain(name, iargs)):
        raise AssertionError(f"{name} {case_label(name, args)}: "
                             "integer-valued sums differ")
    return float(err.max())


def offset_invariance(cases, gen) -> int:
    """B4 at every recorded one-segment (camera) input, and B3 on the same
    axis and rows (U), alone and with a dummy segment of DUMMY_OBS
    observations in front: the camera's outputs must not change by a bit.
    Returns the number of inputs checked."""
    checked = 0
    for (name, *_), (args, _) in cases.items():
        if name != "pair_rowsum" or args[-1].n_seg != 1:
            continue
        U, V, pairs, axis = args
        dev = U.device
        shifted = kernels.SegmentAxis.build(torch.cat([
            torch.zeros(DUMMY_OBS, dtype=torch.int32, device=dev),
            axis.ids + 1]), 2)

        def front(t):
            return torch.cat([torch.randn((t.shape[0], DUMMY_OBS),
                                          generator=gen).to(dev), t],
                             dim=1).contiguous()
        U2 = front(U)
        V2 = U2 if V is U else front(V)
        for alone, behind in (
                (kernels.pair_rowsum(U, V, pairs, axis),
                 kernels.pair_rowsum(U2, V2, pairs, shifted)),
                (kernels.rowsum(U, axis), kernels.rowsum(U2, shifted))):
            if not torch.equal(alone.view(torch.int32),
                               behind[1:].view(torch.int32)):
                raise AssertionError(
                    f"{case_label(name, args)}: the camera segment's sums "
                    "change behind a dummy segment")
        checked += 1
    if not checked:
        raise AssertionError("no one-segment pair_rowsum input recorded")
    return checked


def gather_extra_cases(cases, gen) -> list:
    """B2's own inputs beside the main path's: BA's frame-sensor (staged
    whole, k 24) and point (read in place, k 3) gathers cut to every other
    O % 4, so that the output rows start off a 16-byte boundary, and a
    table of 4,950 rows of 53 columns (1 MB, more than a block's shared
    memory holds) read in place through 1,000,001 unsorted ids."""
    extra = []
    for (name, *_), (args, _) in cases.items():
        tab, axis = args if name == "gather" else (None, None)
        if tab is None or tab.shape[1] not in (24, 3) or axis.n_seg == 1:
            continue
        for cut in (1, 2, 3):
            extra.append((tab, kernels.SegmentAxis.build(
                axis.ids[:axis.num_obs - cut], axis.n_seg)))
    dev = extra[0][0].device
    T = 4950
    ids = torch.randint(0, T, (1_000_001,), generator=gen).to(dev)
    extra.append((torch.randn((T, 53), generator=gen).to(dev),
                  kernels.SegmentAxis.build(ids, T)))
    return extra


def projection_kinds_rig_args(args, gen):
    """The main path's projection inputs with every camera kind, full
    distortion and the rig columns (zdim 31): off the bench's path, but
    the kernel's other branches at the same size."""
    M, S, b, X, uv, k16, kind, _ = args
    O = M.shape[1]

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(M.device)
    k16 = k16.clone()
    k16[4:8] = 0.05 * rnd(4, O)
    k16[11:15] = 0.001 * rnd(4, O)
    k16[15] = 0.9
    kind = torch.randint(0, 3, (1, O), generator=gen).to(M.device, M.dtype)
    return (M, S, b, X, uv, k16.contiguous(), kind, 0.1 * rnd(3, O))


def case_work(name, args):
    """(bytes, operations) the function needs: each input read once, each
    output written once, and the operations on these inputs."""
    f = 4  # f32 and int32
    if name == "sampson_score":
        M = args[0].shape[1]
        return f * 16 * M, SAMPSON_OPS * M
    if name == "huber_irls":
        (k, O), weighted = args[0].shape, args[2] is not None
        return (f * (k + weighted + 2) * O,
                (2 * k - 1 + HUBER_OPS + 2 * weighted) * O)
    if name == "projection_resid_jac":
        O = args[0].shape[1]
        zdim = 25 if args[7] is None else 31
        rows_in = 9 + 9 + 3 + 3 + 2 + 16 + 1 + (3 if zdim == 31 else 0)
        return f * O * (rows_in + 2 + 2 * zdim), PROJ_OPS[zdim] * O
    axis = args[-1]
    O, n_seg = axis.num_obs, axis.n_seg
    index_bytes = f * (O + n_seg + 1)
    if name == "gather":
        T, k = args[0].shape
        return f * (T * k + k * O + O), 0
    if name == "gather_dot":
        (T, k), rows = args[0].shape, args[1].shape[0]
        return f * (T * k + rows * O + O + rows // k * O), 2 * rows * O
    if name == "rowsum":
        k = args[0].shape[0]
        return f * k * O + index_bytes + f * n_seg * k, k * O
    U, V, pairs = args[0], args[1], args[2]
    rows = U.shape[0] + (0 if V.data_ptr() == U.data_ptr() else V.shape[0])
    terms = sum(len(t) for t in pairs)
    return f * rows * O + index_bytes + f * n_seg * len(pairs), 2 * terms * O


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call of fn, from a CUDA graph of `reps` calls."""
    fn()  # caches (term tables) and lazy state outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        g.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def case_label(name, args):
    if name == "sampson_score":
        return f"M={args[0].shape[1]}"
    if name == "huber_irls":
        return (f"k={args[0].shape[0]} O={args[0].shape[1]} "
                f"delta={args[1]} weight={args[2] is not None}")
    if name == "projection_resid_jac":
        return f"zdim={25 if args[7] is None else 31} O={args[0].shape[1]}"
    axis = args[-1]
    if name == "pair_rowsum":
        return (f"n_seg={axis.n_seg} R={len(args[2])} "
                f"terms={sum(len(t) for t in args[2])} O={axis.num_obs}")
    if name == "gather_dot":
        k = args[0].shape[1]
        return (f"n_seg={axis.n_seg} k={k} nr={args[1].shape[0] // k} "
                f"O={axis.num_obs}")
    k = args[0].shape[0] if name == "rowsum" else args[0].shape[1]
    return f"n_seg={axis.n_seg} k={k} O={axis.num_obs}"


def measure_case(name, args, gen, peak_bw, peak_flops, on_path=True):
    err = check_case(name, args, gen)
    saved = dict(kernels.LAUNCHES)  # timing launches are not the path's
    ms = graph_ms(lambda: getattr(kernels, name)(*args))
    kernels.LAUNCHES.update(saved)
    plain_ms = graph_ms(lambda: _plain(name, args))
    lib = _library(name, args)
    nbytes, ops = case_work(name, args)
    t_bytes, t_ops = nbytes / peak_bw * 1e3, ops / peak_flops * 1e3
    return dict(name=name, shape=case_label(name, args), on_path=on_path,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=None if lib is None else graph_ms(lib),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, operations=ops)


def _path_summary(cases, calls, launches):
    """A kernel's per-launch numbers on one path, averaged over the path's
    shapes weighted by their calls in the recorded run; the launches
    alone where no input of the path was recorded."""
    on = [(c, calls[i]) for i, c in enumerate(cases) if c["on_path"]]
    n = sum(w for _, w in on)
    if not n:
        return dict(launches=launches)

    def mean(k):
        if any(c[k] is None for c, _ in on):
            return None
        return sum(c[k] * w for c, w in on) / n
    out = dict(launches=launches, ms=mean("ms"), plain_ms=mean("plain_ms"),
               bound_ms=mean("bound_ms"), library_ms=mean("library_ms"),
               bound_by="bytes" if all(c["bound_by"] == "bytes"
                                       for c, _ in on) else "operations")
    lib = [(c, w) for c, w in on if c["library_ms"] is not None]
    if lib and len(lib) < len(on):
        # B4: a library call only on its one-segment (camera) inputs, so
        # the kernel's time there beside it
        nl = sum(w for _, w in lib)
        out["where_library"] = {
            "share_of_calls": nl / n,
            "ms": sum(c["ms"] * w for c, w in lib) / nl,
            "library_ms": sum(c["library_ms"] * w for c, w in lib) / nl}
    return out


def kernel_summary(name, paths):
    """One entry per kernel. paths: {path: (cases, calls per recorded run,
    launches in the path's counted run)}. `launches` sums every path's;
    the other top-level numbers are the timed paths' means weighted by
    their launches; each path's own are under "paths"."""
    per = {p: _path_summary(*v) for p, v in paths.items()}
    total = sum(v["launches"] for v in per.values())
    timed = [v for v in per.values() if "ms" in v]
    weight = sum(v["launches"] for v in timed)

    def mean(k):
        if any(v[k] is None for v in timed):
            return None
        return sum(v[k] * v["launches"] for v in timed) / weight
    source, replaces = REPLACES[name]
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=total,
                max_abs_err=max((c["max_abs_err"] for v in paths.values()
                                 for c in v[0]), default=None),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"),
                bound_by="bytes" if all(v["bound_by"] == "bytes"
                                        for v in timed)
                else "operations",
                library_ms=mean("library_ms"), paths=per,
                cases={p: v[0] for p, v in paths.items()})


# ----------------------------------------------------------------------------
# phase 4 helpers
# ----------------------------------------------------------------------------


def run_sweep(scene, vg, device, lift=True):
    """(view graph with the results, scores, seconds, seconds of the lift)
    of undistort_images (unless lift is False) and
    image_pairs_inlier_count in f32 on a copy of vg."""
    out = vg.copy()
    cuda = device.type == "cuda"

    def now():
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter()
    t0 = now()
    if lift:
        undistort_images(scene, device=device)
    t1 = now()
    score = pair_inliers.image_pairs_inlier_count(scene, out, device=device)
    t2 = now()
    return out, score, t2 - t0, t1 - t0


def same_sweep(a, b) -> bool:
    return (np.array_equal(a[0].match_inlier, b[0].match_inlier)
            and np.array_equal(a[0].pair_num_inliers, b[0].pair_num_inliers)
            and np.array_equal(a[1], b[1]))


def sweep_disagreements(card, cpu, cases, opts: InlierThresholds) -> dict:
    """Matches that the card and the CPU's plain f32 path classify
    differently. Raises unless the pair counts differ by exactly those
    matches and each one is an E or F match whose f64 Sampson error lies
    within B7's rounding bound of its threshold. `cases` are the recorded
    kernel inputs of a one-chunk card run."""
    vg = card[0]
    step = card[0].match_inlier.astype(np.int64) - cpu[0].match_inlier
    per_pair = np.bincount(vg.match_pair, weights=step,
                           minlength=vg.num_pairs).astype(np.int64)
    if not np.array_equal(card[0].pair_num_inliers
                          - cpu[0].pair_num_inliers, per_pair):
        raise AssertionError("sweep: pair counts differ beyond the matches "
                             "classified differently")
    diff = np.flatnonzero(step)
    out = {"matches": int(len(diff)),
           "pairs": int(len(np.unique(vg.match_pair[diff]))),
           "score_max_rel_diff": float(np.max(
               np.abs(card[1] - cpu[1]) / np.maximum(np.abs(cpu[1]), 1e-30)))}
    if not len(diff):
        return out
    tab = next(a[0] for (n, *_), (a, _) in cases.items()
               if n == "gather" and a[0].shape[1] == 53)
    E_args = cases[("sampson_score", 0)][0]
    F_args = cases[("sampson_score", 1)][0]
    pair = vg.match_pair[diff]
    cfg = vg.pair_config[pair]
    worst = 0.0
    for kind, args in ((vgm.CONFIG_CALIBRATED, E_args),
                       (vgm.CONFIG_UNCALIBRATED, F_args)):
        sel = cfg == kind
        if not sel.any():
            continue
        idx = torch.from_numpy(diff[sel]).to(tab.device)
        r, bound = sampson_bound(*(a[:, idx] for a in args))
        thr = tab[torch.from_numpy(pair[sel].astype(np.int64)).to(
            tab.device), 48].double() if kind == vgm.CONFIG_CALIBRATED \
            else torch.full_like(r, opts.max_epipolar_error_F ** 2)
        margin = (r - thr).abs() / bound
        worst = max(worst, float(margin.max()))
        if bool((margin > 1.0).any()):
            raise AssertionError(f"sweep: a config-{kind} match differs "
                                 "outside B7's bound of its threshold")
    if not np.isin(cfg, (vgm.CONFIG_CALIBRATED,
                         vgm.CONFIG_UNCALIBRATED)).all():
        raise AssertionError("sweep: an H or unscored match differs")
    out["max_threshold_distance_over_bound"] = worst
    return out


# ----------------------------------------------------------------------------
# phase 3 helpers
# ----------------------------------------------------------------------------


def _params(out):
    fq, ft, cp, X = out[0:4]
    return {"frame_quat": fq, "frame_trans": ft, "cam_params": cp,
            "points": X}


def compare_runs(a, b, what: str) -> dict:
    """Cost and parameters of two _solve_ba results; raises outside the
    slice tolerances. Returns the largest differences."""
    if a[5] != b[5]:
        raise AssertionError(f"{what}: {a[5]} vs {b[5]} LM iterations")
    ca, cb = float(a[4]), float(b[4])
    rel_cost = abs(ca - cb) / abs(cb)
    if rel_cost > SLICE_COST_RTOL:
        raise AssertionError(f"{what}: cost {ca} vs {cb}")
    diffs = {"cost_rel": rel_cost}
    pa, pb = _params(a), _params(b)
    for k in pa:
        x, y = pa[k].double().cpu(), pb[k].double().cpu()
        d = float((x - y).abs().max())
        scale = float(y.abs().max())
        diffs[k] = d
        if d > SLICE_PARAM_RTOL * scale:
            raise AssertionError(f"{what}: {k} differs by {d} "
                                 f"(scale {scale})")
    return diffs


# ----------------------------------------------------------------------------
# phase 5: stages 4-6 (track establishment, global positioning, iterated
# bundle adjustment) through the controller's stage code
# (glomap_tpu_torch/controllers/global_mapper.py), default options
# ----------------------------------------------------------------------------


def stage_4(scene, vg, device):
    """Track establishment and selection: (tracks, report)."""
    mapper = GlobalMapper(device=device)
    tracks = mapper.establish_tracks(scene, vg)
    return tracks, mapper.reports["track establishment"]


def stage_5(scene, vg, tracks, device, dtype=torch.float32) -> dict:
    """Global positioning and its filters, normalization and rescue."""
    mapper = GlobalMapper(device=device, dtype=dtype)
    if not mapper.global_positioning(scene, vg, tracks):
        raise AssertionError("stage 5: global positioning failed")
    return mapper.reports["global positioning"]


def stage_6(scene, tracks, device, dtype=torch.float32) -> dict:
    """Iterated BA (position-only, then full) with normalization, the ray
    refresh and the progressive reprojection filter with its early exit
    (under 0.1% of the tracks filtered); then the final filters and the
    deregistration."""
    mapper = GlobalMapper(device=device, dtype=dtype)
    if not mapper.bundle_adjustment(scene, tracks):
        raise AssertionError("stage 6: bundle adjustment failed")
    report = mapper.reports["bundle adjustment"]
    report["final_removed"]["deregistered_frames"] = deregister_unsupported(
        scene, tracks)
    return report


def center_errors(scene, gt_centers) -> np.ndarray:
    """Distances of the registered frames' centers, Sim3-aligned by
    umeyama_alignment, to their ground truth."""
    reg = scene.frame_registered
    return aligned_center_errors(scene.frame_centers()[reg], gt_centers[reg])


def _state(scene, tracks):
    return (scene.frame_trans, scene.frame_registered, scene.cam_params,
            tracks.xyz, tracks.valid, tracks.obs_valid)


def capture_gp_args(run) -> tuple:
    """run() with _solve_gp wrapped; the positional arguments of its first
    call."""
    captured = []
    original = gpm._solve_gp

    def recorded(*args):
        if not captured:
            captured.append(args)
        return original(*args)
    gpm._solve_gp = recorded
    try:
        run()
    finally:
        gpm._solve_gp = original
    return captured[0]


def torch_sum_depth(n: int) -> int:
    """The height of the tree in which torch.sum adds n contiguous f32
    values on the card (ATen/native/cuda/Reduce.cuh): vectors of 4 go to
    4 accumulators a thread, a chain of at most ceil(n / 2048) adds with
    the 512 threads of a block, plus an unaligned head and tail (2; a split
    of the input over blocks only shortens the chain); then the 4
    accumulators are added (3) and the block's threads reduced in a tree
    (9); where blocks share the input, one block adds their partials (at
    most ceil(n / 131072) serial adds a thread and another tree of 9)."""
    return -(-n // 2048) + 2 + 3 + 9 + -(-n // 131072) + 9


def gp_cost_bound(args, f32_constants=True) -> tuple:
    """(cost, bound): GP's cost at its initial state (cost_of at c0, X0 of
    _solve_gp's arguments) in f64 of the f32 arguments, and the first-order
    bound on the f32 evaluation on the card, from the order of its
    operations (u = 2^-24 per rounding):
      d = (X[p] - c[f]) + u_rig        u |X - c| + u |d| a component
      dn2 = sum d^2, num = sum t d     three terms in any order: 3u of the
                                       sum of |terms|, plus d's error
      s = max(num / dn2, 1e-5)         the division's u |s| and what the
                                       errors of num and dn2 carry
      r = t - s d                      |d| ds + s dd + u |s d| + u |r|
      x = |r|^2                        B6's order, 3u x, plus 2 |r| dr
    then Huber's step (huber_bounds) and the weight product u |o_w c|
    per observation; the same for camera edges (d = c[j] - c[i]); then
    torch.sum of each family's weighted costs, torch_sum_depth(n) u of
    their sum, and the add of the two families. Not a tuned number. With
    f32_constants False, the cost is the f64 solve's (its Huber constants
    in f64)."""
    u = 2.0 ** -24
    c0, X0, of, op, tT, uT, ow, ci, cj, tcc, cw = (
        a.detach().cpu().double() if a.is_floating_point()
        else a.detach().cpu().long() for a in args[:11])
    delta = args[13]
    families = []
    if of.numel():
        a = X0[op].T - c0[of].T
        d = a + uT
        families.append((d, u * (a.abs() + d.abs()), tT, ow))
    if ci.numel():
        d = c0[cj].T - c0[ci].T
        families.append((d, u * d.abs(), tcc, cw))
    total, bound = 0.0, 0.0
    for d, e_d, t, wgt in families:
        raw = (d * d).sum(0)
        dn2 = torch.clamp(raw, min=1e-12)
        e_dn2 = (2 * d.abs() * e_d).sum(0) + 3 * u * raw
        num = (t * d).sum(0)
        e_num = (t.abs() * e_d).sum(0) + 3 * u * (t * d).abs().sum(0)
        q = num / dn2
        e_q = e_num / dn2 + num.abs() * e_dn2 / dn2 ** 2 + u * q.abs()
        s = torch.clamp(q, min=1e-5)
        r = t - s * d
        e_r = d.abs() * e_q + s * e_d + u * (s * d).abs() + u * r.abs()
        x = (r * r).sum(0)
        e_x = (2 * r.abs() * e_r).sum(0) + (3 * u + 2.0 ** -50) * x
        _, c, _, bc = huber_bounds(x, e_x, delta, f32_constants)
        h = wgt * c
        bh = wgt * bc + (u + 2.0 ** -50) * h.abs()
        n = h.numel()
        total += float(h.sum())
        bound += float(bh.sum()) + (torch_sum_depth(n) * u
                                    + n * 2.0 ** -53) * float((h.abs()
                                                               + bh).sum())
    if len(families) == 2:
        bound += u * abs(total)
    return total, bound


def gp_cost_at_start(args) -> dict:
    """GP's cost at the shared initial state (_solve_gp with no LM
    iteration: the cost evaluation alone, no CG) on the card (f32), against
    its evaluation on the CPU in f64 from the same f32 arguments with the
    card's f32 Huber constants, within gp_cost_bound's derived bound. That
    evaluation must be the port's own f64 cost_of where the constants are
    f64 too (to 1e-12); the CPU's plain f32 path is reported beside."""
    def start(a):
        return float(gpm._solve_gp(*a[:14], 0.0, 0, *a[16:])[2])

    def on_cpu(dtype):
        return tuple(x.cpu().to(dtype) if isinstance(x, torch.Tensor)
                     and x.is_floating_point() else
                     x.cpu() if isinstance(x, torch.Tensor) else x
                     for x in args)
    card, cpu32, cpu64 = (start(args), start(on_cpu(torch.float32)),
                          start(on_cpu(torch.float64)))
    ref, bound = gp_cost_bound(args)
    replica = gp_cost_bound(args, f32_constants=False)[0]
    if not abs(cpu64 - replica) <= 1e-12 * abs(cpu64):
        raise AssertionError(f"GP cost at start: the bound's evaluation "
                             f"{replica} is not _solve_gp's f64 {cpu64}")
    gap = abs(card - ref)
    if not gap <= bound:
        raise AssertionError(f"GP cost at start: card {card} vs f64 {ref}, "
                             f"gap {gap} above the derived bound {bound}")
    return {"card": card, "f64": ref, "cpu_f32": cpu32,
            "card_vs_f64_rel": gap / abs(ref), "bound_rel": bound / abs(ref),
            "cpu_f32_vs_f64_rel": abs(cpu32 - ref) / abs(ref)}


def gp_card_vs_cpu(args) -> dict:
    """CPU_ITERS LM iterations of _solve_gp, no early exit, on the card and
    on the CPU's plain path (f32) from the same arguments."""
    def three(a):
        return gpm._solve_gp(*a[:14], 0.0, CPU_ITERS, *a[16:])
    card = three(args)
    cpu = three(tuple(x.cpu() if isinstance(x, torch.Tensor) else x
                      for x in args))
    if not card[3] == cpu[3] == CPU_ITERS:
        raise AssertionError(f"GP: {card[3]} vs {cpu[3]} LM iterations")
    cost_card, cost_cpu = float(card[2]), float(cpu[2])
    rel = abs(cost_card - cost_cpu) / abs(cost_cpu)
    if not rel <= GP_COST_RTOL:
        raise AssertionError(f"GP card vs CPU: cost {cost_card} vs "
                             f"{cost_cpu}")
    out = {"cost_rel": rel, "cg_iters": [card[6], cpu[6]]}
    for name, i in (("centers", 0), ("points", 1)):
        x, y = card[i].double().cpu(), cpu[i].double()
        out[f"{name}_max_diff_over_scale"] = float(
            (x - y).abs().max() / y.abs().max())
    return out


def stages_phase(scene, vg, dev, gen, peak_bw, peak_flops):
    """Phase 5 on phase 4's filtered scene: (report, {kernel: (cases,
    calls)} per path, launches per stage, (scene, tracks) after stage 6,
    the generator's frame centers)."""
    gt_centers = scene.frame_centers()  # the generator's poses
    tracks, s4 = stage_4(scene, vg, dev)
    print(f"# stage 4: {s4['tracks']} tracks of {s4['tracks_full']}, "
          f"{s4['observations']} observations in {s4['seconds']:.2f} s",
          file=sys.stderr)
    # every kernel input of one GP LM iteration; _solve_gp's arguments
    gp_args = None

    def gp_one():
        nonlocal gp_args
        gp_args = capture_gp_args(lambda: gpm.solve_global_positioning(
            scene.copy(), vg, tracks.copy(),
            GlobalPositionerOptions(max_num_iterations=1), device=dev))
    gp_cases = record_cases(gp_one)
    card_vs_cpu = gp_card_vs_cpu(gp_args)
    at_start = gp_cost_at_start(gp_args)
    del gp_args

    # stage 5 twice from the same state, counted; then stage 6
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for _ in range(2):
        sc, tr = scene.copy(), tracks.copy()
        kernels.reset_launch_counts()
        rep5 = stage_5(sc, vg, tr, dev)
        runs.append((sc, tr, rep5, dict(kernels.LAUNCHES)))
    (sc, tr, rep5, gp_launches), other = runs[0], runs[1]
    if not all(np.array_equal(a, b) for a, b in zip(
            _state(sc, tr), _state(other[0], other[1]))):
        raise AssertionError("stage 5: two runs on the card differ")
    del runs, other
    if not all(gp_launches[COUNTER.get(n, n)] > 0 for n in GP_KERNELS):
        raise AssertionError(f"stage 5: a kernel was not launched: "
                             f"{gp_launches}")
    err5 = center_errors(sc, gt_centers)
    # every kernel input of one BA LM iteration from stage 5's result
    ba_cases = record_cases(lambda: solve_bundle_adjustment(
        sc.copy(), tr.copy(), BundleAdjusterOptions(
            optimize_rotations=False, max_num_iterations=1), device=dev))
    offset_checked = offset_invariance(ba_cases, gen)
    kernels.reset_launch_counts()
    rep6 = stage_6(sc, tr, dev)
    ba_launches = dict(kernels.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    if not all(ba_launches[COUNTER.get(n, n)] > 0 for n in BA_KERNELS):
        raise AssertionError(f"stage 6: a kernel was not launched: "
                             f"{ba_launches}")
    err6 = center_errors(sc, gt_centers)
    if not (err5.max() < GP_CENTER_BOUND and err6.max() < GP_CENTER_BOUND
            and err6.max() <= err5.max()):
        raise AssertionError(f"stages 5-6: center errors {err5.max()} "
                             f"(GP), {err6.max()} (BA), bound "
                             f"{GP_CENTER_BOUND}")
    valid_obs = int((tr.obs_valid & tr.valid[tr.obs_track]).sum())
    if not valid_obs or not np.isfinite(tr.xyz[tr.valid]).all():
        raise AssertionError("stage 6: no valid observation, or non-finite "
                             "points")

    per_path = {}
    for path, cases, names in (("stage5_gp", gp_cases, GP_KERNELS),
                               ("stage6_ba", ba_cases, BA_KERNELS)):
        per_path[path] = {n: ([], []) for n in names}
        for (name, *_), (args, calls) in cases.items():
            res = measure_case(name, args, gen, peak_bw, peak_flops)
            per_path[path][name][0].append(res)
            per_path[path][name][1].append(calls)
    gp = rep5["gp"]
    ba_lm = sum(b["lm_iters"] for b in rep6["ba"])
    ba_s = sum(b["seconds"] for b in rep6["ba"])
    report = {
        "problem": (f"phase 4's scene after its filters: "
                    f"{scene.num_frames} frames, {vg.num_matches} matches, "
                    f"f32"),
        "stage4": s4, "stage5_seconds": rep5["seconds"],
        "stage6_seconds": rep6["seconds"],
        "gp": {**gp, "lm_iters_per_s": gp["lm_iters"] / gp["seconds"]},
        "stage5_removed": rep5["removed"],
        "ba_calls": len(rep6["ba"]), "ba_lm_iters": ba_lm,
        "ba_lm_iters_per_s": ba_lm / ba_s, "ba": rep6["ba"],
        "stage6_progressive_obs_removed": rep6["progressive_obs_removed"],
        "stage6_final_removed": rep6["final_removed"],
        "valid_observations": valid_obs,
        "registered_frames": int(sc.frame_registered.sum()),
        "center_error_gp": {"max": float(err5.max()),
                            "median": float(np.median(err5))},
        "center_error_ba": {"max": float(err6.max()),
                            "median": float(np.median(err6))},
        "center_bound": GP_CENTER_BOUND,
        "gp_card_vs_cpu_f32_after_3": card_vs_cpu,
        "gp_cost_at_start": at_start,
        "stage5_bitwise_reproducible": True,
        "camera_segment_offset_invariant_cases": offset_checked,
        "peak_device_bytes": peak_bytes,
        "launches_stage5": gp_launches, "launches_stage6": ba_launches}
    return report, per_path, {"stage5_gp": gp_launches,
                              "stage6_ba": ba_launches}, (sc, tr), gt_centers



# ----------------------------------------------------------------------------
# phase 6: mapper_resume as a user runs it, through the port's CLI
# ----------------------------------------------------------------------------


def same_model(a, b) -> bool:
    """Two (cameras, images, points) model dicts hold the same ids and
    the same values, bit for bit."""
    def same(x, y):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return (np.asarray(x).dtype == np.asarray(y).dtype
                    and np.array_equal(x, y))
        return type(x) is type(y) and x == y
    return all(da.keys() == db.keys() and all(
        len(da[k]) == len(db[k]) and all(map(same, da[k], db[k]))
        for k in da) for da, db in zip(a, b))


def model_bytes(path) -> dict:
    return {n: (Path(path) / n).read_bytes() for n in MODEL_FILES}


def model_counts(model) -> dict:
    _, images, points = model
    return {"images": len(images), "points": len(points),
            "observations": sum(len(p[3]) for p in points.values())}


def capture_mapper(run):
    """run() with GlobalMapper.solve wrapped: (run's result, the mapper
    that solved)."""
    seen = []
    original = GlobalMapper.solve

    def recorded(self, *args, **kwargs):
        seen.append(self)
        return original(self, *args, **kwargs)
    GlobalMapper.solve = recorded
    try:
        out = run()
    finally:
        GlobalMapper.solve = original
    return out, seen[-1]


def model_center_errors(model, names_gt: dict) -> np.ndarray:
    """Distances of a model's image centers, Sim3-aligned by
    umeyama_alignment, to the generator's centers of the same image
    names."""
    images = model[1].values()
    q = torch.from_numpy(np.stack([im[0] for im in images]))
    t = torch.from_numpy(np.stack([im[1] for im in images]))
    est = pose_center(q, t).numpy()
    gt = np.stack([names_gt[im[3]] for im in images])
    s, R, tr = umeyama_alignment(est, gt)
    return np.linalg.norm(apply_sim3(s, R, tr, est) - gt, axis=-1)


def mapper_resume_phase(scene, tracks, gt_centers, dev, card):
    """Phase 6: (report, the kernel inputs of the first run's GP and BA,
    its launches). Stage 6's result is written as a binary COLMAP model,
    read back, and run through `cli.main(["mapper_resume", ...])` on the
    card four times: counted (and its kernel inputs recorded), again (the
    same bytes), with --checkpoint_dir (the same bytes), and resumed from
    that run's stage_05.npz with the later checkpoints deleted (the same
    bytes). Every run prunes (--skip_pruning 0), so stage 8 runs too."""
    root = MAPPER_RESUME_DIR
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    written = write_reconstruction(str(root / "input"), scene, tracks)
    write_s = time.perf_counter() - t0
    if len(written) != 1:
        raise AssertionError(f"mapper_resume: input in {len(written)} "
                             "clusters")
    t0 = time.perf_counter()
    model_in = read_model(written[0])
    read_s = time.perf_counter() - t0
    cameras, images, points = scene_to_model(scene, tracks)
    if not same_model(model_in, (cameras, images, points.to_dict())):
        raise AssertionError("mapper_resume: the model read back differs "
                             "from scene_to_model's")
    ckpt = root / "checkpoints"

    def run(name, *extra):
        out = root / name
        t0 = time.perf_counter()
        rc, mapper = capture_mapper(lambda: cli.main(
            ["mapper_resume", "--input_path", written[0], "--output_path",
             str(out), "--skip_pruning", "0", *extra]))
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"mapper_resume ({name}) returned {rc}")
        return {"model": out / "0", "seconds": seconds,
                "stages": dict(mapper.timer.stages),
                "reports": mapper.reports}

    kernels.reset_launch_counts()
    runs = {}
    cases = record_cases(lambda: runs.update(first=run("first")))
    launches = dict(kernels.LAUNCHES)
    if not all(launches[COUNTER.get(n, n)] > 0 for n in BA_KERNELS):
        raise AssertionError(f"mapper_resume: a kernel was not launched: "
                             f"{launches}")
    runs["second"] = run("second")
    runs["checkpointed"] = run("checkpointed", "--checkpoint_dir", str(ckpt))
    for path in ckpt.glob("stage_*.npz"):
        if int(path.stem[len("stage_"):]) > 5:
            path.unlink()
    runs["resumed"] = run("resumed", "--checkpoint_dir", str(ckpt))
    if "global positioning" in runs["resumed"]["stages"]:
        raise AssertionError("mapper_resume: the resumed run ran stage 5")
    first = model_bytes(runs["first"]["model"])
    for name in ("second", "checkpointed", "resumed"):
        if model_bytes(runs[name]["model"]) != first:
            raise AssertionError(f"mapper_resume: the {name} run wrote "
                                 "other bytes than the first")

    model_out = read_model(str(runs["first"]["model"]))
    if model_out[1].keys() != model_in[1].keys():
        raise AssertionError("mapper_resume: images lost their "
                             "registration")
    xyz = np.stack([p[0] for p in model_out[2].values()])
    if not np.isfinite(xyz).all():
        raise AssertionError("mapper_resume: non-finite points")
    names_gt = {n: gt_centers[scene.image_frame[k]]
                for k, n in enumerate(scene.image_names)}
    err = model_center_errors(model_out, names_gt)
    if not err.max() < GP_CENTER_BOUND:
        raise AssertionError(f"mapper_resume: center error {err.max()} "
                             f"above {GP_CENTER_BOUND}")
    report = {
        "problem": (f"stage 6's result on the stage scene as a binary "
                    f"COLMAP model: {model_counts(model_in)}"),
        "write_input_s": write_s, "read_input_s": read_s,
        "runs": {n: {"seconds": r["seconds"], "stages_s": r["stages"]}
                 for n, r in runs.items()},
        "first_run_records_kernel_inputs": True,
        "gp": runs["second"]["reports"]["global positioning"]["gp"],
        "ba": runs["second"]["reports"]["bundle adjustment"]["ba"],
        "in": model_counts(model_in), "out": model_counts(model_out),
        "center_error": {"max": float(err.max()),
                         "median": float(np.median(err))},
        "center_bound": GP_CENTER_BOUND, "launches": launches,
        "byte_identical": ["second", "checkpointed", "resumed"],
        "resumed_from": "stage_05.npz", "card": card}
    return report, cases, launches

# ----------------------------------------------------------------------------
# phase 7: stage 7 (retriangulation) on the stage scene after stage 6
# ----------------------------------------------------------------------------


def _track_names(scene, tracks):
    """(name (T,), keys): each track named by the smallest keypoint of its
    valid observations (track ids renumber freely between two runs), and
    the sorted (name, keypoint) keys of the valid observations."""
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
    kp = (scene.kp_offset[tracks.obs_image[ok]]
          + tracks.obs_feature[ok]).astype(np.int64)
    tr = tracks.obs_track[ok]
    name = np.full(tracks.num_tracks, np.iinfo(np.int64).max)
    np.minimum.at(name, tr, kp)
    return name, np.unique(name[tr] * np.int64(scene.num_keypoints) + kp)


def compare_track_sets(scene, card, cpu) -> dict:
    """Two track sets of one scene: the valid (track, keypoint) keys in
    one and not the other, and over the tracks whose valid keypoints are
    the same in both, the largest point difference relative to the extent
    of the registered frame centers."""
    (na, ka), (nb, kb) = _track_names(scene, card), _track_names(scene, cpu)
    differ = np.setxor1d(ka, kb, assume_unique=True)
    K = np.int64(scene.num_keypoints)
    # a track is the same in both when no differing key carries its name
    bad = np.unique(differ // K)
    same = np.setdiff1d(np.intersect1d(na, nb), bad)
    same = same[same != np.iinfo(np.int64).max]
    ia = np.searchsorted(np.sort(na), same)
    ib = np.searchsorted(np.sort(nb), same)
    xa = card.xyz[np.argsort(na)[ia]]
    xb = cpu.xyz[np.argsort(nb)[ib]]
    c = scene.frame_centers()[scene.frame_registered]
    extent = float(np.linalg.norm(c.max(0) - c.min(0)))
    return {"tracks": [card.num_tracks, cpu.num_tracks],
            "valid_keys": [len(ka), len(kb)], "keys_differ": len(differ),
            "keys_differ_share": len(differ) / max(len(kb), 1),
            "same_tracks": len(same),
            "point_max_diff_over_extent": float(
                np.abs(xa - xb).max() / extent) if len(same) else 0.0}


def keypoint_share(scene, tracks) -> float:
    """The share of the keypoints a valid observation explains (the
    reference's oracle counts observations, global_mapper_test.cc:213)."""
    return float((tracks.obs_valid & tracks.valid[tracks.obs_track]).sum()
                 / scene.num_keypoints)


def stage_7(scene, vg, tracks, device):
    """The controller's stage 7 on copies: (scene, tracks, report)."""
    sc, tr = scene.copy(), tracks.copy()
    mapper = GlobalMapper(device=device)
    out = mapper.retriangulation(sc, vg, tr)
    if out is None:
        raise AssertionError("stage 7: a refinement BA failed")
    return sc, out, mapper.reports["retriangulation"]


def profiled(fn, dev=None) -> tuple:
    """fn() once under torch.profiler, the card synchronised before and
    after: (its result, the wall ms of the call, the profile). On the CPU
    (dev "cpu", a rehearsal) the profile holds no device event."""
    cuda = dev is None or torch.device(dev).type == "cuda"
    acts = [torch.profiler.ProfilerActivity.CPU] + (
        [torch.profiler.ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, prof


def device_events(prof) -> list:
    """The device (kernel and copy) events of a profile."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_ms(prof) -> float:
    """The summed device ms of a profile's device events (0 if none)."""
    return sum(e.time_range.elapsed_us() for e in device_events(prof)) / 1e3


def _events_ms(fn, reps: int = 10) -> float:
    """Device ms per call of fn by CUDA events (eigvalsh reads back its
    convergence info, so it cannot be captured in a graph)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def solver_library_ms(cases) -> dict:
    """The batched 3x3 library calls of midpoint_triangulate (solve_ex,
    eigvalsh) on the normal matrices of each recorded 9-row sum."""
    out = []
    for (name, *_), (args, _) in cases.items():
        if name != "rowsum" or args[0].shape[0] != 9:
            continue
        s = kernels.rowsum(*args)
        A = s[:, list(tri._SYM)].reshape(-1, 3, 3).contiguous()
        rhs = s[:, 6:9, None].contiguous()
        out.append({"tracks": A.shape[0],
                    "solve_ex_ms": _events_ms(
                        lambda: torch.linalg.solve_ex(A, rhs)),
                    "eigvalsh_ms": _events_ms(
                        lambda: torch.linalg.eigvalsh(A))})
    return out


def profile_retriangulation(scene, vg, dev) -> dict:
    """retriangulate_tracks once under torch.profiler: its device time,
    the device time of the batched 3x3 solves (the kernels under the
    solve_ex and eigvalsh ops), and the device's busy share of the wall
    time."""
    _, wall_ms, prof = profiled(
        lambda: retriangulate_tracks(scene.copy(), vg, None, device=dev))
    dev_ms = {}
    for e in device_events(prof):
        dev_ms[e.name] = dev_ms.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    total = sum(dev_ms.values())
    solver = {e.key: getattr(e, "device_time_total",
                             getattr(e, "cuda_time_total", 0.0)) / 1e3
              for e in prof.key_averages() if e.key in SOLVER_OPS}
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    if not total:
        return {"device_ms": "not measured", "wall_ms": wall_ms}
    return {"device_ms": total, "wall_ms": wall_ms,
            "device_busy_share": total / wall_ms,
            "solver_ops_ms": solver,
            "solver_ops_share_of_device": sum(solver.values()) / total,
            "top_device_ms": [{"name": n[:80], "ms": ms} for n, ms in top]}


def retriangulation_phase(scene, tracks, vg, scene_f, gt_centers, dev):
    """Phase 7: (report, the kernel inputs of stage 7's triangulation calls
    and of one LM iteration of its first refinement BA, the launches of
    the counted run). `scene` and `tracks` are stage 6's result, scene_f
    and vg phase 4's filtered scene (the generator's poses)."""
    t_phase = time.perf_counter()
    valid6 = int((tracks.obs_valid & tracks.valid[tracks.obs_track]).sum())
    # every kernel input of the triangulation calls, and of one LM
    # iteration of the first refinement BA from their result
    sc0 = scene.copy()
    retri = {}
    cases = record_cases(lambda: retri.update(tracks=retriangulate_tracks(
        sc0, vg, None, device=dev)))
    cases.update(record_cases(lambda: solve_bundle_adjustment(
        sc0, retri["tracks"].copy(), BundleAdjusterOptions(
            max_num_iterations=1), device=dev)))
    del sc0, retri

    # stage 7 twice from the same state, the first counted
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sc, tr, rep = stage_7(scene, vg, tracks, dev)
    stage_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not all(launches[COUNTER.get(n, n)] > 0 for n in BA_KERNELS):
        raise AssertionError(f"stage 7: a kernel was not launched: "
                             f"{launches}")
    t0 = time.perf_counter()
    sc2, tr2, _ = stage_7(scene, vg, tracks, dev)
    second_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(
            _state(sc, tr) + (sc.frame_quat, tr.obs_track, tr.obs_image,
                              tr.obs_feature),
            _state(sc2, tr2) + (sc2.frame_quat, tr2.obs_track,
                                tr2.obs_image, tr2.obs_feature))):
        raise AssertionError("stage 7: two runs on the card differ")
    del sc2, tr2

    # retriangulate_tracks alone: the card against the CPU's plain f32 path
    t0 = time.perf_counter()
    card = retriangulate_tracks(scene.copy(), vg, None, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = retriangulate_tracks(scene.copy(), vg, None, device="cpu",
                               dtype=torch.float32)
    cpu_s = time.perf_counter() - t0
    vs_cpu = compare_track_sets(scene, card, cpu)
    vs_cpu.update(card_s=card_s, cpu_f32_s=cpu_s,
                  bound_keys_share=RETRI_KEYS_SHARE,
                  bound_point_over_extent=RETRI_POINT_REL)
    if RETRI_KEYS_SHARE is not None and not (
            vs_cpu["keys_differ_share"] <= RETRI_KEYS_SHARE
            and vs_cpu["point_max_diff_over_extent"] <= RETRI_POINT_REL):
        raise AssertionError(f"retriangulate_tracks card vs CPU f32: "
                             f"{vs_cpu}")
    del card, cpu

    # the oracles
    err = center_errors(sc, gt_centers)
    share = keypoint_share(sc, tr)
    if not (err.max() < GP_CENTER_BOUND and share >= KEYPOINT_ORACLE
            and np.isfinite(tr.xyz).all()):
        raise AssertionError(f"stage 7: center error {err.max()} (bound "
                             f"{GP_CENTER_BOUND}), keypoint share {share} "
                             f"(oracle {KEYPOINT_ORACLE}), or non-finite "
                             "points")

    # the user's entry point: stages 4-7 through GlobalMapper.solve on
    # phase 4's filtered scene, the generator's rotations for stages 0-3
    opt = GlobalMapperOptions(
        skip_preprocessing=True, skip_view_graph_calibration=True,
        skip_relative_pose_estimation=True, skip_rotation_averaging=True)
    solver = GlobalMapper(opt, device=dev)
    sc_s = scene_f.copy()
    t0 = time.perf_counter()
    out = solver.solve(sc_s, vg.copy())
    solve_s = time.perf_counter() - t0
    if out is None:
        raise AssertionError("GlobalMapper.solve (stages 4-7) failed")
    err_s = center_errors(sc_s, gt_centers)
    share_s = keypoint_share(sc_s, out)
    if not (err_s.max() < GP_CENTER_BOUND and share_s >= KEYPOINT_ORACLE):
        raise AssertionError(f"GlobalMapper.solve: center error "
                             f"{err_s.max()}, keypoint share {share_s}")
    solve_report = solver.reports["retriangulation"]

    (it,) = rep["iterations"]
    report = {
        "problem": (f"stage 6's result on the stage scene: "
                    f"{scene.num_frames} frames, {vg.num_matches} matches, "
                    f"{scene.num_keypoints} keypoints, {valid6} valid "
                    f"observations, f32"),
        "stage7_seconds": [stage_s, second_s],
        "stage7_report_seconds": rep["seconds"],
        "generations": it["generations"],
        "completed_in_place": it["completed_in_place"],
        "completed_from_matches": it["completed_from_matches"],
        "merged": it["merged"], "tracks": tr.num_tracks,
        "valid_observations": int((tr.obs_valid
                                   & tr.valid[tr.obs_track]).sum()),
        "retriangulate_seconds": it["seconds"],
        "refinement_rounds": [
            {"ba_lm_iters": r["ba"]["lm_iters"],
             "ba_seconds": r["ba"]["seconds"],
             "completed": r["completed"], "merged": r["merged"],
             "filtered": r["filtered"], "changed": r.get("changed")}
            for r in it["rounds"]],
        "final_removed": rep["final_removed"],
        "keypoint_share": share, "keypoint_oracle": KEYPOINT_ORACLE,
        "stage6_keypoint_share": valid6 / scene.num_keypoints,
        "center_error": {"max": float(err.max()),
                         "median": float(np.median(err))},
        "center_bound": GP_CENTER_BOUND, "bitwise_reproducible": True,
        "card_vs_cpu_f32": vs_cpu,
        "solver_library": solver_library_ms(cases),
        "profile": profile_retriangulation(scene, vg, dev),
        "launches": launches,
        "solve_stages_4_7": {
            "seconds": solve_s, "stages_s": dict(solver.timer.stages),
            "retriangulation": {
                "generations": solve_report["iterations"][0]["generations"],
                "merged": solve_report["iterations"][0]["merged"],
                "rounds": len(solve_report["iterations"][0]["rounds"]),
                "ba_lm_iters": [r["ba"]["lm_iters"] for r in
                                solve_report["iterations"][0]["rounds"]]},
            "keypoint_share": share_s,
            "center_error_max": float(err_s.max())}}
    report["phase_seconds"] = time.perf_counter() - t_phase
    return report, cases, launches


# ----------------------------------------------------------------------------
# phase 8: stage 3 (rotation averaging, gravity priors, the rig bootstrap's
# controller) and the rotation_averager command
# ----------------------------------------------------------------------------


def perturb_relative_rotations(vg, rng, noise_deg, outlier_ratio):
    """tests/test_rotation_averaging.py:28-41 on the port's math: noise
    about random axes on every pair, then random rotations on a share."""
    n = vg.num_pairs
    w = np.deg2rad(noise_deg) * rng.standard_normal((n, 3)) / np.sqrt(3)
    vg.pair_quat = rotm.host(rotm.quat_mul, rotm.host(rotm.so3_exp_quat, w),
                             vg.pair_quat)
    idx = rng.choice(n, size=int(round(outlier_ratio * n)), replace=False)
    q = rng.standard_normal((len(idx), 4))
    vg.pair_quat[idx] = q / np.linalg.norm(q, axis=-1, keepdims=True)


def pairwise_errors_deg(q, q_gt, sample=0, seed=0) -> np.ndarray:
    """Angles between the estimated and the true relative rotations of
    every frame pair, or of `sample` random pairs as
    scripts/ra_quality_ab.py:64-78 draws them."""
    if sample:
        rng = np.random.default_rng(seed)
        ii, jj = rng.integers(0, len(q), sample), rng.integers(0, len(q),
                                                                 sample)
        ii, jj = ii[ii != jj], jj[ii != jj]
    else:
        ii, jj = np.triu_indices(len(q), k=1)

    def rel(a):
        return rotm.host(lambda x, y: rotm.quat_mul(x, rotm.quat_conj(y)),
                         a[ii], a[jj])
    return np.degrees(rotm.host(rotm.relative_quat_angle_rad, rel(q),
                                rel(q_gt)))


def quat_angle_diff(a, b) -> float:
    """The largest rotation between unit quaternions a and b (2 |a - b| up
    to sign; exact to first order)."""
    s = np.sign(np.sum(a * b, axis=-1, keepdims=True))
    return float(2 * np.linalg.norm(a - s * b, axis=-1).max())


def rotation_graph(frames, degree, span, noise_deg, outliers, seed, dedupe):
    """The JAX package's sequential-capture rotation graphs on the port's
    math, draw for draw: (fi, fj, q_rel, q_gt). dedupe=False is
    scripts/bench_components.py's (edges repeat), True
    scripts/ra_quality_ab.py's synth_graph."""
    rng = np.random.default_rng(seed)
    q_gt = rng.standard_normal((frames, 4))
    q_gt /= np.linalg.norm(q_gt, axis=1, keepdims=True)
    fi = np.repeat(np.arange(frames), degree)
    fj = np.minimum(fi + rng.integers(1, span, size=len(fi)), frames - 1)
    keep = fi != fj
    fi, fj = fi[keep], fj[keep]
    if dedupe:
        uniq = np.unique(fi * np.int64(frames) + fj)
        fi, fj = uniq // frames, uniq % frames
    fi, fj = fi.astype(np.int32), fj.astype(np.int32)
    q_rel = rotm.host(lambda a, b: rotm.quat_mul(a, rotm.quat_conj(b)),
                      q_gt[fj], q_gt[fi])
    w = np.deg2rad(noise_deg) * rng.standard_normal((len(fi), 3))
    q_rel = rotm.host(rotm.quat_mul, q_rel, rotm.host(rotm.so3_exp_quat, w))
    if outliers:
        n_out = int(outliers * len(fi))
        idx = rng.choice(len(fi), n_out, replace=False)
        q_out = rng.standard_normal((n_out, 4))
        q_rel[idx] = q_out / np.linalg.norm(q_out, axis=1, keepdims=True)
    return fi, fj, q_rel, q_gt


def graph_scene(fi, fj, q_rel, frames):
    """A scene of `frames` trivial frames (image k named frameKKKKK.jpg)
    and the view graph of the edges, as read_rel_pose would make them."""
    scene = Scene()
    pose_io._extend_scene_with_images(
        scene, [f"frame{k:05d}.jpg" for k in range(frames)])
    n = len(fi)
    vg = vgm.ViewGraph(
        pair_i=fi.copy(), pair_j=fj.copy(), pair_valid=np.ones(n, bool),
        pair_config=np.full(n, vgm.CONFIG_CALIBRATED, np.int32),
        pair_quat=q_rel, pair_trans=np.zeros((n, 3)), pair_weight=np.ones(n),
        pair_num_inliers=np.ones(n, np.int64),
        pair_match_offset=np.zeros(n + 1, np.int64))
    return scene, vg


def solve_summary(st) -> dict:
    """The report of one estimate_rotations call: its path and size, the
    ADMM's branch (the factor's relerr, whether it ran and was kept, its
    rounds and inner iterations), the sweeps of each phase and the CG
    iterations per sweep."""
    if "l1" not in st:
        return st
    l1 = st["l1"]
    out = {k: st[k] for k in ("path", "frames", "edges", "gravity_frames")}
    if "admm" in l1:
        out["admm"] = {k: l1["admm"].get(k) for k in (
            "relerr", "ran", "kept", "outer", "inner", "objective")}
    out.update(l1_irls_sweeps=l1["l1_irls"]["sweeps"],
               l1_irls_kept=l1["l1_irls"]["kept"],
               irls_sweeps=st["irls"]["sweeps"])
    cg = l1["l1_irls"]["cg_iters"] + st["irls"]["cg_iters"]
    if cg:
        out["cg_iters_per_sweep"] = {"mean": float(np.mean(cg)),
                                     "min": min(cg), "max": max(cg)}
    return out


def stage_3(scene, vg, device, dtype=None):
    """The controller's stage 3 on copies: (scene, view graph, report)."""
    sc, g = scene.copy(), vg.copy()
    mapper = GlobalMapper(device=device, dtype=dtype)
    if not mapper.rotation_averaging(sc, g):
        raise AssertionError("stage 3: rotation averaging failed")
    rep = mapper.reports["rotation averaging"]
    return sc, g, {"seconds": rep["seconds"], "passes": [
        {"ok": p["ok"], "seconds": p["seconds"],
         "filtered_pairs": p["filtered_pairs"],
         "component_images": p["component_images"],
         "solves": [solve_summary(s) for s in p["solves"]]}
        for p in rep["passes"]]}


def require_launched(launches, names, what):
    if not all(launches[COUNTER.get(n, n)] > 0 for n in names):
        raise AssertionError(f"{what}: a kernel was not launched: "
                             f"{launches}")


def stage_3_on_card(scene, vg, gt_quat, dev) -> tuple:
    """Phase 8 (a): (report, recorded cases, launches)."""
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run = {}
    cases = record_cases(lambda: run.update(out=stage_3(scene, vg, dev)))
    first_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require_launched(launches, ("rowsum",), "stage 3")
    sc, g, rep = run["out"]
    t0 = time.perf_counter()
    sc2, g2, _ = stage_3(scene, vg, dev)
    second_s = time.perf_counter() - t0
    if not (np.array_equal(sc.frame_quat, sc2.frame_quat)
            and np.array_equal(g.pair_valid, g2.pair_valid)
            and np.array_equal(sc.frame_registered, sc2.frame_registered)):
        raise AssertionError("stage 3: two runs on the card differ")
    vs_cpu = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        t0 = time.perf_counter()
        sc_c, g_c, rep_c = stage_3(scene, vg, "cpu", dtype)
        vs_cpu[name] = {
            "seconds": time.perf_counter() - t0,
            "max_rad": quat_angle_diff(sc.frame_quat, sc_c.frame_quat),
            "pairs_differ": int((g.pair_valid != g_c.pair_valid).sum()),
            "admm": [[s.get("admm") for s in p["solves"]]
                     for p in rep_c["passes"]]}
    vs_cpu["bound_f32_rad"] = RA_CPU_F32_RAD
    if not (vs_cpu["f32"]["max_rad"] <= RA_CPU_F32_RAD
            and vs_cpu["f32"]["pairs_differ"] == 0):
        raise AssertionError(f"stage 3 card vs CPU f32: {vs_cpu['f32']}")
    reg = sc.frame_registered
    errs = pairwise_errors_deg(sc.frame_quat[reg], gt_quat[reg])
    if not (errs.max() < RA_MAX_DEG and errs.mean() < RA_MEAN_DEG):
        raise AssertionError(f"stage 3: pairwise errors max {errs.max()}, "
                             f"mean {errs.mean()} deg")
    return {**rep, "seconds_host": [first_s, second_s],
            "registered_frames": int(reg.sum()),
            "pairwise_error_deg": {"max": float(errs.max()),
                                   "mean": float(errs.mean())},
            "bitwise_reproducible": True, "card_vs_cpu": vs_cpu,
            "launches": launches}, cases, launches


def gravity_on_card(scene_gt, vg_gt, scene, vg, gt_quat, dev) -> tuple:
    """Phase 8 (b): priors from the generator's rotations (scene_gt) with
    30% outliers on 80% of the frames, refined against the generator's
    relative rotations (vg_gt; tests/test_gravity.py:79-99), then the
    stratified gravity solve on the perturbed ones (vg; :65-77). (report,
    recorded cases, launches)."""
    rng = np.random.default_rng(RA_SEED + 1)
    truth, noisy = scene_gt.copy(), scene_gt.copy()
    synthesize_gravity(truth, None, rng)
    synthesize_gravity(noisy, None, rng, outlier_ratio=GRAVITY_OUTLIERS)
    sc = scene.copy()
    sc.frame_has_gravity = rng.uniform(size=sc.num_frames) < \
        GRAVITY_PRIOR_SHARE
    sc.frame_gravity = noisy.frame_gravity.copy()
    has = sc.frame_has_gravity
    before = gravm.gravity_angle_deg(sc.frame_gravity, truth.frame_gravity)
    t0 = time.perf_counter()
    rectified = refine_gravity(sc, vg_gt)
    refine_s = time.perf_counter() - t0
    after = gravm.gravity_angle_deg(sc.frame_gravity, truth.frame_gravity)
    if not after[has].max() < GRAVITY_REFINED_DEG:
        raise AssertionError(f"gravity refinement: {after[has].max()} deg "
                             "from the truth")
    g = vg.copy()
    stats = []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ok = {}
    cases = record_cases(lambda: ok.update(ok=solve_rotation_averaging(
        sc, g, RotationAveragerOptions(use_gravity=True), device=dev,
        stats=stats)))
    solve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not ok["ok"] or len(stats) != 2:
        raise AssertionError(f"gravity solve: ok {ok['ok']}, {len(stats)} "
                             "solves (the stratified one and the full one)")
    require_launched(launches, RA_KERNELS, "gravity solve")
    reg = sc.frame_registered
    errs = pairwise_errors_deg(sc.frame_quat[reg], gt_quat[reg])
    up = rotm.host(rotm.quat_rotate, sc.frame_quat,
                   np.tile([0.0, 1.0, 0.0], (sc.num_frames, 1)))
    manifold = gravm.gravity_angle_deg(up, sc.frame_gravity)[has & reg]
    if not (errs.max() < GRAVITY_MAX_DEG
            and manifold.max() < GRAVITY_MANIFOLD_DEG):
        raise AssertionError(f"gravity solve: pairwise errors max "
                             f"{errs.max()} deg, {manifold.max()} deg off "
                             "the gravity manifold")
    return {"frames_with_priors": int(has.sum()),
            "outlier_priors": int((before[has] > 10).sum()),
            "rectified": rectified, "refine_seconds": refine_s,
            "refined_error_deg_max": float(after[has].max()),
            "solve_seconds": solve_s,
            "solves": [solve_summary(s) for s in stats],
            "pairwise_error_deg": {"max": float(errs.max()),
                                   "mean": float(errs.mean())},
            "off_manifold_deg_max": float(manifold.max()),
            "launches": launches}, cases, launches


def rotation_averager_command() -> dict:
    """Phase 8 (c): the component graph as a rel-pose file, through
    `cli.main(["rotation_averager", ...])` on the card twice."""
    fi, fj, q_rel, q_gt = rotation_graph(**COMPONENT_GRAPH)
    scene, vg = graph_scene(fi, fj, q_rel, COMPONENT_GRAPH["frames"])
    shutil.rmtree(RA_DIR, ignore_errors=True)
    RA_DIR.mkdir(parents=True)
    rel_path = RA_DIR / "relpose.txt"
    pose_io.write_rel_poses(str(rel_path), scene, vg)
    seconds, outs = [], []
    kernels.reset_launch_counts()
    for k in range(2):
        out = RA_DIR / f"rotations_{k}.txt"
        t0 = time.perf_counter()
        rc = cli.main(["rotation_averager", "--relpose_path", str(rel_path),
                       "--output_path", str(out)])
        seconds.append(time.perf_counter() - t0)
        if rc != 0:
            raise AssertionError(f"rotation_averager exited with {rc}")
        if k == 0:
            launches = dict(kernels.LAUNCHES)
        outs.append(out.read_bytes())
    if outs[0] != outs[1]:
        raise AssertionError("rotation_averager: two runs wrote different "
                             "bytes")
    rows = [ln.split() for ln in outs[0].decode().splitlines()]
    idx = np.array([int(r[0][5:10]) for r in rows])
    q = np.array([[float(v) for v in r[1:]] for r in rows])
    errs = pairwise_errors_deg(q, q_gt[idx], sample=2000)
    if not (len(rows) == COMPONENT_GRAPH["frames"]
            and errs.max() < COMPONENT_MAX_DEG):
        raise AssertionError(f"rotation_averager: {len(rows)} rotations, "
                             f"sampled pairwise error max {errs.max()} deg")
    return {"graph": {**COMPONENT_GRAPH, "edges": len(fi)},
            "seconds": seconds, "rotations": len(rows),
            "pairwise_error_deg_sampled": {"max": float(errs.max()),
                                           "median": float(np.median(errs))},
            "bytes_identical": True, "launches": launches}


def matvec_split_ms(fi, fj, num_frames, dev) -> dict:
    """Device ms of one CG Laplacian apply on the graph's axes (seeded
    weights and vector), of its B2 gather and its B3 sum alone, and of
    the rest (the elementwise glue, mostly the (3, 2E) weight product);
    the timing launches are not the path's."""
    saved = dict(kernels.LAUNCHES)
    gen = torch.Generator().manual_seed(RA_SEED)
    edges = build_edge_ops(fi, fj, num_frames, dev, dense=False)
    E = edges.num_edges
    w = (torch.rand(E, generator=gen) + 0.5).to(dev)
    w2 = torch.cat([w, w])
    x = torch.randn((num_frames, 3), generator=gen).to(dev)
    keep = torch.ones(num_frames, device=dev)
    keep[0] = 0.0
    deg = edges.edge_sums(w[:, None], w[:, None])[:, 0]
    vals = (w2[None] * edges.gather_dst(x)).contiguous()
    out = {"matvec_ms": graph_ms(lambda: linear.laplacian_matvec(
               edges, w2, deg, x, keep)),
           "b2_ms": graph_ms(lambda: edges.gather_dst(x)),
           "b3_ms": graph_ms(lambda: kernels.rowsum(vals, edges.axis))}
    out["glue_ms"] = out["matvec_ms"] - out["b2_ms"] - out["b3_ms"]
    kernels.LAUNCHES.update(saved)
    return out


def city_graph_on_card(dev) -> tuple:
    """Phase 8 (d): estimate_rotations beyond the dense ceiling (L1-IRLS
    and IRLS on the projected CG). (report, recorded cases, launches)."""
    t0 = time.perf_counter()
    fi, fj, q_rel, q_gt = rotation_graph(**CITY_GRAPH)
    scene, vg = graph_scene(fi, fj, q_rel, CITY_GRAPH["frames"])
    gen_s = time.perf_counter() - t0
    st = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ok = {}
    cases = record_cases(lambda: ok.update(ok=estimate_rotations(
        scene, vg, device=dev, stats=st)))
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not ok["ok"] or st["path"] != "cg":
        raise AssertionError(f"city graph: ok {ok['ok']}, path "
                             f"{st.get('path')}")
    require_launched(launches, RA_KERNELS, "city graph")
    errs = pairwise_errors_deg(scene.frame_quat, q_gt, sample=2000)
    if not errs.max() < CITY_MAX_DEG:
        raise AssertionError(f"city graph: sampled pairwise error max "
                             f"{errs.max()} deg")
    summary = solve_summary(st)
    sweeps = summary["l1_irls_sweeps"] + summary["irls_sweeps"]
    return {"graph": {**CITY_GRAPH, "edges": len(fi)},
            "generation_seconds": gen_s, "seconds": seconds,
            "sweeps_per_s": sweeps / seconds, **summary,
            "laplacian_apply": matvec_split_ms(fi, fj, CITY_GRAPH["frames"],
                                               dev),
            "pairwise_error_deg_sampled": {"max": float(errs.max()),
                                           "median": float(np.median(errs))},
            "launches": launches}, cases, launches


def rotation_phase(scene_f, vg_f, gt_centers, dev):
    """Phase 8 on phase 4's filtered scene (the generator's poses): (the
    stage_3 report, the recorded B2 and B3 inputs of (a), (b) and (d) with
    their calls, the launches of their counted runs summed)."""
    t_phase = time.perf_counter()
    gt_quat = scene_f.frame_quat.copy()
    scene, vg = scene_f.copy(), vg_f.copy()
    perturb_relative_rotations(vg, np.random.default_rng(RA_SEED),
                               RA_NOISE_DEG, RA_OUTLIERS)
    scene.frame_quat[:] = [1.0, 0.0, 0.0, 0.0]

    a, cases_a, launches_a = stage_3_on_card(scene, vg, gt_quat, dev)
    print(f"# stage 3: {a['seconds_host']} s, pairwise max "
          f"{a['pairwise_error_deg']['max']:.3f} deg", file=sys.stderr)
    b, cases_b, launches_b = gravity_on_card(scene_f, vg_f, scene, vg,
                                             gt_quat, dev)
    print(f"# gravity: {b['solve_seconds']:.2f} s, pairwise max "
          f"{b['pairwise_error_deg']['max']:.3f} deg", file=sys.stderr)
    c = rotation_averager_command()
    print(f"# rotation_averager: {c['seconds']} s", file=sys.stderr)
    d, cases_d, launches_d = city_graph_on_card(dev)
    print(f"# city graph: {d['seconds']:.2f} s, {d['l1_irls_sweeps']} + "
          f"{d['irls_sweeps']} sweeps", file=sys.stderr)

    # (e) the mapper from stage 3: stages 3-6, then the deregistration
    opt = GlobalMapperOptions(
        skip_preprocessing=True, skip_view_graph_calibration=True,
        skip_relative_pose_estimation=True, skip_retriangulation=True)
    solver = GlobalMapper(opt, device=dev)
    sc_e = scene.copy()
    t0 = time.perf_counter()
    out = solver.solve(sc_e, vg.copy())
    solve_s = time.perf_counter() - t0
    if out is None:
        raise AssertionError("GlobalMapper.solve (stages 3-6) failed")
    err_e = center_errors(sc_e, gt_centers)
    if not err_e.max() < GP_CENTER_BOUND:
        raise AssertionError(f"GlobalMapper.solve (stages 3-6): center "
                             f"error {err_e.max()}")

    # the recorded axes stay alive in the cases, so their ids do not clash
    cases = {**cases_a, **cases_b, **cases_d}
    launches = {n: launches_a[n] + launches_b[n] + launches_d[n]
                for n in launches_a}
    report = {
        "problem": (f"phase 4's scene after its filters: "
                    f"{scene.num_frames} frames, {vg.num_pairs} pairs, "
                    f"relative rotations with {RA_NOISE_DEG} deg noise "
                    f"and {RA_OUTLIERS:.0%} outliers, identity start"),
        "stage3": a, "gravity": b, "rotation_averager": c, "city_graph": d,
        "solve_stages_3_6": {
            "seconds": solve_s, "stages_s": dict(solver.timer.stages),
            "center_error_max": float(err_e.max()),
            "center_bound": GP_CENTER_BOUND},
        "launches_a_b_d": launches}
    report["phase_seconds"] = time.perf_counter() - t_phase
    return report, cases, launches


# ----------------------------------------------------------------------------
# phase 9: the mapper command from a COLMAP database
# ----------------------------------------------------------------------------


def mapper_database(root: Path):
    """(a) The sweep scene as COLMAP's matcher would store it: its
    two-view geometries (config, E, F, H and relative pose) kept, every
    frame pose reset. Returns (database path, the generator's frame
    center by image name, the generator's relative poses, report)."""
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    scene, vg, gen_s = sweep_problem()
    centers = scene.frame_centers()
    names_gt = {n: centers[scene.image_frame[k]]
                for k, n in enumerate(scene.image_names)}
    pair_gt = (vg.pair_quat.copy(), vg.pair_trans.copy())
    scene.frame_quat[:] = [1.0, 0.0, 0.0, 0.0]
    scene.frame_trans[:] = 0.0
    path = root / "database.db"
    t0 = time.perf_counter()
    write_database(str(path), scene, vg)
    write_s = time.perf_counter() - t0
    report = {"problem": (f"synthetic {SWEEP_OPTIONS}: {scene.num_images} "
                          f"images, {vg.num_pairs} pairs, {vg.num_matches} "
                          f"matches, {scene.num_keypoints} keypoints"),
              "generation_s": gen_s, "write_s": write_s,
              "bytes": path.stat().st_size,
              "configs": {str(c): int((vg.pair_config == c).sum())
                          for c in np.unique(vg.pair_config)}}
    return path, names_gt, pair_gt, report


def ingest(path):
    """(scene, view graph, seconds) of a database, as `mapper` reads it."""
    t0 = time.perf_counter()
    scene, vg = database_to_scene(read_database(str(path)))
    return scene, vg, time.perf_counter() - t0


def _qdiff(a, b) -> float:
    """The largest rotation angle (rad) between unit quaternions a and b
    (2 |a - b| up to sign: first-order exact, not limited by arccos)."""
    s = np.sign(np.sum(a * b, -1, keepdims=True))
    return float(2 * np.linalg.norm(a - s * b, axis=-1).max())


def front_end_vs_cpu(scene0, vg0, dev) -> dict:
    """(b) decompose_rel_pose, calibrate_view_graph (the prior cleared,
    the focal at 1.3x), one RANSAC round of 64 hypotheses on every pair
    with the same draws, and the LO step from the same start, each on the
    card and on the CPU's plain f32 path from the same input (the rays of
    the card's lift). Returns (report, the card calibration's recorded
    kernel inputs, its launches): the `mapper` run's cameras carry prior
    focals, so its calibration solves nothing, and B3's (C, C) normal
    matrix is checked here."""
    cpu, f32 = torch.device("cpu"), torch.float32
    scene = scene0.copy()
    undistort_images(scene, device=dev)
    out = {}
    # decomposition
    res = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        vg = vg0.copy()
        t0 = time.perf_counter()
        n_pure = vgmp.decompose_rel_pose(scene, vg, device=d, dtype=f32)
        res[name] = (vg, n_pure, time.perf_counter() - t0)
    (vg_c, pure_c, s_c), (vg_p, pure_p, s_p) = res["card"], res["cpu"]
    if not (np.array_equal(vg_c.pair_config, vg_p.pair_config)
            and pure_c == pure_p):
        raise AssertionError("decompose_rel_pose: configurations differ "
                             "on the card and the CPU")
    out["decompose"] = {
        "pure_rotations": pure_c, "seconds_card": s_c, "seconds_cpu": s_p,
        "quat_rad": _qdiff(vg_c.pair_quat, vg_p.pair_quat),
        "trans": float(np.abs(vg_c.pair_trans - vg_p.pair_trans).max()),
        "bound_rad": FRONT_DECOMPOSE_RAD}
    # calibration from a 1.3x focal without a prior
    f_gt = scene.cam_params[:, 0].copy()
    res = {}
    for name, d, dt in (("card", dev, f32), ("cpu", cpu, f32),
                        ("cpu_f64", cpu, torch.float64)):
        sc, vg = scene.copy(), vg0.copy()
        sc.cam_has_prior_focal[:] = False
        sc.cam_params[:, 0:2] *= CALIB_START
        st, ok = {}, {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        cases = record_cases(lambda: ok.update(ok=calibrate_view_graph(
            sc, vg, device=d, dtype=dt, stats=st)))
        if not ok["ok"]:
            raise AssertionError(f"calibrate_view_graph failed ({name})")
        st["seconds"] = time.perf_counter() - t0
        st["rowsum_launches"] = kernels.LAUNCHES["rowsum"]
        if name == "card":
            calib = (cases, dict(kernels.LAUNCHES))
        res[name] = (sc.cam_params[:, 0].copy(), vg.pair_valid.copy(), st)
    (f_c, valid_c, st_c), (f_p, valid_p, st_p) = res["card"], res["cpu"]
    rel_gt = float(np.abs(f_c / f_gt - 1).max())
    if not rel_gt < CALIB_FOCAL_REL or st_c["rowsum_launches"] == 0:
        raise AssertionError(f"calibration: focal {rel_gt} off the "
                             f"generator's, {st_c}")
    out["calibration"] = {
        "focal_rel_to_generator": rel_gt,
        "focal_rel_card_cpu": float(np.abs(f_c / f_p - 1).max()),
        "bound_rel": FRONT_FOCAL_REL, "card": st_c, "cpu": st_p,
        "pairs_kept": int(valid_c.sum()),
        "pairs_kept_differ": int((valid_c != valid_p).sum()),
        "pairs_kept_differ_card_vs_f64": int(
            (valid_c != res["cpu_f64"][1]).sum()),
        "cpu_f64": res["cpu_f64"][2], "bound_pairs": FRONT_CALIB_PAIRS}
    # one RANSAC round on every pair with the same draws, then the LO step
    # from the same start
    vg = vg0.copy()
    P = vg.num_pairs
    gen = torch.Generator().manual_seed(0)
    u = torch.randint(0, 1 << 30, (P, 2, relpose.HYP_PER_ROUND),
                      generator=gen)
    rounds, tabs = {}, {}
    for name, d, dt in (("card", dev, f32), ("cpu", cpu, f32),
                        ("cpu_f64", cpu, torch.float64)):
        tab, mask, counts = relpose._pair_tables(scene, vg, 512, 1, d, dt)
        f = scene.cam_params[scene.image_camera, 0]
        thr = torch.from_numpy((0.5 * (1 / f[vg.pair_i] + 1 / f[vg.pair_j])
                                ) ** 2).to(d, dt)
        tabs[name] = (tab, mask, thr)
        t0 = time.perf_counter()
        E, c = kernels.ransac_chunk(
            u.to(d)[None], torch.stack(tab, 1), mask.contiguous(), counts,
            thr, torch.zeros((P, 3, 3), dtype=dt, device=d),
            torch.zeros(P, dtype=torch.int64, device=d))
        c = c.cpu().numpy()
        rounds[name] = (E, c, time.perf_counter() - t0)
    c_c, c_p, c_64 = (rounds[k][1] for k in ("card", "cpu", "cpu_f64"))
    diff = np.abs(c_c - c_p)
    out["ransac_round"] = {
        "pairs": P, "hypotheses": relpose.HYP_PER_ROUND,
        "pairs_count_differs": int((diff > 0).sum()),
        "count_diff_max": int(diff.max()),
        "count_sum": {"card": int(c_c.sum()), "cpu": int(c_p.sum()),
                      "cpu_f64": int(c_64.sum())},
        "pairs_count_differs_from_f64": {
            "card": int((c_c != c_64).sum()),
            "cpu": int((c_p != c_64).sum())},
        "seconds_card": rounds["card"][2], "seconds_cpu": rounds["cpu"][2],
        "seconds_cpu_f64": rounds["cpu_f64"][2],
        "bound_pairs_share": FRONT_COUNT_PAIRS_SHARE,
        "bound_sum_rel": FRONT_COUNT_SUM_REL}
    tab, mask, _ = tabs["card"]
    q0, t0_ = relpose._choose_pose_tab(rounds["card"][0], tab, mask)
    refined = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        tab, mask, thr = tabs[name]
        t0 = time.perf_counter()
        q, t = relpose._refine_poses_tab(q0.to(d), t0_.to(d), tab, mask,
                                         thr, 10)
        refined[name] = (q.cpu().double().numpy(), t.cpu().double().numpy(),
                         time.perf_counter() - t0)
    out["refine"] = {
        "quat_rad": _qdiff(refined["card"][0], refined["cpu"][0]),
        "trans": float(np.abs(refined["card"][1] - refined["cpu"][1]).max()),
        "seconds_card": refined["card"][2], "seconds_cpu": refined["cpu"][2],
        "bound_rad": FRONT_REFINE_RAD, "bound_trans": FRONT_REFINE_TRANS}
    return (out, *calib)


def check_front_end(fe: dict) -> None:
    """The card-vs-CPU bounds of (b)."""
    rr, ref = fe["ransac_round"], fe["refine"]
    sums = rr["count_sum"]
    fails = [
        fe["calibration"]["pairs_kept_differ"] > FRONT_CALIB_PAIRS,
        fe["decompose"]["quat_rad"] > FRONT_DECOMPOSE_RAD,
        fe["calibration"]["focal_rel_card_cpu"] > FRONT_FOCAL_REL,
        rr["pairs_count_differs"] > FRONT_COUNT_PAIRS_SHARE * rr["pairs"],
        abs(sums["card"] - sums["cpu"]) > FRONT_COUNT_SUM_REL * sums["cpu"],
        ref["quat_rad"] > FRONT_REFINE_RAD,
        ref["trans"] > FRONT_REFINE_TRANS]
    if any(fails):
        raise AssertionError(f"front end: card and CPU differ beyond the "
                             f"measured bounds: {fe}")


def launches_per_round(scene, vg, dev) -> dict:
    """One RANSAC round on every pair (its draws and one ransac_chunk
    call, B8 on the card) under torch.profiler: its device kernels
    (launches) and device ms."""
    tab, mask, counts = relpose._pair_tables(scene, vg, 512, 1, dev,
                                             torch.float32)
    P = vg.num_pairs
    args = (torch.stack(tab, 1), mask.contiguous(), counts,
            torch.full((P,), 1e-6, device=dev),
            torch.zeros((P, 3, 3), device=dev),
            torch.zeros(P, dtype=torch.int64, device=dev))
    gen = torch.Generator(device=dev).manual_seed(0)

    def one():
        u = torch.randint(0, 1 << 30, (P, 2, relpose.HYP_PER_ROUND),
                          generator=gen, device=dev)
        return kernels.ransac_chunk(u[None], *args)
    one()
    _, wall_ms, prof = profiled(one)
    kern = device_events(prof)
    dev_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by = {}
    for e in kern:
        by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    return {"launches": len(kern), "device_ms": dev_ms or "not measured",
            "wall_ms": wall_ms,
            "top_device_ms": [{"name": n[:80], "ms": ms} for n, ms in top]}


def relpose_counted(scene0, vg0, pair_gt, dev) -> dict:
    """(c) estimate_relative_poses on the card on the ingested scene
    (lifted): twice, bit for bit alike, then once under torch.profiler
    (the device's busy share); pose errors against the generator's."""
    scene = scene0.copy()
    undistort_images(scene, device=dev)
    runs = []
    for _ in range(2):
        vg, st = vg0.copy(), {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        relpose.estimate_relative_poses(scene, vg, device=dev, stats=st)
        torch.cuda.synchronize()
        st["seconds"] = time.perf_counter() - t0
        runs.append((vg, st))
    (vg, st), (vg2, _) = runs
    if not all(np.array_equal(getattr(vg, k), getattr(vg2, k)) for k in (
            "pair_quat", "pair_trans", "_relpose_budget")):
        raise AssertionError("estimate_relative_poses: two runs differ")
    _, wall_ms, prof = profiled(lambda: relpose.estimate_relative_poses(
        scene, vg0.copy(), device=dev))
    dev_ms = device_ms(prof)
    rot = np.degrees(rotm.host(rotm.relative_quat_angle_rad, vg.pair_quat,
                               pair_gt[0]))
    t_gt = pair_gt[1] / np.linalg.norm(pair_gt[1], axis=-1, keepdims=True)
    tdir = np.degrees(np.arccos(np.clip(np.sum(vg.pair_trans * t_gt, -1),
                                        -1, 1)))
    rep = {**st, "bitwise_reproducible": True,
           "profiled_wall_ms": wall_ms,
           "device_ms": dev_ms or "not measured",
           "device_busy_share": dev_ms / wall_ms if dev_ms else
           "not measured",
           "rotation_error_deg": {"median": float(np.median(rot)),
                                  "max": float(rot.max()),
                                  "under_2deg": float((rot < 2.0).mean())},
           "translation_dir_error_deg": {"median": float(np.median(tdir))},
           "round": launches_per_round(scene, vg0, dev)}
    if not (np.median(rot) < RELPOSE_MEDIAN_DEG
            and (rot < 2.0).mean() > RELPOSE_UNDER_2DEG):
        raise AssertionError(f"estimate_relative_poses: pose errors "
                             f"{rep['rotation_error_deg']}")
    return rep


def mapper_command(db, names_gt, num_keypoints, dev, card):
    """(d) `cli.main(["mapper", ...])` on the card: counted (B1-B7 must
    launch; the kernel inputs of every stage recorded), again, with
    --checkpoint_dir, and resumed from that run's stage_02.npz with the
    later checkpoints deleted; all four must write the same bytes.
    Returns (report, the counted run's recorded cases, its launches)."""
    root = Path(db).parent
    ckpt = root / "checkpoints"

    def run(name, *extra):
        out = root / name
        t0 = time.perf_counter()
        rc, mapper = capture_mapper(lambda: cli.main(
            ["mapper", "--database_path", str(db), "--output_path",
             str(out), *extra]))
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"mapper ({name}) returned {rc}")
        return {"model": out / "0", "seconds": seconds,
                "stages": dict(mapper.timer.stages),
                "reports": mapper.reports}

    kernels.reset_launch_counts()
    runs = {}
    cases = record_cases(lambda: runs.update(first=run("first")))
    launches = dict(kernels.LAUNCHES)
    require_launched(launches, MAPPER_KERNELS + ("ransac_chunk",), "mapper")
    runs["second"] = run("second")
    runs["checkpointed"] = run("checkpointed", "--checkpoint_dir", str(ckpt))
    for path in ckpt.glob("stage_*.npz"):
        if int(path.stem[len("stage_"):]) > 2:
            path.unlink()
    runs["resumed"] = run("resumed", "--checkpoint_dir", str(ckpt))
    if "relative pose estimation" in runs["resumed"]["stages"]:
        raise AssertionError("mapper: the resumed run ran stage 2")
    first = model_bytes(runs["first"]["model"])
    for name in ("second", "checkpointed", "resumed"):
        if model_bytes(runs[name]["model"]) != first:
            raise AssertionError(f"mapper: the {name} run wrote other "
                                 "bytes than the first")
    model = read_model(str(runs["first"]["model"]))
    counts = model_counts(model)
    xyz = np.stack([p[0] for p in model[2].values()])
    err = model_center_errors(model, names_gt)
    share = counts["observations"] / num_keypoints
    if not (counts["images"] >= MAPPER_MIN_IMAGES and np.isfinite(xyz).all()
            and err.max() < GP_CENTER_BOUND and share >= KEYPOINT_ORACLE):
        raise AssertionError(f"mapper: {counts}, center error {err.max()}, "
                             f"keypoint share {share}")
    reports = runs["first"]["reports"]
    report = {
        "runs": {n: {"seconds": r["seconds"], "stages_s": r["stages"]}
                 for n, r in runs.items()},
        "byte_identical": ["second", "checkpointed", "resumed"],
        "resumed_from": "stage_02.npz", "out": counts,
        "center_error": {"max": float(err.max()),
                         "median": float(np.median(err))},
        "center_bound": GP_CENTER_BOUND, "keypoint_share": share,
        "keypoint_oracle": KEYPOINT_ORACLE, "launches": launches,
        "front_end": {k: reports[k] for k in (
            "preprocessing", "view graph calibration",
            "relative pose estimation") if k in reports},
        "card": card}
    return report, cases, launches


def mapper_phase(dev, card):
    """Phase 9: (report, {path: (recorded kernel inputs, launches)} of the
    card's calibration in (b) and the counted `mapper` run in (d), the
    database's path, the generator's centers by image name, its keypoint
    count and the counted run's model for phase 11)."""
    t_phase = time.perf_counter()
    db, names_gt, pair_gt, a = mapper_database(MAPPER_DIR)
    print(f"# database: {a['bytes']} bytes in {a['write_s']:.2f} s",
          file=sys.stderr)
    scene, vg, a["ingest_s"] = ingest(db)
    b, calib_cases, calib_launches = front_end_vs_cpu(scene, vg, dev)
    print(f"# front end vs CPU: {json.dumps(b)}", file=sys.stderr)
    check_front_end(b)
    c = relpose_counted(scene, vg, pair_gt, dev)
    print(f"# relpose: {c['seconds']:.2f} s, {c['chunks']} chunks, "
          f"{c['round']['launches']} launches a round", file=sys.stderr)
    d, cases, launches = mapper_command(db, names_gt, scene.num_keypoints,
                                        dev, card)
    print(f"# mapper: {d['runs']['first']['seconds']:.2f} s a run",
          file=sys.stderr)
    report = {"database": a, "front_end_vs_cpu": b, "relpose": c,
              "command": d, "phase_seconds": time.perf_counter() - t_phase}
    database = {"path": db, "names_gt": names_gt,
                "num_keypoints": scene.num_keypoints,
                "model": MAPPER_DIR / "first" / "0"}
    return report, {"view_graph_calibration": (calib_cases, calib_launches),
                    "mapper": (cases, launches)}, database


# ----------------------------------------------------------------------------
# phase 10: the partitioned solvers at the 1DSfM scale
# ----------------------------------------------------------------------------


def partitioned_problem(dev, options=None):
    """(a) The sequential capture, its tracks from stage 4 triangulated on
    the card: (BA's scene and tracks, the poses perturbed as
    tests/test_bundle_adjustment.py's _prepare does; GP's, the generator's
    poses; the generator's frame centers; report; the generator's scene,
    lifted, and view graph for phase 11)."""
    opt = SequentialCaptureOptions(**(options or PART_OPTIONS))
    t0 = time.perf_counter()
    scene, vg, _ = synthesize_sequential_dataset(opt)
    t1 = time.perf_counter()
    undistort_images(scene, device=dev)
    capture = (scene.copy(), vg)
    full = establish_full_tracks(scene, vg)
    tracks = find_tracks_for_problem(scene, full)
    t2 = time.perf_counter()
    tri.triangulate_tracks(scene, tracks, device=dev)
    t3 = time.perf_counter()
    gt_centers = scene.frame_centers()
    gp = (scene.copy(), tracks.copy())
    rng = np.random.default_rng(0)
    w = 0.01 * rng.standard_normal((scene.num_frames, 3))
    scene.frame_quat = rotm.quat_normalize(rotm.quat_mul(
        torch.from_numpy(scene.frame_quat),
        rotm.so3_exp_quat(torch.from_numpy(w)))).numpy()
    scene.frame_trans = scene.frame_trans + 0.01 * rng.standard_normal(
        scene.frame_trans.shape)
    tracks.xyz = tracks.xyz + 0.05 * rng.standard_normal(tracks.xyz.shape)
    obs = int((tracks.obs_valid & tracks.valid[tracks.obs_track]).sum())
    report = {"options": dataclasses.asdict(opt),
              "frames": scene.num_frames, "pairs": vg.num_pairs,
              "matches": vg.num_matches, "keypoints": scene.num_keypoints,
              "tracks_full": full.num_tracks, "tracks": tracks.num_tracks,
              "observations": obs, "generation_s": t1 - t0,
              "stage4_s": t2 - t1, "triangulation_s": t3 - t2}
    return (scene, tracks), gp, gt_centers, report, capture


def sum_depth_bound(O: int, parts: int) -> float:
    """The rounding depth of BA's f32 cost, torch.sum over O per-observation
    costs (bit for bit the same in every layout: elementwise kernels on
    the same values), in one layout against another: a sum over O in
    each order, or over one rank's share and then the all_reduce of the
    ranks' partials (one add a rank)."""
    return 2 * torch_sum_depth(O) + parts


def aligned_center_errors(a, b) -> np.ndarray:
    """The distances of a's centers, Sim3-aligned to b's, to b's."""
    s, R, t = umeyama_alignment(a, b)
    return np.linalg.norm(apply_sim3(s, R, t, a) - b, axis=1)


def aligned_center_gap(a, b) -> float:
    """The largest of aligned_center_errors over the span of b's."""
    return float(aligned_center_errors(a, b).max()
                 / np.linalg.norm(np.ptp(b, axis=0)))


def raw_center_gap(a, b) -> float:
    span = np.linalg.norm(np.ptp(b, axis=0))
    return float(np.linalg.norm(a - b, axis=1).max() / span)


def empty_axis_checks(dev) -> int:
    """Each reduction and gather kernel on a zero-length observation axis
    (a rank whose parts hold no observation) and on an axis of no
    segment: zeros of the right shape, as the plain version gives.
    Returns the number of inputs checked; their launches are not the
    path's."""
    saved = dict(kernels.LAUNCHES)
    f32 = dict(dtype=torch.float32, device=dev)
    none = torch.zeros(0, dtype=torch.int64, device=dev)
    cases = []
    for n_seg in (5, 0):
        axis = kernels.SegmentAxis.build(none, n_seg)
        J = torch.zeros((12, 0), **f32)
        cases += [("rowsum", (torch.zeros((3, 0), **f32), axis)),
                  ("pair_rowsum", (J, J, tba._gram_pairs(6, 6), axis)),
                  ("gather", (torch.ones((n_seg, 3), **f32), axis)),
                  ("gather_dot", (torch.ones((n_seg, 3), **f32),
                                  torch.zeros((9, 0), **f32), axis))]
    rows = [torch.zeros((k, 0), **f32) for k in (9, 9, 3, 3, 2, 16, 1)]
    cases += [("huber_irls", (torch.zeros((2, 0), **f32), 1.0,
                              torch.zeros(0, **f32))),
              ("projection_resid_jac", tuple(rows) + (None,))]
    for name, args in cases:
        got = getattr(kernels, name)(*args)
        want = _plain(name, args)
        for g, w_ in zip(got if isinstance(got, tuple) else (got,),
                         want if isinstance(want, tuple) else (want,)):
            if g.shape != w_.shape or not torch.equal(g, w_.to(g.dtype)):
                raise AssertionError(f"{name} on an empty axis: "
                                     f"{tuple(g.shape)} vs "
                                     f"{tuple(w_.shape)}")
    torch.cuda.synchronize(dev) if dev.type == "cuda" else None
    kernels.LAUNCHES.update(saved)
    return len(cases)


def part_ba_options(iters=PART_BA_ITERS):
    return BundleAdjusterOptions(max_num_iterations=iters,
                                 function_tolerance=0.0)


def cusolver_probe(dev, num_tracks: int, num_pairs: int) -> dict:
    """ROADMAP C.12: cuSOLVER's batched eigensolver on 32,768 or more
    symmetric 3x3 matrices at once (whether it raises), the split
    smallest_eigenvalues on the capture's track count, and the batched
    SVD of calibration's fetzer_coefficients on its pair count."""
    gen = torch.Generator().manual_seed(0)

    def spd(n):
        B = torch.randn((n, 3, 3), generator=gen).to(dev)
        return B @ B.transpose(1, 2)

    def runs(fn):
        try:  # the probe records the library's refusal; the port splits
            fn()
            torch.cuda.synchronize(dev)
            return "ok"
        except RuntimeError as e:
            return f"raises: {str(e)[:80]}"
    A = spd(num_tracks)
    return {"eigvalsh_16384": runs(lambda: torch.linalg.eigvalsh(
                A[:16384])),
            "eigvalsh_32768": runs(lambda: torch.linalg.eigvalsh(
                A[:32768])),
            f"smallest_eigenvalues_{num_tracks}": runs(
                lambda: tri.smallest_eigenvalues(A)),
            f"svd_{num_pairs}": runs(lambda: torch.linalg.svd(
                torch.randn((num_pairs, 3, 3), generator=gen).to(dev)))}


def part_gp_options():
    return GlobalPositionerOptions(max_num_iterations=PART_GP_ITERS)


def part_ba_run(solve, ba_input) -> dict:
    """One BA solve on copies of BA's input; its stats, scene and tracks."""
    sc, tr = ba_input[0].copy(), ba_input[1].copy()
    st = {}
    solve(sc, tr, st)
    if not np.isfinite(st.get("cost", np.nan)):
        raise AssertionError(f"phase 10: BA gave no finite cost: {st}")
    return dict(st, centers=sc.frame_centers(), xyz=tr.xyz)


def part_gp_run(solve, gp_input) -> dict:
    sc, tr = gp_input[0].copy(), gp_input[1].copy()
    st = {}
    t0 = time.perf_counter()
    if not solve(sc, tr, st):
        raise AssertionError("phase 10: GP failed")
    return dict(st, seconds=time.perf_counter() - t0,
                centers=sc.frame_centers())


def unpartitioned_runs(ba_input, gp_input, dev) -> dict:
    """(b), (c): the single-device solves, and BA's cost at the start."""
    def ba(iters):
        def solve(sc, tr, st):
            if not solve_bundle_adjustment(sc, tr, part_ba_options(iters),
                                           device=dev, stats=st):
                raise AssertionError("phase 10: BA failed")
        return solve
    return {"ba": part_ba_run(ba(PART_BA_ITERS), ba_input),
            "ba_start": part_ba_run(ba(0), ba_input),
            "gp": part_gp_run(lambda sc, tr, st: gpm.solve_global_positioning(
                sc, vgm.ViewGraph(), tr, part_gp_options(), device=dev,
                stats=st), gp_input)}


def one_rank_runs(ba_input, gp_input, dev, backend) -> tuple:
    """(b)-(d) on a world of one rank holding PART_PARTS parts (NCCL on the
    card): BA twice, which must agree bit for bit, and its cost at the
    start; GP; each counted. Then one BA and one GP LM iteration with
    every kernel input recorded. Returns (runs, cases, launches)."""
    store = PART_DIR / "store_one_rank"
    store.unlink(missing_ok=True)
    multihost.initialize(store.resolve().as_uri(), 1, 0, dev, backend)
    try:
        def ba(iters):
            def solve(sc, tr, st):
                if not solve_bundle_adjustment(
                        sc, tr, part_ba_options(iters), device=dev,
                        stats=st, num_parts=PART_PARTS):
                    raise AssertionError("phase 10: partitioned BA failed")
            return solve
        runs = {}
        # the first run counted (its first all_reduce also sets NCCL up),
        # the second timed, the third profiled
        kernels.reset_launch_counts()
        first = part_ba_run(ba(PART_BA_ITERS), ba_input)
        launches_ba = dict(kernels.LAUNCHES)
        runs["ba"] = part_ba_run(ba(PART_BA_ITERS), ba_input)
        # the busy share of the profiled run's own solve span, which
        # holds every transfer and kernel of the solve
        busy, _, prof = profiled(
            lambda: part_ba_run(ba(PART_BA_ITERS), ba_input), dev)
        dev_ms, solve_ms = device_ms(prof), busy["solve_seconds"] * 1e3
        runs["ba"]["first_run_solve_seconds"] = first["solve_seconds"]
        runs["ba"]["busy"] = {
            "device_ms": dev_ms or "not measured",
            "profiled_solve_ms": solve_ms,
            "device_busy_share": dev_ms / solve_ms if dev_ms
            else "not measured"}
        if not (first["cost"] == runs["ba"]["cost"]
                and np.array_equal(first["centers"], runs["ba"]["centers"])
                and np.array_equal(first["xyz"], runs["ba"]["xyz"])):
            raise AssertionError("phase 10: two NCCL runs of partitioned BA "
                                 "differ")
        runs["ba_start"] = part_ba_run(ba(0), ba_input)
        kernels.reset_launch_counts()
        runs["gp"] = part_gp_run(
            lambda sc, tr, st: gpm.solve_global_positioning(
                sc, vgm.ViewGraph(), tr, part_gp_options(), device=dev,
                stats=st, num_parts=PART_PARTS), gp_input)
        launches_gp = dict(kernels.LAUNCHES)
        require_launched(launches_ba, BA_KERNELS, "partitioned BA")
        require_launched(launches_gp, GP_KERNELS, "partitioned GP")
        cases = record_cases(lambda: solve_bundle_adjustment(
            ba_input[0].copy(), ba_input[1].copy(), part_ba_options(1),
            device=dev, num_parts=PART_PARTS))
        cases.update(record_cases(lambda: gpm.solve_global_positioning(
            gp_input[0].copy(), vgm.ViewGraph(), gp_input[1].copy(),
            GlobalPositionerOptions(max_num_iterations=1), device=dev,
            num_parts=PART_PARTS)))
    finally:
        multihost.shutdown()
    launches = {k: launches_ba[k] + launches_gp[k] for k in launches_ba}
    runs["launches_ba"], runs["launches_gp"] = launches_ba, launches_gp
    return runs, cases, launches


def two_rank_runs(ba_input, gp_input, dev) -> dict:
    """(b), (c) on two ranks under gloo, two processes on the one card
    (NCCL runs no two ranks on one device): each loads the problem from a
    checkpoint, runs its share and checks its results against rank 0's."""
    save_checkpoint(str(PART_DIR / "ba_problem.npz"), *ba_input[:1],
                    tracks=ba_input[1])
    save_checkpoint(str(PART_DIR / "gp_problem.npz"), *gp_input[:1],
                    tracks=gp_input[1])
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {}
    for solver, options in (
            ("ba", {"max_num_iterations": PART_BA_ITERS,
                    "function_tolerance": 0.0}),
            ("gp", {"max_num_iterations": PART_GP_ITERS})):
        ranks = dryrun.run_world(
            2, solver, PART_PARTS, PART_DIR / f"gloo_{solver}",
            device=dev, backend="gloo",
            problem=PART_DIR / f"{solver}_problem.npz", options=options,
            timeout=PART_WORLD_TIMEOUT)
        r0, r1 = ranks
        if not all(r["ok"] and r["agree"] for r in ranks) or not all(
                np.array_equal(r0[k], r1[k]) for k in (
                    "frame_quat", "frame_trans", "cam_params", "xyz")):
            raise AssertionError(f"phase 10: the two gloo ranks of {solver} "
                                 "disagree")
        scene = gp_input[0].copy() if solver == "gp" else \
            ba_input[0].copy()
        scene.frame_quat, scene.frame_trans = r0["frame_quat"], \
            r0["frame_trans"]
        out[solver] = {"cost": r0["cost"] if solver == "ba" else None,
                       "lm_iters": r0["lm_iters"],
                       "seconds": [r["seconds"] for r in ranks],
                       "stats": [r["stats"] for r in ranks],
                       "launches": [r["launches"] for r in ranks],
                       "centers": scene.frame_centers()}
    return out


def ba_summary(run, it_key="lm_iters") -> dict:
    st = {k: v for k, v in run.items() if k not in ("centers", "xyz")}
    it = run[it_key]
    out = {"cost": run["cost"], "lm_iters": it,
           "lm_iters_per_s": it / run["solve_seconds"], "stats": st}
    if "partitioned" in run:
        part = run["partitioned"]
        out["allreduce_bytes_per_lm_iter"] = part["allreduce_bytes"] / max(
            it, 1)
        out["allreduce_calls_per_lm_iter"] = part["allreduce_calls"] / max(
            it, 1)
    return out


def partitioned_phase(dev, card, options=None, backend=None):
    """Phase 10: (report, recorded kernel inputs, launches, the capture's
    generator scene, view graph and frame centers) of the partitioned
    solvers on the sequential capture. `options` and
    `backend` shrink the problem and name the one-rank world's backend
    for a CPU rehearsal; the card runs the defaults and NCCL."""
    t_phase = time.perf_counter()
    shutil.rmtree(PART_DIR, ignore_errors=True)
    PART_DIR.mkdir(parents=True)
    ba_in, gp_in, gt_centers, a, capture = partitioned_problem(dev, options)
    print(f"# partitioned problem: {a['frames']} frames, {a['pairs']} "
          f"pairs, {a['matches']} matches, {a['tracks']} tracks, "
          f"{a['observations']} observations; generated in "
          f"{a['generation_s']:.1f} s, stage 4 {a['stage4_s']:.1f} s",
          file=sys.stderr)
    if options is None and a["observations"] < 1_000_000:
        raise AssertionError(f"phase 10: {a['observations']} observations, "
                             "under 1M")
    _, obs, _ = tba.build_ba_inputs(*ba_in)
    t0 = time.perf_counter()
    plan = partition_points(*ba_in, PART_PARTS, obs["o_point"],
                            obs["o_frame"])
    a["partition_s"] = time.perf_counter() - t0
    a["cut_fraction"] = plan.cut_fraction
    del obs

    single = unpartitioned_runs(ba_in, gp_in, dev)
    one, cases, launches = one_rank_runs(ba_in, gp_in, dev, backend)
    two = two_rank_runs(ba_in, gp_in, dev)

    # BA: the cost at the shared start within the derived bound; after
    # the run within PART_BA_COST_RTOL; centers within PART_CENTER_SPAN
    u = 2.0 ** -24
    c0 = single["ba_start"]["cost"]
    start_gap = abs(one["ba_start"]["cost"] - c0)
    start_bound = sum_depth_bound(a["observations"], 1) * u * c0
    if not start_gap <= start_bound:
        raise AssertionError(f"phase 10: BA cost at the start {c0} vs "
                             f"{one['ba_start']['cost']}, gap {start_gap} "
                             f"above the derived {start_bound}")
    ref = single["ba"]
    ba = {"unpartitioned": ba_summary(ref),
          "one_rank_nccl": ba_summary(one["ba"])}
    ba["two_rank_gloo"] = {
        "cost": two["ba"]["cost"], "lm_iters": two["ba"]["lm_iters"],
        "lm_iters_per_s": [two["ba"]["lm_iters"] / s["solve_seconds"]
                           for s in two["ba"]["stats"]],
        "allreduce_bytes_per_lm_iter": [
            s["partitioned"]["allreduce_bytes"] /
            max(two["ba"]["lm_iters"], 1)
            for s in two["ba"]["stats"]],
        "stats": two["ba"]["stats"], "launches": two["ba"]["launches"]}
    for name, run in (("one_rank_nccl", one["ba"]),
                      ("two_rank_gloo", two["ba"])):
        rel = abs(run["cost"] - ref["cost"]) / ref["cost"]
        gap = aligned_center_gap(run["centers"], ref["centers"])
        ba[name].update(cost_rel=rel, center_gap_over_span=gap)
        if not (rel <= PART_BA_COST_RTOL and gap <= PART_CENTER_SPAN):
            raise AssertionError(f"phase 10: BA {name}: cost {rel} "
                                 f"relative, centers {gap} of the span")
    gp = {"unpartitioned": {k: v for k, v in single["gp"].items()
                            if k != "centers"}}
    for name, run in (("one_rank_nccl", one["gp"]),
                      ("two_rank_gloo", two["gp"])):
        gap = aligned_center_gap(run["centers"], single["gp"]["centers"])
        gp[name] = {k: v for k, v in run.items() if k != "centers"}
        prep = [s_["partitioned"]["prep_seconds"] for s_ in run["stats"]] \
            if name == "two_rank_gloo" else \
            run["partitioned"]["prep_seconds"]
        gp[name]["lm_iters_per_s_after_prep"] = (
            [run["lm_iters"] / (t - p_) for t, p_ in zip(run["seconds"],
                                                         prep)]
            if name == "two_rank_gloo"
            else run["lm_iters"] / (run["seconds"] - prep))
        gp[name]["center_gap_over_span"] = gap
        gp[name]["unaligned_center_gap_over_span"] = raw_center_gap(
            run["centers"], single["gp"]["centers"])
        if not gap <= PART_CENTER_SPAN:
            raise AssertionError(f"phase 10: GP {name}: centers {gap} of "
                                 "the span")
    err = aligned_center_errors(single["gp"]["centers"], gt_centers)
    report = {
        "problem": a, "parts": PART_PARTS, "ba": ba, "gp": gp,
        "ba_cost_at_start": {"unpartitioned": c0,
                             "one_rank_nccl": one["ba_start"]["cost"],
                             "gap_rel": start_gap / c0,
                             "derived_bound_rel": start_bound / c0},
        "ba_cost_rtol": PART_BA_COST_RTOL,
        "center_bound_over_span": PART_CENTER_SPAN,
        "gp_center_error_vs_generator": {"max": float(err.max()),
                                         "median": float(np.median(err))},
        "launches_ba": one["launches_ba"], "launches_gp": one["launches_gp"],
        "empty_axis_cases": empty_axis_checks(dev),
        "cusolver_batches": cusolver_probe(dev, a["tracks"], a["pairs"])
        if dev.type == "cuda" else "not measured",
        "nccl_bitwise_reproducible": True,
        "phase_seconds": time.perf_counter() - t_phase, "card": card}
    return report, cases, launches, (*capture, gt_centers)


# ----------------------------------------------------------------------------
# phase 11: the multi-device mapper
# ----------------------------------------------------------------------------


def _env(values: dict):
    """Set os.environ's values; returns a function that restores them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)

    def restore():
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return restore


def centers_on_generator(model, names_gt: dict) -> dict:
    """A model's image centers by name, Sim3-aligned to the generator's
    centers of the same names (umeyama_alignment)."""
    images = list(model[1].values())
    q = torch.from_numpy(np.stack([im[0] for im in images]))
    t = torch.from_numpy(np.stack([im[1] for im in images]))
    est = pose_center(q, t).numpy()
    gt = np.stack([names_gt[im[3]] for im in images])
    s, R, tr = umeyama_alignment(est, gt)
    return dict(zip([im[3] for im in images], apply_sim3(s, R, tr, est)))


def model_check(path, database) -> dict:
    """A written model against the generator: images, finite points,
    centers by image name (Sim3-aligned) and the keypoint share, with
    phase 9's oracles; raises when one fails."""
    model = read_model(str(path))
    counts = model_counts(model)
    xyz = np.stack([p[0] for p in model[2].values()])
    err = model_center_errors(model, database["names_gt"])
    share = counts["observations"] / database["num_keypoints"]
    if not (counts["images"] >= MAPPER_MIN_IMAGES and np.isfinite(xyz).all()
            and err.max() < GP_CENTER_BOUND and share >= KEYPOINT_ORACLE):
        raise AssertionError(f"phase 11: model {path}: {counts}, center "
                             f"error {err.max()}, keypoint share {share}")
    return {"counts": counts, "keypoint_share": share,
            "center_error_max": float(err.max()), "model": model}


def model_center_gap(a, b, names_gt: dict) -> float:
    """The largest distance between two models' centers of one image,
    each model Sim3-aligned to the generator's centers. Each lies within
    its own center error of the generator's, so by the triangle
    inequality the gap is at most the sum of the two errors."""
    ca, cb = centers_on_generator(a, names_gt), centers_on_generator(
        b, names_gt)
    return float(max(np.linalg.norm(ca[n] - cb[n])
                     for n in set(ca) & set(cb)))


def mesh_mapper_cli(database, dev) -> tuple:
    """(a) `mapper --distributed` on phase 9's database: a world of one
    NCCL rank set through GLOMAP_* and a file store (counted: B1-B7 must
    launch), then two gloo ranks on the one card (dryrun.run_world), each
    writing the model it computed. Returns (report, launches)."""
    root = MESH_DIR / "cli"
    restore = _env({"GLOMAP_COORDINATOR": (root / "store").resolve().as_uri(),
                    "GLOMAP_NUM_PROCESSES": "1", "GLOMAP_PROCESS_ID": "0"})
    root.mkdir(parents=True)
    try:
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc, mapper = capture_mapper(lambda: cli.main(
            ["mapper", "--distributed", "--database_path",
             str(database["path"]), "--output_path", str(root / "nccl")]))
        nccl_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
    finally:
        restore()
    if rc != 0 or torch.distributed.is_initialized():
        raise AssertionError(f"phase 11: mapper --distributed returned {rc}"
                             " or did not leave its group")
    require_launched(launches, MAPPER_KERNELS, "mapper --distributed")
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    t0 = time.perf_counter()
    ranks = dryrun.run_world(2, "mapper", 2, root / "gloo", device=dev,
                             backend="gloo", problem=database["path"],
                             timeout=MESH_WORLD_TIMEOUT)
    gloo_s = time.perf_counter() - t0
    digests = [r["stats"]["digest"] for r in ranks]
    if not (all(r["ok"] and r["agree"] for r in ranks)
            and digests[0] == digests[1]
            and model_bytes(root / "gloo" / "cli" / "0")
            == model_bytes(root / "gloo" / "rank_0" / "0")):
        raise AssertionError("phase 11: the two gloo ranks' models differ")
    one = model_check(database["model"], database)
    nccl = model_check(root / "nccl" / "0", database)
    gloo = model_check(root / "gloo" / "rank_0" / "0", database)
    gaps = {name: model_center_gap(m["model"], one["model"],
                                   database["names_gt"])
            for name, m in (("nccl", nccl), ("gloo", gloo))}
    if not max(gaps.values()) <= MESH_MODEL_CENTER_BOUND:
        raise AssertionError(f"phase 11: models against the one-device "
                             f"model: {gaps}")
    ra = mapper.reports["rotation averaging"]["passes"]
    report = {
        "one_nccl_rank": {
            "seconds": nccl_s, "stages_s": dict(mapper.timer.stages),
            "counts": nccl["counts"], "keypoint_share": nccl["keypoint_share"],
            "center_error_max": nccl["center_error_max"],
            "ra_solves": [solve_summary(s) for p in ra for s in p["solves"]],
            "ra_allreduce": [s["sharded"]["allreduce_calls"]
                             for p in ra for s in p["solves"]],
            "launches": launches},
        "two_gloo_ranks": {
            "seconds": gloo_s, "rank_seconds": [r["seconds"] for r in ranks],
            "stages_s": [r["stats"]["stages"] for r in ranks],
            "counts": gloo["counts"], "keypoint_share": gloo["keypoint_share"],
            "center_error_max": gloo["center_error_max"],
            "models_byte_identical": True},
        "one_device_center_error_max": one["center_error_max"],
        "center_gap_to_one_device": gaps,
        "center_gap_bound": MESH_MODEL_CENTER_BOUND}
    return report, launches


def capture_mapper_options(parts=None) -> GlobalMapperOptions:
    """(b) stages 3-6 on the capture (stages 0-2 skipped: the generator's
    two-view geometry; stage 7 is (a)'s), with the JAX package's dry-run
    budget for BA: one round of MESH_BA_ITERS LM iterations, here with no
    early exit, and GP to its function tolerance (phase 10's cap): runs
    that add in other orders stop alike only then, and the default GP cap
    of 100 cut both short (a frame left without observations in one of
    them). Stage 3 runs through the controller's method before solve, so
    solve skips it."""
    opt = GlobalMapperOptions(
        skip_preprocessing=True, skip_view_graph_calibration=True,
        skip_relative_pose_estimation=True, skip_rotation_averaging=True,
        skip_retriangulation=True, num_iteration_bundle_adjustment=1)
    opt.opt_ba.max_num_iterations = MESH_BA_ITERS
    opt.opt_ba.function_tolerance = 0.0
    opt.opt_gp.max_num_iterations = PART_GP_ITERS
    opt.device_mesh_shape = (parts,) if parts else None
    return opt


def capture_run(capture, dev, parts=None, record=False) -> dict:
    """(b) One run of stages 3-6 on the capture from the identity, with
    device_mesh_shape=(parts,) or on one device; the counts zeroed before
    stage 3 and read after stage 6; with `record`, stage 3's kernel
    inputs."""
    scene0, vg0 = capture
    sc, g = scene0.copy(), vg0.copy()
    sc.frame_quat[:] = [1.0, 0.0, 0.0, 0.0]
    sc.frame_trans[:] = 0.0
    mapper = GlobalMapper(capture_mapper_options(parts), device=dev)
    ok = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stage3 = (lambda: ok.update(ok=mapper.rotation_averaging(sc, g)))
    cases = record_cases(stage3) if record else stage3()
    t1 = time.perf_counter()
    tracks = mapper.solve(sc, g) if ok["ok"] else None
    t2 = time.perf_counter()
    launches = dict(kernels.LAUNCHES)
    if tracks is None:
        raise AssertionError(f"phase 11: stages 3-6 failed (parts {parts})")
    return {"scene": sc, "tracks": tracks, "mapper": mapper,
            "cases": cases if record else {}, "launches": launches,
            "stage3_s": t1 - t0, "stages_4_6_s": t2 - t1}


def capture_summary(run, gt_quat, gt_centers) -> dict:
    sc, mapper = run["scene"], run["mapper"]
    reg = sc.frame_registered
    errs = pairwise_errors_deg(sc.frame_quat[reg], gt_quat[reg],
                               sample=20000)
    rep = mapper.reports
    gp = rep["global positioning"]["gp"]
    ba = rep["bundle adjustment"]["ba"]
    out = {"stage3_s": run["stage3_s"], "stages_4_6_s": run["stages_4_6_s"],
           "stages_s": dict(mapper.timer.stages),
           "registered_frames": int(reg.sum()),
           "rotation_error_deg_sampled": {"max": float(errs.max()),
                                          "median": float(np.median(errs))},
           "center_gap_to_generator_over_span": aligned_center_gap(
               sc.frame_centers()[reg], gt_centers[reg]),
           "ra_solves": [solve_summary(s) for p in rep["rotation averaging"]
                         ["passes"] for s in p["solves"]],
           "gp_lm_iters": gp.get("lm_iters"),
           "gp_lm_iters_per_s": gp["lm_iters"] / gp["seconds"],
           "ba": [{"lm_iters": b["lm_iters"],
                   "lm_iters_per_s": b["lm_iters"] / b["solve_seconds"],
                   "cost": b["cost"]} for b in ba],
           "launches": run["launches"]}
    if not errs.max() < RA_MAX_DEG:
        raise AssertionError(f"phase 11: capture rotations {errs.max()} deg "
                             "from the generator's")
    if mapper.num_parts:
        ra = [s["sharded"] for p in rep["rotation averaging"]["passes"]
              for s in p["solves"]]
        sweeps = [s["l1_irls_sweeps"] + s["irls_sweeps"]
                  for s in out["ra_solves"]]
        out["ra_allreduce"] = [
            {"calls": s["allreduce_calls"], "bytes": s["allreduce_bytes"],
             "calls_per_sweep": s["allreduce_calls"] / max(n, 1),
             "parts": s["parts"], "locality": s["locality"]}
            for s, n in zip(ra, sweeps)]
        out["gp_allreduce"] = {
            k: gp["partitioned"][k] for k in ("allreduce_calls",
                                              "allreduce_bytes")}
        out["ba_allreduce_per_lm_iter"] = [
            {"calls": b["partitioned"]["allreduce_calls"] / max(
                b["lm_iters"], 1),
             "bytes": b["partitioned"]["allreduce_bytes"] / max(
                 b["lm_iters"], 1)} for b in ba]
    return out


def sharded_ba_runs(run, dev) -> tuple:
    """The replicated-point BA (parallel/sharded_ba.py) on (b)'s result,
    MESH_SHARDED_BA_ITERS LM iterations with no early exit, in the world
    of one NCCL rank holding MESH_PARTS blocks (counted), against the
    same solve with no process group (one block, no hook); then one LM
    iteration with every kernel input recorded. Returns (report, cases,
    launches); the solve with no group runs before the world is joined,
    see mesh_phase."""
    sc, tr = run["scene"], run["tracks"]
    opts = part_ba_options(MESH_SHARDED_BA_ITERS)
    st = {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cost, it = solve_ba_sharded(sc.copy(), tr.copy(), opts, MESH_PARTS,
                                device=dev, stats=st)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require_launched(launches, BA_KERNELS, "sharded BA")
    cases = record_cases(lambda: solve_ba_sharded(
        sc.copy(), tr.copy(), part_ba_options(1), MESH_PARTS, device=dev))
    return {"cost": cost, "lm_iters": it, "seconds": seconds,
            "lm_iters_per_s": it / seconds, **st["sharded"],
            "allreduce_calls_per_lm_iter": st["sharded"]["allreduce_calls"]
            / max(it, 1),
            "allreduce_bytes_per_lm_iter": st["sharded"]["allreduce_bytes"]
            / max(it, 1), "launches": launches}, cases, launches


def sharded_city(dev) -> tuple:
    """(c) The city graph (phase 8 (d)'s, the CG route) through
    solve_rotations_sharded in MESH_PARTS parts on the world of one NCCL
    rank: counted and recorded (B2, B3). (report, cases, launches, the
    graph and its rotations)."""
    fi, fj, q_rel, q_gt = rotation_graph(**CITY_GRAPH)
    scene, vg = graph_scene(fi, fj, q_rel, CITY_GRAPH["frames"])
    st, ok = {}, {}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    cases = record_cases(lambda: ok.update(ok=solve_rotations_sharded(
        scene, vg, num_parts=MESH_PARTS, device=dev, stats=st)))
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if not ok["ok"] or st["path"] != "cg":
        raise AssertionError(f"phase 11: sharded city graph: ok {ok['ok']}")
    require_launched(launches, RA_KERNELS, "sharded city graph")
    errs = pairwise_errors_deg(scene.frame_quat, q_gt, sample=2000)
    if not errs.max() < CITY_MAX_DEG:
        raise AssertionError(f"phase 11: sharded city graph: sampled "
                             f"pairwise error max {errs.max()} deg")
    summary = solve_summary(st)
    sweeps = summary["l1_irls_sweeps"] + summary["irls_sweeps"]
    return {"seconds": seconds, "sweeps_per_s": sweeps / seconds, **summary,
            "sharded": st["sharded"],
            "allreduce_calls_per_sweep": st["sharded"]["allreduce_calls"]
            / max(sweeps, 1),
            "pairwise_error_deg_sampled": {"max": float(errs.max()),
                                           "median": float(np.median(errs))},
            "launches": launches}, cases, launches, \
        (scene, vg, scene.frame_quat.copy())


def sharded_component_gloo(dev) -> dict:
    """(c) The component graph (phase 8 (c)'s 2,000 frames, the dense
    ADMM route) through solve_rotations_sharded on two gloo ranks on the
    one card: the same bits on both ranks, and within MESH_RA_RAD of
    estimate_rotations on the card (phase 8 (c) holds that solve to the
    generator's oracle)."""
    fi, fj, q_rel, q_gt = rotation_graph(**COMPONENT_GRAPH)
    scene, vg = graph_scene(fi, fj, q_rel, COMPONENT_GRAPH["frames"])
    problem = MESH_DIR / "component.npz"
    save_checkpoint(str(problem), scene, vg)
    one = scene.copy()
    if not estimate_rotations(one, vg, device=dev):
        raise AssertionError("phase 11: component graph on one device "
                             "failed")
    t0 = time.perf_counter()
    ranks = dryrun.run_world(2, "ra", 2, MESH_DIR / "gloo_ra", device=dev,
                             backend="gloo", problem=problem,
                             timeout=MESH_WORLD_TIMEOUT)
    seconds = time.perf_counter() - t0
    r0, r1 = ranks
    if not (all(r["ok"] and r["agree"] for r in ranks)
            and np.array_equal(r0["frame_quat"], r1["frame_quat"])):
        raise AssertionError("phase 11: the two gloo ranks' rotations "
                             "differ")
    gap = quat_angle_diff(r0["frame_quat"], one.frame_quat)
    if not gap <= MESH_RA_RAD:
        raise AssertionError(f"phase 11: component graph on two ranks "
                             f"{gap} rad from the one-device solve")
    errs = pairwise_errors_deg(r0["frame_quat"], q_gt, sample=2000)
    st = r0["stats"]
    summary = solve_summary(st)
    sweeps = summary["l1_irls_sweeps"] + summary["irls_sweeps"]
    return {"seconds": seconds, "rank_seconds": [r["seconds"] for r in ranks],
            **summary, "sharded": [r["stats"]["sharded"] for r in ranks],
            "allreduce_calls_per_sweep": st["sharded"]["allreduce_calls"]
            / max(sweeps, 1),
            "rotation_gap_to_one_device_rad": gap,
            "rotation_gap_bound_rad": MESH_RA_RAD,
            "pairwise_error_deg_sampled": {"max": float(errs.max()),
                                           "median": float(np.median(errs))},
            "bitwise_identical_ranks": True,
            "launches": [r["launches"] for r in ranks]}


def mesh_phase(database, capture, dev, card):
    """Phase 11 on phase 9's database and phase 10's capture (its
    generator scene, view graph and frame centers): (report, {path:
    (recorded kernel inputs, launches)})."""
    t_phase = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    *capture, gt_centers = capture
    gt_quat = capture[0].frame_quat.copy()

    a, launches_a = mesh_mapper_cli(database, dev)
    print(f"# phase 11 (a): mapper --distributed "
          f"{a['one_nccl_rank']['seconds']:.1f} s on one NCCL rank, "
          f"{a['two_gloo_ranks']['seconds']:.1f} s on two gloo ranks",
          file=sys.stderr)

    one = capture_run(capture, dev)
    # the replicated-point BA's reference: one block, no process group
    t0 = time.perf_counter()
    ref_cost, ref_it = solve_ba_sharded(
        one["scene"].copy(), one["tracks"].copy(),
        part_ba_options(MESH_SHARDED_BA_ITERS), 1, device=dev)
    ref_s = time.perf_counter() - t0
    store = MESH_DIR / "store_one_rank"
    multihost.initialize(store.resolve().as_uri(), 1, 0, dev)
    try:
        mesh = capture_run(capture, dev, MESH_PARTS, record=True)
        sba, sba_cases, sba_launches = sharded_ba_runs(one, dev)
        c, city_cases, city_launches, city = sharded_city(dev)
    finally:
        multihost.shutdown()
    b = {"one_device": capture_summary(one, gt_quat, gt_centers),
         "mesh": capture_summary(mesh, gt_quat, gt_centers)}
    reg = mesh["scene"].frame_registered & one["scene"].frame_registered
    b["frames_registered_in_one_run_only"] = int(
        (mesh["scene"].frame_registered != one["scene"].frame_registered)
        .sum())
    b["rotation_gap_mesh_vs_one_device_rad"] = quat_angle_diff(
        mesh["scene"].frame_quat[reg], one["scene"].frame_quat[reg])
    b["center_gap_mesh_vs_one_device_over_span"] = aligned_center_gap(
        mesh["scene"].frame_centers()[reg], one["scene"].frame_centers()[reg])
    gap = b["center_gap_mesh_vs_one_device_over_span"]
    if not gap <= PART_CENTER_SPAN:
        raise AssertionError(f"phase 11: stages 3-6 on 4 parts against one "
                             f"device: centers {gap} of the span")
    require_launched(mesh["launches"], BA_KERNELS, "stages 3-6 on 4 parts")
    sba["cost_rel_to_one_block"] = abs(sba["cost"] - ref_cost) / ref_cost
    if not sba["cost_rel_to_one_block"] <= PART_BA_COST_RTOL:
        raise AssertionError(f"phase 11: replicated-point BA cost "
                             f"{sba['cost_rel_to_one_block']} relative to "
                             "one block")
    sba["one_block"] = {"cost": ref_cost, "lm_iters": ref_it,
                        "seconds": ref_s}
    b["sharded_ba"] = sba
    print(f"# phase 11 (b): stages 3-6 {b['mesh']['stages_4_6_s']:.1f} s "
          f"on 4 parts, {b['one_device']['stages_4_6_s']:.1f} s on one "
          f"device", file=sys.stderr)
    # the city graph unsharded, for comparison
    scene, vg, q_sharded = city
    sc = scene.copy()
    t0 = time.perf_counter()
    if not estimate_rotations(sc, vg, device=dev):
        raise AssertionError("phase 11: unsharded city graph failed")
    c["unsharded_seconds"] = time.perf_counter() - t0
    c["rotation_gap_to_unsharded_rad"] = quat_angle_diff(q_sharded,
                                                         sc.frame_quat)
    if not c["rotation_gap_to_unsharded_rad"] <= MESH_RA_RAD:
        raise AssertionError(f"phase 11: sharded city graph "
                             f"{c['rotation_gap_to_unsharded_rad']} rad "
                             "from the unsharded solve")
    c = {"city_one_nccl_rank": c,
         "component_two_gloo_ranks": sharded_component_gloo(dev)}
    print(f"# phase 11 (c): city graph "
          f"{c['city_one_nccl_rank']['seconds']:.1f} s sharded, "
          f"component graph {c['component_two_gloo_ranks']['seconds']:.1f} "
          "s on two gloo ranks", file=sys.stderr)
    report = {"parts": MESH_PARTS, "mapper_cli": a, "capture_stages_3_6": b,
              "sharded_ra": c,
              "phase_seconds": time.perf_counter() - t_phase, "card": card}
    return report, {
        "mesh_mapper": ({}, launches_a),
        "mesh_capture": (mesh["cases"], mesh["launches"]),
        "sharded_ba": (sba_cases, sba_launches),
        "sharded_ra": (city_cases, city_launches)}


# ----------------------------------------------------------------------------
# phase 12: B8 on tiles of the loop's stage 2
# ----------------------------------------------------------------------------


class _TilesRecorded(Exception):
    """Ends the loop's mapper once both tiles are recorded."""


def loop_stage2_tiles() -> dict:
    """{"first": args, "tail": args} of ransac_chunk in the `mapper` run
    of the benchmark's loop cell at RANSAC_SEED, copied: its first call
    (the first tile of the first chunk) and its first call on fewer than
    RANSAC_TAIL_PAIRS pairs, where the run stops; or, where no chunk gets
    that small, the first of its calls on the fewest pairs."""
    from sfm_bench.gen.inputs import make_inputs
    from sfm_bench.run import load_cell
    shutil.rmtree(RANSAC_DIR, ignore_errors=True)
    _, config, traffic = load_cell(RANSAC_CELL)
    inputs = make_inputs(config, traffic, RANSAC_SEED,
                         str(RANSAC_DIR / "input"))
    tiles = {}
    original = kernels.ransac_chunk

    def recorded(us, *args):
        label = "first" if not tiles else "tail"
        if label not in tiles or us.shape[1] < tiles[label][0].shape[1]:
            tiles[label] = tuple(a.clone() for a in (us, *args))
        if tiles["tail" if "tail" in tiles else "first"][0].shape[1] < \
                RANSAC_TAIL_PAIRS and len(tiles) == 2:
            raise _TilesRecorded
        return original(us, *args)
    kernels.ransac_chunk = recorded
    try:
        rc = cli.main([*inputs.argv, "--output_path",
                       str(RANSAC_DIR / "out")])
        if rc != 0 or len(tiles) < 2:
            raise AssertionError(f"ransac: the loop's mapper returned {rc} "
                                 f"after {len(tiles)} recorded tile(s)")
    except _TilesRecorded:
        pass
    finally:
        kernels.ransac_chunk = original
    shutil.rmtree(RANSAC_DIR, ignore_errors=True)
    return tiles


def ransac_work(R: int, P: int, H: int, cap: int) -> tuple:
    """(bytes, f32 operations) of one B8 launch: the draws, each pair's
    table and mask once, its count, threshold and best in and out; the
    solves, the scores and each block's lift."""
    nbytes = P * (R * 2 * H * 8 + 6 * cap * 4 + cap + 8 + 4 + 2 * (36 + 8))
    ops = P * R * (H * (RANSAC_SOLVE_OPS + cap * RANSAC_SLOT_OPS)
                   + cap * RANSAC_LIFT_OPS)
    return nbytes, ops


def count_agreement(c, ref) -> dict:
    """How far best counts c lie from ref's, pair by pair."""
    d = (c - ref).abs()
    return {"equal_share": float((d == 0).float().mean()),
            "differ": int((d > 0).sum()), "differ_over_2": int((d > 2).sum()),
            "diff_max": int(d.max()), "sum": int(c.sum()),
            "ref_sum": int(ref.sum())}


def reversed_draws(u, counts):
    """Draws whose 8 samples are u's in reverse order (base b + 7 s, step
    n - s): the same slots in another Gram sum."""
    n = torch.clamp(counts, min=1)[:, None]
    b = u[:, 0] % n
    s = 1 + u[:, 1] % torch.clamp(n - 1, min=1)
    return torch.stack([(b + 7 * s) % n, (n - s - 1) % torch.clamp(
        n - 1, min=1)], 1)


def ransac_tie_check(args) -> dict:
    """B8 on round 0's draws and on their reverse, alone and as one chunk
    in both orders: the chunk's count is the larger, and a pair whose two
    rounds tie keeps the earlier round's E."""
    us, tab6, mask, counts, thr, E0, c0 = args
    u0 = us[0]
    u1 = reversed_draws(u0, counts)
    Ea, ca = kernels.ransac_chunk(u0[None], tab6, mask, counts, thr, E0, c0)
    Eb, cb = kernels.ransac_chunk(u1[None], tab6, mask, counts, thr, E0, c0)
    tie = (ca == cb) & (ca > c0)
    for first, E_first in ((u0, Ea), (u1, Eb)):
        second = u1 if first is u0 else u0
        E, c = kernels.ransac_chunk(torch.stack([first, second]), tab6, mask,
                                    counts, thr, E0, c0)
        ok = (torch.equal(c, torch.maximum(torch.maximum(ca, cb), c0))
              and torch.equal(E[tie], E_first[tie])
              and torch.equal(E[ca > cb], Ea[ca > cb])
              and torch.equal(E[cb > ca], Eb[cb > ca]))
        if not ok:
            raise AssertionError("ransac: a tie across rounds did not keep "
                                 "the earlier round, or a count was lost")
    return {"ties": int(tie.sum()),
            "ties_with_other_E": int((tie & (Ea != Eb).flatten(1).any(1)
                                      ).sum())}


def ransac_case(label, args, peak_bw, peak_flops, timed=True) -> dict:
    """B8 against its plain version (f32, on the card) and the plain
    version in f64 (the same f32 tables): launches, bit-for-bit repeats,
    the best counts' agreement, and, where timed, device ms (a CUDA graph
    of launches), the plain chain's ms (CUDA events; and its summed
    kernel time and launches under the profiler) and the bound."""
    us, tab6, mask, counts, thr, E0, c0 = args
    R, P, _, H = us.shape
    cap = tab6.shape[2]
    before = kernels.LAUNCHES["ransac"]
    E_k, c_k = kernels.ransac_chunk(*args)
    launches = kernels.LAUNCHES["ransac"] - before
    E_k2, c_k2 = kernels.ransac_chunk(*args)
    if launches != 1 or not (torch.equal(E_k, E_k2)
                             and torch.equal(c_k, c_k2)):
        raise AssertionError(f"ransac {label}: {launches} launches, or two "
                             "launches differ")
    unmasked = mask.sum(1)
    if not bool(((c_k >= c0) & (c_k <= torch.maximum(unmasked, c0))).all()):
        raise AssertionError(f"ransac {label}: a best count out of range")
    _, c_p = kernels.ransac_chunk_plain(*args)
    _, c_d = kernels.ransac_chunk_plain(us, tab6.double(), mask, counts,
                                        thr.double(), E0.double(), c0)
    out = {"label": label, "pairs": P, "rounds": R, "hypotheses": H,
           "cap": cap, "launches": launches, "bitwise_reproducible": True,
           "vs_plain": count_agreement(c_k, c_p),
           "vs_f64": count_agreement(c_k, c_d),
           "plain_vs_f64": count_agreement(c_p, c_d)}
    b8, plain = out["vs_f64"], out["plain_vs_f64"]
    f64_sum = b8["ref_sum"]
    if (b8["differ"] > plain["differ"] + RANSAC_DIFFER_SLACK * P
            or abs(b8["sum"] - f64_sum) > abs(plain["sum"] - f64_sum)
            + RANSAC_SUM_SLACK * f64_sum):
        raise AssertionError(f"ransac {label}: B8 lies farther from the f64 "
                             f"chain than the plain f32 chain does: {out}")
    if timed:
        saved = dict(kernels.LAUNCHES)  # timing launches are not the path's
        out["ms"] = graph_ms(lambda: kernels.ransac_chunk(*args), reps=10,
                             replays=3)
        kernels.LAUNCHES.update(saved)
        out["plain_ms"] = _events_ms(
            lambda: kernels.ransac_chunk_plain(*args), reps=3)
        _, _, prof = profiled(lambda: kernels.ransac_chunk_plain(*args))
        out["plain_device_ms"] = device_ms(prof) or "not measured"
        out["plain_launches"] = len(device_events(prof))
        nbytes, ops = ransac_work(R, P, H, cap)
        t_bytes, t_ops = nbytes / peak_bw * 1e3, ops / peak_flops * 1e3
        out.update(bytes=nbytes, operations=ops,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   hypotheses_per_s=R * P * H / out["ms"] * 1e3)
    return out


def ransac_phase(peak_bw, peak_flops) -> dict:
    """Phase 12: B8 on the loop's first and tail tiles (timed), the tail
    tile cut to RANSAC_SHORT_CAP slots with odd pairs at half as many
    distinct slots and masked on a third, from a zero best (checked), and
    the tie rule."""
    t_phase = time.perf_counter()
    tiles = loop_stage2_tiles()
    record_s = time.perf_counter() - t_phase
    torch.cuda.empty_cache()
    cases = [ransac_case(k, tiles[k], peak_bw, peak_flops)
             for k in ("first", "tail")]
    us, tab6, mask, counts, thr, E0, c0 = tiles["tail"]
    short_counts = torch.clamp(counts, max=RANSAC_SHORT_CAP)
    short_counts[1::2] = torch.clamp(short_counts[1::2],
                                     max=RANSAC_SHORT_CAP // 2)
    short_mask = mask[:, :RANSAC_SHORT_CAP].clone()
    short_mask[1::2, ::3] = False
    short = (us, tab6[:, :, :RANSAC_SHORT_CAP].contiguous(), short_mask,
             short_counts, thr, torch.zeros_like(E0), torch.zeros_like(c0))
    cases.append(ransac_case(f"tail at cap {RANSAC_SHORT_CAP}", short,
                             peak_bw, peak_flops, timed=False))
    ties = ransac_tie_check(tiles["first"])
    for c in cases:
        print(f"# ransac {c['label']}: {c['pairs']} pairs, "
              f"vs plain {c['vs_plain']}, vs f64 {c['vs_f64']}, plain vs "
              f"f64 {c['plain_vs_f64']}, ms {c.get('ms')} (plain "
              f"{c.get('plain_ms')})", file=sys.stderr)
    return {"cell": RANSAC_CELL, "seed": RANSAC_SEED, "cases": cases,
            "tie_check": ties, "record_seconds": record_s,
            "phase_seconds": time.perf_counter() - t_phase}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    peak_bw, peak_flops = next((v for k, v in PEAKS.items() if k in kind),
                               PEAKS["H100"])

    # phase 1: device and build
    print(f"# card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    rep = _build.build()
    for n, out in rep["ptxas"].items():
        used = [ln.split("info    :")[-1].strip() for ln in out.splitlines()
                if "Used" in ln]
        print(f"# ptxas {n}: {'; '.join(used)}", file=sys.stderr)
    print(f"# kernels built in {rep['seconds']:.2f} s", file=sys.stderr)

    # phase 2: record each kernel's inputs on one LM iteration, then check
    # and time every one of them
    inputs = load_bench(dev)
    cost0 = float(solve(inputs, 0)[4])
    cases = record_cases(lambda: solve(inputs, 1))
    torch.cuda.synchronize()
    gen = torch.Generator().manual_seed(0)
    per_kernel = {n: ([], []) for n in BA_KERNELS}
    for (name, *_), (args, calls) in cases.items():
        res = measure_case(name, args, gen, peak_bw, peak_flops)
        per_kernel[name][0].append(res)
        per_kernel[name][1].append(calls)
    proj_args = next(a for (n, *_), (a, _) in cases.items()
                     if n == "projection_resid_jac")
    res = measure_case("projection_resid_jac",
                       projection_kinds_rig_args(proj_args, gen), gen,
                       peak_bw, peak_flops, on_path=False)
    per_kernel["projection_resid_jac"][0].append(res)
    per_kernel["projection_resid_jac"][1].append(0)
    for args in gather_extra_cases(cases, gen):
        per_kernel["gather"][0].append(measure_case(
            "gather", args, gen, peak_bw, peak_flops, on_path=False))
        per_kernel["gather"][1].append(0)
    offset_checked = offset_invariance(cases, gen)
    del cases
    # estimated device time of the four kernels in one LM iteration
    kernel_ms_per_iter = sum(c["ms"] * w for cs, ws in per_kernel.values()
                             for c, w in zip(cs, ws))

    # phase 3: the main path, counted; then two more timed runs (the
    # step is bound by the host, whose clock varies more than the card's)
    kernels.reset_launch_counts()
    out, seconds = None, []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run = solve(inputs, LM_ITERS)
        cost = float(run[4])  # host read: waits for the card
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if out is None:
            out, launches = run, dict(kernels.LAUNCHES)
    if not all(launches[COUNTER.get(n, n)] > 0 for n in BA_KERNELS):
        raise AssertionError(f"a BA kernel was not launched: {launches}")
    cost = float(out[4])
    if out[5] != LM_ITERS or not math.isfinite(cost) or not cost < cost0:
        raise AssertionError(f"slice: {out[5]} iterations, cost {cost} "
                             f"from {cost0}")
    for k, v in _params(out).items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"slice: non-finite {k}")

    # the card against the CPU's plain path (f32, and f64 for scale), and
    # against itself
    cuda_a = solve(inputs, CPU_ITERS)
    cuda_b = solve(inputs, CPU_ITERS)
    for x, y in zip(cuda_a[:8], cuda_b[:8]):
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        if not same:
            raise AssertionError("two runs on the card differ")
    t_cpu = time.perf_counter()
    cpu = solve(load_bench("cpu"), CPU_ITERS)
    t_cpu = time.perf_counter() - t_cpu
    diffs = compare_runs(cuda_a, cpu, "card vs CPU f32")
    diffs64 = compare_runs(cuda_a, solve(load_bench("cpu", torch.float64),
                                         CPU_ITERS), "card vs CPU f64")

    # the user's entry point on the same problem as a Scene and Tracks
    scene, tracks = bench_scene()
    kernels.reset_launch_counts()
    if not solve_bundle_adjustment(
            scene, tracks, BundleAdjusterOptions(
                max_num_iterations=CPU_ITERS, function_tolerance=0.0),
            dtype=torch.float32, device=dev):
        raise AssertionError("solve_bundle_adjustment failed")
    entry_launches = dict(kernels.LAUNCHES)
    if not all(entry_launches[COUNTER.get(n, n)] > 0 for n in BA_KERNELS):
        raise AssertionError(f"entry point: a kernel was not launched: "
                             f"{entry_launches}")
    entry = [torch.from_numpy(a) for a in (
        scene.frame_quat, scene.frame_trans, scene.cam_params, tracks.xyz)]
    entry_diffs = compare_runs(tuple(entry) + cuda_a[4:], cuda_a,
                               "solve_bundle_adjustment vs _solve_ba")

    # phase 4: the inlier sweep at Gerrard-Hall scale
    thr = InlierThresholds()
    scene, vg, gen_s = sweep_problem()
    M, P, K = vg.num_matches, vg.num_pairs, scene.num_keypoints
    print(f"# sweep scene: M={M} P={P} K={K}, generated in {gen_s:.2f} s",
          file=sys.stderr)
    undistort_images(scene, device=dev)
    sweep_cases = record_cases(
        lambda: pair_inliers.image_pairs_inlier_count(scene, vg.copy(),
                                                      thr, device=dev))
    torch.cuda.synchronize()
    per_sweep = {n: ([], []) for n in SWEEP_KERNELS}
    for (name, *_), (args, calls) in sweep_cases.items():
        res = measure_case(name, args, gen, peak_bw, peak_flops)
        per_sweep[name][0].append(res)
        per_sweep[name][1].append(calls)

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    runs = [run_sweep(scene, vg, dev)]
    sweep_launches = dict(kernels.LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    runs += [run_sweep(scene, vg, dev) for _ in range(2)]
    n_chunks = len(pair_inliers._chunk_bounds(
        vg.pair_match_offset, P, M, pair_inliers._SWEEP_CHUNK_MATCHES)) - 1
    if sweep_launches["sampson"] != 2 * n_chunks or not all(
            sweep_launches[COUNTER.get(n, n)] > 0 for n in SWEEP_KERNELS):
        raise AssertionError(f"sweep: launches {sweep_launches} for "
                             f"{n_chunks} chunk(s)")
    if not all(same_sweep(runs[0], r) for r in runs[1:]):
        raise AssertionError("sweep: two runs on the card differ")
    one_shot = pair_inliers._SWEEP_CHUNK_MATCHES
    try:
        pair_inliers._SWEEP_CHUNK_MATCHES = -(-M // 3)
        chunked = run_sweep(scene, vg, dev)
    finally:
        pair_inliers._SWEEP_CHUNK_MATCHES = one_shot
    if not same_sweep(runs[0], chunked):
        raise AssertionError("sweep: chunks of ceil(M/3) differ from one "
                             "shot")
    # the CPU's plain path on the same rays (the card's lift)
    cpu = run_sweep(scene, vg, torch.device("cpu"), lift=False)
    disagree = sweep_disagreements(runs[0], cpu, sweep_cases, thr)
    print(f"# sweep: {disagree['matches']} matches classified differently "
          "on the card and the CPU (f32)", file=sys.stderr)
    del sweep_cases
    # the rest of stage 2 on the card's result
    vg_f, scene_f = runs[0][0].copy(), scene.copy()
    removed = {
        "inlier_num": relpose_filter.filter_inlier_num(vg_f,
                                                       thr.min_inlier_num),
        "inlier_ratio": relpose_filter.filter_inlier_ratio(
            vg_f, thr.min_inlier_ratio)}
    valid_before = int(vg_f.pair_valid.sum())
    component = vg_f.keep_largest_connected_component(scene_f)
    removed["largest_component"] = valid_before - int(vg_f.pair_valid.sum())
    if component == 0:
        raise AssertionError("sweep: no connected component left")
    inl = runs[0][0].match_inlier
    if not (0.0 < inl.mean() < 1.0 and np.isfinite(runs[0][1]).all()):
        raise AssertionError("sweep: degenerate classification")

    # phase 5: stages 4-6 from the filtered sweep result
    stages, per_stage, stage_launches, final, gt_centers = stages_phase(
        scene_f, vg_f, dev, gen, peak_bw, peak_flops)

    stage7_input = (final[0].copy(), final[1].copy())

    # phase 6: mapper_resume through the CLI on stage 6's result
    resume, resume_cases, resume_launches = mapper_resume_phase(
        *final, gt_centers, dev, card)
    per_stage["mapper_resume"] = {n: ([], []) for n in BA_KERNELS}
    for (name, *_), (args, calls) in resume_cases.items():
        res = measure_case(name, args, gen, peak_bw, peak_flops)
        per_stage["mapper_resume"][name][0].append(res)
        per_stage["mapper_resume"][name][1].append(calls)
    stage_launches["mapper_resume"] = resume_launches
    del resume_cases

    # phase 7: stage 7 on stage 6's result (copied before phase 6)
    retri, retri_cases, retri_launches = retriangulation_phase(
        *stage7_input, vg_f, scene_f, gt_centers, dev)
    per_stage["retriangulation"] = {n: ([], []) for n in BA_KERNELS}
    for (name, *_), (args, calls) in retri_cases.items():
        res = measure_case(name, args, gen, peak_bw, peak_flops)
        per_stage["retriangulation"][name][0].append(res)
        per_stage["retriangulation"][name][1].append(calls)
    stage_launches["retriangulation"] = retri_launches
    del retri_cases

    # phase 8: stage 3, gravity priors, the rotation_averager command and
    # the CG path beyond the dense ceiling, on phase 4's filtered scene
    ra, ra_cases, ra_launches = rotation_phase(scene_f, vg_f, gt_centers,
                                               dev)
    per_stage["rotation_averaging"] = {n: ([], []) for n in RA_KERNELS}
    for (name, *_), (args, calls) in ra_cases.items():
        res = measure_case(name, args, gen, peak_bw, peak_flops)
        per_stage["rotation_averaging"][name][0].append(res)
        per_stage["rotation_averaging"][name][1].append(calls)
    stage_launches["rotation_averaging"] = ra_launches
    del ra_cases

    # phase 9: the mapper command from a COLMAP database of the sweep scene
    mapper, mapper_paths, database = mapper_phase(dev, card)
    for path, (path_cases, path_launches) in mapper_paths.items():
        per_stage[path] = {n: ([], []) for n in MAPPER_KERNELS
                           if path == "mapper"
                           or any(k[0] == n for k in path_cases)}
        for (name, *_), (args, calls) in path_cases.items():
            res = measure_case(name, args, gen, peak_bw, peak_flops)
            per_stage[path][name][0].append(res)
            per_stage[path][name][1].append(calls)
        stage_launches[path] = path_launches
    del mapper_paths

    # phase 10: the partitioned solvers on the sequential capture
    part, part_cases, part_launches, capture = partitioned_phase(dev, card)
    per_stage["partitioned"] = {n: ([], []) for n in BA_KERNELS}
    for (name, *_), (args, calls) in part_cases.items():
        res = measure_case(name, args, gen, peak_bw, peak_flops)
        per_stage["partitioned"][name][0].append(res)
        per_stage["partitioned"][name][1].append(calls)
    stage_launches["partitioned"] = part_launches
    del part_cases

    # phase 11: the multi-device mapper: the CLI on phase 9's database,
    # stages 3-6 on phase 10's capture in 4 parts, the sharded RA
    mesh, mesh_paths = mesh_phase(database, capture, dev, card)
    del capture
    for path, (path_cases, path_launches) in mesh_paths.items():
        per_stage[path] = {n: ([], []) for n in MAPPER_KERNELS
                           if any(k[0] == n for k in path_cases)}
        for (name, *_), (args, calls) in path_cases.items():
            res = measure_case(name, args, gen, peak_bw, peak_flops)
            per_stage[path][name][0].append(res)
            per_stage[path][name][1].append(calls)
        stage_launches[path] = path_launches
    del mesh_paths

    # phase 12: B8 on tiles of the benchmark's loop cell at seed 1
    ransac = ransac_phase(peak_bw, peak_flops)

    paths = [("ba", per_kernel, launches),
             ("inlier_sweep", per_sweep, sweep_launches)] + \
        [(p, per_stage[p], stage_launches[p]) for p in per_stage]
    entries = [kernel_summary(n, {
        p: v.get(n, ([], [])) + (l[COUNTER.get(n, n)],)
        for p, v, l in paths
        if n in v or l[COUNTER.get(n, n)] > 0}) for n in REPLACES]
    sweep_s = [r[2] for r in runs]
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"slice": {
        "problem": "bench_cache: 100 frames, 1001 points, 100100 obs, f32",
        "lm_iters": LM_ITERS, "seconds": seconds,
        "lm_iters_per_s": [LM_ITERS / t for t in seconds],
        "cg_total": out[8], "cost0": cost0, "cost": cost,
        "launches": launches,
        "kernel_ms_per_lm_iter_est": kernel_ms_per_iter,
        "card_vs_cpu_f32_after_3": diffs, "card_vs_cpu_f64_after_3": diffs64,
        "cpu_f32_3_iters_s": t_cpu, "bitwise_reproducible": True,
        "entry_point_launches": entry_launches,
        "entry_point_vs_solve_ba": entry_diffs,
        "camera_segment_offset_invariant_cases": offset_checked,
        "build_s": rep["seconds"], "card": card}}))
    print(json.dumps({"inlier_sweep": {
        "problem": (f"synthetic {SWEEP_OPTIONS}: {M} matches, {P} pairs, "
                    f"{K} keypoints, f32"),
        "configs": {str(c): int((vg.pair_config == c).sum())
                    for c in np.unique(vg.pair_config)},
        "generation_s": gen_s, "chunks": n_chunks,
        "seconds": sweep_s, "matches_per_s": [M / t for t in sweep_s],
        "undistort_s": [r[3] for r in runs],
        "chunked_ceil_M_over_3_s": chunked[2],
        "peak_device_bytes": peak_bytes, "launches": sweep_launches,
        "kernel_ms_est": sum(c["ms"] * w for cs, ws in per_sweep.values()
                             for c, w in zip(cs, ws)),
        "inlier_share": float(inl.mean()),
        "pair_inliers_total": int(runs[0][0].pair_num_inliers.sum()),
        "bitwise_reproducible": True, "chunked_equals_one_shot": True,
        "card_vs_cpu_f32": disagree, "cpu_f32_s": cpu[2],
        "pairs_removed": removed, "component_images": component,
        "card": card}}))
    print(json.dumps({"stages_4_6": {**stages, "card": card}}))
    print(json.dumps({"mapper_resume": resume}))
    print(json.dumps({"stage_7": {**retri, "card": card}}))
    print(json.dumps({"stage_3": {**ra, "card": card}}))
    print(json.dumps({"mapper": mapper}))
    print(json.dumps({"partitioned": part}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"ransac": {**ransac, "card": card}}))
    print(card)
    # the run used one card
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
