"""Epipolar inlier classification over all matches in one device sweep.

Counterpart of glomap_tpu/processors/pair_inliers.py (_score_matches,
image_pairs_inlier_count), the batched form of the reference's
glomap/processors/image_pair_inliers.{h,cc} (ScoreError and
ImagePairsInlierCount): per-match squared Sampson or homography-transfer
errors against per-config thresholds, cheirality and degeneracy checks,
and per-pair counts and scores.

Semantics (the reference's, as the JAX package has them):
  * CALIBRATED (E): squared Sampson on undistorted rays, threshold
    max_epipolar_error_E * 0.5 * (1/f1 + 1/f2), PoseLib cheirality with
    depth in [1e-2, 100], and an epipole-proximity check at cos(3 deg).
  * UNCALIBRATED (F): squared Sampson on pixels, and a per-pair majority
    vote of orientation signs as the cheirality test; a tie invalidates
    every match of the pair.
  * PLANAR / PANORAMIC (H): squared transfer error on pixels.

Matches are sorted by pair. The per-pair table (53 columns: E, R, t,
epipoles, F, the F epipole, H, the squared E threshold and the config
flags) is built once on the host in f64 and expanded onto the matches
with the gather kernel (B2); both Sampson errors run on the Sampson
kernel (B7); the vote sum and the inlier and score sums are per-pair
row sums (B3). Pair-aligned chunks of at most _SWEEP_CHUNK_MATCHES
matches bound device memory (about 420 B per match at f32); chunks hold
whole pairs and no padding, so a chunked sweep equals the one-shot sweep
bit for bit.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from glomap_tpu_torch.config import InlierThresholds
from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.estimators.relpose import _cheirality_rows
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.math import two_view as tv
from glomap_tpu_torch.ops import camera_models as cm
from glomap_tpu_torch.ops import kernels, segment_ops
from glomap_tpu_torch.processors.undistortion import device_keypoints
from glomap_tpu_torch.scene.arrays import Scene
from glomap_tpu_torch.scene.view_graph import (
    ViewGraph, CONFIG_CALIBRATED, CONFIG_UNCALIBRATED, CONFIG_PLANAR,
    CONFIG_PANORAMIC, CONFIG_PLANAR_OR_PANORAMIC)
from glomap_tpu_torch.utils.profiling import count

# most matches per sweep call
_SWEEP_CHUNK_MATCHES = 12 << 20
# epipole proximity: a ray within 3 degrees of the epipole is degenerate
_COS3 = math.cos(math.radians(3.0)) + 1e-6


def _pair_table(vg: ViewGraph, focal1, focal2, thres_E: float):
    """(P, 53) f64 CPU table of the per-pair quantities of the sweep."""
    P = vg.num_pairs
    f64 = lambda a: torch.from_numpy(np.asarray(a, np.float64))  # noqa: E731
    q, t = f64(vg.pair_quat), f64(vg.pair_trans)
    F, H = f64(vg.pair_F), f64(vg.pair_H)
    E9 = tv.essential_from_motion(q, t).reshape(P, 9)
    R9 = rotm.quat_to_rotmat(q).reshape(P, 9)
    thrE = thres_E * 0.5 * (1.0 / f64(focal1) + 1.0 / f64(focal2))

    def unit_forward(v):
        v = torch.where(v[:, 2:3] < 0, -v, v)
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1,
                                                        keepdim=True),
                               min=1e-12)
    ep12 = unit_forward(t)
    ep21 = unit_forward(rotm.rigid_inverse(q, t)[1])
    epi = torch.linalg.cross(F[:, 0, :], F[:, 2, :], dim=-1)
    epi_alt = torch.linalg.cross(F[:, 1, :], F[:, 2, :], dim=-1)
    use_alt = torch.amax(torch.abs(epi), dim=-1) <= 1e-12
    epi = torch.where(use_alt[:, None], epi_alt, epi)
    config = vg.pair_config
    is_H = np.isin(config, (CONFIG_PLANAR, CONFIG_PANORAMIC,
                            CONFIG_PLANAR_OR_PANORAMIC))
    flags = np.stack([vg.pair_valid, config == CONFIG_CALIBRATED,
                      config == CONFIG_UNCALIBRATED, is_H], axis=1)
    return torch.cat([
        E9,                          # 0:9
        R9,                          # 9:18
        t,                           # 18:21
        ep21,                        # 21:24
        ep12,                        # 24:27
        F.reshape(P, 9),             # 27:36
        epi,                         # 36:39
        H.reshape(P, 9),             # 39:48
        (thrE * thrE)[:, None],      # 48
        f64(flags),                  # 49 valid, 50 E, 51 F, 52 H
    ], dim=1)


def _score_matches(tab, base1, base2, offsets, f1, f2, kp5,
                   thres_F: float, thres_H: float):
    """One pair-aligned chunk of the sweep.

    tab (P, 53) per-pair table in the sweep's dtype; base1/base2 (P,)
    keypoint offsets of each pair's images; offsets (P + 1,) the chunk's
    match CSR from 0; f1/f2 (M,) feature ids; kp5 (5, K) rays over pixels.
    Returns (match inlier (M,) bool, pair inlier counts (P,) int32, pair
    scores (P,)), on the device."""
    P, M = tab.shape[0], f1.shape[0]
    mp = segment_ops.segment_ids_from_offsets(offsets, M)
    reduce_rows, expand = segment_ops.make_axis_ops(mp, P)
    mp = mp.long()
    rows1 = kp5[:, base1[mp] + f1]
    rows2 = kp5[:, base2[mp] + f2]
    ray1T, ray2T = rows1[0:3], rows2[0:3]
    one_row = torch.ones((1, M), dtype=kp5.dtype, device=kp5.device)
    px1T = torch.cat([rows1[3:5], one_row])
    px2T = torch.cat([rows2[3:5], one_row])

    rows = expand(tab)
    E9_m, R9_m, t_m = rows[0:9], rows[9:18], rows[18:21]
    e21T, e12T = rows[21:24], rows[24:27]
    F9_m, epiT, H9_m = rows[27:36], rows[36:39], rows[39:48]
    sq_thrE_m = rows[48]
    valid_m = rows[49] > 0.5
    is_E = rows[50] > 0.5
    is_F = rows[51] > 0.5
    is_H = rows[52] > 0.5

    # ---- Essential (rays, normalized threshold) ----
    r2_E = kernels.sampson_score(E9_m, ray1T, ray2T)
    cheir = _cheirality_rows(R9_m, t_m, ray1T, ray2T, min_depth=1e-2,
                             max_depth=100.0)
    d1 = ray1T[0] * e21T[0] + ray1T[1] * e21T[1] + ray1T[2] * e21T[2]
    d2 = ray2T[0] * e12T[0] + ray2T[1] * e12T[1] + ray2T[2] * e12T[2]
    near_epipole = (d1 >= _COS3) | (d2 >= _COS3)
    ok_E = (r2_E < sq_thrE_m) & cheir & ~near_epipole

    # ---- Fundamental (pixels) ----
    sq_thrF = thres_F * thres_F
    r2_F = kernels.sampson_score(F9_m, px1T, px2T)
    pre_F = r2_F < sq_thrF
    # orientation signum: s1 = F00 x2 + F10 y2 + F20; s2 = e1 - e2 * y1
    s1 = F9_m[0] * px2T[0] + F9_m[3] * px2T[1] + F9_m[6]
    s2 = epiT[1] - epiT[2] * px1T[1]
    sig = torch.sign(s1 * s2)
    votes = torch.where(pre_F & is_F, sig, torch.zeros_like(sig))
    vote_sum = reduce_rows(votes[None, :])[:, 0]
    tie_maj = torch.stack([(vote_sum == 0).to(tab.dtype),
                           torch.sign(vote_sum)], dim=1)  # (P, 2)
    tm_rows = expand(tie_maj)
    ok_F = pre_F & (sig == tm_rows[1]) & ~(tm_rows[0] > 0.5)

    # ---- Homography (pixels) ----
    sq_thrH = thres_H * thres_H
    Hx0 = H9_m[0] * px1T[0] + H9_m[1] * px1T[1] + H9_m[2]
    Hx1 = H9_m[3] * px1T[0] + H9_m[4] * px1T[1] + H9_m[5]
    Hx2 = H9_m[6] * px1T[0] + H9_m[7] * px1T[1] + H9_m[8]
    zi = 1.0 / (Hx2 + 1e-12)
    r2_H = (Hx0 * zi - px2T[0]) ** 2 + (Hx1 * zi - px2T[1]) ** 2
    ok_H = r2_H < sq_thrH

    inlier = torch.where(is_E, ok_E, torch.where(is_F, ok_F, ok_H & is_H))
    inlier = inlier & valid_m
    r2 = torch.where(is_E, torch.minimum(r2_E, sq_thrE_m),
                     torch.where(is_F, torch.clamp(r2_F, max=sq_thrF),
                                 torch.clamp(r2_H, max=sq_thrH)))
    cap = torch.where(is_E, sq_thrE_m,
                      torch.where(is_F, torch.full_like(r2, sq_thrF),
                                  torch.full_like(r2, sq_thrH)))
    score_m = torch.where(inlier, r2, cap)
    sums = reduce_rows(torch.stack([inlier.to(tab.dtype), score_m]))
    return inlier, sums[:, 0].to(torch.int32), sums[:, 1]


def _chunk_bounds(off: np.ndarray, num_pairs: int, num_matches: int,
                  cap: int) -> list[int]:
    """Pair indices delimiting chunks of whole pairs, each holding at most
    `cap` matches."""
    bounds = [0]
    while off[bounds[-1]] < num_matches:
        nxt = int(np.searchsorted(off, off[bounds[-1]] + cap,
                                  side="right")) - 1
        if nxt <= bounds[-1]:
            raise ValueError(f"pair {bounds[-1]} has more than {cap} matches")
        bounds.append(min(nxt, num_pairs))
    return bounds


def image_pairs_inlier_count(scene: Scene, vg: ViewGraph,
                             opts: InlierThresholds | None = None,
                             device=None, dtype: torch.dtype = torch.float32):
    """Classify every match; sets vg.match_inlier (bool) and
    vg.pair_num_inliers (int64), counts them as `matches` on the innermost
    open span, and returns the per-pair score (f64).

    Needs scene.kp_ray (processors.undistortion.undistort_images) for
    CALIBRATED pairs. Runs on the card unless `device` says otherwise;
    with device=None and no CUDA it raises. The CUDA kernels take f32."""
    opts = opts or InlierThresholds()
    device = resolve_device(device)
    if vg.num_matches == 0:
        return None
    kp5 = torch.cat(device_keypoints(scene, device, dtype))
    f1 = cm.mean_focal(scene.cam_params[scene.image_camera[vg.pair_i]])
    f2 = cm.mean_focal(scene.cam_params[scene.image_camera[vg.pair_j]])
    tab = _pair_table(vg, f1, f2, float(opts.max_epipolar_error_E)).to(
        device=device, dtype=dtype)
    kp_offset = torch.from_numpy(np.asarray(scene.kp_offset, np.int64)).to(
        device)
    base1 = kp_offset[torch.from_numpy(vg.pair_i.astype(np.int64)).to(device)]
    base2 = kp_offset[torch.from_numpy(vg.pair_j.astype(np.int64)).to(device)]
    off = np.asarray(vg.pair_match_offset, np.int64)
    off_d = torch.from_numpy(off).to(device)
    bounds = _chunk_bounds(off, vg.num_pairs, vg.num_matches,
                           _SWEEP_CHUNK_MATCHES)

    inlier = np.empty(vg.num_matches, dtype=bool)
    n_inl = np.empty(vg.num_pairs, dtype=np.int64)
    score = np.empty(vg.num_pairs, dtype=np.float64)
    for p0, p1 in zip(bounds[:-1], bounds[1:]):
        m0, m1 = int(off[p0]), int(off[p1])
        ok, n, s = _score_matches(
            tab[p0:p1], base1[p0:p1], base2[p0:p1], off_d[p0:p1 + 1] - m0,
            torch.from_numpy(vg.match_f1[m0:m1]).to(device),
            torch.from_numpy(vg.match_f2[m0:m1]).to(device), kp5,
            float(opts.max_epipolar_error_F),
            float(opts.max_epipolar_error_H))
        inlier[m0:m1] = ok.cpu().numpy()
        n_inl[p0:p1] = n.cpu().numpy()
        score[p0:p1] = s.cpu().double().numpy()
    vg.match_inlier = inlier
    vg.pair_num_inliers = n_inl
    count("matches", vg.num_matches)
    logging.getLogger(__name__).debug(
        "inlier sweep: %d matches in %d chunk(s)", vg.num_matches,
        len(bounds) - 1)
    return score
