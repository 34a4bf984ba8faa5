"""Batched multi-view triangulation: the midpoint method and per-track
two-view RANSAC.

Counterpart of glomap_tpu/ops/triangulation.py, itself the counterpart of
the colmap triangulation machinery the reference's retriangulation stage
runs (glomap/controllers/track_retriangulation.cc:21-116, colmap
EstimateTriangulation). Every track is triangulated at once: for
observations with world ray directions d_o from centers c_o, the midpoint
solves the 3x3 system
    [sum_o w_o (I - d_o d_o^T)] X = sum_o w_o (I - d_o d_o^T) c_o,
whose nine sums are one B3 row sum (kernels.rowsum) over the track axis,
then a batched 3x3 solve. The RANSAC scores each hypothesis with one B2
gather of its (T, 3) point table onto the observations and one 2-row B3
sum. Per-observation data are (3, O) row stacks; every function runs on
the device and in the dtype of its inputs (f32 on the card, whose kernels
take f32). The JAX package's bucket padding, sorted-window widths, TPU
dispatch and bf16 `exact` flags are gone: the track axis is a
SegmentAxis, built once per track set and shared by every call on it.
"""

from __future__ import annotations

import numpy as np
import torch

from glomap_tpu_torch.device import resolve_device
from glomap_tpu_torch.math import rotation as rotm
from glomap_tpu_torch.ops import kernels
from glomap_tpu_torch.ops.kernels import SegmentAxis
from glomap_tpu_torch.scene.arrays import Scene, Tracks

_U32 = 0xFFFFFFFF
# A[i, j] of the symmetric normal matrix from the six unique row sums
_SYM = (0, 1, 2, 1, 3, 4, 2, 4, 5)


def midpoint_triangulate(axis: SegmentAxis, dT: torch.Tensor,
                         cT: torch.Tensor, w: torch.Tensor):
    """axis: observation -> track; dT (3, O) unit world directions, cT
    (3, O) centers, w (O,) weights. Returns (X (T, 3), ok (T,)): the
    weighted midpoint of each track, and whether its normal matrix is
    well posed (smallest eigenvalue above 1e-6 of the trace)."""
    Pxx = w * (1.0 - dT[0] * dT[0])
    Pxy = -w * dT[0] * dT[1]
    Pxz = -w * dT[0] * dT[2]
    Pyy = w * (1.0 - dT[1] * dT[1])
    Pyz = -w * dT[1] * dT[2]
    Pzz = w * (1.0 - dT[2] * dT[2])
    b0 = Pxx * cT[0] + Pxy * cT[1] + Pxz * cT[2]
    b1 = Pxy * cT[0] + Pyy * cT[1] + Pyz * cT[2]
    b2 = Pxz * cT[0] + Pyz * cT[1] + Pzz * cT[2]
    s = kernels.rowsum(torch.stack([Pxx, Pxy, Pxz, Pyy, Pyz, Pzz,
                                    b0, b1, b2]), axis)  # (T, 9)
    A = s[:, _SYM].reshape(-1, 3, 3)
    b = s[:, 6:9]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    # regularize rank-deficient systems (collinear rays); solve_ex reads
    # nothing back, and a singular system's X is discarded by `ok`
    tr = A.diagonal(dim1=-2, dim2=-1).sum(-1)
    scale = torch.clamp(tr, min=1e-12)
    X = torch.linalg.solve_ex(A + (1e-10 * scale)[:, None, None] * eye,
                              b[..., None])[0][..., 0]
    ok = torch.linalg.eigvalsh(A)[:, 0] > 1e-6 * scale
    return X, ok


def _hash_u32(x: torch.Tensor) -> torch.Tensor:
    """The JAX package's deterministic integer mix (Knuth multiplicative)
    of uint32 values, on int64 tensors holding them: every product and
    shift is taken mod 2^32."""
    x = x & _U32
    x = _mul_u32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul_u32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for 0 <= x, c < 2^32, without int64 overflow: the
    high half of c contributes only the low 16 bits of its product."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def pair_offsets(tids: torch.Tensor) -> tuple:
    """(h1, h2) int64: the enumeration phases of tracks `tids` (int64),
    the low 31 bits of the hash of 9781 t + 1 and of 7919 t + 7."""
    h1 = _hash_u32(tids * 9781 + 1) & 0x7FFFFFFF
    h2 = _hash_u32(tids * 7919 + 7) & 0x7FFFFFFF
    return h1, h2


def pair_indices(h1, h2, t_len, k: int) -> tuple:
    """(i1, i2): the positions within its track of hypothesis k's two
    observations. Short tracks sweep every ordered pair (k < len (len - 1)
    is exhaustive); the hash phase decorrelates which window long tracks
    explore. Sums are int64, as the JAX package's are under x64 (its
    float64 mode and the mode of its tests)."""
    len_ = torch.clamp(t_len, min=1)
    len1 = torch.clamp(t_len - 1, min=1)
    i1 = torch.remainder(h1 + k // len1, len_)
    i2 = torch.remainder(i1 + 1 + torch.remainder(h2 + k, len1), len_)
    return i1, i2


def ransac_triangulate(axis: SegmentAxis, dT: torch.Tensor,
                       cT: torch.Tensor, t_start: torch.Tensor,
                       t_len: torch.Tensor, num_hyps: int,
                       cos_err_thresh: float, min_pair_angle_rad: float):
    """Robust multi-view triangulation: per-track two-view RANSAC.

    Every track evaluates the same static budget of `num_hyps`
    deterministically sampled observation pairs: a two-view midpoint
    hypothesis (T, 3) per round, the angular support of every observation
    against its track's hypothesis, and the best hypothesis kept by a
    running max of the support outside the sample pair, tie-broken by
    the consensus margin. Then a weighted midpoint over the winning
    consensus set, kept unless it lowers the support. Nothing is read
    back to the host. Observations must be sorted by track (t_start,
    t_len (T,) int64 delimit each track).

    Args: axis (the track of each observation), dT (3, O) unit world ray
    directions, cT (3, O) camera centers, cos_err_thresh the cosine of
    the largest angular error of a supporting observation,
    min_pair_angle_rad the least triangulation angle of a sample pair.
    Returns (X (T, 3), support (T,) int32, inlier (O,) bool)."""
    dtype, dev = dT.dtype, dT.device
    n_obs = axis.num_obs
    cos_max_pair = torch.cos(torch.tensor(min_pair_angle_rad, dtype=dtype,
                                          device=dev))
    h1, h2 = pair_offsets(torch.arange(axis.n_seg, dtype=torch.int64,
                                       device=dev))

    def score(X):
        Xr = kernels.gather(X.contiguous(), axis)  # (3, O)
        v0 = Xr[0] - cT[0]
        v1 = Xr[1] - cT[1]
        v2 = Xr[2] - cT[2]
        vn = torch.sqrt(v0 * v0 + v1 * v1 + v2 * v2)
        cos = (v0 * dT[0] + v1 * dT[1] + v2 * dT[2]) / \
            torch.clamp(vn, min=1e-12)
        inl = (cos > cos_err_thresh) & (vn > 1e-12)
        margin = torch.where(inl, cos - cos_err_thresh,
                             torch.zeros_like(cos))
        sums = kernels.rowsum(torch.stack([inl.to(dtype), margin]),
                              axis)  # (T, 2)
        return sums[:, 0].to(torch.int32), inl, margin, sums[:, 1]

    def hypothesis(k):
        i1, i2 = pair_indices(h1, h2, t_len, k)
        o1 = torch.clamp(t_start + i1, 0, n_obs - 1)
        o2 = torch.clamp(t_start + i2, 0, n_obs - 1)
        d1, c1 = dT[:, o1], cT[:, o1]
        d2, c2 = dT[:, o2], cT[:, o2]
        # two-view ray midpoint: min_{s,t} |c1 + s d1 - c2 - t d2|
        b = c2 - c1
        d12 = d1[0] * d2[0] + d1[1] * d2[1] + d1[2] * d2[2]
        denom = torch.clamp(1.0 - d12 * d12, min=1e-12)
        bd1 = b[0] * d1[0] + b[1] * d1[1] + b[2] * d1[2]
        bd2 = b[0] * d2[0] + b[1] * d2[1] + b[2] * d2[2]
        s = (bd1 - d12 * bd2) / denom
        t = (d12 * bd1 - bd2) / denom
        X = (0.5 * (c1 + s * d1 + c2 + t * d2)).T
        # eligibility: pair parallax above the least angle, both depths
        # positive (cheirality, colmap TriangulatePoint), two observations
        ok = ((torch.abs(d12) < cos_max_pair) & (s > 0) & (t > 0)
              & (t_len >= 2))
        return X, ok, o1, o2

    best_score = torch.full((axis.n_seg,), -torch.inf, dtype=dtype,
                            device=dev)
    best_sup = torch.zeros((axis.n_seg,), dtype=torch.int32, device=dev)
    best_X = torch.zeros((axis.n_seg, 3), dtype=dtype, device=dev)
    for k in range(num_hyps):
        X, ok, o1, o2 = hypothesis(k)
        sup, inl, margin, msum = score(X)
        # rank by the support outside the sample pair (a bad pair always
        # supports itself with 2), tie-broken by the consensus margin; the
        # margin sum is < 1 by construction (<= O_max (1 - cos_thresh))
        sup_ex = (sup - inl[o1].to(torch.int32)
                  - inl[o2].to(torch.int32)).to(dtype)
        msum_ex = msum - margin[o1] - margin[o2]
        sc = torch.where(ok, sup_ex + msum_ex / (1.0 + msum_ex),
                         torch.full_like(msum_ex, -1.0))
        better = sc > best_score
        best_X = torch.where(better[:, None], X, best_X)
        best_sup = torch.where(better, sup, best_sup)
        best_score = torch.maximum(best_score, sc)
    # local refinement: weighted midpoint over the winning consensus set
    _, inl, _, _ = score(best_X)
    X_ref, ok_ref = midpoint_triangulate(axis, dT, cT, inl.to(dtype))
    refine = ok_ref & (best_sup >= 2)
    X_out = torch.where(refine[:, None], X_ref, best_X)
    sup2, inl2, _, _ = score(X_out)
    worse = sup2 < best_sup  # keep the RANSAC point if refinement regressed
    X_out = torch.where(worse[:, None], best_X, X_out)
    sup_out = torch.where(worse, best_sup, sup2)
    inl_out = torch.where(worse[axis.ids.long()], inl, inl2)
    return X_out, sup_out, inl_out


def _solver_dtype(device: torch.device, dtype):
    return dtype or (torch.float64 if device.type == "cpu"
                     else torch.float32)


def _rays_and_centers(scene: Scene, tracks: Tracks, rows: np.ndarray,
                      device, dtype):
    """(dT, cT): the world ray directions and camera centers (3, O) of the
    observation rows, lifted on the host in f64, on `device` in `dtype`."""
    o_img = tracks.obs_image[rows]
    kp = scene.kp_offset[o_img] + tracks.obs_feature[rows]
    q_img, _ = scene.image_cam_from_world()
    d = rotm.quat_rotate(rotm.quat_conj(torch.from_numpy(q_img[o_img])),
                         torch.from_numpy(np.asarray(scene.kp_ray[kp],
                                                     np.float64)))
    c = torch.from_numpy(scene.image_centers()[o_img])
    return tuple(a.T.contiguous().to(device=device, dtype=dtype)
                 for a in (d, c))


def ransac_triangulate_tracks(scene: Scene, tracks: Tracks,
                              max_angle_error_deg: float = 2.0,
                              min_tri_angle_deg: float = 1.0,
                              num_hyps: int = 16, device=None,
                              dtype: torch.dtype | None = None) -> np.ndarray:
    """Robustly fill tracks.xyz and mark outlier observations invalid.

    Runs on CUDA unless `device` says otherwise (device=None without CUDA
    raises), in `dtype` (None: f64 on the CPU, f32 on the card). Returns
    the per-track success mask (support >= 2). The valid observations
    must be sorted by track (track establishment's order)."""
    device = resolve_device(device)
    dtype = _solver_dtype(device, dtype)
    n_tr = tracks.num_tracks
    if tracks.num_obs == 0:
        return np.zeros(n_tr, dtype=bool)
    o_idx = np.nonzero(tracks.obs_valid & tracks.valid[tracks.obs_track])[0]
    if len(o_idx) == 0:
        return np.zeros(n_tr, dtype=bool)
    ot = tracks.obs_track[o_idx].astype(np.int64)
    # segment offsets (observations sorted by track; empty tracks len 0)
    t_len = np.bincount(ot, minlength=n_tr)
    t_start = np.concatenate([[0], np.cumsum(t_len)[:-1]])
    dT, cT = _rays_and_centers(scene, tracks, o_idx, device, dtype)
    axis = SegmentAxis.build(torch.from_numpy(ot).to(device), n_tr)
    X, sup, inl = ransac_triangulate(
        axis, dT, cT, torch.from_numpy(t_start).to(device),
        torch.from_numpy(t_len).to(device), num_hyps,
        float(np.cos(np.deg2rad(max_angle_error_deg))),
        float(np.deg2rad(min_tri_angle_deg)))
    X = X.cpu().numpy().astype(np.float64)
    ok = sup.cpu().numpy() >= 2
    tracks.xyz[:] = np.where(ok[:, None], X, tracks.xyz)
    inl = inl.cpu().numpy()
    tracks.obs_valid[o_idx[~inl & ok[ot]]] = False
    return ok


def triangulate_tracks(scene: Scene, tracks: Tracks, device=None,
                       dtype: torch.dtype | None = None) -> np.ndarray:
    """Fill tracks.xyz by the midpoint of every valid observation from the
    current poses and rays; returns the per-track well-posedness mask.
    Device and dtype as ransac_triangulate_tracks."""
    device = resolve_device(device)
    dtype = _solver_dtype(device, dtype)
    if tracks.num_obs == 0:
        return np.zeros(0, dtype=bool)
    rows = np.nonzero(tracks.obs_valid)[0]
    dT, cT = _rays_and_centers(scene, tracks, rows, device, dtype)
    axis = SegmentAxis.build(torch.from_numpy(
        tracks.obs_track[rows].astype(np.int64)).to(device),
        tracks.num_tracks)
    X, ok = midpoint_triangulate(axis, dT, cT, torch.ones(
        len(rows), dtype=dtype, device=device))
    X = X.cpu().numpy().astype(np.float64)
    ok = ok.cpu().numpy()
    tracks.xyz[:] = np.where(ok[:, None], X, tracks.xyz)
    return ok
