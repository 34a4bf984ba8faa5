"""Native host-side track engine, built with g++ and loaded with ctypes.

Counterpart of glomap_tpu/native (establish_tracks,
establish_tracks_consistent, select_tracks, connected_components), with
the port's own copy of its C++ source (track_engine.cpp): the union-find
track concatenation and the greedy track selection of stage 4, and the
union-find connected components of the strong clustering (pruning),
sequential passes that stay on the host as in the reference. The library is compiled at first
use into build/native/ at the repository root, never next to the source.
There is no Python fallback: at millions of matches a sequential Python
union-find would turn a seconds-long stage into a much longer one, so a
failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "track_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX = "g++"
# no FMA contraction: the consistency test compares squared box diagonals
# with the threshold, as the unfused C++ expression does
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_I64, _U8 = ctypes.c_int64, ctypes.c_uint8
_P64, _PU8 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)
_PF64 = ctypes.POINTER(ctypes.c_double)
# C entry point -> argtypes; every entry returns int64
_SIGNATURES = {
    "glomap_establish_tracks": [_I64, _I64, _P64, _P64, _P64],
    "glomap_establish_tracks_consistent": [_I64, _I64, _P64, _P64, _P64,
                                           _PF64, ctypes.c_double, _P64],
    "glomap_select_tracks": [_I64, _I64, _P64, _P64, _PU8, _P64, _I64, _I64,
                             _I64, _PU8],
    "glomap_connected_components": [_I64, _I64, _P64, _P64, _P64],
}
_lib = None


def library_path() -> Path:
    return BUILD_DIR / "libtrack_engine.so"


def build() -> Path:
    """Compile track_engine.cpp into build/native/; raises on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = library_path()
    tmp = so.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the track engine needs {CXX}: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} failed to build the track engine "
                           f"(rc {out.returncode}):\n{out.stderr}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded track engine, building it first when it is stale."""
    global _lib
    if _lib is None:
        so = library_path()
        if not so.exists() or so.stat().st_mtime < SRC.stat().st_mtime:
            build()
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I64
        _lib = lib
    return _lib


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _check_index(name: str, a: np.ndarray, n: int, size: int | None = None):
    """The C code indexes with these values unchecked: each must lie in
    [0, n), and the array must hold `size` entries when one is given."""
    if size is not None and a.shape != (size,):
        raise ValueError(f"{name}: shape {a.shape}, expected ({size},)")
    if a.size and (a.min() < 0 or a.max() >= n):
        raise ValueError(f"{name}: values outside [0, {n})")


def _check_matches(num_kp: int, kp1: np.ndarray, kp2: np.ndarray) -> None:
    _check_index("kp1", kp1, num_kp)
    _check_index("kp2", kp2, num_kp, len(kp1))


def establish_tracks(num_kp: int, kp1: np.ndarray, kp2: np.ndarray):
    """Union keypoints joined by matches; returns (track id per keypoint,
    -1 for keypoints in no match, number of tracks)."""
    kp1, kp2 = _i64(kp1), _i64(kp2)
    _check_matches(num_kp, kp1, kp2)
    out = np.empty(num_kp, dtype=np.int64)
    n = get_lib().glomap_establish_tracks(
        num_kp, len(kp1), _ptr(kp1, _I64), _ptr(kp2, _I64), _ptr(out, _I64))
    return out, int(n)


def establish_tracks_consistent(num_kp: int, kp1: np.ndarray,
                                kp2: np.ndarray, kp_image: np.ndarray,
                                kp_xy: np.ndarray, thres: float):
    """Consistency-aware union-find: a union is refused when the merged
    component would hold two features of one image further apart than
    `thres` (per-image bounding-box diagonal). Returns (track id per
    keypoint, -1 = none, number of tracks)."""
    kp1, kp2, kp_image = _i64(kp1), _i64(kp2), _i64(kp_image)
    kp_xy = np.ascontiguousarray(kp_xy, dtype=np.float64)
    _check_matches(num_kp, kp1, kp2)
    if kp_image.shape != (num_kp,) or kp_xy.shape != (num_kp, 2):
        raise ValueError(f"kp_image {kp_image.shape} and kp_xy "
                         f"{kp_xy.shape} must describe {num_kp} keypoints")
    out = np.empty(num_kp, dtype=np.int64)
    n = get_lib().glomap_establish_tracks_consistent(
        num_kp, len(kp1), _ptr(kp1, _I64), _ptr(kp2, _I64),
        _ptr(kp_image, _I64), _ptr(kp_xy, ctypes.c_double), float(thres),
        _ptr(out, _I64))
    return out, int(n)


def select_tracks(num_tracks: int, obs_track: np.ndarray,
                  obs_image: np.ndarray, track_eligible: np.ndarray,
                  track_num_images: np.ndarray, num_images: int,
                  min_tracks_per_view: int, max_num_tracks: int):
    """Greedy longest-first coverage selection (reference
    FindTracksForProblem, min_tracks_per_view < 0 selecting every eligible
    track); returns a bool mask per track."""
    obs_track, obs_image = _i64(obs_track), _i64(obs_image)
    track_eligible = np.ascontiguousarray(track_eligible, dtype=np.uint8)
    track_num_images = _i64(track_num_images)
    _check_index("obs_track", obs_track, num_tracks)
    _check_index("obs_image", obs_image, num_images, len(obs_track))
    if track_eligible.shape != (num_tracks,) or \
            track_num_images.shape != (num_tracks,):
        raise ValueError(f"track_eligible and track_num_images must hold "
                         f"{num_tracks} entries")
    sel = np.zeros(num_tracks, dtype=np.uint8)
    get_lib().glomap_select_tracks(
        num_tracks, len(obs_track), _ptr(obs_track, _I64),
        _ptr(obs_image, _I64), _ptr(track_eligible, _U8),
        _ptr(track_num_images, _I64), num_images, min_tracks_per_view,
        max_num_tracks, _ptr(sel, _U8))
    return sel.astype(bool)


def connected_components(num_nodes: int, ei: np.ndarray,
                         ej: np.ndarray) -> np.ndarray:
    """Component label per node over the edges (ei, ej): labels count up
    from 0 in the order of each component's smallest node, as the JAX
    package's native union-find numbers them."""
    ei, ej = _i64(ei), _i64(ej)
    _check_index("ei", ei, num_nodes)
    _check_index("ej", ej, num_nodes, len(ei))
    out = np.empty(num_nodes, dtype=np.int64)
    get_lib().glomap_connected_components(
        num_nodes, len(ei), _ptr(ei, _I64), _ptr(ej, _I64), _ptr(out, _I64))
    return out
