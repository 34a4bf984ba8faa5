"""Point color extraction from source images.

A copy of glomap_tpu/processors/color_extraction.py. Counterpart of the
color extraction colmap performs inside the
reference's WriteGlomapReconstruction path (glomap/io/colmap_io.cc:8-69
with ExtractColors): each track takes the color of its first valid
observation's pixel; images are loaded lazily via PIL.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from glomap_tpu_torch.scene.arrays import Scene, Tracks

logger = logging.getLogger(__name__)


def extract_colors(scene: Scene, tracks: Tracks, image_path: str) -> int:
    """Fill tracks.color from image pixels. Returns #tracks colored."""
    try:
        from PIL import Image as PILImage
    except ImportError:
        logger.warning("PIL unavailable; skipping color extraction")
        return 0
    if tracks.num_tracks == 0:
        return 0
    if len(tracks.color) != tracks.num_tracks:
        tracks.color = np.zeros((tracks.num_tracks, 3), dtype=np.uint8)

    # first valid observation per track
    ok = tracks.obs_valid & tracks.valid[tracks.obs_track]
    order = np.argsort(tracks.obs_track[ok], kind="stable")
    ot = tracks.obs_track[ok][order]
    oi = tracks.obs_image[ok][order]
    of = tracks.obs_feature[ok][order]
    first = np.searchsorted(ot, np.arange(tracks.num_tracks))
    valid_first = first < len(ot)

    # group the needed lookups by image
    n_colored = 0
    by_image = {}
    for t in np.nonzero(tracks.valid & valid_first)[0]:
        k = first[t]
        if k >= len(ot) or ot[k] != t:
            continue
        by_image.setdefault(int(oi[k]), []).append((t, int(of[k])))

    for img_idx, items in by_image.items():
        path = os.path.join(image_path, scene.image_names[img_idx])
        if not os.path.exists(path):
            continue
        try:
            with PILImage.open(path) as im:
                arr = np.asarray(im.convert("RGB"))
        except Exception:
            continue
        sl = scene.kp_slice(img_idx)
        kps = scene.kp_xy[sl]
        h, w = arr.shape[:2]
        for t, feat in items:
            x, y = kps[feat]
            xi = min(max(int(round(x)), 0), w - 1)
            yi = min(max(int(round(y)), 0), h - 1)
            tracks.color[t] = arr[yi, xi]
            n_colored += 1
    logger.info("Extracted colors for %d tracks", n_colored)
    return n_colored
