"""View graph as flat edge arrays + host graph algorithms.

Counterpart of glomap_tpu/scene/view_graph.py with the same field names,
so a JAX-package ViewGraph carries over field by field (utils/carry.py).
Like the reference's glomap/scene/view_graph.{h,cc} and image_pair.h, laid
out as edge arrays (i, j, valid, weight, E/F/H, rel pose) plus flat match
arrays sorted by pair. Host-resident numpy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

# colmap TwoViewGeometry::ConfigurationType (public schema contract)
CONFIG_UNDEFINED = 0
CONFIG_DEGENERATE = 1
CONFIG_CALIBRATED = 2
CONFIG_UNCALIBRATED = 3
CONFIG_PLANAR = 4
CONFIG_PANORAMIC = 5
CONFIG_PLANAR_OR_PANORAMIC = 6
CONFIG_WATERMARK = 7
CONFIG_MULTIPLE = 8


def _empty(shape, dtype=np.float64):
    return np.zeros(shape, dtype=dtype)


@dataclass
class ViewGraph:
    # --- pairs (P); i < j by dense image index ---
    pair_i: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    pair_j: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    pair_valid: np.ndarray = field(default_factory=lambda: _empty((0,), bool))
    pair_config: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    pair_E: np.ndarray = field(default_factory=lambda: _empty((0, 3, 3)))
    pair_F: np.ndarray = field(default_factory=lambda: _empty((0, 3, 3)))
    pair_H: np.ndarray = field(default_factory=lambda: _empty((0, 3, 3)))
    # relative pose cam_j_from_cam_i
    pair_quat: np.ndarray = field(default_factory=lambda: _empty((0, 4)))
    pair_trans: np.ndarray = field(default_factory=lambda: _empty((0, 3)))
    pair_weight: np.ndarray = field(default_factory=lambda: _empty((0,)))
    pair_num_inliers: np.ndarray = field(default_factory=lambda: _empty((0,), np.int64))

    # --- matches, flat and sorted by pair (M) ---
    match_pair: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    match_f1: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    match_f2: np.ndarray = field(default_factory=lambda: _empty((0,), np.int32))
    match_inlier: np.ndarray = field(default_factory=lambda: _empty((0,), bool))
    pair_match_offset: np.ndarray = field(
        default_factory=lambda: _empty((1,), np.int64))

    @property
    def num_pairs(self):
        return len(self.pair_i)

    @property
    def num_matches(self):
        return len(self.match_pair)

    def match_slice(self, pair_idx: int) -> slice:
        return slice(int(self.pair_match_offset[pair_idx]),
                     int(self.pair_match_offset[pair_idx + 1]))

    # ------------------------------------------------------------------
    def connected_components(self, num_images: int) -> np.ndarray:
        """Component label per image over valid pairs (host union-find).

        Counterpart of ViewGraph::FindConnectedComponent
        (glomap/scene/view_graph.cc:56-126), as label propagation on the
        edge list instead of per-node BFS over adjacency maps.
        """
        parent = np.arange(num_images)

        def find(x):
            root = x
            while parent[root] != root:
                root = parent[root]
            while parent[x] != root:
                parent[x], x = root, parent[x]
            return root

        for i, j in zip(self.pair_i[self.pair_valid],
                        self.pair_j[self.pair_valid]):
            ri, rj = find(int(i)), find(int(j))
            if ri != rj:
                parent[ri] = rj
        return np.asarray([find(int(x)) for x in range(num_images)])

    def keep_largest_connected_component(self, scene) -> int:
        """Invalidate pairs outside the largest component; deregister frames
        not in it. Returns the component size in images.

        Counterpart of ViewGraph::KeepLargestConnectedComponents
        (glomap/scene/view_graph.cc). A frame is in the component if any of
        its images is.
        """
        n = scene.num_images
        if self.num_pairs == 0 or n == 0:
            return 0
        labels = self.connected_components(n)
        # only images touched by valid pairs count
        touched = np.zeros(n, dtype=bool)
        touched[self.pair_i[self.pair_valid]] = True
        touched[self.pair_j[self.pair_valid]] = True
        if not touched.any():
            scene.frame_registered[:] = False
            return 0
        lab = labels[touched]
        vals, counts = np.unique(lab, return_counts=True)
        best = vals[np.argmax(counts)]
        in_comp = (labels == best) & touched

        self.pair_valid &= in_comp[self.pair_i] & in_comp[self.pair_j]
        frame_in = np.zeros(scene.num_frames, dtype=bool)
        frame_in[scene.image_frame[in_comp]] = True
        scene.frame_registered[:] = frame_in
        return int(in_comp.sum())

    def invalidate(self, mask: np.ndarray):
        """Mark pairs invalid where mask is True."""
        self.pair_valid &= ~mask

    def copy(self) -> "ViewGraph":
        out = ViewGraph()
        for f in dataclasses.fields(self):
            setattr(out, f.name, getattr(self, f.name).copy())
        return out


def pair_id_from_image_ids(id1: int, id2: int) -> int:
    """COLMAP database pair_id convention (public schema contract)."""
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * 2147483647 + id2


def image_ids_from_pair_id(pair_id: int) -> tuple[int, int]:
    id2 = pair_id % 2147483647
    id1 = pair_id // 2147483647
    return int(id1), int(id2)
