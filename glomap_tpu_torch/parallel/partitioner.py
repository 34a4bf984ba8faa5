"""The frame partitioner: recursive spectral bisection of the frame
covisibility graph.

Counterpart of glomap_tpu/parallel/partitioner.py, which replaces METIS
for the distributed solvers (SURVEY.md §2.3): frames are split into P
balanced parts that cut little covisibility weight, by recursive
bisection at the median of the Fiedler vector of the weighted Laplacian,
with whole connected components packed first. Host numpy and scipy, with
the JAX version's fixed ARPACK start vector, so every process computes
the same parts, and the same parts as the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.sparse.linalg import eigsh

from glomap_tpu_torch.processors.pruning import _covisibility_edges
from glomap_tpu_torch.scene.arrays import Scene, Tracks


@dataclass
class Partition:
    frame_part: np.ndarray       # (F,) part id per frame
    num_parts: int
    edge_cut: float              # covisibility weight between parts
    total_weight: float
    sizes: np.ndarray            # frames per part

    @property
    def cut_fraction(self):
        return self.edge_cut / max(self.total_weight, 1e-12)


def covisibility_graph(scene: Scene, tracks: Tracks):
    """(f1, f2, count): frame pairs that share tracks of 3 or more
    observations, and how many."""
    return _covisibility_edges(scene, tracks)


def _fiedler_vector(L, n: int) -> np.ndarray:
    """The eigenvector of the second-smallest eigenvalue of the Laplacian
    L of a connected graph of n > 3 nodes. Shift-invert ARPACK about
    -1e-3 factorises L once and converges in a few Lanczos steps (plain
    which="SM" stalls beyond ~5k nodes); where ARPACK does not converge,
    which="SM", and where that fails too, a seeded random vector, as in
    the JAX package."""
    v0 = np.random.default_rng(12345).standard_normal(n)
    try:
        vals, vecs = eigsh(L, k=2, sigma=-1e-3, which="LM", maxiter=1000,
                           v0=v0)
        return vecs[:, np.argsort(vals)[1]]
    except Exception:
        try:
            vals, vecs = eigsh(L, k=2, which="SM", maxiter=5000, v0=v0)
            return vecs[:, np.argsort(vals)[1]]
        except Exception:
            return np.random.default_rng(0).standard_normal(n)


def _fiedler_split(nodes, ei, ej, w):
    """Split `nodes` in two by the Fiedler vector of the weighted
    sub-Laplacian; a boolean mask (True = side A) balanced at the median.

    A disconnected subgraph has a null space of several dimensions, in
    which the second eigenvector is any direction and no Fiedler vector:
    whole components are packed into two balanced sides first, so the
    spectral split only ever sees a connected graph."""
    n = len(nodes)
    if n <= 1:
        return np.zeros(n, dtype=bool)
    remap = -np.ones(nodes.max() + 1 if len(nodes) else 1, dtype=np.int64)
    remap[nodes] = np.arange(n)
    a = remap[ei]
    b = remap[ej]

    A = coo_matrix((w, (a, b)), shape=(n, n))
    ncomp, labels = connected_components(A, directed=False)
    if ncomp > 1:
        sizes = np.bincount(labels, minlength=ncomp)
        order = np.argsort(-sizes)
        side_of_comp = np.zeros(ncomp, dtype=bool)
        tot = [0, 0]
        for c in order:
            pick = int(tot[1] < tot[0])
            side_of_comp[c] = bool(pick)
            tot[pick] += int(sizes[c])
        if max(tot) <= 0.6 * n:
            return side_of_comp[labels]
        # one giant component and crumbs: split the giant spectrally and
        # put crumbs on side A up to half the nodes
        giant = order[0]
        sel_nodes = np.nonzero(labels == giant)[0]
        sub = (labels[a] == giant) & (labels[b] == giant)
        side_giant = _fiedler_split(nodes[sel_nodes], ei[sub], ej[sub],
                                    w[sub])
        side = np.zeros(n, dtype=bool)
        side[sel_nodes] = side_giant
        crumbs = np.nonzero(labels != giant)[0]
        need = n // 2 - int(side.sum())
        side[crumbs[:max(need, 0)]] = True
        return side

    L = coo_matrix((np.concatenate([-w, -w]),
                    (np.concatenate([a, b]), np.concatenate([b, a]))),
                   shape=(n, n)).tocsr()
    deg = -np.asarray(L.sum(axis=1)).ravel()
    L = L + coo_matrix((deg + 1e-9, (np.arange(n), np.arange(n))),
                       shape=(n, n))
    fiedler = np.arange(n, dtype=np.float64) if n <= 3 \
        else _fiedler_vector(L, n)
    # balanced at the median of the Fiedler vector; the nodes nearest it
    # move to make the halves exact
    thresh = np.median(fiedler)
    side = fiedler > thresh
    imbalance = int(side.sum()) - n // 2
    if imbalance != 0:
        for idx in np.argsort(np.abs(fiedler - thresh)):
            if imbalance > 0 and side[idx]:
                side[idx] = False
                imbalance -= 1
            elif imbalance < 0 and not side[idx]:
                side[idx] = True
                imbalance += 1
            if imbalance == 0:
                break
    return side


def partition_frames(scene: Scene, tracks: Tracks, num_parts: int
                     ) -> Partition:
    """Recursive spectral bisection of the frame covisibility graph."""
    f1, f2, w = covisibility_graph(scene, tracks)
    return partition_graph(scene.num_frames, f1, f2, w, num_parts)


def partition_graph(F: int, f1: np.ndarray, f2: np.ndarray, w: np.ndarray,
                    num_parts: int) -> Partition:
    """Partition a weighted graph of F nodes into num_parts parts by
    recursive balanced Fiedler bisection (parts of odd counts split
    num_parts - num_parts // 2 against num_parts // 2)."""
    w = w.astype(np.float64)
    part = np.zeros(F, dtype=np.int64)

    def recurse(nodes, parts_left, base):
        if parts_left <= 1 or len(nodes) <= 1:
            part[nodes] = base
            return
        in_set = np.zeros(F, dtype=bool)
        in_set[nodes] = True
        sel = in_set[f1] & in_set[f2]
        side = _fiedler_split(nodes, f1[sel], f2[sel], w[sel])
        half = parts_left // 2
        recurse(nodes[~side], parts_left - half, base)
        recurse(nodes[side], half, base + (parts_left - half))

    recurse(np.arange(F, dtype=np.int64), num_parts, 0)
    cut = float(w[part[f1] != part[f2]].sum())
    return Partition(frame_part=part, num_parts=num_parts, edge_cut=cut,
                     total_weight=float(w.sum()),
                     sizes=np.bincount(part, minlength=num_parts))


def assign_observations(scene: Scene, tracks: Tracks,
                        partition: Partition) -> np.ndarray:
    """Each observation's part: the part of its frame."""
    return partition.frame_part[scene.image_frame[tracks.obs_image]]
