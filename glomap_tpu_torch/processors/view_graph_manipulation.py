"""View-graph manipulation: the strong-clustering core.

Counterpart of glomap_tpu/processors/view_graph_manipulation.py
(strong_cluster_labels), from the reference's
glomap/processors/view_graph_manipulation.cc (EstablishStrongClusters,
:70-177). The rest of the module (pair configurations, relative-pose
decomposition, sparsification, the view-graph clusterer) belongs to
stages 0-2 and is not ported yet.
"""

from __future__ import annotations

import numpy as np

from glomap_tpu_torch import native


def strong_cluster_labels(num_nodes: int, f1: np.ndarray, f2: np.ndarray,
                          w: np.ndarray, thres: float,
                          weak_factor: float = 0.75,
                          min_weak_links: int = 2,
                          rounds: int = 10) -> np.ndarray:
    """Strong-clustering core (EstablishStrongClusters,
    view_graph_manipulation.cc:70-177): connected components over edges
    with w > thres, then iterative merging of clusters joined by at least
    `min_weak_links` slightly-weaker edges (w >= weak_factor * thres).
    One native connected-components pass per round; reconstruction
    pruning uses it, and so will the view-graph clusterer.

    A merge joins the two clusters' first nodes, as the reference unions
    their roots. The JAX package joins the nodes whose indices equal the
    two cluster labels, which merges other clusters where a label is not
    its cluster's first node (ROADMAP C.6)."""
    f1 = np.asarray(f1, np.int64)
    f2 = np.asarray(f2, np.int64)
    strong = w > thres
    acc_i = [f1[strong]]
    acc_j = [f2[strong]]
    labels = native.connected_components(
        num_nodes, acc_i[0], acc_j[0])
    weak = w >= weak_factor * thres
    for _ in range(rounds):
        ra = labels[f1]
        rb = labels[f2]
        cross = weak & (ra != rb)
        if not cross.any():
            break
        lo = np.minimum(ra[cross], rb[cross]).astype(np.int64)
        hi = np.maximum(ra[cross], rb[cross]).astype(np.int64)
        key = lo * num_nodes + hi
        uniq, n = np.unique(key, return_counts=True)
        mergeable = uniq[n >= min_weak_links]
        if len(mergeable) == 0:
            break
        # labels count up in the order of their first node
        first = np.unique(labels, return_index=True)[1]
        acc_i.append(first[mergeable // num_nodes])
        acc_j.append(first[mergeable % num_nodes])
        labels = native.connected_components(
            num_nodes, np.concatenate(acc_i), np.concatenate(acc_j))
    return labels
