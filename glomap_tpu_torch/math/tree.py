"""Host graph utilities: maximum spanning tree and BFS order.

Counterpart of glomap_tpu/math/tree.py (the port's own copy), itself the
counterpart of glomap/math/tree.{h,cc} (Boost Kruskal maximum spanning
tree, then BFS). Small and irregular: host numpy and scipy.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import breadth_first_order, minimum_spanning_tree


def maximum_spanning_tree(num_nodes: int, edges_i: np.ndarray,
                          edges_j: np.ndarray, weights: np.ndarray):
    """Maximum spanning tree; returns (parent, bfs_order, root).

    parent[v] is v's parent in the BFS tree (-1 for the root and for nodes
    it does not reach). The weights are maximized: scipy's minimum
    spanning tree runs on their negation, shifted below zero so that no
    entry reads as "no edge"."""
    if len(edges_i) == 0 or num_nodes == 0:
        return (np.full(num_nodes, -1, dtype=np.int64),
                np.arange(num_nodes, dtype=np.int64), 0)
    w = np.asarray(weights, dtype=np.float64)
    wmax = w.max()
    g = coo_matrix((-(w - wmax - 1.0), (edges_i, edges_j)),
                   shape=(num_nodes, num_nodes))
    g = g + g.T  # symmetrize
    mst = minimum_spanning_tree(g.tocsr())
    mst = mst + mst.T
    # root at the node with the largest incident weight sum
    deg = np.bincount(edges_i, weights=w, minlength=num_nodes) + \
        np.bincount(edges_j, weights=w, minlength=num_nodes)
    root = int(np.argmax(deg))
    order, parent = breadth_first_order(mst, root, directed=False,
                                        return_predecessors=True)
    parent = np.asarray(parent, dtype=np.int64)
    parent[parent < 0] = -1  # scipy marks unreached nodes with -9999
    parent[root] = -1
    return parent, np.asarray(order, dtype=np.int64), root
