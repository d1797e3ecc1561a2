"""Fill-reducing orderings.

Nested dissection for grid graphs (geometric, optimal-order fill for
Laplacians — produces the deep balanced assembly trees of the paper's data
set) and a plain minimum-degree for general symmetric patterns.
"""
from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np
import scipy.sparse as sp


def nested_dissection_2d(nx: int, ny: Optional[int] = None, leaf: int = 4) -> np.ndarray:
    """Order grid points by recursive separator bisection.

    Returns ``perm`` with perm[k] = original index of the k-th eliminated
    point (separators eliminated last).
    """
    ny = ny or nx
    order: List[int] = []

    def idx(i, j):
        return i * ny + j

    def rec(x0, x1, y0, y1):
        # eliminate [x0,x1) × [y0,y1)
        w, h = x1 - x0, y1 - y0
        if w <= 0 or h <= 0:
            return
        if w * h <= leaf:
            for i in range(x0, x1):
                for j in range(y0, y1):
                    order.append(idx(i, j))
            return
        if w >= h:
            mid = x0 + w // 2
            rec(x0, mid, y0, y1)
            rec(mid + 1, x1, y0, y1)
            for j in range(y0, y1):  # separator column
                order.append(idx(mid, j))
        else:
            mid = y0 + h // 2
            rec(x0, x1, y0, mid)
            rec(x0, x1, mid + 1, y1)
            for i in range(x0, x1):
                order.append(idx(i, mid))

    # iterative wrapper to avoid deep recursion on large grids
    import sys

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10 * (nx + ny) + 1000))
    try:
        rec(0, nx, 0, ny)
    finally:
        sys.setrecursionlimit(old)
    assert len(order) == nx * ny
    return np.array(order, dtype=np.int64)


def min_degree(a: sp.csr_matrix) -> np.ndarray:
    """Plain minimum-degree ordering (clique-forming elimination).

    O(n·deg²) — intended for the moderate test/benchmark matrices; grids use
    nested dissection instead.
    """
    n = a.shape[0]
    coo = a.tocoo()
    adj = [set() for _ in range(n)]
    for i, j in zip(coo.row, coo.col):
        if i != j:
            adj[i].add(int(j))
    heap = [(len(adj[i]), i) for i in range(n)]
    heapq.heapify(heap)
    eliminated = np.zeros(n, dtype=bool)
    order = []
    while heap:
        d, v = heapq.heappop(heap)
        if eliminated[v] or d != len(adj[v]):
            continue
        eliminated[v] = True
        order.append(v)
        nbrs = [u for u in adj[v] if not eliminated[u]]
        for u in nbrs:
            adj[u].discard(v)
        for ii, u in enumerate(nbrs):
            for w in nbrs[ii + 1 :]:
                if w not in adj[u]:
                    adj[u].add(w)
                    adj[w].add(u)
        for u in nbrs:
            heapq.heappush(heap, (len(adj[u]), u))
        adj[v] = set()
    return np.array(order, dtype=np.int64)
