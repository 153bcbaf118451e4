"""Exact minimum (weighted) vertex cover on bipartite graphs.

A copy of ``repro.core.mwvc`` (NumPy only): the port keeps its own
host-side code so that it never imports the JAX package.

This is SHIRO's optimization core (paper §5.3): every nonzero (i, j) of an
off-diagonal block A^(p,q) is an edge between row-vertex i and col-vertex j;
a vertex cover selects which C-rows (row vertices) and B-rows (col vertices)
are communicated. Minimum cover == minimum communication volume.

Two exact solvers, both polynomial:

* ``min_vertex_cover_unweighted`` — Hopcroft–Karp maximum matching +
  König's theorem (paper §7.1.4's "faster implementation for the
  uniform-weight case").
* ``min_vertex_cover_weighted`` — Dinic max-flow on the s-t network of
  paper Fig. 4 (s→row_i cap w_i^row, col_j→t cap w_j^col, edges cap ∞);
  the min s-t cut IS the optimal cover (paper §5.3.2). In this network
  every level-graph augmenting path is exactly s→L→R→t (length 3), so
  the DFS depth is constant.

Inputs are edge lists over *compacted* vertex ids; helpers in planner.py
build those from CSR blocks.
"""
from __future__ import annotations

import sys
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "hopcroft_karp",
    "min_vertex_cover_unweighted",
    "min_vertex_cover_weighted",
    "cover_is_valid",
]

_INF = float("inf")


def _build_adj(n_left: int, edges_u: np.ndarray, edges_v: np.ndarray) -> List[np.ndarray]:
    """Adjacency lists for left vertices (vectorized bucketing)."""
    order = np.argsort(edges_u, kind="stable")
    u_sorted = edges_u[order]
    v_sorted = edges_v[order]
    starts = np.searchsorted(u_sorted, np.arange(n_left + 1))
    return [v_sorted[starts[u] : starts[u + 1]] for u in range(n_left)]


def hopcroft_karp(
    n_left: int, n_right: int, edges_u: np.ndarray, edges_v: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Maximum bipartite matching in O(E sqrt(V)).

    Returns (match_l, match_r): match_l[u] = matched right vertex or -1.
    """
    adj = _build_adj(n_left, np.asarray(edges_u), np.asarray(edges_v))
    match_l = np.full(n_left, -1, dtype=np.int64)
    match_r = np.full(n_right, -1, dtype=np.int64)
    dist = np.zeros(n_left, dtype=np.float64)

    def bfs() -> bool:
        q: deque = deque()
        for u in range(n_left):
            if match_l[u] == -1:
                dist[u] = 0.0
                q.append(u)
            else:
                dist[u] = _INF
        found = False
        while q:
            u = q.popleft()
            for v in adj[u]:
                w = int(match_r[v])
                if w == -1:
                    found = True
                elif dist[w] == _INF:
                    dist[w] = dist[u] + 1.0
                    q.append(w)
        return found

    def dfs(u: int) -> bool:
        for v in adj[u]:
            v = int(v)
            w = int(match_r[v])
            if w == -1 or (dist[w] == dist[u] + 1.0 and dfs(w)):
                match_l[u] = v
                match_r[v] = u
                return True
        dist[u] = _INF
        return False

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000 + 2 * n_left))
    try:
        while bfs():
            for u in range(n_left):
                if match_l[u] == -1:
                    dfs(u)
    finally:
        sys.setrecursionlimit(old_limit)
    return match_l, match_r


def min_vertex_cover_unweighted(
    n_left: int, n_right: int, edges_u, edges_v
) -> Tuple[np.ndarray, np.ndarray]:
    """König's theorem: min vertex cover from maximum matching.

    Returns boolean masks (cover_left[n_left], cover_right[n_right]).
    |cover| == |max matching| (König), and the cover covers every edge.
    """
    edges_u = np.asarray(edges_u, dtype=np.int64)
    edges_v = np.asarray(edges_v, dtype=np.int64)
    if edges_u.size == 0:
        return np.zeros(n_left, bool), np.zeros(n_right, bool)
    match_l, match_r = hopcroft_karp(n_left, n_right, edges_u, edges_v)
    adj = _build_adj(n_left, edges_u, edges_v)

    # Z = unmatched left vertices plus everything reachable by alternating
    # paths (left->right via non-matching edges, right->left via matching).
    visited_l = np.zeros(n_left, bool)
    visited_r = np.zeros(n_right, bool)
    q: deque = deque(int(u) for u in range(n_left) if match_l[u] == -1)
    for u in q:
        visited_l[u] = True
    while q:
        u = q.popleft()
        for v in adj[u]:
            v = int(v)
            if not visited_r[v]:
                visited_r[v] = True
                w = int(match_r[v])
                if w != -1 and not visited_l[w]:
                    visited_l[w] = True
                    q.append(w)
    # Cover = (L \ Z) ∪ (R ∩ Z); isolated left vertices never need covering.
    deg = np.zeros(n_left, np.int64)
    np.add.at(deg, edges_u, 1)
    cover_left = ~visited_l & (deg > 0)
    cover_right = visited_r
    return cover_left, cover_right


class _Dinic:
    """Dinic max-flow (paper §5.3.2, ref [11]) on a static graph.

    Edge arrays; reverse edge of e is e^1. For the bipartite-cover network
    every augmenting path is s→L→R→t so the recursive DFS depth is 4.
    """

    def __init__(self, n: int):
        self.n = n
        self.to: List[int] = []
        self.cap: List[float] = []
        self.nxt: List[int] = []
        self.head = [-1] * n

    def add_edge(self, u: int, v: int, c: float) -> None:
        for a, b, cc in ((u, v, c), (v, u, 0.0)):
            self.to.append(b)
            self.cap.append(cc)
            self.nxt.append(self.head[a])
            self.head[a] = len(self.to) - 1

    def _bfs(self, s: int, t: int) -> Optional[List[int]]:
        level = [-1] * self.n
        level[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            e = self.head[u]
            while e != -1:
                v = self.to[e]
                if self.cap[e] > 1e-12 and level[v] == -1:
                    level[v] = level[u] + 1
                    q.append(v)
                e = self.nxt[e]
        return level if level[t] != -1 else None

    def _dfs(self, u: int, t: int, f: float, level: List[int], it: List[int]) -> float:
        if u == t:
            return f
        while it[u] != -1:
            e = it[u]
            v = self.to[e]
            if self.cap[e] > 1e-12 and level[v] == level[u] + 1:
                d = self._dfs(v, t, min(f, self.cap[e]), level, it)
                if d > 1e-12:
                    self.cap[e] -= d
                    self.cap[e ^ 1] += d
                    return d
            it[u] = self.nxt[e]
        return 0.0

    def max_flow(self, s: int, t: int) -> float:
        flow = 0.0
        while True:
            level = self._bfs(s, t)
            if level is None:
                return flow
            it = list(self.head)
            while True:
                f = self._dfs(s, t, _INF, level, it)
                if f <= 1e-12:
                    break
                flow += f

    def min_cut_reachable(self, s: int) -> np.ndarray:
        """Vertices reachable from s in the residual graph (after max_flow)."""
        seen = np.zeros(self.n, bool)
        seen[s] = True
        q = deque([s])
        while q:
            u = q.popleft()
            e = self.head[u]
            while e != -1:
                v = self.to[e]
                if self.cap[e] > 1e-12 and not seen[v]:
                    seen[v] = True
                    q.append(v)
                e = self.nxt[e]
        return seen


def min_vertex_cover_weighted(
    n_left: int,
    n_right: int,
    edges_u,
    edges_v,
    w_left: Optional[Sequence[float]] = None,
    w_right: Optional[Sequence[float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Minimum *weighted* vertex cover via max-flow min-cut (paper Fig. 4).

    Network: s --w_left[i]--> row_i --inf--> col_j --w_right[j]--> t.
    After max flow, min cut selects: row i iff (s,i) is cut (i NOT
    reachable from s in the residual graph), col j iff (j,t) is cut
    (j reachable from s).
    """
    edges_u = np.asarray(edges_u, dtype=np.int64)
    edges_v = np.asarray(edges_v, dtype=np.int64)
    if edges_u.size == 0:
        return np.zeros(n_left, bool), np.zeros(n_right, bool)
    if w_left is None and w_right is None:
        return min_vertex_cover_unweighted(n_left, n_right, edges_u, edges_v)
    wl = np.ones(n_left) if w_left is None else np.asarray(w_left, dtype=np.float64)
    wr = np.ones(n_right) if w_right is None else np.asarray(w_right, dtype=np.float64)

    # de-duplicate edges
    key = edges_u * n_right + edges_v
    uniq = np.unique(key)
    eu = (uniq // n_right).astype(np.int64)
    ev = (uniq % n_right).astype(np.int64)

    s = n_left + n_right
    t = s + 1
    net = _Dinic(n_left + n_right + 2)
    inf_cap = float(wl.sum() + wr.sum() + 1.0)
    touched_l = np.zeros(n_left, bool)
    touched_r = np.zeros(n_right, bool)
    touched_l[eu] = True
    touched_r[ev] = True
    for i in range(n_left):
        if touched_l[i]:
            net.add_edge(s, i, float(wl[i]))
    for j in range(n_right):
        if touched_r[j]:
            net.add_edge(n_left + j, t, float(wr[j]))
    for a, b in zip(eu, ev):
        net.add_edge(int(a), n_left + int(b), inf_cap)
    net.max_flow(s, t)
    reach = net.min_cut_reachable(s)
    cover_left = touched_l & ~reach[:n_left]
    cover_right = touched_r & reach[n_left : n_left + n_right]
    return cover_left, cover_right


def cover_is_valid(edges_u, edges_v, cover_left: np.ndarray, cover_right: np.ndarray) -> bool:
    """Every edge must have at least one covered endpoint (paper Eq. 8)."""
    edges_u = np.asarray(edges_u, dtype=np.int64)
    edges_v = np.asarray(edges_v, dtype=np.int64)
    if edges_u.size == 0:
        return True
    return bool(np.all(cover_left[edges_u] | cover_right[edges_v]))
