"""3-D linear elasticity on Lagrange hexahedra of any order p (Q_p, H1).

MFEM's example 2 (``examples/ex2.cpp``, run as ``ex2 -m beam-hex.mesh -o
p``): a cantilever beam of ``elements = (nx, ny, nz)`` cubes of side ``h``,
clamped on the face x = 0 (boundary attribute 1), two materials with their
own Lame constants (lambda, mu).  Each element carries the (p+1)^3 nodes of
a tensor-product Lagrange basis at the Gauss-Lobatto points (MFEM's
default H1 basis), three displacement unknowns a node.  The element
stiffness ``KE`` is Gauss-Legendre quadrature with p+1 points per axis of

    K[(a, i), (b, j)] = int lambda d_i N_a d_j N_b + mu d_j N_a d_i N_b
                        + mu delta_ij grad N_a . grad N_b,

exact on affine cubes.  Element e contributes ``s_e KE_m`` for its
material m, with ``s_e`` ``q1_elasticity``'s SIMP law of a density drawn
per element from ``(seed, index)``: the pattern is fixed, the values change.

The pattern is node adjacency times 3x3 blocks: every entry of the element
blocks is kept, as MFEM's ``Assemble(0)`` keeps it.  On affine cubes some
entries are zero in every element matrix (lambda d_x N_a d_y N_b and its
mirror vanish when a and b share an interior Gauss-Lobatto coordinate
along x or y); they are stored zeros, and ``matrix`` checks that no other
entry cancels.

The matrices come in elimination order, and ``perm`` is None: the
operator numbers its nodes by the nested dissection below, as a mesh
generator may, and ``Session.analyze(a, ordering=None)`` reads the pattern
as it is stored, the stored zeros with it.  ``natural`` gives a matrix in
the free nodes' row-major order.

The ordering is a geometric nested dissection aligned with the elements:
a box of nodes is cut by the element-face plane nearest the middle of its
longest axis (in elements; the first such axis on a tie), the two halves
ordered, then the plane; a box spanning at most ``leaf`` elements on every
axis is a leaf.  In a leaf and in a separator the nodes are grouped by the
mesh entity they lie inside (cell, face, edge, vertex, in that order, then
by position), so each entity's nodes are consecutive, and each node's 3
unknowns ``3p, 3p+1, 3p+2`` are consecutive.  Free node (I, J, K) of the
lattice of ``(p nx + 1, p ny + 1, p nz + 1)`` nodes (I >= 1) is numbered
row-major over ``(p nx, p ny + 1, p nz + 1)``.

Assembly is vectorised NumPy and imports nothing of the measured program:
the pattern is built on node pairs (one sort of the elements' node pairs)
and expanded to 3x3 blocks by arithmetic; the map from element moduli to
entries (``q1_elasticity``'s) is built once, and each matrix is one
product with it.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import List, Tuple

import numpy as np
import scipy.sparse as sp


def _sibling(name: str):
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_lagrange_elasticity_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_q1 = _sibling("q1_elasticity")
rng = _q1.rng  # the generator of draw ``stream`` for factorization ``index``


def gll_points(p: int) -> np.ndarray:
    """The p+1 Gauss-Lobatto-Legendre points on [-1, 1], ascending: the
    ends and the roots of P_p'."""
    inner = np.polynomial.legendre.Legendre.basis(p).deriv().roots().real
    return np.concatenate([[-1.0], np.sort(inner), [1.0]])


def lagrange_1d(nodes: np.ndarray, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Values and derivatives of the Lagrange polynomials of ``nodes`` at
    ``x``: arrays (len(x), len(nodes))."""
    k = len(nodes)
    val = np.ones((len(x), k))
    der = np.zeros((len(x), k))
    for a in range(k):
        others = [b for b in range(k) if b != a]
        for b in others:
            val[:, a] *= (x - nodes[b]) / (nodes[a] - nodes[b])
        for c in others:
            t = np.full(len(x), 1.0 / (nodes[a] - nodes[c]))
            for b in others:
                if b != c:
                    t *= (x - nodes[b]) / (nodes[a] - nodes[b])
            der[:, a] += t
    return val, der


def element_stiffness(p: int, lam: float, mu: float, h: float) -> np.ndarray:
    """``KE`` (3(p+1)^3 square) of a cube of side ``h``; local node
    ``a = (a_x (p+1) + a_y)(p+1) + a_z`` sits at the Gauss-Lobatto point
    ``(a_x, a_y, a_z)``, and local unknown ``3a + i`` is its displacement
    along axis i.  Exactly symmetric."""
    val, der = lagrange_1d(gll_points(p), np.polynomial.legendre.leggauss(p + 1)[0])
    w = np.polynomial.legendre.leggauss(p + 1)[1]
    k = p + 1
    s = 2.0 / h  # d xi / d x
    grads = [np.einsum("ia,jb,kc->ijkabc", *f).reshape(k**3, k**3) * s
             for f in ((der, val, val), (val, der, val), (val, val, der))]
    g = np.stack(grads, axis=-1)  # (point, node, axis)
    wq = np.einsum("i,j,k->ijk", w, w, w).ravel() * (h / 2.0) ** 3
    t1 = np.einsum("q,qai,qbj->aibj", wq, g, g)
    t2 = np.einsum("q,qaj,qbi->aibj", wq, g, g)
    t3 = np.einsum("q,qak,qbk->ab", wq, g, g)
    ke = lam * t1 + mu * t2 + mu * t3[:, None, :, None] * np.eye(3)[None, :, None, :]
    ke = ke.reshape(3 * k**3, 3 * k**3)
    return (ke + ke.T) / 2.0


def _entity(c: np.ndarray, p: int) -> np.ndarray:
    """Along one axis: 2e at the element face e, 2e+1 inside element e."""
    return np.where(c % p == 0, 2 * (c // p), 2 * (c // p) + 1)


def _ordered(box: List[Tuple[int, int]], p: int) -> np.ndarray:
    """The lattice nodes of ``box`` (half-open per axis) grouped by mesh
    entity: cells, faces, edges, vertices, each by position, its nodes
    row-major; as (count, 3) lattice coordinates."""
    axes = np.meshgrid(*[np.arange(lo, hi) for lo, hi in box], indexing="ij")
    xyz = np.stack([a.ravel() for a in axes], axis=1)
    ent = np.stack([_entity(xyz[:, d], p) for d in range(3)], axis=1)
    dim = (ent % 2).sum(axis=1)
    order = np.lexsort((xyz[:, 2], xyz[:, 1], xyz[:, 0], ent[:, 2], ent[:, 1], ent[:, 0], -dim))
    return xyz[order]


def nested_dissection(elements: Tuple[int, int, int], p: int, leaf: int) -> np.ndarray:
    """Lattice coordinates (free nodes, I >= 1) in elimination order, shape
    (nodes, 3)."""
    lat = [p * e + 1 for e in elements]
    out: List[np.ndarray] = []
    # ("box", box) orders a box; ("sep", box) emits a finished separator
    stack = [("box", [(1, lat[0]), (0, lat[1]), (0, lat[2])])]
    while stack:
        kind, box = stack.pop()
        if min(hi - lo for lo, hi in box) <= 0:
            continue
        # element-face planes strictly inside, with nodes on both sides
        planes = [[c for c in range(lo + 1, hi - 1) if c % p == 0] for lo, hi in box]
        span = [len(c) + 1 for c in planes]
        ax = int(np.argmax(span))
        if kind == "sep" or span[ax] <= leaf:
            out.append(_ordered(box, p))
            continue
        mid = planes[ax][len(planes[ax]) // 2]
        low = box[:ax] + [(box[ax][0], mid)] + box[ax + 1:]
        high = box[:ax] + [(mid + 1, box[ax][1])] + box[ax + 1:]
        sep = box[:ax] + [(mid, mid + 1)] + box[ax + 1:]
        # popped in reverse: the low half, the high half, then the separator
        stack += [("sep", sep), ("box", high), ("box", low)]
    xyz = np.concatenate(out)
    if len(xyz) != (lat[0] - 1) * lat[1] * lat[2]:
        raise AssertionError("nested dissection lost nodes")
    return xyz


class Operator(_q1.Operator):
    """The configuration's operator: its pattern once, its values per draw
    (``q1_elasticity``'s SIMP moduli through its map)."""

    def __init__(self, cfg: dict) -> None:
        p = self.order = int(cfg["order"])
        self.dims = tuple(int(x) for x in cfg["elements"])
        if p < 1 or len(self.dims) != 3 or min(self.dims) < 1:
            raise ValueError(f"need order >= 1 and 3 axes of elements, got {p}, {self.dims}")
        if cfg["clamped"] != "x0":
            raise ValueError(f"only the face x = 0 is clamped, got {cfg['clamped']!r}")
        simp, dens = cfg["simp"], cfg["density"]
        if dens["law"] != "uniform" or dens["per"] != "element":
            raise ValueError(f"unsupported density law {dens}")
        self.e0, self.emin, self.penal = float(simp["E0"]), float(simp["Emin"]), float(simp["penal"])
        self.low, self.high = float(dens["low"]), float(dens["high"])
        h = float(cfg["h"])
        lat = np.array([p * e + 1 for e in self.dims])
        free = (lat[0] - 1, lat[1], lat[2])
        n_nodes = int(np.prod(free))
        self.n = 3 * n_nodes
        xyz = nested_dissection(self.dims, p, int(cfg["ordering"]["leaf"]))
        nodes = ((xyz[:, 0] - 1) * free[1] + xyz[:, 1]) * free[2] + xyz[:, 2]
        # unknown k in elimination order is unknown elimination[k] row-major
        self.elimination = (3 * nodes[:, None] + np.arange(3)).ravel()
        self.perm = None  # the matrices are in elimination order already
        node_at = np.empty(n_nodes, dtype=np.int64)  # natural node -> elimination
        node_at[nodes] = np.arange(n_nodes)

        # each element's nodes in elimination order, -1 where clamped
        k = p + 1
        ex, ey, ez = (a.ravel() for a in np.meshgrid(
            *[np.arange(x) for x in self.dims], indexing="ij"))
        loc = np.stack([a.ravel() for a in np.meshgrid(*[np.arange(k)] * 3, indexing="ij")], 1)
        gi, gj, gk = (p * e[:, None] + loc[None, :, d] for d, e in enumerate((ex, ey, ez)))
        nat = ((gi - 1) * free[1] + gj) * free[2] + gk
        enode = np.where(gi >= 1, node_at[np.maximum(nat, 0)], -1)  # (elements, k^3)
        n_el = len(ex)
        centre = (ex + 0.5) * h
        self.material = np.full(n_el, -1, dtype=np.int64)
        kes = []
        for m, mat in enumerate(cfg["materials"]):
            lo, hi = mat["x"]
            self.material[(centre >= lo) & (centre < hi)] = m
            kes.append(element_stiffness(p, float(mat["lambda"]), float(mat["mu"]), h))
        if (self.material < 0).any():
            raise ValueError("an element lies in no material's x range")

        # node pairs sharing an element, in elimination order: one sort
        a, b = np.meshgrid(np.arange(k**3), np.arange(k**3), indexing="ij")
        a, b = a.ravel(), b.ravel()
        ra, cb = enode[:, a], enode[:, b]  # (elements, k^6)
        ok = (ra >= 0) & (cb >= 0)
        pair, inv = np.unique((ra * n_nodes + cb)[ok], return_inverse=True)
        del ra, cb
        prow = pair // n_nodes
        cols = (pair % n_nodes).astype(np.int64)
        nptr = np.searchsorted(prow, np.arange(n_nodes + 1))
        deg = np.diff(nptr)
        # node pair q of node row r holds the 3x3 block at row 3r + i,
        # columns 3c + j: entry 9 nptr[r] + 3 i deg[r] + 3 (q - nptr[r]) + j
        base = 9 * nptr[prow] + 3 * (np.arange(len(pair)) - nptr[prow])
        self.indptr = np.concatenate([[0], np.cumsum(np.repeat(3 * deg, 3))]).astype(np.int64)
        nnz = int(self.indptr[-1])
        if nnz >= 2**31:
            raise ValueError(f"{nnz} entries: past 32-bit indices")
        self.indptr = self.indptr.astype(np.int32)
        self.indices = np.empty(nnz, dtype=np.int32)
        for i in range(3):
            row_off = base + i * 3 * deg[prow]
            for j in range(3):
                self.indices[row_off + j] = 3 * cols + j
        del cols
        # entries = M @ moduli: element e's entry (3a + i, 3b + j) of its
        # material's KE at its block's place; entries that KE leaves zero
        # are left out of the map (stored zeros)
        elem = np.broadcast_to(np.arange(n_el)[:, None], ok.shape)[ok]
        la, lb = np.broadcast_to(a, ok.shape)[ok], np.broadcast_to(b, ok.shape)[ok]
        q = inv.ravel()
        del ok
        pos, col, val = [], [], []
        for i in range(3):
            for j in range(3):
                v = np.empty(len(q))
                for m, ke in enumerate(kes):
                    sel = self.material[elem] == m
                    v[sel] = ke[3 * la[sel] + i, 3 * lb[sel] + j]
                nz = v != 0
                pos.append(base[q[nz]] + i * 3 * deg[prow[q[nz]]] + j)
                col.append(elem[nz].astype(np.int32))
                val.append(v[nz])
        del elem, la, lb, q, base, prow
        pos, col, val = np.concatenate(pos), np.concatenate(col), np.concatenate(val)
        self.map = sp.csr_matrix((val, (pos, col)), shape=(nnz, n_el))
        del pos, col, val
        self.stored_zero = np.diff(self.map.indptr) == 0
        self.nonzero = nnz - int(self.stored_zero.sum())

    def matrix(self, seed: int, index: int, original_order: bool = False) -> sp.csr_matrix:
        """The ``index``-th matrix of ``seed``, in elimination order, which
        is the operator's own order (``original_order`` gives the same)."""
        data = self.map @ self.moduli(seed, index).ravel()
        # the stored zeros have no term in the map, so they are 0 exactly
        if np.count_nonzero(data) != self.nonzero:
            raise AssertionError("an assembled entry cancelled: the pattern would change")
        return sp.csr_matrix((data, self.indices, self.indptr), shape=(self.n, self.n))

    def natural(self, a: sp.csr_matrix) -> sp.csr_matrix:
        """``a`` (in elimination order) in the free nodes' row-major order."""
        coo = a.tocoo()
        return sp.csr_matrix(
            (coo.data, (self.elimination[coo.row], self.elimination[coo.col])),
            shape=(self.n, self.n))
