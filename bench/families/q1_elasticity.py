"""3-D linear elasticity on trilinear (Q1, 8-node) hexahedra.

The stiffness of a box of ``grid = (nx, ny, nz)`` unit-cube elements with
three displacement unknowns a node and every boundary node clamped, as in
Liu & Tovar's ``top3d`` (Struct. Multidiscip. Optim. 50:1175-1196, 2014):
the element stiffness ``KE`` is 2x2x2 Gauss quadrature of B^T D B with
E = 1 and Poisson's ratio nu, and element e contributes ``E_e KE`` with
the SIMP modulus ``E_e = Emin + x_e^p (E0 - Emin)``.  Each factorization
draws new densities ``x_e`` uniform on [low, high] from ``(seed, index)``,
so the pattern is fixed and the values change, as in a topology
optimisation's loop.

The pattern is node adjacency times 3x3 blocks: KE has no zero entry, and
with densities drawn per element no assembled entry cancels, which the
operator checks.  The ordering is ``grid_diffusion``'s geometric nested
dissection of the free nodes, node p's unknowns ``3p, 3p+1, 3p+2`` kept
consecutive.  Free node (i, j, k) (the node at (i+1, j+1, k+1)) is numbered
row-major over ``(nx-1, ny-1, nz-1)``.

Assembly is vectorised NumPy and imports nothing of the measured program:
the pattern and a sparse map from the element moduli to the matrix's
entries are built once, and each matrix is one product with that map.
"""
from __future__ import annotations

import importlib.util
import itertools
from pathlib import Path

import numpy as np
import scipy.sparse as sp


def _sibling(name: str):
    path = Path(__file__).resolve().parent / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_q1_elasticity_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_grid = _sibling("grid_diffusion")
rng = _grid.rng  # the generator of draw ``stream`` for factorization ``index``

# local node a of an element lies at the element's corner (a_x, a_y, a_z),
# the bits of a with x the highest
CORNERS = np.array(list(itertools.product((0, 1), repeat=3)), dtype=np.int64)


def element_stiffness(nu: float) -> np.ndarray:
    """KE (24x24) of the unit cube, E = 1: sum over the 2x2x2 Gauss points
    of B^T D B det J; local unknown 3a + d is node a's displacement d."""
    lam = nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = 1.0 / (2.0 * (1.0 + nu))
    d = np.zeros((6, 6))
    d[:3, :3] = lam
    d[np.arange(3), np.arange(3)] += 2.0 * mu
    d[np.arange(3, 6), np.arange(3, 6)] = mu
    s = 2.0 * CORNERS - 1.0  # the corners in [-1, 1]^3
    g = 1.0 / np.sqrt(3.0)
    ke = np.zeros((24, 24))
    for point in itertools.product((-g, g), repeat=3):
        f = 1.0 + s * np.array(point)  # (8, 3): the factors of each N_a
        grad = np.empty((8, 3))  # dN_a/dx = 2 dN_a/dxi
        for k in range(3):
            others = [m for m in range(3) if m != k]
            grad[:, k] = 2.0 * s[:, k] * f[:, others[0]] * f[:, others[1]] / 8.0
        b = np.zeros((6, 24))
        for k in range(3):
            b[k, k::3] = grad[:, k]
        for row, (p, q) in zip((3, 4, 5), ((0, 1), (1, 2), (0, 2))):
            b[row, p::3] = grad[:, q]
            b[row, q::3] = grad[:, p]
        ke += b.T @ d @ b / 8.0  # det J of the map from [-1, 1]^3
    return ke


class Operator:
    """The configuration's operator: its pattern once, its values per draw."""

    def __init__(self, cfg: dict) -> None:
        self.dims = tuple(int(x) for x in cfg["grid"])
        if len(self.dims) != 3 or min(self.dims) < 2:
            raise ValueError(f"grid must be 3 axes of at least 2 elements, got {self.dims}")
        mat, dens = cfg["material"], cfg["density"]
        if dens["law"] != "uniform" or dens["per"] != "element":
            raise ValueError(f"unsupported density law {dens}")
        self.e0, self.emin, self.penal = float(mat["E0"]), float(mat["Emin"]), float(mat["penal"])
        self.low, self.high = float(dens["low"]), float(dens["high"])
        free = tuple(x - 1 for x in self.dims)
        n_nodes = int(np.prod(free))
        self.n = 3 * n_nodes
        nodes = _grid.nested_dissection(free, int(cfg["ordering"]["leaf"]))
        self.perm = (3 * nodes[:, None] + np.arange(3)).ravel()
        self.iperm = np.empty_like(self.perm)
        self.iperm[self.perm] = np.arange(self.n)

        # each element's 24 unknowns in elimination order, -1 where clamped
        ex, ey, ez = (a.ravel() for a in np.meshgrid(
            *[np.arange(x) for x in self.dims], indexing="ij"))
        ijk = [e[:, None] + CORNERS[None, :, k] - 1 for k, e in enumerate((ex, ey, ez))]
        inside = np.ones(ijk[0].shape, dtype=bool)
        for a, m in zip(ijk, free):
            inside &= (a >= 0) & (a < m)
        node = (ijk[0] * free[1] + ijk[1]) * free[2] + ijk[2]
        dof = 3 * node[:, :, None] + np.arange(3)  # (elements, 8, 3)
        dof = np.where(inside[:, :, None], self.iperm[np.clip(dof, 0, self.n - 1)], -1)
        dof = dof.reshape(-1, 24)
        n_el = dof.shape[0]
        ke = element_stiffness(float(mat["nu"]))
        if not (ke != 0).all():
            raise AssertionError("KE has a zero entry: the block pattern would not be full")
        r = np.repeat(dof, 24, axis=1).ravel()
        c = np.tile(dof, (1, 24)).ravel()
        keep = (r >= 0) & (c >= 0)
        elem = np.repeat(np.arange(n_el), 576)[keep]
        val = np.tile(ke.ravel(), n_el)[keep]
        key, pos = np.unique(r[keep] * self.n + c[keep], return_inverse=True)
        del r, c, keep
        rows = key // self.n
        self.indices = (key % self.n).astype(np.int32)
        self.indptr = np.searchsorted(rows, np.arange(self.n + 1)).astype(np.int32)
        # entries = M @ moduli
        self.map = sp.csr_matrix((val, (pos.ravel(), elem)), shape=(len(key), n_el))
        # node adjacency times 3x3 blocks, and nothing else
        adj = sp.csr_matrix((np.ones(len(key), dtype=bool), (rows // 3, self.indices // 3)),
                            shape=(n_nodes, n_nodes))
        adj.sum_duplicates()
        if adj.nnz * 9 != len(key):
            raise AssertionError("the assembled pattern is not node adjacency x 3x3 blocks")

    def moduli(self, seed: int, index: int) -> np.ndarray:
        """The SIMP moduli of the elements, shape ``grid``."""
        x = rng(seed, index, 0).uniform(self.low, self.high, size=self.dims)
        return self.emin + x**self.penal * (self.e0 - self.emin)

    def matrix(self, seed: int, index: int, original_order: bool = False) -> sp.csr_matrix:
        """The ``index``-th matrix of ``seed``, in elimination order (or in
        the free nodes' row-major order with ``original_order``)."""
        data = self.map @ self.moduli(seed, index).ravel()
        if not data.all():
            raise AssertionError("an assembled entry cancelled: the pattern would change")
        a = sp.csr_matrix((data, self.indices, self.indptr), shape=(self.n, self.n))
        if not original_order:
            return a
        coo = a.tocoo()
        return sp.csr_matrix((coo.data, (self.perm[coo.row], self.perm[coo.col])),
                             shape=(self.n, self.n))
