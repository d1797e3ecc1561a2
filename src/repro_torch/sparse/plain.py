"""Plain references for 3-D linear elasticity on trilinear hexahedra.

They define what the port's analysis and factorization must give on a
Q1 elasticity operator (``torch`` and NumPy only, no kernel of the port;
tests hold the port against them):

* :func:`q1_element_stiffness`: the 24×24 element stiffness ``KE`` as
  Liu & Tovar's ``top3d`` defines it (Struct. Multidiscip. Optim.
  50:1175–1196, 2014): the unit cube, E = 1, 2×2×2 Gauss quadrature of
  BᵀDB;
* :func:`assemble_q1`: the global stiffness of a box of elements with
  per-element moduli, every boundary node clamped, by a loop over elements;
* :func:`symbolic_structure`: struct(L) by boolean elimination on a dense
  pattern;
* :func:`dense_factor`: the dense Cholesky factor in float64.

Node (i, j, k) of the ``(nx+1, ny+1, nz+1)`` grid of nodes is free when it
lies inside the box; free nodes are numbered row-major over
``(nx-1, ny-1, nz-1)`` and node p carries unknowns ``3p, 3p+1, 3p+2``
(displacements along x, y, z).  Local node a of an element at
``(ex, ey, ez)`` sits at ``(ex + a_x, ey + a_y, ez + a_z)`` with
``(a_x, a_y, a_z)`` the bits of ``a`` (x the highest), and its local
unknowns are ``3a, 3a+1, 3a+2``.
"""
from __future__ import annotations

import itertools
from typing import Optional, Sequence

import numpy as np
import torch

CORNERS = tuple(itertools.product((0, 1), repeat=3))  # local node a → bits


def q1_element_stiffness(nu: float = 0.3) -> torch.Tensor:
    """``KE`` (24×24, float64) of the unit cube with E = 1 and Poisson's
    ratio ``nu``: Σ over the 2×2×2 Gauss points of Bᵀ D B det J."""
    d = torch.zeros(6, 6, dtype=torch.float64)
    d[:3, :3] = nu
    d[range(3), range(3)] = 1.0 - nu
    d[range(3, 6), range(3, 6)] = (1.0 - 2.0 * nu) / 2.0
    d /= (1.0 + nu) * (1.0 - 2.0 * nu)
    g = 1.0 / np.sqrt(3.0)
    ke = torch.zeros(24, 24, dtype=torch.float64)
    for point in itertools.product((-g, g), repeat=3):
        b = torch.zeros(6, 24, dtype=torch.float64)
        for a, bits in enumerate(CORNERS):
            s = [2 * bit - 1 for bit in bits]  # the corner in [-1, 1]^3
            # dN/dxi_k of N = prod_l (1 + s_l xi_l) / 8, times dxi/dx = 2
            grad = []
            for k in range(3):
                v = s[k] / 8.0
                for l in range(3):
                    if l != k:
                        v *= 1.0 + s[l] * point[l]
                grad.append(2.0 * v)
            gx, gy, gz = grad
            b[0, 3 * a] = gx
            b[1, 3 * a + 1] = gy
            b[2, 3 * a + 2] = gz
            b[3, 3 * a], b[3, 3 * a + 1] = gy, gx
            b[4, 3 * a + 1], b[4, 3 * a + 2] = gz, gy
            b[5, 3 * a], b[5, 3 * a + 2] = gz, gx
        ke += b.T @ d @ b / 8.0  # det J of the map from [-1, 1]^3
    return ke


def assemble_q1(
    dims: Sequence[int],
    e: torch.Tensor,
    nu: float = 0.3,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """The global stiffness (dense, float64) of ``dims = (nx, ny, nz)``
    elements with moduli ``e`` (shape ``dims``), clamped boundary nodes
    removed, in the free nodes' row-major order (see the module)."""
    nx, ny, nz = (int(x) for x in dims)
    free = (nx - 1, ny - 1, nz - 1)
    n = 3 * free[0] * free[1] * free[2]
    ke = q1_element_stiffness(nu).to(device)
    e = e.to(device=device, dtype=torch.float64)
    k = torch.zeros(n, n, dtype=torch.float64, device=device)
    for ex, ey, ez in itertools.product(range(nx), range(ny), range(nz)):
        local, dofs = [], []
        for a, (bx, by, bz) in enumerate(CORNERS):
            i, j, l = ex + bx - 1, ey + by - 1, ez + bz - 1
            if 0 <= i < free[0] and 0 <= j < free[1] and 0 <= l < free[2]:
                p = (i * free[1] + j) * free[2] + l
                local += [3 * a, 3 * a + 1, 3 * a + 2]
                dofs += [3 * p, 3 * p + 1, 3 * p + 2]
        if not dofs:
            continue
        li = torch.tensor(local, device=device)
        gi = torch.tensor(dofs, device=device)
        k[gi[:, None], gi[None, :]] += e[ex, ey, ez] * ke[li[:, None], li[None, :]]
    return k


def symbolic_structure(pattern: torch.Tensor) -> torch.Tensor:
    """struct(L) of a symmetric ``pattern`` (n×n, boolean): the lower
    triangle, diagonal included, after boolean elimination in order."""
    s = torch.tril(pattern.to(torch.bool) | pattern.to(torch.bool).T)
    s |= torch.eye(len(s), dtype=torch.bool, device=s.device)
    for j in range(len(s)):
        below = s[j + 1 :, j]
        if below.any():
            fill = below[:, None] & below[None, :]
            s[j + 1 :, j + 1 :] |= torch.tril(fill)
    return s


def dense_factor(a: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of ``a`` in float64 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.linalg.cholesky(a.to(torch.float64))
