"""Reference elements: Lagrange shape functions on segments/tris/quads/hexes.

Accelerator-first design: shape values ``B`` (nqp, ndof) and reference gradients ``G``
(nqp, ndof, dim) are tabulated once as dense numpy arrays and then used in
batched per-element contractions on device; there is no per-quadrature-point
virtual dispatch (the reference evaluates shapes per QP inside MFEM's
integrators, e.g. /root/reference/myapps/convection_diffusion/
nonlinear_convection_diffusion_1D.cpp:442-448).

Node layout per element is entity-ordered (vertices, then edge interiors,
then face interiors, then volume interiors) so that a global H1 DOF
enumeration can share entity DOFs between neighbouring elements.  1D node
positions are Gauss-Lobatto (the MFEM H1_FECollection default), which keeps
order-3 bases well conditioned.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

# Supported geometries
SEGMENT = "segment"
TRIANGLE = "triangle"
QUAD = "quad"
TETRAHEDRON = "tet"
HEXAHEDRON = "hex"

GEOM_DIM = {SEGMENT: 1, TRIANGLE: 2, QUAD: 2, TETRAHEDRON: 3, HEXAHEDRON: 3}

# Corner vertices on the reference domain ([0,1]^d boxes; unit simplexes).
GEOM_VERTS = {
    SEGMENT: np.array([[0.0], [1.0]]),
    TRIANGLE: np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    QUAD: np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]]),
    TETRAHEDRON: np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ),
    HEXAHEDRON: np.array(
        [
            [0.0, 0.0, 0.0],
            [1.0, 0.0, 0.0],
            [1.0, 1.0, 0.0],
            [0.0, 1.0, 0.0],
            [0.0, 0.0, 1.0],
            [1.0, 0.0, 1.0],
            [1.0, 1.0, 1.0],
            [0.0, 1.0, 1.0],
        ]
    ),
}

# Local edges as (v0, v1) pairs; edge-interior nodes run from v0 to v1.
GEOM_EDGES = {
    SEGMENT: [],
    TRIANGLE: [(0, 1), (1, 2), (2, 0)],
    QUAD: [(0, 1), (1, 2), (2, 3), (3, 0)],
    TETRAHEDRON: [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)],
    HEXAHEDRON: [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ],
}

# Local faces as corner-vertex tuples (3D elements only).
GEOM_FACES = {
    SEGMENT: [],
    TRIANGLE: [],
    QUAD: [],
    TETRAHEDRON: [(0, 2, 1), (0, 1, 3), (1, 2, 3), (0, 3, 2)],
    HEXAHEDRON: [
        (0, 3, 2, 1),  # z=0
        (4, 5, 6, 7),  # z=1
        (0, 1, 5, 4),  # y=0
        (1, 2, 6, 5),  # x=1
        (2, 3, 7, 6),  # y=1
        (3, 0, 4, 7),  # x=0
    ],
}

# Faces of 2D elements are their edges; faces of 1D elements are vertices.
GEOM_BOUNDARY = {
    SEGMENT: [(0,), (1,)],
    TRIANGLE: GEOM_EDGES[TRIANGLE],
    QUAD: GEOM_EDGES[QUAD],
    TETRAHEDRON: GEOM_FACES[TETRAHEDRON],
    HEXAHEDRON: GEOM_FACES[HEXAHEDRON],
}


def gauss_lobatto_nodes(p: int) -> np.ndarray:
    """1D Gauss-Lobatto points on [0,1] for a degree-p Lagrange basis."""
    if p == 1:
        return np.array([0.0, 1.0])
    if p == 2:
        return np.array([0.0, 0.5, 1.0])
    if p == 3:
        a = 1.0 / np.sqrt(5.0)
        return np.array([0.0, 0.5 * (1 - a), 0.5 * (1 + a), 1.0])
    if p == 4:
        a = np.sqrt(3.0 / 7.0)
        return np.array([0.0, 0.5 * (1 - a), 0.5, 0.5 * (1 + a), 1.0])
    # General: roots of (1-x^2) P'_p(x) on [-1,1], mapped to [0,1] —
    # p+1 nodes (selecting P_{p-1} here returned only p nodes, making
    # every order >= 5 basis silently non-interpolatory).
    from numpy.polynomial import legendre

    c = np.zeros(p + 1)
    c[-1] = 1.0
    dP = legendre.legder(c)
    interior = legendre.legroots(dP)
    xs = np.concatenate([[-1.0], np.sort(interior), [1.0]])
    assert len(xs) == p + 1
    return 0.5 * (xs + 1.0)


def _lagrange_1d(nodes: np.ndarray, x: np.ndarray):
    """Values and derivatives of the 1D Lagrange basis at points x.

    Returns (vals (nx, nn), ders (nx, nn)).
    """
    nn = len(nodes)
    x = np.asarray(x, dtype=np.float64)
    vals = np.ones((len(x), nn))
    ders = np.zeros((len(x), nn))
    for i in range(nn):
        for j in range(nn):
            if j == i:
                continue
            vals[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
        # derivative by sum over excluded factor
        for k in range(nn):
            if k == i:
                continue
            term = np.ones(len(x)) / (nodes[i] - nodes[k])
            for j in range(nn):
                if j == i or j == k:
                    continue
                term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            ders[:, i] += term
    return vals, ders


def _simplex_monomials(dim: int, p: int):
    """Exponent tuples for total-degree-p monomials in `dim` variables."""
    out = []
    if dim == 2:
        for a in range(p + 1):
            for b in range(p + 1 - a):
                out.append((a, b))
    elif dim == 3:
        for a in range(p + 1):
            for b in range(p + 1 - a):
                for c in range(p + 1 - a - b):
                    out.append((a, b, c))
    else:
        raise ValueError(dim)
    return out


def _eval_monomials(exps, pts):
    """(npts, nmono) monomial values and (npts, nmono, dim) gradients."""
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    npts, dim = pts.shape
    nm = len(exps)
    V = np.ones((npts, nm))
    dV = np.zeros((npts, nm, dim))
    for m, e in enumerate(exps):
        for d in range(dim):
            V[:, m] *= pts[:, d] ** e[d]
        for d in range(dim):
            g = np.ones(npts) * e[d]
            for dd in range(dim):
                ex = e[dd] - 1 if dd == d else e[dd]
                if ex < 0:
                    g = np.zeros(npts)
                    break
                g = g * pts[:, dd] ** ex
            dV[:, m, d] = g
    return V, dV


def _simplex_nodes(geom: str, p: int):
    """Entity-ordered Lagrange nodes for tri/tet at uniform barycentric pts."""
    verts = GEOM_VERTS[geom]
    nodes = [v for v in verts]
    # edge interiors
    for (a, b) in GEOM_EDGES[geom]:
        for k in range(1, p):
            t = k / p
            nodes.append(verts[a] * (1 - t) + verts[b] * t)
    if geom == TRIANGLE:
        # interior: barycentric i+j+k=p with all >=1
        for i in range(1, p):
            for j in range(1, p - i):
                nodes.append(
                    verts[0] * (p - i - j) / p + verts[1] * i / p + verts[2] * j / p
                )
    elif geom == TETRAHEDRON:
        # face interiors
        for f in GEOM_FACES[TETRAHEDRON]:
            v = [verts[i] for i in f]
            for i in range(1, p):
                for j in range(1, p - i):
                    nodes.append(v[0] * (p - i - j) / p + v[1] * i / p + v[2] * j / p)
        # interior (p>=4 only for tets; none for p<=3)
        for i in range(1, p):
            for j in range(1, p - i):
                for k in range(1, p - i - j):
                    nodes.append(
                        verts[0] * (p - i - j - k) / p
                        + verts[1] * i / p
                        + verts[2] * j / p
                        + verts[3] * k / p
                    )
    return np.array(nodes)


def _tensor_nodes(geom: str, p: int):
    """Entity-ordered nodes for quad/hex on the GLL tensor lattice.

    Returns (nodes (ndof, dim), tensor_idx (ndof, dim) int indices into the
    1D node array).
    """
    x1 = gauss_lobatto_nodes(p)
    verts = GEOM_VERTS[geom]
    dim = GEOM_DIM[geom]

    def to_idx(pt):
        return tuple(int(np.argmin(np.abs(x1 - c))) for c in pt)

    nodes = []
    for v in verts:
        nodes.append(np.asarray(v, dtype=np.float64))
    for (a, b) in GEOM_EDGES[geom]:
        va, vb = verts[a], verts[b]
        for k in range(1, p):
            t = x1[k]
            nodes.append(va * (1 - t) + vb * t)
    if geom == HEXAHEDRON:
        for f in GEOM_FACES[HEXAHEDRON]:
            c = [np.asarray(verts[i], dtype=np.float64) for i in f]
            for j in range(1, p):
                for i in range(1, p):
                    u, v = x1[i], x1[j]
                    nodes.append(
                        c[0] * (1 - u) * (1 - v)
                        + c[1] * u * (1 - v)
                        + c[2] * u * v
                        + c[3] * (1 - u) * v
                    )
    # interior
    if geom == QUAD:
        for j in range(1, p):
            for i in range(1, p):
                nodes.append(np.array([x1[i], x1[j]]))
    elif geom == HEXAHEDRON:
        for k in range(1, p):
            for j in range(1, p):
                for i in range(1, p):
                    nodes.append(np.array([x1[i], x1[j], x1[k]]))
    nodes = np.array(nodes)
    tensor_idx = np.array([to_idx(pt) for pt in nodes], dtype=np.int64)
    # sanity: node coords must lie exactly on the lattice
    lattice = x1[tensor_idx]
    assert np.allclose(lattice, nodes, atol=1e-12), (geom, p)
    return nodes, tensor_idx


@dataclass(frozen=True)
class ReferenceElement:
    """A Lagrange reference element of a given geometry and order."""

    geom: str
    order: int
    dim: int
    nodes: np.ndarray  # (ndof, dim) entity-ordered node positions
    # counts per entity, used by FESpace for global DOF enumeration
    n_vert_dofs: int  # always 1 per vertex for H1
    n_edge_dofs: int  # per edge (= order - 1)
    n_face_dofs: int  # per 2D face of a 3D element
    n_interior_dofs: int
    _tensor_idx: np.ndarray | None = field(default=None, compare=False)
    _mono_exps: tuple | None = field(default=None, compare=False)
    _mono_coeff: np.ndarray | None = field(default=None, compare=False)

    @property
    def ndof(self) -> int:
        return len(self.nodes)

    def eval(self, pts: np.ndarray):
        """Tabulate basis at reference points.

        Returns (B (npts, ndof), G (npts, ndof, dim)).
        """
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        if self._tensor_idx is not None:
            x1 = gauss_lobatto_nodes(self.order)
            vals = []
            ders = []
            for d in range(self.dim):
                v, g = _lagrange_1d(x1, pts[:, d])
                vals.append(v)
                ders.append(g)
            idx = self._tensor_idx  # (ndof, dim)
            B = np.ones((pts.shape[0], self.ndof))
            G = np.zeros((pts.shape[0], self.ndof, self.dim))
            for d in range(self.dim):
                B *= vals[d][:, idx[:, d]]
            for d in range(self.dim):
                term = np.ones((pts.shape[0], self.ndof))
                for dd in range(self.dim):
                    term *= (ders[dd] if dd == d else vals[dd])[:, idx[:, dd]]
                G[:, :, d] = term
            return B, G
        # simplex path: monomial coefficients precomputed at construction
        V, dV = _eval_monomials(self._mono_exps, pts)
        B = V @ self._mono_coeff
        G = np.einsum("pmd,mn->pnd", dV, self._mono_coeff)
        return B, G


@lru_cache(maxsize=None)
def get_reference_element(geom: str, order: int) -> ReferenceElement:
    dim = GEOM_DIM[geom]
    p = order
    if geom == SEGMENT:
        x1 = gauss_lobatto_nodes(p)
        nodes = np.concatenate([[x1[0]], [x1[-1]], x1[1:-1]])[:, None]
        tensor_idx = np.array(
            [[0], [p]] + [[k] for k in range(1, p)], dtype=np.int64
        )
        return ReferenceElement(
            geom, p, 1, nodes, 1, p - 1, 0, 0, _tensor_idx=tensor_idx
        )
    if geom in (QUAD, HEXAHEDRON):
        nodes, tensor_idx = _tensor_nodes(geom, p)
        n_face = (p - 1) ** 2 if geom == HEXAHEDRON else 0
        n_int = (p - 1) ** dim
        return ReferenceElement(
            geom, p, dim, nodes, 1, p - 1, n_face, n_int, _tensor_idx=tensor_idx
        )
    if geom in (TRIANGLE, TETRAHEDRON):
        nodes = _simplex_nodes(geom, p)
        exps = tuple(_simplex_monomials(dim, p))
        V, _ = _eval_monomials(exps, nodes)
        coeff = np.linalg.inv(V)  # columns = basis-function monomial coeffs
        if geom == TRIANGLE:
            n_face = 0
            n_int = max(0, (p - 1) * (p - 2) // 2)
        else:
            n_face = max(0, (p - 1) * (p - 2) // 2)
            n_int = max(0, (p - 1) * (p - 2) * (p - 3) // 6)
        return ReferenceElement(
            geom, p, dim, nodes, 1, p - 1, n_face, n_int,
            _mono_exps=exps, _mono_coeff=coeff,
        )
    raise ValueError(f"Unsupported geometry: {geom}")


# Geometry of a boundary face of each element type
FACE_GEOM = {
    SEGMENT: None,
    TRIANGLE: SEGMENT,
    QUAD: SEGMENT,
    TETRAHEDRON: TRIANGLE,
    HEXAHEDRON: QUAD,
}
