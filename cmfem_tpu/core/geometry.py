"""Geometric factors: per-element, per-QP Jacobians J, detJ, J^{-1}.

All functions are jax-traceable in the coordinate arrays so moving-mesh
(ALE) drivers can recompute factors each step inside ``jit`` — the
replacement for MFEM's element transformations
(``T.Weight()``/``T.Jacobian()`` used per QP in the reference integrators).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .mesh import Mesh
from .quadrature import QuadratureRule
from .reference_elements import get_reference_element


@dataclass
class GeometricFactors:
    """detJ (ne, nq), invJ (ne, nq, dim, dim), wdetJ (ne, nq),
    xq (ne, nq, dim) physical quadrature points."""

    detJ: jnp.ndarray
    invJ: jnp.ndarray
    wdetJ: jnp.ndarray
    xq: jnp.ndarray


def _inv_det(J, xp=jnp):
    """Batched inverse + determinant for 1x1/2x2/3x3 matrices.
    ``xp`` selects the array module (jnp in-trace, np for the host-side
    setup path)."""
    d = J.shape[-1]
    if d == 1:
        det = J[..., 0, 0]
        inv = (1.0 / det)[..., None, None]
        return det, inv
    if d == 2:
        a, b = J[..., 0, 0], J[..., 0, 1]
        c, dd = J[..., 1, 0], J[..., 1, 1]
        det = a * dd - b * c
        inv = xp.stack(
            [xp.stack([dd, -b], -1), xp.stack([-c, a], -1)], -2
        ) / det[..., None, None]
        return det, inv
    if d == 3:
        m = J
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        inv = xp.stack(
            [
                xp.stack([c00, c10, c20], -1),
                xp.stack([c01, c11, c21], -1),
                xp.stack([c02, c12, c22], -1),
            ],
            -2,
        ) / det[..., None, None]
        return det, inv
    raise ValueError(d)


def compute_geometric_factors(coords_e, Bgeo, Ggeo, weights) -> GeometricFactors:
    """Geometric factors from element geometry-node coordinates.

    coords_e : (ne, ng, dim) geometry node coords (jnp or np)
    Bgeo     : (nq, ng) geometry shape values at quadrature points
    Ggeo     : (nq, ng, dim) geometry shape gradients (reference)
    weights  : (nq,) quadrature weights
    """
    coords_e = jnp.asarray(coords_e)
    Bgeo = jnp.asarray(Bgeo)
    Ggeo = jnp.asarray(Ggeo)
    weights = jnp.asarray(weights)
    # J[e,q,d,r] = sum_n coords[e,n,d] * Ggeo[q,n,r]
    J = jnp.einsum("end,qnr->eqdr", coords_e, Ggeo)
    det, inv = _inv_det(J)
    xq = jnp.einsum("qn,end->eqd", Bgeo, coords_e)
    return GeometricFactors(det, inv, weights[None, :] * det, xq)


def compute_geometric_factors_host(coords_e, Bgeo, Ggeo, weights):
    """SETUP-time geometric factors computed entirely on the HOST.

    Outside jit, evaluating the factors on the device would compile each
    of the ~15 ops as its own program and copy the results back.
    Setup-time consumers only need host arrays anyway (shapes, initial
    mesh quality, assembly constants that jit re-embeds), so numpy is
    both correct and fast; in-trace callers keep using
    ``compute_geometric_factors``."""
    coords_e = np.asarray(coords_e)
    Bgeo = np.asarray(Bgeo)
    Ggeo = np.asarray(Ggeo)
    weights = np.asarray(weights)
    J = np.einsum("end,qnr->eqdr", coords_e, Ggeo)
    det, inv = _inv_det(J, xp=np)
    xq = np.einsum("qn,end->eqd", Bgeo, coords_e)
    return GeometricFactors(det, inv, weights[None, :] * det, xq)


def factors_for(mesh: Mesh, quad: QuadratureRule, coords=None,
                geom_order: int = 1) -> GeometricFactors:
    """Convenience: geometric factors of a mesh at a quadrature rule.

    coords: optional (nv, dim) vertex coordinates overriding mesh.vertices
    (for moving meshes with order-1 geometry).  Only geom_order=1 is
    supported: higher-order (curved) geometry needs a nodal coordinate
    field over an H1 space, not just corner connectivity — moving meshes
    are handled by passing updated vertex ``coords`` instead (the
    reference always uses order-1 geometry too: SetCurvature promotes to
    nodal coordinates of the same linear map, mesh_recession_handler.cpp:54-61)."""
    if geom_order != 1:
        raise NotImplementedError(
            "factors_for supports geom_order=1 only; curved geometry "
            "would need (ne, ndof_geom) nodal coordinates, but coords "
            "are gathered from corner connectivity")
    ref = get_reference_element(mesh.geom, geom_order)
    B, G = ref.eval(quad.points)
    verts = mesh.vertices if coords is None else coords
    coords_e = jnp.asarray(verts)[mesh.elem_conn]
    return compute_geometric_factors(coords_e, B, G, quad.weights)


# -- boundary-face factors --------------------------------------------------

@dataclass
class FaceFactors:
    """dS (nbf, nq): surface measure x weight; normal (nbf, nq, dim) unit
    outward normal; xq (nbf, nq, dim) physical QP positions."""

    wdS: jnp.ndarray
    normal: jnp.ndarray
    xq: jnp.ndarray


def compute_face_factors(face_coords, Bf, Gf, weights, normal_sign) -> FaceFactors:
    """Surface factors for boundary faces.

    face_coords : (nbf, ngf, dim) face geometry-node coordinates
    Bf : (nq, ngf); Gf : (nq, ngf, dim-1); weights : (nq,)
    normal_sign : (nbf,) ±1 flipping the param normal to point outward.
    """
    face_coords = jnp.asarray(face_coords)
    Bf = jnp.asarray(Bf)
    Gf = jnp.asarray(Gf)
    weights = jnp.asarray(weights)
    normal_sign = jnp.asarray(normal_sign)
    T = jnp.einsum("end,qnr->eqdr", face_coords, Gf)  # tangent vectors
    dim = face_coords.shape[-1]
    if dim == 2:
        t = T[..., 0]  # (nbf, nq, 2)
        mag = jnp.linalg.norm(t, axis=-1)
        nrm = jnp.stack([t[..., 1], -t[..., 0]], axis=-1) / mag[..., None]
    else:
        u = T[..., 0]
        v = T[..., 1]
        c = jnp.cross(u, v)
        mag = jnp.linalg.norm(c, axis=-1)
        nrm = c / mag[..., None]
    nrm = nrm * normal_sign[:, None, None]
    xq = jnp.einsum("qn,end->eqd", Bf, face_coords)
    return FaceFactors(weights[None, :] * mag, nrm, xq)
