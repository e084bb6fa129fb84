"""Boundary-face trace evaluation: element fields on boundary faces.

The replacement for MFEM's boundary-face machinery
(``GetBdrFaceTransformations`` + per-face shape evaluation used by the
reference's surface diagnostics and SEB integrator, e.g.
ablation_test_case1_2D.cpp:634-746, ablation_test_case2_1_2D.cpp:2109-2217).

Each boundary face is (adjacent element, local-face id, orientation); the
element basis is tabulated once per (face, orientation) combo at the face
quadrature points, so face values/gradients are batched gathers + einsums
and face residual contributions scatter back through the element DOF map.
2D (tri/quad edges) and 3D (hex quad faces, tet tri faces) supported; the
face quadrature parametrization follows the boundary-element connectivity
ordering so the trace tabulation and the face geometric factors agree
pointwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.geometry import compute_face_factors, FaceFactors
from ..core.quadrature import gauss_rule
from ..core.reference_elements import (
    GEOM_EDGES, GEOM_FACES, GEOM_VERTS, HEXAHEDRON, QUAD, SEGMENT,
    TETRAHEDRON, TRIANGLE, get_reference_element,
)
from .assembly import SpaceOps


class BoundaryTrace:
    """Trace operators for (a subset of) boundary faces of a mesh."""

    def __init__(self, ops: SpaceOps, attr_marker=None, quad_order=None):
        fes = ops.fes
        mesh = fes.mesh
        self.ops = ops
        self.fes = fes
        bdr = fes.bdr
        if attr_marker is None:
            sel = np.arange(len(bdr.attr))
        else:
            sel = np.nonzero(np.isin(bdr.attr, np.asarray(list(attr_marker))))[0]
        self.face_ids = sel
        self.nbf = len(sel)
        self.elem = np.asarray(bdr.elem)[sel]
        conn = np.asarray(mesh.bdr_conn)[sel]  # (nbf, nfv)
        econn = np.asarray(mesh.elem_conn)[self.elem]

        p = fes.order
        qorder = quad_order or max(2, 2 * p + 2)
        ref = fes.ref
        geo = get_reference_element(mesh.geom, 1)
        verts_ref = GEOM_VERTS[mesh.geom]

        if mesh.dim == 2:
            edges = GEOM_EDGES[mesh.geom]
            # local edge id + flip per face; combo = 2*k + flip
            combo = np.full(self.nbf, -1, dtype=np.int64)
            for k, (a, b) in enumerate(edges):
                va = econn[:, a]
                vb = econn[:, b]
                fwd = (va == conn[:, 0]) & (vb == conn[:, 1])
                rev = (va == conn[:, 1]) & (vb == conn[:, 0])
                combo = np.where(fwd, 2 * k, combo)
                combo = np.where(rev, 2 * k + 1, combo)
            if (combo < 0).any():
                raise ValueError("Boundary face not matched to an element edge")
            self.combo = combo
            fgeom = SEGMENT
            self.quad = gauss_rule(fgeom, qorder)
            s = self.quad.points[:, 0]  # (nqf,)
            Btabs, Gtabs, Bg_tabs, Gg_tabs = [], [], [], []
            for k, (a, b) in enumerate(edges):
                for flip in (False, True):
                    ss = 1.0 - s if flip else s
                    pts = verts_ref[a][None, :] * (1 - ss)[:, None] + \
                        verts_ref[b][None, :] * ss[:, None]
                    B, G = ref.eval(pts)
                    Bg, Gg = geo.eval(pts)
                    Btabs.append(B)
                    Gtabs.append(G)
                    Bg_tabs.append(Bg)
                    Gg_tabs.append(Gg)
        else:
            # 3D: combo = nperm * local_face + perm_index, where the perm
            # enumerates rotations x reflection of the face polygon in the
            # SAME order used for the tabulation below (MFEM's face
            # orientation machinery, Geometry::GetFaceOrientation analog)
            face_list = GEOM_FACES[HEXAHEDRON] if mesh.geom == HEXAHEDRON \
                else GEOM_FACES[TETRAHEDRON]
            nfv = len(face_list[0])
            fgeom = QUAD if nfv == 4 else TRIANGLE
            fref1 = get_reference_element(fgeom, 1)
            self.quad = gauss_rule(fgeom, qorder)
            Nf, _ = fref1.eval(self.quad.points)  # (nqf, nfv)
            perms = []
            for j in range(nfv):
                for refl in (False, True):
                    perms.append(tuple(
                        (j + i * (-1 if refl else 1)) % nfv
                        for i in range(nfv)))
            nperm = len(perms)
            combo = np.full(self.nbf, -1, dtype=np.int64)
            for k, f in enumerate(face_list):
                g = econn[:, list(f)]  # (nbf, nfv)
                on_face = (np.sort(g, axis=1) == np.sort(conn, axis=1)) \
                    .all(axis=1)
                for pi, perm in enumerate(perms):
                    ok = on_face & (g[:, list(perm)] == conn).all(axis=1)
                    combo = np.where(ok & (combo < 0), nperm * k + pi, combo)
            if (combo < 0).any():
                raise ValueError(
                    "Boundary face not matched to an element face")
            self.combo = combo
            Btabs, Gtabs, Bg_tabs, Gg_tabs = [], [], [], []
            for k, f in enumerate(face_list):
                for perm in perms:
                    # face QP q sits at sum_i Nf[q,i] * refvert[f[perm[i]]]
                    corners = verts_ref[np.asarray(f)[list(perm)]]  # (nfv, 3)
                    pts = Nf @ corners
                    B, G = ref.eval(pts)
                    Bg, Gg = geo.eval(pts)
                    Btabs.append(B)
                    Gtabs.append(G)
                    Bg_tabs.append(Bg)
                    Gg_tabs.append(Gg)

        self.Btab = jnp.asarray(np.stack(Btabs))   # (ncombo, nqf, ndof)
        self.Gtab = jnp.asarray(np.stack(Gtabs))   # (ncombo, nqf, ndof, dim)
        self.Bgtab = jnp.asarray(np.stack(Bg_tabs))
        self.Ggtab = jnp.asarray(np.stack(Gg_tabs))

        self.eldofs = jnp.asarray(fes.element_dofs[self.elem])  # (nbf, ndof)
        self._elem_conn = jnp.asarray(mesh.elem_conn[self.elem])
        self._face_conn = jnp.asarray(conn)
        self._normal_sign = jnp.asarray(np.asarray(bdr.normal_sign)[sel])
        self._combo_j = jnp.asarray(self.combo)
        # face geometry basis (for wdS / normals / positions)
        fref = get_reference_element(fgeom, 1)
        Bf, Gf = fref.eval(self.quad.points)
        self._Bf = jnp.asarray(Bf)
        self._Gf = jnp.asarray(Gf)

    # -- geometry ----------------------------------------------------------

    def face_factors(self, vertices=None) -> FaceFactors:
        verts = jnp.asarray(self.fes.mesh.vertices if vertices is None
                            else vertices)
        coords = verts[self._face_conn]
        return compute_face_factors(coords, self._Bf, self._Gf,
                                    self.quad.weights, self._normal_sign)

    def element_invJ(self, vertices=None):
        """(nbf, nqf, dim, dim) inverse element Jacobians at face QPs."""
        from ..core.geometry import _inv_det

        verts = jnp.asarray(self.fes.mesh.vertices if vertices is None
                            else vertices)
        coords = verts[self._elem_conn]  # (nbf, nc, dim)
        Gg = self.Ggtab[self._combo_j]   # (nbf, nqf, nc, dim)
        J = jnp.einsum("fnd,fqnr->fqdr", coords, Gg)
        _, inv = _inv_det(J)
        return inv

    # -- field evaluation --------------------------------------------------

    def values(self, u):
        """(nbf, nqf) trace values of a scalar field."""
        u_e = jnp.asarray(u)[self.eldofs]
        B = self.Btab[self._combo_j]
        return jnp.einsum("fqn,fn->fq", B, u_e)

    def grads(self, u, vertices=None):
        """(nbf, nqf, dim) physical gradients of a scalar field at the
        face quadrature points (one-sided, from the adjacent element)."""
        u_e = jnp.asarray(u)[self.eldofs]
        G = self.Gtab[self._combo_j]
        gref = jnp.einsum("fqnr,fn->fqr", G, u_e)
        invJ = self.element_invJ(vertices)
        return jnp.sum(invJ * gref[..., :, None], axis=-2)

    def scatter(self, r_face):
        """Scatter (nbf, nqf) test-function-weighted face integrand into the
        global vector: R_i += sum_q r_face[f,q] * psi_i(x_q)."""
        B = self.Btab[self._combo_j]
        y_e = jnp.einsum("fqn,fq->fn", B, r_face)
        return jax.ops.segment_sum(
            y_e.reshape(-1), self.eldofs.reshape(-1),
            num_segments=self.fes.nscalar)
