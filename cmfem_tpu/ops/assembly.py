"""Assembly: matrix-free partial-assembly apply + local full assembly.

Replacement for MFEM's ``(Par)BilinearForm``/``LinearForm`` with
``MassIntegrator``/``DiffusionIntegrator``/``ConvectionIntegrator``/
``DomainLFIntegrator``/``BoundaryLFIntegrator`` (the set the reference
drivers use, e.g. /root/reference/myapps/convection_diffusion/
linear_convection_diffusion_2D.cpp:335-343).

Every bilinear form is reduced to quadrature-point operator data acting on
the value/reference-gradient pair of the trial function:

    y_e = B^T [ d00 * u_q + d01 . (grad_ref u)_q ]
        + G^T [ d10 * u_q + d11 (grad_ref u)_q ]

with the geometric factors folded into ``dXY``.  The apply is one batch of
dense contractions + gather/segment_sum scatter, so
unstructured sparsity never materializes as a scattered SpMV.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.fespace import FESpace
from ..core.geometry import (
    GeometricFactors,
    FaceFactors,
    compute_geometric_factors,
    compute_face_factors,
)
from ..core.quadrature import gauss_rule
from ..core.reference_elements import get_reference_element


def eval_coefficient(coeff, xq, time=None):
    """Evaluate a scalar coefficient at physical QPs xq (..., dim).

    coeff: float | array broadcastable to xq[...,0] | callable(x[, t])."""
    if callable(coeff):
        flat = xq.reshape(-1, xq.shape[-1])
        vals = coeff(flat) if time is None else coeff(flat, time)
        return jnp.asarray(vals).reshape(xq.shape[:-1])
    return jnp.broadcast_to(jnp.asarray(coeff), xq.shape[:-1])


class SpaceOps:
    """Per-(space, quadrature) tabulations + geometric factors.

    The static data (B, G, dof maps) lives here; geometric factors can be
    recomputed from moved coordinates inside jit (ALE)."""

    def __init__(self, fes: FESpace, quad_order: int | None = None):
        self.fes = fes
        mesh = fes.mesh
        p = fes.order
        if quad_order is None:
            # MFEM-ish default: exact for 2p + geometry order
            quad_order = 2 * p + 1
        self.quad = gauss_rule(mesh.geom, quad_order)
        B, G = fes.ref.eval(self.quad.points)
        self.B = jnp.asarray(B)
        self.G = jnp.asarray(G)
        self.eldofs = jnp.asarray(fes.element_dofs)
        geo = get_reference_element(mesh.geom, 1)
        Bg, Gg = geo.eval(self.quad.points)
        self._Bgeo = jnp.asarray(Bg)
        self._Ggeo = jnp.asarray(Gg)
        self._Bgeo_np = np.asarray(Bg)
        self._Ggeo_np = np.asarray(Gg)
        self._conn = jnp.asarray(mesh.elem_conn)
        # setup-time factors on the HOST (see
        # compute_geometric_factors_host)
        from ..core.geometry import compute_geometric_factors_host
        self.gf = compute_geometric_factors_host(
            np.asarray(mesh.vertices)[np.asarray(mesh.elem_conn)],
            self._Bgeo_np, self._Ggeo_np, self.quad.weights)

        # boundary tabulations
        self.face = None
        if fes.bdr is not None and len(fes.bdr.attr):
            fgeom = fes.bdr.geom
            fref = get_reference_element(fgeom, p)
            fq = gauss_rule(fgeom, quad_order)
            Bf, Gf = fref.eval(fq.points)
            fgeo = get_reference_element(fgeom, 1)
            Bfg, Gfg = fgeo.eval(fq.points)
            self.face = {
                "quad": fq,
                "B": jnp.asarray(Bf),
                "G": jnp.asarray(Gf),
                "Bgeo": jnp.asarray(Bfg),
                "Ggeo": jnp.asarray(Gfg),
                "dofs": jnp.asarray(fes.bdr.dofs),
                "conn": jnp.asarray(fes.bdr.corner_verts),
                "attr": np.asarray(fes.bdr.attr),
                "normal_sign": jnp.asarray(fes.bdr.normal_sign),
            }

    # -- geometry ----------------------------------------------------------

    def geometric_factors(self, vertices) -> GeometricFactors:
        coords_e = jnp.asarray(vertices)[self._conn]
        return compute_geometric_factors(
            coords_e, self._Bgeo, self._Ggeo, self.quad.weights
        )

    def face_factors(self, vertices=None) -> FaceFactors:
        f = self.face
        verts = jnp.asarray(
            self.fes.mesh.vertices if vertices is None else vertices
        )
        coords = verts[f["conn"]]
        return compute_face_factors(
            coords, f["Bgeo"], f["Ggeo"], f["quad"].weights, f["normal_sign"]
        )

    # -- field evaluation at QPs ------------------------------------------

    def values_at_qp(self, u):
        """u (n,) -> (ne, nq) values at quadrature points."""
        u_e = jnp.asarray(u)[self.eldofs]
        return jnp.einsum("qn,en->eq", self.B, u_e)

    def grads_at_qp(self, u, gf: GeometricFactors | None = None):
        """u (n,) -> (ne, nq, dim) physical gradients at quadrature points."""
        gf = gf or self.gf
        u_e = jnp.asarray(u)[self.eldofs]
        gref = jnp.einsum("qnr,en->eqr", self.G, u_e)
        # sum over r (dim<=3): elementwise, not a dot
        return jnp.sum(gf.invJ * gref[..., :, None], axis=-2)

    def scatter(self, y_e):
        """(ne, ndof) element contributions -> global (n,) via segment_sum."""
        return jax.ops.segment_sum(
            y_e.reshape(-1),
            self.eldofs.reshape(-1),
            num_segments=self.fes.nscalar,
        )

    def integrate(self, qvals, gf: GeometricFactors | None = None):
        """Integral of a QP field qvals (ne, nq) over the domain."""
        gf = gf or self.gf
        return jnp.sum(qvals * gf.wdetJ)


@dataclass
class OperatorData:
    """Quadrature-level operator blocks (geometric factors folded in)."""

    d00: jnp.ndarray | None = None  # (ne, nq)
    d01: jnp.ndarray | None = None  # (ne, nq, dim) acting on ref-grad
    d10: jnp.ndarray | None = None  # (ne, nq, dim)
    d11: jnp.ndarray | None = None  # (ne, nq, dim, dim) ref-grad -> ref-grad

    def __add__(self, o: "OperatorData") -> "OperatorData":
        def s(a, b):
            if a is None:
                return b
            if b is None:
                return a
            return a + b

        return OperatorData(s(self.d00, o.d00), s(self.d01, o.d01),
                            s(self.d10, o.d10), s(self.d11, o.d11))


class BilinearForm:
    """A sum of domain integrators over one scalar H1 space.

    Usage:
        a = BilinearForm(ops)
        a.add_mass(coeff)
        a.add_diffusion(kappa)
        a.add_convection(beta, alpha=1.0)
        data = a.assemble()          # OperatorData
        y = a.apply(data, u)         # matrix-free A @ u
        A_e = a.element_matrices(data)
        diag = a.assemble_diagonal(data)
    """

    def __init__(self, ops: SpaceOps):
        self.ops = ops
        self._parts = []  # list of callables gf -> OperatorData

    # -- integrators -------------------------------------------------------

    def add_mass(self, coeff=1.0, time=None):
        """(c u, v) — MassIntegrator."""

        def build(gf: GeometricFactors):
            c = eval_coefficient(coeff, gf.xq, time)
            return OperatorData(d00=c * gf.wdetJ)

        self._parts.append(build)
        return self

    def add_diffusion(self, coeff=1.0, time=None):
        """(c grad u, grad v) — DiffusionIntegrator."""

        def build(gf: GeometricFactors):
            c = eval_coefficient(coeff, gf.xq, time)
            # K[r,s] = c wdetJ sum_d invJ[r,d] invJ[s,d]
            K = jnp.sum(gf.invJ[:, :, :, None, :] * gf.invJ[:, :, None, :, :],
                        axis=-1)
            return OperatorData(d11=K * (c * gf.wdetJ)[..., None, None])

        self._parts.append(build)
        return self

    def add_diffusion_matrix(self, mat_fn, time=None):
        """(M(x) grad u, grad v) with a matrix coefficient: mat_fn(x[, t])
        -> (..., dim, dim).  Used by the ALE pulled-back diffusion metric
        (AleMetricTensorCoefficient, diffusion_mms_ale.cpp:474-502)."""

        def build(gf: GeometricFactors):
            flat = gf.xq.reshape(-1, gf.xq.shape[-1])
            M = mat_fn(flat) if time is None else mat_fn(flat, time)
            M = jnp.asarray(M).reshape(gf.xq.shape[:-1] + M.shape[-2:])
            t = jnp.sum(gf.invJ[..., :, :, None] * M[..., None, :, :],
                        axis=-2)  # (a,q,r,c)
            K = jnp.sum(t[..., :, None, :] * gf.invJ[..., None, :, :],
                        axis=-1)
            return OperatorData(d11=K * gf.wdetJ[..., None, None])

        self._parts.append(build)
        return self

    def add_convection(self, beta, alpha=1.0, time=None):
        """alpha (beta . grad u, v) — ConvectionIntegrator."""

        def build(gf: GeometricFactors):
            b = _eval_vector(beta, gf.xq, time)  # (ne, nq, dim)
            # d01[r] = alpha wdetJ sum_d beta_d invJ[r,d]
            d01 = jnp.sum(b[..., None, :] * gf.invJ, axis=-1)
            return OperatorData(d01=alpha * d01 * gf.wdetJ[..., None])

        self._parts.append(build)
        return self

    def add_supg(self, beta, kappa, reaction=0.0, time=None):
        """SUPG stabilization for steady convection-diffusion-reaction
        (BASELINE config #3: convection-dominated high-Peclet regimes):

          + sum_e tau_e ( beta.grad(u) + s u , beta.grad(psi) )_e

        with tau = h/(2|beta|) (coth(Pe) - 1/Pe), Pe = |beta| h /(2 kappa),
        h from the element volume (the second-derivative term vanishes for
        the bi/tri-linear elements this path targets)."""

        def build(gf: GeometricFactors):
            b = _eval_vector(beta, gf.xq, time)  # (ne, nq, dim)
            k = eval_coefficient(kappa, gf.xq, time)
            s = eval_coefficient(reaction, gf.xq, time)
            dim = gf.xq.shape[-1]
            vol = jnp.sum(gf.wdetJ, axis=1, keepdims=True)  # (ne, 1)
            h = vol ** (1.0 / dim)
            bnorm = jnp.maximum(jnp.linalg.norm(b, axis=-1), 1e-30)
            Pe = bnorm * h / (2.0 * jnp.maximum(k, 1e-30))
            # coth(Pe) - 1/Pe, series-safe for small Pe
            xi = jnp.where(Pe < 1e-4, Pe / 3.0, 1.0 / jnp.tanh(Pe) - 1.0 / Pe)
            tau = h / (2.0 * bnorm) * xi
            # beta in reference-gradient space: br[r] = sum_d beta_d invJ[r,d]
            br = jnp.sum(b[..., None, :] * gf.invJ, axis=-1)
            w = tau * gf.wdetJ
            d11 = jnp.einsum("eq,eqr,eqs->eqrs", w, br, br)
            d10 = (w * s)[..., None] * br
            return OperatorData(d10=d10, d11=d11)

        self._parts.append(build)
        return self

    def add_qpdata(self, build):
        """Custom integrator: build(gf) -> OperatorData."""
        self._parts.append(build)
        return self

    # -- assembly ----------------------------------------------------------

    def assemble(self, gf: GeometricFactors | None = None) -> OperatorData:
        gf = gf or self.ops.gf
        out = OperatorData()
        for p in self._parts:
            out = out + p(gf)
        return out

    def apply(self, data: OperatorData, u):
        """Matrix-free y = A u (partial assembly apply)."""
        ops = self.ops
        u_e = jnp.asarray(u)[ops.eldofs]  # (ne, ndof)
        uq = jnp.einsum("qn,en->eq", ops.B, u_e)
        gq = jnp.einsum("qnr,en->eqr", ops.G, u_e)
        ne, nq = uq.shape
        bq = jnp.zeros_like(uq)
        if data.d00 is not None:
            bq = bq + data.d00 * uq
        if data.d01 is not None:
            bq = bq + jnp.sum(data.d01 * gq, axis=-1)
        fq = None
        if data.d10 is not None:
            fq = data.d10 * uq[..., None]
        if data.d11 is not None:
            t = jnp.sum(data.d11 * gq[..., None, :], axis=-1)
            fq = t if fq is None else fq + t
        y_e = jnp.einsum("qn,eq->en", ops.B, bq)
        if fq is not None:
            y_e = y_e + jnp.einsum("qnr,eqr->en", ops.G, fq)
        return ops.scatter(y_e)

    def element_matrices(self, data: OperatorData):
        """(ne, ndof, ndof) dense local matrices (full local assembly)."""
        ops = self.ops
        B, G = ops.B, ops.G
        A = None

        def acc(x):
            nonlocal A
            A = x if A is None else A + x

        if data.d00 is not None:
            acc(jnp.einsum("qi,eq,qj->eij", B, data.d00, B))
        if data.d01 is not None:
            acc(jnp.einsum("qi,eqr,qjr->eij", B, data.d01, G))
        if data.d10 is not None:
            acc(jnp.einsum("qir,eqr,qj->eij", G, data.d10, B))
        if data.d11 is not None:
            acc(jnp.einsum("qir,eqrs,qjs->eij", G, data.d11, G))
        return A

    def assemble_diagonal(self, data: OperatorData):
        """Global diagonal of A (for Jacobi preconditioning)."""
        ops = self.ops
        B, G = ops.B, ops.G
        d = jnp.zeros((ops.eldofs.shape[0], B.shape[1]))
        if data.d00 is not None:
            d = d + jnp.einsum("qi,eq,qi->ei", B, data.d00, B)
        if data.d01 is not None:
            d = d + jnp.einsum("qi,eqr,qir->ei", B, data.d01, G)
        if data.d10 is not None:
            d = d + jnp.einsum("qir,eqr,qi->ei", G, data.d10, B)
        if data.d11 is not None:
            d = d + jnp.einsum("qir,eqrs,qis->ei", G, data.d11, G)
        return ops.scatter(d)

    def dense_matrix(self, data: OperatorData):
        """Scatter local matrices into a dense (n, n) global matrix.

        Debug / small-problem direct-solve path (replaces MUMPS for the
        smoke-sized systems; see SURVEY.md §2.4)."""
        ops = self.ops
        A_e = self.element_matrices(data)
        n = ops.fes.nscalar
        rows = np.repeat(ops.fes.element_dofs, A_e.shape[1], axis=1)
        cols = np.tile(ops.fes.element_dofs, (1, A_e.shape[1]))
        A = jnp.zeros((n, n))
        return A.at[rows.reshape(-1), cols.reshape(-1)].add(A_e.reshape(-1))


def _eval_vector(coeff, xq, time=None):
    """Vector coefficient -> (ne, nq, dim)."""
    dim = xq.shape[-1]
    if callable(coeff):
        flat = xq.reshape(-1, dim)
        vals = coeff(flat) if time is None else coeff(flat, time)
        return jnp.asarray(vals).reshape(xq.shape)
    # xq may be a host-side f64 numpy array while x64 is off; request the
    # CANONICAL dtype so the conversion is intentional rather than a
    # silent-truncation warning (VERDICT r4 weak #7)
    arr = jnp.asarray(coeff, dtype=jax.dtypes.canonicalize_dtype(xq.dtype))
    return jnp.broadcast_to(arr, xq.shape)


# -- linear forms -----------------------------------------------------------

def domain_lf(ops: SpaceOps, f, time=None, gf: GeometricFactors | None = None):
    """(f, v) over the domain — DomainLFIntegrator."""
    gf = gf or ops.gf
    fq = eval_coefficient(f, gf.xq, time)
    b_e = jnp.einsum("qn,eq->en", ops.B, fq * gf.wdetJ)
    return ops.scatter(b_e)


def boundary_lf(ops: SpaceOps, g, attr_marker=None, time=None, vertices=None):
    """(g, v) over marked boundary faces — BoundaryLFIntegrator."""
    f = ops.face
    if f is None:
        return jnp.zeros(ops.fes.nscalar)
    ff = ops.face_factors(vertices)
    gq = eval_coefficient(g, ff.xq, time)
    if attr_marker is not None:
        mask = np.isin(f["attr"], np.asarray(list(attr_marker)))
        sel = jnp.asarray(mask, dtype=gq.dtype)
        gq = gq * sel[:, None]
    b_f = jnp.einsum("qn,fq->fn", f["B"], gq * ff.wdS)
    return jax.ops.segment_sum(
        b_f.reshape(-1), f["dofs"].reshape(-1), num_segments=ops.fes.nscalar
    )


def supg_lf(ops: SpaceOps, f, beta, kappa, time=None,
            gf: GeometricFactors | None = None):
    """SUPG-consistent RHS: sum_e tau_e (f, beta.grad(psi))_e."""
    gf = gf or ops.gf
    fq = eval_coefficient(f, gf.xq, time)
    b = _eval_vector(beta, gf.xq, time)
    k = eval_coefficient(kappa, gf.xq, time)
    dim = gf.xq.shape[-1]
    vol = jnp.sum(gf.wdetJ, axis=1, keepdims=True)
    h = vol ** (1.0 / dim)
    bnorm = jnp.maximum(jnp.linalg.norm(b, axis=-1), 1e-30)
    Pe = bnorm * h / (2.0 * jnp.maximum(k, 1e-30))
    xi = jnp.where(Pe < 1e-4, Pe / 3.0, 1.0 / jnp.tanh(Pe) - 1.0 / Pe)
    tau = h / (2.0 * bnorm) * xi
    br = jnp.sum(b[..., None, :] * gf.invJ, axis=-1)
    b_e = jnp.einsum("qnr,eqr->en", ops.G,
                     (tau * fq * gf.wdetJ)[..., None] * br)
    return ops.scatter(b_e)


# -- error norms ------------------------------------------------------------

_elevated_ops_cache: "weakref.WeakKeyDictionary" = None  # lazy init


def _elevated_ops(ops: SpaceOps, qorder: int) -> SpaceOps:
    """Cached elevated-quadrature SpaceOps per (fes, qorder): the error
    norms run every timestep, and rebuilding SpaceOps re-tabulates the
    bases, boundary-face data, and whole-mesh geometric factors each
    call.  Safe to cache because nothing mutates mesh.vertices in place
    (moving-mesh callers pass explicit ``gf``)."""
    global _elevated_ops_cache
    if qorder == ops.quad.order:
        return ops
    import weakref

    if _elevated_ops_cache is None:
        _elevated_ops_cache = weakref.WeakKeyDictionary()
    per_fes = _elevated_ops_cache.setdefault(ops.fes, {})
    if qorder not in per_fes:
        per_fes[qorder] = SpaceOps(ops.fes, qorder)
    return per_fes[qorder]


def l2_error(ops: SpaceOps, u, exact, time=None, quad_order=None,
             gf: GeometricFactors | None = None):
    """|| u_h - exact ||_L2 with an elevated quadrature rule.

    Mirrors ``GridFunction::ComputeL2Error`` with the reference's
    order_quad = max(2, 2p+3) convention
    (linear_convection_diffusion_2D.cpp:383-392)."""
    fes = ops.fes
    p = fes.order
    qorder = quad_order or max(2, 2 * p + 3)
    hi = _elevated_ops(ops, qorder)
    gf = gf or hi.gf
    uq = hi.values_at_qp(u)
    ex = eval_coefficient(exact, gf.xq, time)
    return jnp.sqrt(jnp.sum((uq - ex) ** 2 * gf.wdetJ))


def l2_norm_fn(ops: SpaceOps, fn, time=None, quad_order=None,
               gf: GeometricFactors | None = None):
    """|| fn ||_L2 over the mesh (ComputeGlobalLpNorm(2, ...))."""
    fes = ops.fes
    qorder = quad_order or max(2, 2 * fes.order + 3)
    hi = _elevated_ops(ops, qorder)
    gf = gf or hi.gf
    ex = eval_coefficient(fn, gf.xq, time)
    return jnp.sqrt(jnp.sum(ex**2 * gf.wdetJ))


def weighted_l2_error(ops: SpaceOps, u, exact, weight, time=None,
                      quad_order=None):
    """|| u_h - exact ||_L2 with a positive weight (e.g. the ALE Jacobian
    J for physical-domain norms, ComputeLpError with a weight coefficient,
    diffusion_mms_ale.cpp:915-924)."""
    fes = ops.fes
    qorder = quad_order or max(4, 2 * fes.order + 6)
    hi = _elevated_ops(ops, qorder)
    gf = hi.gf
    uq = hi.values_at_qp(u)
    ex = eval_coefficient(exact, gf.xq, time)
    w = eval_coefficient(weight, gf.xq, time)
    return jnp.sqrt(jnp.sum(w * (uq - ex) ** 2 * gf.wdetJ))


def linf_error(fes: FESpace, u, exact, time=None):
    """Max nodal error (the reference's Normlinf on the error grid function,
    diffusion_mms.cpp:377-383)."""
    pts = fes.node_positions
    ex = exact(pts) if time is None else exact(pts, time)
    return jnp.max(jnp.abs(jnp.asarray(u) - jnp.asarray(ex).reshape(-1)))
