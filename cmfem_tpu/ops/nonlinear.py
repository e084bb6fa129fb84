"""Nonlinear forms: QP-level residual functions + AD Jacobians.

Replacement for MFEM ``(Par)NonlinearForm`` with custom
``NonlinearFormIntegrator``s.  The reference hand-derives element residuals
and analytic Jacobians per integrator (e.g. ``NonlinearMassBEIntegrator`` /
``NonlinearDiffusionIntegrator``,
nonlinear_convection_diffusion_1D.cpp:418-642); here the user writes only
the QP residual density and differentiation is by ``jax.jvp`` /
``jax.jacfwd`` of the whole form — deleting both of the reference's
FD-Jacobian machineries while keeping an FD consistency check in tests.

The QP residual signature:

    qp_residual(uq, gradq, xq, **aux) -> (r0, r1)

where uq (ne,nq) values, gradq (ne,nq,dim) physical gradients, xq physical
positions; r0 multiplies the test function, r1 its physical gradient:

    R_i = sum_q w detJ [ psi_i r0 + grad(psi_i) . r1 ].
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .assembly import SpaceOps
from ..core.geometry import GeometricFactors


class NonlinearForm:
    def __init__(self, ops: SpaceOps, qp_residual: Callable):
        self.ops = ops
        self.qp_residual = qp_residual

    def residual(self, u, gf: GeometricFactors | None = None, **aux):
        ops = self.ops
        gf = gf or ops.gf
        u_e = jnp.asarray(u)[ops.eldofs]
        uq = jnp.einsum("qn,en->eq", ops.B, u_e)
        gref = jnp.einsum("qnr,en->eqr", ops.G, u_e)
        gq = jnp.sum(gf.invJ * gref[..., :, None], axis=-2)
        r0, r1 = self.qp_residual(uq, gq, gf.xq, **aux)
        y_e = 0.0
        if r0 is not None:
            y_e = jnp.einsum("qn,eq->en", ops.B, r0 * gf.wdetJ)
        if r1 is not None:
            # pull physical gradient weight back to reference: G^T (invJ r1)
            r1ref = jnp.sum(gf.invJ * r1[..., None, :], axis=-1)
            y_e = y_e + jnp.einsum("qnr,eqr->en", ops.G, r1ref * gf.wdetJ[..., None])
        return ops.scatter(y_e)

    def jvp(self, u, v, gf: GeometricFactors | None = None, **aux):
        """Jacobian-vector product J(u) v by forward-mode AD."""
        f = lambda x: self.residual(x, gf=gf, **aux)
        _, jv = jax.jvp(f, (jnp.asarray(u),), (jnp.asarray(v),))
        return jv

    def linearize(self, u, gf: GeometricFactors | None = None, **aux):
        """Returns (R(u), v -> J(u) v) with shared linearization work."""
        f = lambda x: self.residual(x, gf=gf, **aux)
        return jax.linearize(f, jnp.asarray(u))

    def element_jacobians(self, u, gf: GeometricFactors | None = None, **aux):
        """(ne, ndof, ndof) element Jacobian blocks by vmapped jacfwd.

        Note: for residual densities with cross-element coupling this is
        exact only when the QP residual is local in u (true for all the
        reference's integrators)."""
        ops = self.ops
        gf = gf or ops.gf
        ne = gf.wdetJ.shape[0]
        # aux arrays with a leading element axis are sliced per element;
        # everything else is broadcast unchanged.
        mapped_keys = [k for k, v in aux.items()
                       if hasattr(v, "shape") and v.ndim >= 1 and v.shape[0] == ne]
        static_aux = {k: v for k, v in aux.items() if k not in mapped_keys}

        def elem_res(u_e, invJ, wdetJ, xq, mapped_vals):
            el_aux = dict(static_aux)
            for k, v in zip(mapped_keys, mapped_vals):
                el_aux[k] = v[None]
            uq = jnp.einsum("qn,n->q", ops.B, u_e)[None]
            gref = jnp.einsum("qnr,n->qr", ops.G, u_e)[None]
            gq = jnp.sum(invJ * gref[0][..., :, None], axis=-2)[None]
            r0, r1 = self.qp_residual(uq, gq, xq[None], **el_aux)
            y = 0.0
            if r0 is not None:
                y = jnp.einsum("qn,q->n", ops.B, r0[0] * wdetJ)
            if r1 is not None:
                r1ref = jnp.sum(invJ * r1[0][..., None, :], axis=-1)
                y = y + jnp.einsum("qnr,qr->n", ops.G, r1ref * wdetJ[:, None])
            return y

        u_e = jnp.asarray(u)[ops.eldofs]
        mapped_vals = [jnp.asarray(aux[k]) for k in mapped_keys]
        jac = jax.vmap(jax.jacfwd(elem_res), in_axes=(0, 0, 0, 0, 0))
        return jac(u_e, gf.invJ, gf.wdetJ, gf.xq, mapped_vals)

    def jacobian_diagonal(self, u, gf: GeometricFactors | None = None, **aux):
        """Global diagonal of J(u) (for Jacobi-preconditioned Krylov)."""
        Je = self.element_jacobians(u, gf=gf, **aux)
        diag_e = jnp.diagonal(Je, axis1=1, axis2=2)
        return self.ops.scatter(diag_e)

    def dense_jacobian(self, u, gf: GeometricFactors | None = None, **aux):
        """Dense global Jacobian (small/debug problems)."""
        import numpy as np

        ops = self.ops
        Je = self.element_jacobians(u, gf=gf, **aux)
        n = ops.fes.nscalar
        ed = np.asarray(ops.fes.element_dofs)
        rows = np.repeat(ed, Je.shape[1], axis=1)
        cols = np.tile(ed, (1, Je.shape[1]))
        A = jnp.zeros((n, n))
        return A.at[rows.reshape(-1), cols.reshape(-1)].add(Je.reshape(-1))
