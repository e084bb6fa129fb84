"""Coupled (T, p) porous-medium pyrolysis system (ablation case 1+).

Clean-room re-implementation of the reference's
``AblationTPIntegrator`` + ``ReactionStateManager``
(/root/reference/myapps/convection_diffusion/ablation_test_case1_2D.cpp:264-615):

- energy residual: solid+gas storage, conduction, Darcy enthalpy advection,
  gravity work, pyrolysis heat sink (ComputeElementResidual :466-597);
- pressure residual: gas storage, Darcy flux, pyrolysis source;
- per-QP reaction extents advanced by the implicit TACOT extent solve and
  *frozen per step* (recomputed from the old state inside the residual, so
  AD differentiates through the extent Newton — the semantic the
  reference's whole-residual FD Jacobian (:401-463) captures);
- element Jacobian blocks by vmapped forward-mode AD instead of FD;
- element-average diagnostics (AdvanceInternalStates :821-921) and the
  top-boundary Darcy mass-flux diagnostic (:634-746).

Everything is batched over (ne, nq) and jittable.
"""

from __future__ import annotations

from dataclasses import dataclass

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.assembly import SpaceOps
from ..ops.faces import BoundaryTrace
from .tacot import TacotMaterial

MU_FLOOR = 1.0e-12


@dataclass
class AblationState:
    """Per-QP committed reaction extents + element-average diagnostics."""

    extent: jnp.ndarray            # (ne, nq, nr) committed (extent_old == extent)
    tau_elem: np.ndarray           # (ne,)
    rho_elem: np.ndarray
    pi_elem: np.ndarray
    mdot_elem: np.ndarray
    extent_elem: np.ndarray        # (nr, ne)
    degree_char_elem: np.ndarray
    char_density_fraction_elem: np.ndarray
    pi_qp: np.ndarray | None = None  # (ne, nq) per-QP pyrolysis rate

    @classmethod
    def initial(cls, ne, nq, material: TacotMaterial):
        nr = material.num_reactions
        return cls(
            extent=jnp.zeros((ne, nq, nr)),
            tau_elem=np.ones(ne),
            rho_elem=np.full(ne, material.initial_solid_density()),
            pi_elem=np.zeros(ne),
            mdot_elem=np.zeros(ne),
            extent_elem=np.zeros((nr, ne)),
            degree_char_elem=np.zeros(ne),
            char_density_fraction_elem=np.zeros(ne),
            pi_qp=np.zeros((ne, nq)),
        )


class AblationSystem:
    """The coupled residual, AD Jacobian, state advance, and diagnostics."""

    def __init__(self, ops: SpaceOps, material: TacotMaterial,
                 gravity=(0.0, 0.0), top_attr: int = 1):
        self.ops = ops
        self.mat = material
        self.gravity = jnp.asarray(np.asarray(gravity, dtype=np.float64))
        self.n = ops.fes.nscalar
        self.ne, self.nq = np.asarray(ops.gf.wdetJ).shape
        self.trace = BoundaryTrace(ops, attr_marker=[top_attr])
        self.lat = None

    def set_dof_lattice(self, lat):
        """Enable the window-slicing residual path for tensor-product strip
        meshes: on a dof lattice the per-element gather and segment_sum
        become static window slices / overlap-adds (ops/lattice2d.py — the
        same trick solvers/blocksolve.py plays for the GMRES matvec).  Raises
        ValueError when the mesh elements are not row-major over the cell
        lattice (callers fall back to the generic path)."""
        from ..ops.lattice2d import StripLatticeOps

        self.lat = StripLatticeOps(self.ops.fes.element_dofs, self.n, lat)
        # concrete tabulation copies for interp(): slicing the device
        # arrays ops.G[:, :, r] under an enclosing jit trace yields
        # tracers, which interp() cannot bake into FMA weights
        self._Bn = np.asarray(self.ops.B)
        self._Gn = np.asarray(self.ops.G)
        return self.lat

    # -- QP-level residual densities --------------------------------------

    def _qp_residual(self, Tq, gTq, pq, gpq, T_old_q, p_old_q, X_old, dt,
                     wq=None, gcl=None,
                     ale_toggles=(True, True, True)):
        """Residual densities at QPs.

        Returns (r0T, r1T, r0p, r1p): test-value and test-gradient weights
        for the energy and pressure equations (all (..., nq[, dim])).
        With a mesh velocity wq (..., nq, dim) the case-2.2 ALE advective
        terms +(eps_g rho)(w . grad psi) and
        +(rho_s cp T + eps_g(rho h - p))(w . grad psi) are added
        (ablation_test_case2_2_2D.cpp:1884-1927)."""
        mat = self.mat
        X = mat.solve_reaction_extents(Tq, dt, X_old)
        solid = mat.solid_props(Tq, pq, X, extent_old=X_old, dt=dt)
        gas = mat.gas_props(Tq, pq)
        solid_old = mat.solid_props(T_old_q, p_old_q, X_old)
        gas_old = mat.gas_props(T_old_q, p_old_q)

        mu = jnp.maximum(gas["mu"], MU_FLOOR)
        darcy = solid["K"] / mu
        rho_darcy = gas["rho"] * darcy
        rho2_darcy = gas["rho"] * rho_darcy
        h_rho_darcy = gas["h"] * rho_darcy
        h_rho2_darcy = gas["h"] * rho2_darcy

        ale_mass_on, ale_es_on, ale_eg_on = ale_toggles
        e_m_new = solid["eps_g"] * gas["rho"]
        e_m_old = solid_old["eps_g"] * gas_old["rho"]
        e_s_new = solid["rho_s"] * solid["cp"] * Tq
        e_s_old = solid_old["rho_s"] * solid_old["cp"] * T_old_q
        e_g_new = solid["eps_g"] * (gas["rho"] * gas["h"] - pq)
        e_g_old = solid_old["eps_g"] * (gas_old["rho"] * gas_old["h"]
                                        - p_old_q)
        # plain backward-Euler storage (the solid term uses NEW properties
        # with the temperature difference, matching the reference's
        # solid.rho_s*solid.cp*(T - T_old)/dt)
        storage_p = (e_m_new - e_m_old) / dt
        solid_storage = solid["rho_s"] * solid["cp"] * (Tq - T_old_q) / dt
        gas_storage = (e_g_new - e_g_old) / dt
        if gcl is not None:
            # Jacobian-weighted geometric-conservation storage
            # (ablation_test_case2_2_2D_test.cpp EvaluateQPCoeffs :1678-1775)
            J_old, J_new = gcl
            ok = (J_old > 0) & (J_new > 0)
            Jn = jnp.where(ok, J_new, 1.0)
            Jo = jnp.where(ok, J_old, 1.0)

            def gcl_storage(enabled, enew, eold, plain):
                if not enabled:
                    return plain
                return jnp.where(ok, (Jn * enew - Jo * eold) / (Jn * dt),
                                 plain)

            storage_p = gcl_storage(ale_mass_on, e_m_new, e_m_old, storage_p)
            solid_storage = gcl_storage(ale_es_on, e_s_new, e_s_old,
                                        solid_storage)
            gas_storage = gcl_storage(ale_eg_on, e_g_new, e_g_old,
                                      gas_storage)
        source_p = solid["pi_total"]

        g = self.gravity
        r0p = storage_p - source_p
        r1p = rho_darcy[..., None] * gpq - rho2_darcy[..., None] * g
        r0T = solid_storage + gas_storage - solid["pyrolysis_heat_sink"]
        r1T = (solid["k"][..., None] * gTq
               + h_rho_darcy[..., None] * gpq
               - h_rho2_darcy[..., None] * g)
        if wq is not None:
            ale_mass = e_m_new if ale_mass_on else jnp.zeros_like(e_m_new)
            ale_energy = ((e_s_new if ale_es_on else 0.0)
                          + (e_g_new if ale_eg_on else 0.0))
            r1p = r1p + ale_mass[..., None] * wq
            if ale_es_on or ale_eg_on:
                r1T = r1T + ale_energy[..., None] * wq
        return r0T, r1T, r0p, r1p

    # -- global residual ---------------------------------------------------

    def residual(self, T, p, T_old_q, p_old_q, X_old, dt, gf=None, wq=None,
                 gcl=None, ale_toggles=(True, True, True)):
        """Global block residual (R_T, R_p) for dof vectors T, p (n,)."""
        ops = self.ops
        gf = gf or ops.gf
        lp = self.lat
        ndim = ops.G.shape[2]
        if lp is not None:
            Tl = lp.to_lat(jnp.asarray(T))
            pl = lp.to_lat(jnp.asarray(p))
            Tq = lp.interp(Tl, self._Bn)
            pq = lp.interp(pl, self._Bn)
            gTref = jnp.stack([lp.interp(Tl, self._Gn[:, :, r])
                               for r in range(ndim)], axis=-1)
            gpref = jnp.stack([lp.interp(pl, self._Gn[:, :, r])
                               for r in range(ndim)], axis=-1)
            gT = jnp.sum(gf.invJ * gTref[..., :, None], axis=-2)
            gp = jnp.sum(gf.invJ * gpref[..., :, None], axis=-2)
        else:
            T_e = jnp.asarray(T)[ops.eldofs]
            p_e = jnp.asarray(p)[ops.eldofs]
            Tq = jnp.einsum("qn,en->eq", ops.B, T_e)
            pq = jnp.einsum("qn,en->eq", ops.B, p_e)
            gT = jnp.sum(gf.invJ * jnp.einsum(
                "qnr,en->eqr", ops.G, T_e)[..., :, None], axis=-2)
            gp = jnp.sum(gf.invJ * jnp.einsum(
                "qnr,en->eqr", ops.G, p_e)[..., :, None], axis=-2)
        r0T, r1T, r0p, r1p = self._qp_residual(
            Tq, gT, pq, gp, T_old_q, p_old_q, X_old, dt, wq=wq, gcl=gcl,
            ale_toggles=ale_toggles)

        def scatter_pair(r0, r1):
            y_e = jnp.einsum("qn,eq->en", ops.B, r0 * gf.wdetJ)
            r1ref = jnp.sum(gf.invJ * r1[..., None, :], axis=-1)
            y_e = y_e + jnp.einsum("qnr,eqr->en", ops.G,
                                   r1ref * gf.wdetJ[..., None])
            return lp.scatter(y_e) if lp is not None else ops.scatter(y_e)

        return scatter_pair(r0T, r1T), scatter_pair(r0p, r1p)

    # -- element Jacobian blocks ------------------------------------------

    def elem_residual_fn(self, dt, gcl_enabled=False,
                         ale_toggles=(True, True, True)):
        """Single-element residual closure
        ``elem_res(elT, elp, invJ, wdetJ, To, po, Xo, wqe, Jo, Jn) ->
        (rT (nd,), rp (nd,))`` — the common core of the global residual,
        the AD element Jacobians, and the element-sharded multichip path
        (the per-element quadrature work of AssembleElementVector/Grad,
        ablation_test_case1_2D.cpp:367-615)."""
        ops = self.ops

        def elem_res(elT, elp, invJ, wdetJ, To, po, Xo, wqe, Jo, Jn):
            Tq = jnp.einsum("qn,n->q", ops.B, elT)[None]
            pq = jnp.einsum("qn,n->q", ops.B, elp)[None]
            gT = jnp.sum(invJ * jnp.einsum(
                "qnr,n->qr", ops.G, elT)[..., :, None], axis=-2)[None]
            gp = jnp.sum(invJ * jnp.einsum(
                "qnr,n->qr", ops.G, elp)[..., :, None], axis=-2)[None]
            r0T, r1T, r0p, r1p = self._qp_residual(
                Tq, gT, pq, gp, To[None], po[None], Xo[None], dt,
                wq=wqe[None],
                gcl=(Jo[None], Jn[None]) if gcl_enabled else None,
                ale_toggles=ale_toggles)

            def pair(r0, r1):
                y = jnp.einsum("qn,q->n", ops.B, r0[0] * wdetJ)
                r1ref = jnp.sum(invJ * r1[0][..., None, :], axis=-1)
                return y + jnp.einsum("qnr,qr->n", ops.G,
                                      r1ref * wdetJ[:, None])

            return pair(r0T, r1T), pair(r0p, r1p)

        return elem_res

    def element_jacobians(self, T, p, T_old_q, p_old_q, X_old, dt, gf=None,
                          wq=None, gcl=None, ale_toggles=(True, True, True)):
        """(ne, 2, nd, 2, nd) Jacobian blocks d(rT,rp)/d(elT,elp) by AD."""
        ops = self.ops
        gf = gf or ops.gf
        if wq is None:
            wq = jnp.zeros(gf.wdetJ.shape + (gf.xq.shape[-1],))

        if gcl is None:
            gcl_arrs = (jnp.full(gf.wdetJ.shape, -1.0),
                        jnp.full(gf.wdetJ.shape, -1.0))
        else:
            gcl_arrs = gcl

        elem_res = self.elem_residual_fn(dt, gcl_enabled=gcl is not None,
                                         ale_toggles=ale_toggles)
        T_e = jnp.asarray(T)[ops.eldofs]
        p_e = jnp.asarray(p)[ops.eldofs]
        jac = jax.vmap(jax.jacfwd(elem_res, argnums=(0, 1)),
                       in_axes=(0, 0, 0, 0, 0, 0, 0, 0, 0, 0))
        args = (T_e, p_e, gf.invJ, gf.wdetJ, T_old_q, p_old_q, X_old,
                wq, *gcl_arrs)
        ne = T_e.shape[0]
        chunk = int(os.environ.get("CMFEM_ELEMJAC_CHUNK", "16384"))
        if ne <= chunk:
            (JTT, JTp), (JpT, Jpp) = jac(*args)
            return JTT, JTp, JpT, Jpp
        # large meshes (refinement studies): the tangent-vmapped AD
        # materializes per-element table one-hots with the 2*nd tangent
        # batch dim — (2nd, ne, nq, nT) blew past HBM at refine-3
        # (168k elements).  Chunk the element axis through a sequential
        # lax.map so peak memory is bounded; production-sized meshes
        # take the single vmap above unchanged.
        nch = -(-ne // chunk)
        pad = nch * chunk - ne

        def to_chunks(a):
            if pad:
                a = jnp.concatenate(
                    [a, jnp.broadcast_to(a[:1], (pad,) + a.shape[1:])])
            return a.reshape((nch, chunk) + a.shape[1:])

        outs = jax.lax.map(lambda ars: jac(*ars),
                           tuple(to_chunks(a) for a in args))
        (JTT, JTp), (JpT, Jpp) = jax.tree.map(
            lambda a: a.reshape((nch * chunk,) + a.shape[2:])[:ne], outs)
        return JTT, JTp, JpT, Jpp

    # -- state advance + diagnostics --------------------------------------

    def jacobian_check(self, T, p, T_old_q, p_old_q, X_old, dt,
                       abs_tol=1e-6, rel_tol=1e-4, n_dirs=3, fd_eps=1e-7,
                       gf=None, wq=None, gcl=None,
                       ale_toggles=(True, True, True), seed=0,
                       seb=None, bc=None, vertices=None,
                       skip_nonsmooth=True):
        """AD-vs-FD Jacobian consistency check (the reference's opt-in
        jacobian_check, ablation_test_case2_1_2D.cpp:1016-1046,
        :1287-1302): the element-block-assembled Jacobian action J v is
        compared against a finite-difference directional derivative of the
        global residual for n_dirs random directions.  Raises with the
        argmax row on mismatch; returns the max relative error.

        With ``seb=(branch, model, bprime)`` and ``bc`` the SEB *face*
        blocks are assembled into the test matrix and the face residual
        into R — the per-flux-branch face-Jacobian consistency check of
        the reference (ablation_test_case2_1_2D.cpp:1809-1832).  Like the
        reference, states where the B' table clamps (non-smooth — central
        FD straddles the kink the AD one-sidedly zeroes) are skipped:
        returns None when ``skip_nonsmooth`` and clamps are active."""
        import numpy as _np
        import scipy.sparse as _sp

        blocks = self.element_jacobians(T, p, T_old_q, p_old_q, X_old, dt,
                                        gf=gf, wq=wq, gcl=gcl,
                                        ale_toggles=ale_toggles)
        n = self.n
        ed = _np.asarray(self.ops.fes.element_dofs, dtype=_np.int64)
        nd = ed.shape[1]
        rows_b = _np.repeat(ed, nd, axis=1).reshape(-1)
        cols_b = _np.tile(ed, (1, nd)).reshape(-1)
        rows = _np.concatenate([rows_b, rows_b, rows_b + n, rows_b + n])
        cols = _np.concatenate([cols_b, cols_b + n, cols_b, cols_b + n])
        vals = _np.concatenate([_np.asarray(b).reshape(-1) for b in blocks])
        if seb is not None:
            branch, model, bprime = seb
            chem_on = bc is not None and int(bc.chemistryOn) != 0
            if skip_nonsmooth and bprime is not None and chem_on:
                # clamps only make the residual non-smooth when the B'
                # outputs actually enter the flux (chemistry on): with
                # chemistry off h_w/B'c are zeroed out of q_surf.
                tr = self.trace
                Xrep = jnp.asarray(X_old)[tr.elem, 0]
                terms = self.top_boundary_terms(T, p, Xrep, bc, branch,
                                                model, bprime,
                                                vertices=vertices)
                nclamp = float(terms.get("clamps_p", 0.0)) + \
                    float(terms.get("clamps_bg", 0.0)) + \
                    float(terms.get("clamps_t", 0.0))
                if nclamp > 0:
                    return None
            JTf, Jpf = self.seb_face_jacobians(T, p, X_old, bc, branch,
                                               model, bprime,
                                               vertices=vertices)
            fed = _np.asarray(self.trace.eldofs, dtype=_np.int64)
            ndf = fed.shape[1]
            rows_f = _np.repeat(fed, ndf, axis=1).reshape(-1)
            cols_f = _np.tile(fed, (1, ndf)).reshape(-1)
            rows = _np.concatenate([rows, rows_f, rows_f])
            cols = _np.concatenate([cols, cols_f, cols_f + n])
            vals = _np.concatenate([vals, _np.asarray(JTf).reshape(-1),
                                    _np.asarray(Jpf).reshape(-1)])
        J = _sp.coo_matrix((vals, (rows, cols)), shape=(2 * n, 2 * n)).tocsr()

        def R(x):
            RT, Rp = self.residual(x[:n], x[n:], T_old_q, p_old_q, X_old, dt,
                                   gf=gf, wq=wq, gcl=gcl,
                                   ale_toggles=ale_toggles)
            if seb is not None:
                branch, model, bprime = seb
                RT = RT + self.seb_face_residual(
                    x[:n], x[n:], X_old, bc, branch, model, bprime,
                    vertices=vertices)
            return _np.concatenate([_np.asarray(RT), _np.asarray(Rp)])

        x0 = _np.concatenate([_np.asarray(T), _np.asarray(p)])
        rng = _np.random.default_rng(seed)
        max_rel = 0.0
        for _ in range(n_dirs):
            v = rng.standard_normal(2 * n)
            v *= _np.maximum(1.0, _np.abs(x0)) / _np.linalg.norm(v)
            h = fd_eps
            fd = (R(x0 + h * v) - R(x0 - h * v)) / (2 * h)
            jv = J @ v
            err = _np.abs(jv - fd)
            scale = max(float(_np.abs(fd).max()), 1.0)
            rel = float(err.max()) / scale
            max_rel = max(max_rel, rel)
            if err.max() > abs_tol * scale + rel_tol * scale:
                i = int(err.argmax())
                raise RuntimeError(
                    f"Jacobian check failed at row {i}: "
                    f"AD(Jv)={jv[i]:.6e} FD={fd[i]:.6e} "
                    f"(abs err {err[i]:.3e}, scale {scale:.3e})")

        if seb is not None:
            # dedicated face-block check with its OWN scale (the reference
            # verifies the SEB integrator's Grad against an FD of its
            # Vector as a separate block, VerifyJacobianBlockClose,
            # ablation_test_case2_1_2D.cpp:1016-1046 — a face error hidden
            # under the global residual scale would pass the check above)
            branch, model, bprime = seb
            Jf = _sp.coo_matrix(
                (_np.concatenate([_np.asarray(JTf).reshape(-1),
                                  _np.asarray(Jpf).reshape(-1)]),
                 (_np.concatenate([rows_f, rows_f]),
                  _np.concatenate([cols_f, cols_f + n]))),
                shape=(n, 2 * n)).tocsr()

            def Rf(x):
                return _np.asarray(self.seb_face_residual(
                    x[:n], x[n:], X_old, bc, branch, model, bprime,
                    vertices=vertices))

            def face_dir_check(v, h):
                fd = (Rf(x0 + h * v) - Rf(x0 - h * v)) / (2 * h)
                jv = Jf @ v
                err = _np.abs(jv - fd)
                scale = max(float(_np.abs(fd).max()), 1.0)
                return err, jv, fd, scale

            fails = 0
            for _ in range(n_dirs):
                v = rng.standard_normal(2 * n)
                v *= _np.maximum(1.0, _np.abs(x0)) / _np.linalg.norm(v)
                err, jv, fd, scale = face_dir_check(v, fd_eps)
                if err.max() > (abs_tol + rel_tol) * scale:
                    # discriminate a genuine Jacobian error (h-independent)
                    # from a central difference straddling an interior
                    # spline knot (first-order kink error whose hit window
                    # shrinks with h): retry with a fresh direction at h/8
                    # — the reference's non-smooth-state skip generalized
                    # to interior table kinks
                    v2 = rng.standard_normal(2 * n)
                    v2 *= _np.maximum(1.0, _np.abs(x0)) / _np.linalg.norm(v2)
                    err2, jv2, fd2, scale2 = face_dir_check(v2, fd_eps / 8)
                    if err2.max() > (abs_tol + rel_tol) * scale2:
                        i = int(err2.argmax())
                        raise RuntimeError(
                            f"Jacobian check failed at face row {i} "
                            f"(branch={branch}): AD(Jv)={jv2[i]:.6e} "
                            f"FD={fd2[i]:.6e} (abs err {err2[i]:.3e}, "
                            f"scale {scale2:.3e})")
                    continue
                max_rel = max(max_rel, float(err.max()) / scale)
        return max_rel

    def advance_state_arrays(self, X_old, T, p, dt):
        """Jittable core of the state advance: returns
        (X_new, tau_e, rho_e, pi_e, mdot_e, extent_e (nr, ne), pi_qp)."""
        ops = self.ops
        mat = self.mat
        Tq = ops.values_at_qp(T)
        pq = ops.values_at_qp(p)
        X = mat.solve_reaction_extents(Tq, dt, X_old)
        solid = mat.solid_props(Tq, pq, X, extent_old=X_old, dt=dt)
        return (X, jnp.mean(solid["tau"], axis=1),
                jnp.mean(solid["rho_s"], axis=1),
                jnp.mean(solid["pi_total"], axis=1),
                jnp.mean(solid["m_dot_g"], axis=1),
                jnp.mean(X, axis=1).T, solid["pi_total"])

    def advance_state(self, state: AblationState, T, p, dt) -> AblationState:
        """Commit per-QP extents after a converged step and refresh the
        element-average diagnostics (AdvanceInternalStates :821-921)."""
        mat = self.mat
        (X, tau_e, rho_e, pi_e, mdot_e, extent_e,
         pi_qp) = self.advance_state_arrays(state.extent, T, p, dt)
        tau_e = np.asarray(tau_e)
        rho_e = np.asarray(rho_e)
        degree_char = np.clip(1.0 - tau_e, 0.0, 1.0)
        rho_v = mat.initial_solid_density()
        rho_c = mat.char_solid_density()
        den = rho_v - rho_c
        cdf = np.clip((rho_v - rho_e) / den, 0.0, 1.0) if abs(den) > 1e-14 \
            else np.zeros_like(rho_e)

        return AblationState(
            extent=X, tau_elem=tau_e, rho_elem=rho_e,
            pi_elem=np.asarray(pi_e), mdot_elem=np.asarray(mdot_e),
            extent_elem=np.asarray(extent_e),
            degree_char_elem=degree_char, char_density_fraction_elem=cdf,
            pi_qp=np.asarray(pi_qp),
        )

    # -- surface energy balance (case 2.1+) --------------------------------

    def _seb_face_qp(self, Tw, pw, gpw, Xrep, normal, bc, branch, model,
                     bprime, count_clamps=False):
        """Flux terms at face QPs given trace values (batched (nbf, nqf))."""
        from .seb import surface_flux

        mat = self.mat
        nqf = Tw.shape[-1]
        Xf = jnp.broadcast_to(Xrep[:, None, :],
                              Tw.shape + (Xrep.shape[-1],))
        solid = mat.solid_props(Tw, pw, Xf)
        gas = mat.gas_props(Tw, pw)
        mu = jnp.maximum(gas["mu"], MU_FLOOR)
        rho_darcy = gas["rho"] * solid["K"] / mu
        rho2_darcy = gas["rho"] * rho_darcy
        mflux = (-rho_darcy[..., None] * gpw
                 + rho2_darcy[..., None] * self.gravity)
        m_dot_g_w = jnp.einsum("fqd,fqd->fq", mflux, normal)
        emissivity = jnp.full_like(Tw, model.emissivity_override) \
            if model.use_emissivity_override else solid["emissivity"]
        absorptivity = jnp.full_like(Tw, model.absorptivity_override) \
            if model.use_absorptivity_override else solid["absorptivity"]
        terms = surface_flux(m_dot_g_w, gas["h"], Tw, emissivity,
                             absorptivity, solid["reflectivity"], bc, branch,
                             model, bprime, count_clamps=count_clamps)
        terms["m_dot_g_w"] = m_dot_g_w
        terms["rho_s"] = solid["rho_s"]
        return terms

    def seb_face_residual(self, T, p, extent, bc, branch,
                          model, bprime, vertices=None):
        """R_T contribution of the SEB boundary integrator:
        R_T[i] -= int q_surf psi_i ds over the top boundary
        (ComputeFaceResidual, ablation_test_case2_1_2D.cpp:2109-2217)."""
        tr = self.trace
        Tw = tr.values(T)
        pw = tr.values(p)
        gpw = tr.grads(p, vertices)
        ff = tr.face_factors(vertices)
        Xrep = jnp.asarray(extent)[tr.elem, 0]
        terms = self._seb_face_qp(Tw, pw, gpw, Xrep, ff.normal, bc, branch,
                                  model, bprime)
        return -tr.scatter(terms["q_surf"] * ff.wdS)

    def seb_face_res_fn(self, branch, model, bprime):
        """Single-face SEB residual closure ``face_res(elT, elp, B, G, iJ,
        nrm, wdS, Xr, bc) -> rT (nd,)`` — shared by the AD face Jacobians
        and the element-sharded multichip path (bc is a traced
        BoundaryState pytree; branch/model/bprime are static)."""

        def face_res(elT, elp, B, G, iJ, nrm, wdS, Xr, bc):
            Tw = jnp.einsum("qn,n->q", B, elT)[None]
            pw = jnp.einsum("qn,n->q", B, elp)[None]
            gref = jnp.einsum("qnr,n->qr", G, elp)
            gpw = jnp.sum(iJ * gref[..., :, None], axis=-2)[None]
            terms = self._seb_face_qp(Tw, pw, gpw, Xr[None], nrm[None], bc,
                                      branch, model, bprime)
            return -jnp.einsum("qn,q->n", B, terms["q_surf"][0] * wdS)

        return face_res

    def seb_face_jacobians(self, T, p, extent, bc, branch,
                           model, bprime, vertices=None):
        """(nbf, nd, nd) x2 face Jacobian blocks d(rT_face)/d(elT, elp)."""
        tr = self.trace
        ff = tr.face_factors(vertices)
        invJ = tr.element_invJ(vertices)
        Btab = tr.Btab[tr._combo_j]
        Gtab = tr.Gtab[tr._combo_j]
        Xrep = jnp.asarray(extent)[tr.elem, 0]
        T_e = jnp.asarray(T)[tr.eldofs]
        p_e = jnp.asarray(p)[tr.eldofs]

        face_res = self.seb_face_res_fn(branch, model, bprime)
        jacf = jax.vmap(jax.jacfwd(face_res, argnums=(0, 1)),
                        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None))
        JT, Jp = jacf(T_e, p_e, Btab, Gtab, invJ, ff.normal, ff.wdS, Xrep,
                      bc)
        return JT, Jp

    _SURF_KEYS = ("m_dot_c_surf", "rho_s_surf", "BprimeG_surf",
                  "BprimeC_surf", "h_w_surf", "emissivity_surf",
                  "absorptivity_surf", "reflectivity_surf",
                  "blowing_correction_surf", "q_conv_surf",
                  "q_adv_pyro_surf", "q_rad_emit_surf", "q_rad_abs_surf",
                  "q_surf")

    def top_boundary_terms(self, T, p, Xrep, bc, branch, model, bprime,
                           vertices=None):
        """Jittable area-averaged surface terms (dict of jnp scalars incl.
        ``area`` and B'-table clamp counts)."""
        tr = self.trace
        Tw = tr.values(T)
        pw = tr.values(p)
        gpw = tr.grads(p, vertices)
        ff = tr.face_factors(vertices)
        terms = self._seb_face_qp(Tw, pw, gpw, Xrep, ff.normal, bc, branch,
                                  model, bprime)
        area = jnp.sum(ff.wdS)
        avg = lambda x: jnp.sum(x * ff.wdS) / jnp.maximum(area, 1e-300)
        src = {"m_dot_c_surf": "m_dot_c", "rho_s_surf": "rho_s",
               "BprimeG_surf": "BprimeG", "BprimeC_surf": "BprimeC",
               "h_w_surf": "h_w", "emissivity_surf": "emissivity",
               "absorptivity_surf": "absorptivity",
               "reflectivity_surf": "reflectivity",
               "blowing_correction_surf": "blowing_correction",
               "q_conv_surf": "q_conv", "q_adv_pyro_surf": "q_adv_pyro",
               "q_rad_emit_surf": "q_rad_emit", "q_rad_abs_surf": "q_rad_abs",
               "q_surf": "q_surf"}
        out = {k: avg(terms[v]) for k, v in src.items()}
        out["m_dot_g_surf"] = avg(terms["m_dot_g_w"])
        out["area"] = area
        for k in ("clamps_p", "clamps_bg", "clamps_t"):
            out[k] = terms[k]
        return out

    def _diag_jitted(self, branch, model, bprime):
        """Per-(branch, model, bprime) cached jit of top_boundary_terms."""
        if not hasattr(self, "_diag_cache"):
            self._diag_cache = {}
        key = (branch, id(model), id(bprime))
        if key not in self._diag_cache:
            self._diag_cache[key] = jax.jit(
                lambda T, p, X, bcc, v: self.top_boundary_terms(
                    T, p, X, bcc, branch, model, bprime, vertices=v))
        return self._diag_cache[key]

    def top_boundary_diagnostics(self, T, p, state: AblationState, bc,
                                 branch, model, bprime,
                                 compute_surface_terms=True, vertices=None,
                                 count_clamps=True):
        """Area-averaged surface diagnostics (ComputeTopBoundaryDiagnostics,
        :2257-2468): 13 quantities + m_dot_g_surf.  Runs one jitted kernel
        per branch (the eager path traced the whole SEB pipeline on every
        call, dominating driver output time)."""
        tr = self.trace
        verts = jnp.asarray(tr.fes.mesh.vertices if vertices is None
                            else vertices)
        Xrep = jnp.asarray(state.extent)[tr.elem, 0]
        vals = self._diag_jitted(branch, model, bprime)(
            jnp.asarray(T), jnp.asarray(p), Xrep, bc, verts)
        vals = jax.device_get(vals)
        if count_clamps and bprime is not None:
            bprime.clamp_stats.p += int(vals["clamps_p"])
            bprime.clamp_stats.bg += int(vals["clamps_bg"])
            bprime.clamp_stats.t += int(vals["clamps_t"])
        if float(vals["area"]) <= 0:
            return {k: float("nan") for k in
                    ("m_dot_g_surf",) + self._SURF_KEYS}
        out = {"m_dot_g_surf": float(vals["m_dot_g_surf"])}
        for k in self._SURF_KEYS:
            out[k] = float(vals[k]) if compute_surface_terms else float("nan")
        return out

    def _recession_velocity_terms(self, T, p, Xrep, bc, branch, model,
                                  bprime, recession_density_mode,
                                  recession_density_constant, vertices):
        """Jittable body of top_boundary_recession_velocity."""
        tr = self.trace
        Tw = tr.values(T)
        pw = tr.values(p)
        gpw = tr.grads(p, vertices)
        ff = tr.face_factors(vertices)
        terms = self._seb_face_qp(Tw, pw, gpw, Xrep, ff.normal, bc, branch,
                                  model, bprime)
        rho_rec = terms["rho_s"] if recession_density_mode == "char_surface" \
            else jnp.full_like(Tw, recession_density_constant)
        rho_rec = jnp.maximum(rho_rec, 1e-8)
        v_rec = jnp.maximum(0.0, terms["m_dot_c"]) / rho_rec
        num = tr.scatter(v_rec * ff.wdS)
        den = tr.scatter(ff.wdS)
        tiny = jnp.finfo(den.dtype).tiny
        v = jnp.where(den > 1e-16, num / jnp.maximum(den, tiny), 0.0)
        v = jnp.where(jnp.isfinite(v) & (v > 0), v, 0.0)
        # restrict to top-boundary dofs
        top_mask = np.zeros(self.n, dtype=bool)
        top_mask[np.unique(np.asarray(tr.fes.bdr.dofs)[tr.face_ids])] = True
        return jnp.where(jnp.asarray(top_mask), v, 0.0)

    def top_boundary_recession_velocity(self, T, p, state: AblationState,
                                        bc, branch, model, bprime,
                                        recession_density_mode="char_surface",
                                        recession_density_constant=1200.0,
                                        vertices=None):
        """Lumped top-boundary recession velocity (n,) at scalar DOFs:
        v_rec = max(0, m_dot_c)/rho_rec averaged with ds psi weights
        (AssembleTopBoundaryRecessionVelocity,
        ablation_test_case2_2_2D.cpp:2740-2953).  Uses the element
        QP-average extents as the representative state (:2454-2500).
        Runs as one cached jit per (branch, density mode)."""
        tr = self.trace
        if not hasattr(self, "_rec_cache"):
            self._rec_cache = {}
        key = (branch, recession_density_mode,
               float(recession_density_constant), id(model), id(bprime))
        if key not in self._rec_cache:
            self._rec_cache[key] = jax.jit(
                lambda T, p, X, bcc, v: self._recession_velocity_terms(
                    T, p, X, bcc, branch, model, bprime,
                    recession_density_mode, recession_density_constant, v))
        verts = jnp.asarray(tr.fes.mesh.vertices if vertices is None
                            else vertices)
        Xrep = jnp.mean(jnp.asarray(state.extent), axis=1)[tr.elem]
        return self._rec_cache[key](jnp.asarray(T), jnp.asarray(p), Xrep,
                                    bc, verts)

    def mass_eq_probe(self, T, p, state: AblationState, points,
                      vertices=None):
        """Per-point mass-equation diagnostics (SampleMassEqProbeAtPoint,
        ablation_test_case2_2_2D_test.cpp:3483-3560): for each probe point,
        [pi_total, tau, eps_g*rho_g, dp/dy, rho_g, mu_g, K,
        mobility(=rho K/mu), mflux_y] using the nearest tabulated QP's
        reaction state; NaN rows where the point is not found."""
        from ..core.pointlocate import locate_points, sample_h1, \
            sample_h1_grad

        fes = self.ops.fes
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        Tpt = sample_h1(fes, T, points, vertices)
        ppt = sample_h1(fes, p, points, vertices)
        gp = sample_h1_grad(fes, p, points, vertices)
        e_ids, refs = locate_points(fes.mesh, points, vertices)
        out = np.full((len(points), 9), np.nan)
        found = np.nonzero(e_ids >= 0)[0]
        if len(found) == 0:
            return out
        qp_ref = np.asarray(self.ops.quad.points)
        d2 = ((refs[found][:, None, :] - qp_ref[None]) ** 2).sum(axis=2)
        nearest_q = np.argmin(d2, axis=1)
        Xn = np.asarray(state.extent)[e_ids[found], nearest_q]  # (nf, nr)
        Tf = jnp.asarray(Tpt[found])
        pf = jnp.asarray(ppt[found])
        solid = self.mat.solid_props(Tf, pf, jnp.asarray(Xn))
        gas = self.mat.gas_props(Tf, pf)
        mu = np.maximum(np.asarray(gas["mu"]), MU_FLOOR)
        rho = np.asarray(gas["rho"])
        K = np.asarray(solid["K"])
        rho_darcy = rho * K / mu
        gy = float(self.gravity[1]) if self.gravity.shape[0] > 1 else 0.0
        gradp_y = gp[found][:, 1] if gp.shape[1] > 1 else np.zeros(len(found))
        if state.pi_qp is not None:
            pi = np.asarray(state.pi_qp)[e_ids[found], nearest_q]
        else:
            pi = np.asarray(state.pi_elem)[e_ids[found]]
        out[found, 0] = pi
        out[found, 1] = np.asarray(solid["tau"])
        out[found, 2] = np.asarray(solid["eps_g"]) * rho
        out[found, 3] = gradp_y
        out[found, 4] = rho
        out[found, 5] = np.asarray(gas["mu"])
        out[found, 6] = K
        out[found, 7] = rho_darcy
        out[found, 8] = -rho_darcy * gradp_y + rho * rho_darcy * gy
        return out

    def mass_eq_probe_scan(self, T, p, X, pi_qp, sampler, loc, verts):
        """Jittable ``mass_eq_probe``: same 9 columns per point
        (SampleMassEqProbeAtPoint, ablation_test_case2_2_2D_test.cpp:
        3483-3560), fed by a ``TrackedSampler`` location so the scan
        drivers emit the mass-probe CSV without host round trips.
        ``loc = sampler.locate(verts)``; NaN rows where not found."""
        eid, ref, found = loc
        Tpt = sampler.sample_h1(loc, T)
        ppt = sampler.sample_h1(loc, p)
        gp = sampler.sample_grad(loc, p, verts)
        qp_ref = jnp.asarray(self.ops.quad.points)
        d2 = ((ref[:, None, :] - qp_ref[None]) ** 2).sum(axis=2)
        nearest_q = jnp.argmin(d2, axis=1)
        e_safe = jnp.maximum(eid, 0)
        Xn = X[e_safe, nearest_q]                      # (npts, nr)
        solid = self.mat.solid_props(Tpt, ppt, Xn)
        gas = self.mat.gas_props(Tpt, ppt)
        mu = jnp.maximum(gas["mu"], MU_FLOOR)
        rho = gas["rho"]
        K = solid["K"]
        rho_darcy = rho * K / mu
        gy = self.gravity[1] if self.gravity.shape[0] > 1 else 0.0
        gradp_y = gp[:, 1]
        pi = pi_qp[e_safe, nearest_q]
        out = jnp.stack([
            pi, solid["tau"], solid["eps_g"] * rho, gradp_y, rho,
            gas["mu"], K, rho_darcy,
            -rho_darcy * gradp_y + rho * rho_darcy * gy], axis=1)
        return jnp.where(found[:, None], out, jnp.nan)

    def top_boundary_mass_flux(self, T, p, state, vertices=None):
        """Area-averaged outward Darcy mass flux on the top boundary
        (ComputeTopBoundaryMassFlux :634-746).  Uses the adjacent element's
        first-QP reaction state as representative (:706-708).  ``state``
        may be an AblationState or a raw (ne, nq, nr) extent array (the
        jitted scan-stepping path)."""
        tr = self.trace
        Tq = tr.values(T)
        pq = tr.values(p)
        gp = tr.grads(p, vertices)
        extent = state.extent if isinstance(state, AblationState) else state
        Xrep = extent[tr.elem, 0]  # (nbf, nr)
        Xf = jnp.broadcast_to(Xrep[:, None, :],
                              (tr.nbf, tr.quad.nqp, Xrep.shape[-1]))
        solid = self.mat.solid_props(Tq, pq, Xf)
        gas = self.mat.gas_props(Tq, pq)
        mu = jnp.maximum(gas["mu"], MU_FLOOR)
        rho_darcy = gas["rho"] * solid["K"] / mu
        rho2_darcy = gas["rho"] * rho_darcy
        mflux = (-rho_darcy[..., None] * gp
                 + rho2_darcy[..., None] * self.gravity)
        ff = tr.face_factors(vertices)
        flux_int = jnp.sum(jnp.einsum("fqd,fqd->fq", mflux, ff.normal)
                           * ff.wdS)
        area = jnp.sum(ff.wdS)
        return jnp.where(area > 0, flux_int / area, jnp.nan)
