"""On-device Newton-Krylov solves for the 2x2 (T, p) block Jacobians.

Replacement for the reference's MUMPS direct solves of the
ablation Newton systems (Input/petsc_ablation*.opts: `-ksp_type preonly
-pc_type lu -pc_factor_mat_solver_type mumps`; dispatch in
newton_petsc_solver.hpp:269-342).  Instead of materializing a global
sparse matrix on the host and factorizing it, the Jacobian stays in the
element-block form produced by `AblationSystem.element_jacobians` /
`seb_face_jacobians` and the solve runs entirely on the accelerator:

- **symmetric diagonal equilibration**: the raw (T, p) system spans ~9
  orders of magnitude (measured diag range 1..364 for T rows vs 8e-7..1
  for p rows on the case-1 strip), which stalls any Krylov method in the
  unscaled norm.  The system is rescaled once per Jacobian rebuild as
  S J S y = S b, x = S y with S = diag(1/sqrt(|diag J|));
- **2x2 point-block preconditioning**: the (T_i, p_i) diagonal coupling
  pair of every dof is inverted in closed form — on the case-1 system
  this cuts GMRES(400) from 2 cycles to 1 vs no PC.  (An element-block
  additive-Schwarz PC was evaluated and *rejected*: it stalls GMRES on
  this nonsymmetric system — measured relerr 0.97 after 1000 its vs
  convergence without it.)
- the operator apply is a batched (ne, 2nd, 2nd) @ (ne, 2nd) matmul plus
  a segment-sum scatter (dense batched work, no sparse formats);
- the outer solve is the jittable restarted GMRES from
  ``cmfem_tpu.solvers.krylov``.

This is the SURVEY.md §7.3 "direct-solver replacement" path ("needs block
preconditioning and/or dimensionless scaling of the p block" — it needs
both).  The host sparse-LU route remains the default for bit-parity with
the reference; select this path with ``linear_solver: gmres`` in the
driver YAML.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .krylov import SolveResult, gmres


def strip_dof_lattice(positions, tol_factor=1e-8):
    """Recover an (NY, NX) dof lattice from scalar-dof positions of a
    tensor-product strip mesh (the reference's transfinite ablation
    strips, Mesh/ablation_strip.geo).  Columns are tolerance-clustered on
    x (GMSH emits float jitter); each column must hold the same number of
    dofs, sorted by y.  Raises ValueError when the dofs are not a
    tensor-product lattice."""
    from ..ops.lattice2d import cluster_x_columns

    pos = np.asarray(positions)
    if pos.ndim != 2 or pos.shape[1] < 2:
        raise ValueError("strip_dof_lattice needs (n, >=2) positions")
    xy = pos[:, :2]
    n = len(xy)
    col_of, nx = cluster_x_columns(xy[:, 0], tol_factor)
    if n % nx:
        raise ValueError("dofs do not tile an x-column lattice")
    ny = n // nx
    lat = np.full((ny, nx), -1, dtype=np.int64)
    for c in range(nx):
        ids = np.nonzero(col_of == c)[0]
        if len(ids) != ny:
            raise ValueError("unequal column heights in dof lattice")
        lat[:, c] = ids[np.argsort(xy[ids, 1], kind="stable")]
    return lat


def equilibrated_block_factors(Je, lmask, mask2, gather, scatter, nd, n,
                               reduce_fn=lambda x: x):
    """BC-eliminate and equilibrate (2nd, 2nd) element blocks; build the
    2x2 point-block preconditioner.  The single source of truth for both
    the single-device solver and the element-sharded multichip path
    (which passes slab-local gather/scatter plus a psum ``reduce_fn``).

    Returns (Je_s, pb, s): scaled blocks (the matvec), the per-dof inverse
    2x2 coupling factors (the preconditioner), and the equilibration
    vector s (2n,)."""
    dtype = Je.dtype
    lm = lmask.astype(dtype)                    # (nel, 2nd)
    keep = 1.0 - lm
    eye = jnp.eye(2 * nd, dtype=dtype)
    Je_bc = Je * keep[:, :, None] * keep[:, None, :] \
        + eye[None] * lm[:, :, None]
    # global diagonal -> symmetric equilibration S J S
    tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)
    diag_e = jnp.diagonal(Je_bc, axis1=1, axis2=2)
    dvec = reduce_fn(scatter(diag_e))
    s = jnp.where(mask2, 1.0,
                  1.0 / jnp.sqrt(jnp.maximum(jnp.abs(dvec), tiny)))
    s_e = gather(s)
    Je_s = Je_bc * s_e[:, :, None] * s_e[:, None, :]
    # 2x2 point-block PC: per-dof scaled [[dTT, dTp], [dpT, dpp]]
    # (off-diagonal pairs gathered from the (i_T, i_p) block entries)
    idx = jnp.arange(nd)
    dTp_e = Je_s[:, idx, nd + idx]              # (nel, nd)
    dpT_e = Je_s[:, nd + idx, idx]
    dJ = reduce_fn(scatter(jnp.diagonal(Je_s, axis1=1, axis2=2)))
    half = jnp.zeros((dTp_e.shape[0], nd), dtype)
    seg_T = lambda v: reduce_fn(
        scatter(jnp.concatenate([v, half], axis=1)))[:n]
    dTT = jnp.where(mask2[:n], 1.0, dJ[:n])
    dpp = jnp.where(mask2[n:], 1.0, dJ[n:])
    off_mask = mask2[:n] | mask2[n:]
    dTp = jnp.where(off_mask, 0.0, seg_T(dTp_e))
    dpT = jnp.where(off_mask, 0.0, seg_T(dpT_e))
    det = dTT * dpp - dTp * dpT
    det = jnp.where(jnp.abs(det) > tiny, det, 1.0)
    pb = jnp.stack([dpp / det, -dTp / det, -dpT / det, dTT / det])
    return Je_s, pb, s


def solve_equilibrated(matvec, pb, s, b, mask2, n, rtol, atol,
                       restart, maxiter):
    """GMRES on the equilibrated system with the 2x2 point-block PC;
    ``matvec`` applies the scaled blocks (without the essential-identity
    rows, which are pinned here).  Returns a SolveResult with x unscaled."""

    def apply_A(y):
        return jnp.where(mask2, y, matvec(y))

    def M(r):
        rT, rp = r[:n], r[n:]
        return jnp.concatenate([pb[0] * rT + pb[1] * rp,
                                pb[2] * rT + pb[3] * rp])

    res = gmres(apply_A, s * b, M=M, rtol=rtol, atol=atol,
                restart=restart, maxiter=maxiter)
    return res._replace(x=s * res.x)


class BlockNewtonKrylov:
    """Iterative solver for BC-eliminated block systems J dx = b.

    The global system is the 2n x 2n two-field Jacobian with essential
    rows/columns replaced by identity (FormLinearSystem semantics — the
    same elimination the host LU path applies with d @ J @ d + I_ess).

    Parameters
    ----------
    element_dofs : (ne, nd) int array — scalar-space element DOF map.
    n            : scalar-space true-dof count (system size is 2n).
    ess_T, ess_p : essential-DOF index arrays for the T and p fields.
    restart, maxiter : GMRES(m) restart length and outer-cycle cap.
    """

    def __init__(self, element_dofs, n, ess_T, ess_p,
                 restart: int = 400, maxiter: int = 10, dof_lattice=None,
                 pc: str = "pointblock"):
        ed = np.asarray(element_dofs, dtype=np.int64)
        self.ne, self.nd = ed.shape
        self.n = int(n)
        self.eldofs = jnp.asarray(ed)
        mask = np.zeros(2 * self.n, dtype=bool)
        mask[np.asarray(ess_T, dtype=np.int64)] = True
        mask[np.asarray(ess_p, dtype=np.int64) + self.n] = True
        self.mask2 = jnp.asarray(mask)
        # local essential masks over the stacked [T_e; p_e] element vector
        lT = mask[:self.n][ed]                      # (ne, nd)
        lp = mask[self.n:][ed]
        self.lmask = jnp.asarray(np.concatenate([lT, lp], axis=1))
        self.restart = int(restart)
        self.maxiter = int(maxiter)
        self._init_lattice(ed, mask, dof_lattice)
        self.pc = pc
        self.mg = None
        if pc == "linemg":
            # h-robust x-semicoarsened MG with exact y-line smoothing
            # (solvers/linemg.py) — replaces the point-block PC whose
            # iterations grow ~2.7x per refinement.  Lattice-only.
            if self.lattice is None:
                raise ValueError("pc='linemg' requires a dof lattice")
            from .linemg import StripLineMG

            self.mg = StripLineMG(self.lattice["NY"], self.lattice["NX"],
                                  self.lattice["offs"])
        elif pc != "pointblock":
            raise ValueError(f"unknown pc {pc!r}")
        self._prepare = jax.jit(self._prepare_impl)
        self._prepare_face = jax.jit(self._prepare_impl_face)
        self._solve = jax.jit(self._solve_impl)

    def _init_lattice(self, ed, mask, dof_lattice):
        """Precompute the stencil-assembly map for lattice (DIA) mode.

        On a tensor-product dof lattice the assembled Jacobian is a small
        stencil of 2x2 field blocks per dof (9-point at order 1, 25-point
        at order 2, ...), so the GMRES matvec becomes shifted-window
        multiplies over the (NY, NX) grid — no per-iteration gather or
        segment_sum.  The assembly scatter runs once per
        Jacobian rebuild inside ``prepare``.
        """
        self.lattice = None
        self.wlat = None
        if dof_lattice is None:
            return
        lat = np.asarray(dof_lattice, dtype=np.int64)
        NY, NX = lat.shape
        if NY * NX != self.n:
            raise ValueError("dof_lattice must enumerate every scalar dof")
        latflat = lat.reshape(-1)                   # lattice pos -> dof
        perm = np.empty(self.n, np.int64)
        perm[latflat] = np.arange(self.n)           # dof -> lattice pos
        ly, lx = perm // NX, perm % NX
        # offset of entry (e, a, b): coord(col dof) - coord(row dof)
        oy = ly[ed][:, None, :] - ly[ed][:, :, None]   # (ne, nd, nd)
        ox = lx[ed][:, None, :] - lx[ed][:, :, None]
        # bijective key for |ox| <= NX; decode with the +NX bias so
        # negative x-offsets round to the correct row
        off_keys = oy * (2 * NX + 1) + ox
        uniq, off_idx = np.unique(off_keys.ravel(), return_inverse=True)
        qy = (uniq + NX) // (2 * NX + 1)
        offs = np.stack([qy, uniq - qy * (2 * NX + 1)], axis=1)
        KO = len(uniq)
        pad = int(max(np.abs(offs).max(), 1))
        row_pos = (ly[ed][:, :, None] * NX
                   + lx[ed][:, :, None]) * np.ones((1, 1, self.nd),
                                                   dtype=np.int64)
        stencil_idx = off_idx.reshape(ed.shape[0], self.nd, self.nd) \
            * (NY * NX) + row_pos
        # windowed-assembly plan: when every element shares one lattice
        # dof stencil AND elements are row-major over the cell lattice
        # (make_cartesian_mesh_2d; GMSH strips after the lattice_residual
        # renumbering), the per-rebuild stencil assembly becomes nd^2
        # shifted overlap-adds instead of a (4*ne*nd^2)-entry
        # segment_sum.
        kab = None
        offab = off_idx.reshape(ed.shape[0], self.nd, self.nd)
        if (offab == offab[0]).all():
            from ..ops.lattice2d import StripLatticeOps

            try:
                self.wlat = StripLatticeOps(ed, self.n, lat)
                kab = offab[0].tolist()    # offset slot of entry (a, b)
            except ValueError:
                pass
        self.lattice = {
            "kab": kab,
            "NY": NY, "NX": NX, "KO": KO, "pad": pad,
            "offs": [(int(a), int(b)) for a, b in offs],
            "idx": jnp.asarray(stencil_idx.reshape(-1)),
            "latflat2": jnp.asarray(
                np.concatenate([latflat, latflat + self.n])),
            "dofperm2": jnp.asarray(
                np.concatenate([perm, perm + self.n])),
            "latflat": jnp.asarray(latflat),
            "mask2_lat": jnp.asarray(
                np.concatenate([mask[:self.n][latflat],
                                mask[self.n:][latflat]])),
        }

    # -- Jacobian preparation (once per Newton rebuild) ---------------------

    def _prepare_core(self, Je):
        """Shared BC-elimination/equilibration/PC build (see
        ``equilibrated_block_factors``); in lattice mode additionally
        assembles the scaled blocks into the (4, KO, NY, NX) stencil and
        permutes the PC/scaling vectors into lattice layout."""
        Je_s, pb, s = equilibrated_block_factors(
            Je, self.lmask, self.mask2, self._gather, self._scatter,
            self.nd, self.n)
        if self.lattice is None:
            return Je_s, pb, s
        L = self.lattice
        nd = self.nd
        blocks = jnp.stack([Je_s[:, :nd, :nd], Je_s[:, :nd, nd:],
                            Je_s[:, nd:, :nd], Je_s[:, nd:, nd:]])
        if self.wlat is not None:
            # nd^2 shifted overlap-adds (row dof a of every cell lands at
            # its lattice window; the offset slot k is fixed per (a, b))
            wl, kab = self.wlat, L["kab"]
            NY, NX = L["NY"], L["NX"]
            Sk = [jnp.zeros((4, NY, NX), Je_s.dtype)
                  for _ in range(L["KO"])]
            bc = blocks.reshape(4, wl.nyc, wl.nxc, nd, nd)
            for a in range(nd):
                for b in range(nd):
                    k = kab[a][b]
                    Sk[k] = wl.add_window(Sk[k], bc[:, :, :, a, b], a)
            S = jnp.stack(Sk, axis=1)       # (4, KO, NY, NX)
        else:
            ngrid = L["KO"] * L["NY"] * L["NX"]
            idx4 = (L["idx"][None] + (jnp.arange(4) * ngrid)[:, None])
            S = jax.ops.segment_sum(blocks.reshape(-1), idx4.reshape(-1),
                                    num_segments=4 * ngrid)
            S = S.reshape(4, L["KO"], L["NY"], L["NX"])
        if self.mg is not None:
            # the line-MG hierarchy replaces the point-block factors
            return S, self.mg.setup(S, L["mask2_lat"], self.n), \
                s[L["latflat2"]]
        pb_lat = pb[:, L["latflat"]]
        s_lat = s[L["latflat2"]]
        return S, pb_lat, s_lat

    def _assemble_element_blocks(self, JTT, JTp, JpT, Jpp):
        top = jnp.concatenate([JTT, JTp], axis=2)
        bot = jnp.concatenate([JpT, Jpp], axis=2)
        return jnp.concatenate([top, bot], axis=1)      # (ne, 2nd, 2nd)

    def _prepare_impl(self, JTT, JTp, JpT, Jpp):
        return self._prepare_core(
            self._assemble_element_blocks(JTT, JTp, JpT, Jpp))

    def _prepare_impl_face(self, JTT, JTp, JpT, Jpp, FJT, FJp, face_elem):
        Je = self._assemble_element_blocks(JTT, JTp, JpT, Jpp)
        Fe = jnp.concatenate([FJT, FJp], axis=2)        # (nbf, nd, 2nd)
        Je = Je.at[face_elem, :self.nd, :].add(Fe)
        return self._prepare_core(Je)

    def prepare(self, blocks, face=None, face_elem=None):
        """Build device factors from element (and optional SEB face) blocks.

        blocks    : (JTT, JTp, JpT, Jpp), each (ne, nd, nd).
        face      : optional (FJT, FJp), each (nbf, nd, nd) — boundary-face
                    contributions to the T rows (seb_face_jacobians).
        face_elem : (nbf,) adjacent-element ids for the face blocks.
        """
        if face is None:
            return self._prepare(*blocks)
        return self._prepare_face(*blocks, *face,
                                  jnp.asarray(np.asarray(face_elem,
                                                         dtype=np.int64)))

    # -- jitted apply / preconditioner / solve ------------------------------

    def _gather(self, x):
        if self.wlat is not None:
            # one n-gather per field + static window stacks in place of
            # a per-element gather
            return jnp.concatenate(
                [self.wlat.gather_elem(self.wlat.to_lat(x[:self.n])),
                 self.wlat.gather_elem(self.wlat.to_lat(x[self.n:]))],
                axis=1)
        xT = x[:self.n][self.eldofs]
        xp = x[self.n:][self.eldofs]
        return jnp.concatenate([xT, xp], axis=1)        # (ne, 2nd)

    def _scatter(self, y_e):
        if self.wlat is not None:
            return jnp.concatenate([self.wlat.scatter(y_e[:, :self.nd]),
                                    self.wlat.scatter(y_e[:, self.nd:])])
        flat = self.eldofs.reshape(-1)
        yT = jax.ops.segment_sum(y_e[:, :self.nd].reshape(-1), flat,
                                 num_segments=self.n)
        yp = jax.ops.segment_sum(y_e[:, self.nd:].reshape(-1), flat,
                                 num_segments=self.n)
        return jnp.concatenate([yT, yp])

    def _solve_impl(self, Je_s, pb, s, b, rtol, atol):
        if self.lattice is not None:
            return self._solve_impl_lattice(Je_s, pb, s, b, rtol, atol)

        def matvec(y):
            return self._scatter(jnp.einsum("eij,ej->ei", Je_s,
                                            self._gather(y)))

        return solve_equilibrated(matvec, pb, s, b, self.mask2, self.n,
                                  rtol, atol, self.restart, self.maxiter)

    def _solve_impl_lattice(self, S, pb, s, b, rtol, atol):
        """Stencil (DIA) matvec: y[f] = sum_g sum_off S[f,g,off] *
        shift(x[g], off) as padded shifted-window multiplies — no gather
        or scatter per GMRES iteration.  ``pb`` is the point-block
        factors, or the line-MG level hierarchy when pc='linemg'."""
        L = self.lattice
        NY, NX, pad = L["NY"], L["NX"], L["pad"]
        n = self.n

        def matvec(y):
            xT = y[:n].reshape(NY, NX)
            xp = y[n:].reshape(NY, NX)
            pads = ((pad, pad), (pad, pad))
            xTp = jnp.pad(xT, pads)
            xpp = jnp.pad(xp, pads)
            yT = jnp.zeros((NY, NX), y.dtype)
            yp = jnp.zeros((NY, NX), y.dtype)
            for k, (oy, ox) in enumerate(L["offs"]):
                wT = xTp[pad + oy:pad + oy + NY, pad + ox:pad + ox + NX]
                wp = xpp[pad + oy:pad + oy + NY, pad + ox:pad + ox + NX]
                yT = yT + S[0, k] * wT + S[1, k] * wp
                yp = yp + S[2, k] * wT + S[3, k] * wp
            return jnp.concatenate([yT.reshape(-1), yp.reshape(-1)])

        bl = b[L["latflat2"]]
        if self.mg is not None:
            def apply_A(y):
                return jnp.where(L["mask2_lat"], y, matvec(y))

            res = gmres(apply_A, s * bl,
                        M=lambda r: self.mg.apply(pb, r,
                                                  mask=L["mask2_lat"]),
                        rtol=rtol, atol=atol, restart=self.restart,
                        maxiter=self.maxiter)
            res = res._replace(x=s * res.x)
        else:
            res = solve_equilibrated(matvec, pb, s, bl, L["mask2_lat"],
                                     n, rtol, atol, self.restart,
                                     self.maxiter)
        return res._replace(x=res.x[L["dofperm2"]])

    def solve(self, factors, b, rtol=1e-10, atol=0.0):
        """Solve J dx = b to the given preconditioned-residual tolerance
        (measured on the equilibrated system).

        Returns the krylov ``SolveResult`` (x, iters=restart cycles,
        final residual, converged flag)."""
        Je_s, pb, s = factors
        return self._solve(Je_s, pb, s, jnp.asarray(b),
                           jnp.asarray(rtol, dtype=jnp.result_type(b)),
                           jnp.asarray(atol, dtype=jnp.result_type(b)))


class BlockTridiagDirect(BlockNewtonKrylov):
    """Exact block-tridiagonal direct solver for strip dof lattices —
    the analog of the reference's MUMPS LU
    (Input/petsc_ablation*.opts: -ksp_type preonly -pc_type lu).

    On an (NY, NX) dof lattice whose assembled stencil couples adjacent
    y-levels only (order-1 strips: 9-point stencil), the equilibrated
    two-field Jacobian is block-tridiagonal with dense (2 NX, 2 NX)
    level blocks.  Factorization (block Thomas) and the two sweeps are
    ``lax.scan``s over NY levels of small matmuls: no Krylov iteration,
    no restart-length Arnoldi program (whose XLA compile alone is
    minutes inside a scanned Newton), and no working-precision residual
    floor beyond one iterative-refinement pass.  Newton gets true
    Newton directions, matching the reference's direct-solve
    convergence behavior.

    Same ``prepare``/``solve``/``_prepare``/``_solve`` surface as
    ``BlockNewtonKrylov`` so the scan-path Newton loops are
    solver-agnostic.
    """

    def __init__(self, element_dofs, n, ess_T, ess_p, dof_lattice,
                 restart: int = 16, maxiter: int = 6):
        super().__init__(element_dofs, n, ess_T, ess_p, restart=restart,
                         maxiter=maxiter, dof_lattice=dof_lattice)
        if self.lattice is None:
            raise ValueError("BlockTridiagDirect requires a dof lattice")
        if max(abs(oy) for oy, _ in self.lattice["offs"]) > 1:
            raise ValueError(
                "stencil couples beyond adjacent y-levels (order > 1); "
                "use the GMRES path")

    # -- preparation: stencil -> level blocks -> block-Thomas factors ----

    def _level_blocks(self, S):
        """Scatter the (4, KO, NY, NX) DIA stencil into dense per-level
        blocks A (diag), B (couples y-1), C (couples y+1), each
        (NY, 2NX, 2NX), with essential rows replaced by identity
        (the stencil's mask rows carry summed per-element identity
        entries; the GMRES path overrides them in the matvec instead)."""
        L = self.lattice
        NY, NX = L["NY"], L["NX"]
        m = 2 * NX
        dt = S.dtype
        A = jnp.zeros((NY, m, m), dt)
        B = jnp.zeros((NY, m, m), dt)
        C = jnp.zeros((NY, m, m), dt)
        for k, (oy, ox) in enumerate(L["offs"]):
            lo, hi = max(0, -ox), NX - max(0, ox)
            if hi <= lo:
                continue
            rows = np.arange(lo, hi)
            cols = rows + ox
            for fg, (f, g) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
                vals = S[fg, k][:, lo:hi]
                if oy == 0:
                    A = A.at[:, f * NX + rows, g * NX + cols].add(vals)
                elif oy == -1:
                    B = B.at[:, f * NX + rows, g * NX + cols].add(vals)
                else:
                    C = C.at[:, f * NX + rows, g * NX + cols].add(vals)
        n = self.n
        mT = L["mask2_lat"][:n].reshape(NY, NX)
        mp = L["mask2_lat"][n:].reshape(NY, NX)
        mrow = jnp.concatenate([mT, mp], axis=1).astype(dt)   # (NY, m)
        keep = (1.0 - mrow)[:, :, None]
        eye = jnp.eye(m, dtype=dt)
        A = A * keep + eye[None] * mrow[:, :, None]
        B = B * keep
        C = C * keep
        return A, B, C

    def _prepare_core(self, Je):
        """Block-QR elimination down the levels (the stable banded
        factorization: orthogonal transforms bound the growth factor,
        where block Thomas measured ~1e6 growth on the graded case-1
        strip and turned f32 solves into noise).  Fill-in makes the
        upper factor block-PENTAdiagonal: row y carries (R_y upper
        triangular, C1_y, E_y) coupling x_{y+1} and x_{y+2}; the level
        Q factors are kept to transform the rhs at solve time."""
        S, pb, s = super()._prepare_core(Je)
        A, B, C = self._level_blocks(S)
        m = A.shape[1]
        dt = A.dtype
        zm = jnp.zeros((m, m), dt)

        def qstep(carry, abc):
            Dc, Cc = carry                      # current top row (E = 0)
            By, Ay, Cy = abc                    # incoming row y+1
            M = jnp.concatenate([Dc, By], axis=0)          # (2m, m)
            Q, R = jnp.linalg.qr(M, mode="complete")       # Q (2m, 2m)
            right = Q.T @ jnp.concatenate(
                [jnp.concatenate([Cc, zm], axis=1),
                 jnp.concatenate([Ay, Cy], axis=1)], axis=0)   # (2m, 2m)
            out = (R[:m], right[:m, :m], right[:m, m:], Q)
            return (right[m:, :m], right[m:, m:]), out

        (Dl, _), (R, C1, E, Q) = jax.lax.scan(
            qstep, (A[0], C[0]), (B[1:], A[1:], C[1:]))
        # final level: QR of the remaining (m, m) block
        Qf, Rf = jnp.linalg.qr(Dl, mode="complete")
        return S, (R, C1, E, Q, Qf, Rf), s

    # -- solve: rhs transform + block back-substitution + refinement -----

    def _banded_solve(self, fac, blev):
        R, C1, E, Q, Qf, Rf = fac
        m = blev.shape[1]
        dt = blev.dtype

        def fwd(zc, inp):
            Qy, b_next = inp
            zz = Qy.T @ jnp.concatenate([zc, b_next])
            return zz[m:], zz[:m]

        zl, Z = jax.lax.scan(fwd, blev[0], (Q, blev[1:]))
        zl = Qf.T @ zl

        def bwd(carry, inp):
            x1, x2 = carry                      # x_{y+1}, x_{y+2}
            Ry, C1y, Ey, zy = inp
            x = jax.scipy.linalg.solve_triangular(
                Ry, zy - C1y @ x1 - Ey @ x2, lower=False)
            return (x, x1), x

        xl = jax.scipy.linalg.solve_triangular(Rf, zl, lower=False)
        (x0, _), X = jax.lax.scan(bwd, (xl, jnp.zeros(m, dt)),
                                  (R, C1, E, Z), reverse=True)
        return jnp.concatenate([X, xl[None]], axis=0)

    def _dia_matvec(self, S, y):
        """Equilibrated stencil matvec in lattice order (mask rows pass
        through as identity, matching the assembled identity rows)."""
        L = self.lattice
        NY, NX, pad = L["NY"], L["NX"], L["pad"]
        n = self.n
        xT = y[:n].reshape(NY, NX)
        xp = y[n:].reshape(NY, NX)
        pads = ((pad, pad), (pad, pad))
        xTp = jnp.pad(xT, pads)
        xpp = jnp.pad(xp, pads)
        yT = jnp.zeros((NY, NX), y.dtype)
        yp = jnp.zeros((NY, NX), y.dtype)
        for k, (oy, ox) in enumerate(L["offs"]):
            wT = xTp[pad + oy:pad + oy + NY, pad + ox:pad + ox + NX]
            wp = xpp[pad + oy:pad + oy + NY, pad + ox:pad + ox + NX]
            yT = yT + S[0, k] * wT + S[1, k] * wp
            yp = yp + S[2, k] * wT + S[3, k] * wp
        out = jnp.concatenate([yT.reshape(-1), yp.reshape(-1)])
        return jnp.where(L["mask2_lat"], y, out)

    def _to_levels(self, v):
        L = self.lattice
        NY, NX = L["NY"], L["NX"]
        return jnp.concatenate([v[:self.n].reshape(NY, NX),
                                v[self.n:].reshape(NY, NX)], axis=1)

    def _from_levels(self, X):
        NX = self.lattice["NX"]
        return jnp.concatenate([X[:, :NX].reshape(-1),
                                X[:, NX:].reshape(-1)])

    def _solve_impl(self, S, fac, s, b, rtol, atol):
        """GMRES with the banded-QR solve as (near-exact) left
        preconditioner.  A pure direct solve is NOT enough here: the
        equilibrated ablation Jacobian measures cond ~1e15, so any f32
        factorization — even the backward-stable QR — leaves O(1)
        relative residual (measured 0.17 at the real step-1 state).
        GMRES *minimizes* the preconditioned residual over the Krylov
        space, which is what Newton needs, and with M ~= A^-1 it gets
        there in a few iterations instead of the point-block PC's
        hundreds (f64: 1 iteration, direct-grade)."""
        L = self.lattice
        bl = jnp.asarray(b)[L["latflat2"]]

        def M(r):
            return self._from_levels(self._banded_solve(
                fac, self._to_levels(r)))

        res = gmres(lambda y: self._dia_matvec(S, y), s * bl, M=M,
                    rtol=rtol, atol=atol, restart=self.restart,
                    maxiter=self.maxiter)
        return res._replace(x=(s * res.x)[L["dofperm2"]])

    def solve(self, factors, b, rtol=1e-10, atol=0.0):
        S, fac, s = factors
        return self._solve(S, fac, s, jnp.asarray(b),
                           jnp.asarray(rtol, dtype=jnp.result_type(b)),
                           jnp.asarray(atol, dtype=jnp.result_type(b)))


def make_scan_block_solver(cfg, element_dofs, n, ess_T, ess_p,
                           node_positions):
    """Device linear solver for the scan-path Newton loops: the
    block-tridiagonal direct solver when the mesh qualifies (order-1
    strip dof lattice; ``lattice_direct: false`` opts out), else
    equilibrated block GMRES (``gmres_lattice: true`` uses the DIA
    matvec when a lattice exists)."""
    lat = None
    if bool(cfg.get("gmres_lattice", True)):
        try:
            lat = strip_dof_lattice(node_positions)
        except ValueError:
            lat = None
    if lat is not None and bool(cfg.get("lattice_direct", True)):
        try:
            return BlockTridiagDirect(element_dofs, n, ess_T, ess_p,
                                      dof_lattice=lat)
        except ValueError:
            pass
    return BlockNewtonKrylov(
        element_dofs, n, ess_T, ess_p,
        restart=int(cfg.get("gmres_restart", 400)),
        maxiter=int(cfg.get("gmres_maxiter", 10)),
        dof_lattice=lat)
