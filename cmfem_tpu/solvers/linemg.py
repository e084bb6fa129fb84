"""h-robust preconditioner for the coupled (T, p) strip Jacobians:
x-semicoarsened multigrid with exact y-line smoothing.

The reference solves every ablation Newton system with a distributed
direct LU (MUMPS, Input/petsc_ablation*.opts), which is refinement-
insensitive by construction.  The point-block GMRES
(solvers/blocksolve.py) measured iteration growth ~2.7x per uniform
refinement (scripts/blocksolve_refinement.py) — the classic
h-dependence of a point preconditioner.  This module supplies the
h-robust replacement for lattice (strip) systems:

- **y-line smoothing**: the ablation strips are tall-and-thin and
  graded toward the heated top (Mesh/ablation_strip.geo), so the
  dominant coupling is vertical.  Each smoothing step solves every
  x-column's block-tridiagonal (2x2 field blocks over NY rows) system
  EXACTLY, batched over columns, via the same orthogonal (QR)
  elimination the banded direct solver uses (growth-factor-bounded —
  plain block Thomas measured ~1e6 element growth on the graded strip
  and is useless in f32).
- **semicoarsening in x**: levels coarsen ONLY the x (column) axis by
  2 with linear interpolation and Galerkin (P^T A P) coarse operators,
  until a single column remains — where the line solve IS the exact
  coarse solve.  Coarsening the line-smoothed direction is never
  needed; this is the textbook robust pairing for grid-aligned
  anisotropy.
- everything operates on the canonical (3, 3, NY, NX, 2, 2) DIA
  stencil (|oy| <= 1, |ox| <= 1 — order-1 quad AND tri strips), so a
  v-cycle is shifted-window multiplies + batched small matmuls: no
  gathers, no segment-sums.

The cycle is a FIXED linear operator (static sweep counts), hence a
valid left preconditioner for the non-flexible GMRES in
``solvers.krylov``.  Used by ``BlockNewtonKrylov(pc="linemg")``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def canonical_stencil(S, offs, NY, NX, mask2_lat, n):
    """(4, KO, NY, NX) DIA stencil -> canonical (3, 3, NY, NX, 2, 2).

    ``SS[oy+1, ox+1, y, x]`` is the 2x2 field block coupling row
    (y, x) to column (y+oy, x+ox).  Essential rows/columns are
    sanitized to exact identity/zero (the assembled stencil carries
    summed per-element identity entries at essential dofs — harmless
    for the matvec, which overrides those rows, but the PC hierarchy
    must see a clean identity).  Raises ValueError beyond the 3x3
    offset footprint (order > 1 strips)."""
    dt = S.dtype
    SS = jnp.zeros((3, 3, NY, NX, 2, 2), dt)
    for k, (oy, ox) in enumerate(offs):
        if abs(oy) > 1 or abs(ox) > 1:
            raise ValueError(
                "line-MG supports 3x3 stencils (order-1 strips) only")
        blk = jnp.stack(
            [jnp.stack([S[0, k], S[1, k]], axis=-1),
             jnp.stack([S[2, k], S[3, k]], axis=-1)], axis=-2)
        SS = SS.at[oy + 1, ox + 1].set(blk)
    # mask (NY, NX, 2): field-f row (y, x) essential
    mrow = jnp.stack([mask2_lat[:n].reshape(NY, NX),
                      mask2_lat[n:].reshape(NY, NX)], axis=-1)
    keep_r = 1.0 - mrow.astype(dt)                      # (NY, NX, 2)
    mpad = jnp.pad(mrow, ((1, 1), (1, 1), (0, 0)))
    SSc = []
    for oy in range(3):
        row = []
        for ox in range(3):
            blk = SS[oy, ox]
            # zero masked rows (axis -2 = row field) and masked columns
            # (axis -1 = col field, shifted mask)
            keep_c = 1.0 - mpad[oy:oy + NY, ox:ox + NX].astype(dt)
            blk = blk * keep_r[..., :, None] * keep_c[..., None, :]
            if oy == 1 and ox == 1:
                eye = jnp.eye(2, dtype=dt)
                blk = blk + eye * mrow.astype(dt)[..., :, None]
            row.append(blk)
        SSc.append(jnp.stack(row))
    return jnp.stack(SSc)


def stencil_matvec(SS, z):
    """Apply the canonical stencil: z (NY, NX, 2) -> (NY, NX, 2)."""
    NY, NX = z.shape[0], z.shape[1]
    zp = jnp.pad(z, ((1, 1), (1, 1), (0, 0)))
    out = jnp.zeros_like(z)
    for oy in range(3):
        for ox in range(3):
            w = zp[oy:oy + NY, ox:ox + NX]
            out = out + jnp.einsum("yxab,yxb->yxa", SS[oy, ox], w)
    return out


def semicoarsen_x(SS):
    """Galerkin (R A P) coarse stencil with P = linear interpolation in
    x only, R = P^T.  Coarse columns sit at even fine columns; the 3x3
    offset footprint is invariant.  Closed-form per-diagonal formulas
    (fine x-diagonals l = ox-1, c = ox 0, r = ox +1):

      diag[J]  = c[2J] + (l[2J] + r[2J-1])/2 + (l[2J+1] + r[2J])/2...
                 = 1/4 c[2J-1] + 1/2 r[2J-1] + 1/2 l[2J] + c[2J]
                   + 1/2 r[2J] + 1/2 l[2J+1] + 1/4 c[2J+1]
      super[J] = 1/2 r[2J] + 1/4 c[2J+1] + 1/2 r[2J+1]
      sub[J]   = 1/2 l[2J] + 1/4 c[2J-1] + 1/2 l[2J-1]

    (out-of-range fine columns contribute zero).  Verified against the
    1D Laplacian: (-1, 2, -1) -> 0.5*(-1, 2, -1), the exact Galerkin
    result for linear interpolation."""
    NX = SS.shape[3]
    NXc = (NX + 1) // 2

    def coarsen_diag(l, c, r):
        # pad x with 1 left / 2 right zeros; fine j lives at padded j+1
        pads = ((0, 0), (1, 2), (0, 0), (0, 0))
        lp, cp, rp = (jnp.pad(a, pads) for a in (l, c, r))
        sl = lambda a, s: a[:, s:s + 2 * NXc:2]
        l_m1, l_0, l_p1 = sl(lp, 0), sl(lp, 1), sl(lp, 2)
        c_m1, c_0, c_p1 = sl(cp, 0), sl(cp, 1), sl(cp, 2)
        r_m1, r_0, r_p1 = sl(rp, 0), sl(rp, 1), sl(rp, 2)
        d = (0.25 * c_m1 + 0.5 * r_m1 + 0.5 * l_0 + c_0 + 0.5 * r_0
             + 0.5 * l_p1 + 0.25 * c_p1)
        up = 0.5 * r_0 + 0.25 * c_p1 + 0.5 * r_p1
        dn = 0.5 * l_0 + 0.25 * c_m1 + 0.5 * l_m1
        return dn, d, up

    rows = []
    for oy in range(3):
        dn, d, up = coarsen_diag(SS[oy, 0], SS[oy, 1], SS[oy, 2])
        rows.append(jnp.stack([dn, d, up]))
    return jnp.stack(rows)


def restrict_x(r):
    """R = P^T: r (NY, NX, 2) -> (NY, NXc, 2)."""
    NX = r.shape[1]
    NXc = (NX + 1) // 2
    rp = jnp.pad(r, ((0, 0), (1, 2), (0, 0)))
    return (rp[:, 1:1 + 2 * NXc:2]
            + 0.5 * (rp[:, 0:2 * NXc:2] + rp[:, 2:2 + 2 * NXc:2]))


def prolong_x(e_c, NX):
    """P: e_c (NY, NXc, 2) -> (NY, NX, 2) by linear interpolation."""
    NY, NXc = e_c.shape[0], e_c.shape[1]
    out = jnp.zeros((NY, NX, e_c.shape[2]), e_c.dtype)
    out = out.at[:, 0::2].set(e_c[:, : (NX + 1) // 2])
    ep = jnp.pad(e_c, ((0, 0), (0, 1), (0, 0)))
    nodd = NX // 2
    out = out.at[:, 1::2].set(
        0.5 * (ep[:, :nodd] + ep[:, 1:nodd + 1]))
    return out


def line_factor(SS):
    """Factor every x-column's block-tridiagonal (2x2 blocks over NY)
    y-line system by orthogonal (QR) elimination, batched over columns.

    The line operator is the ox = 0 slice: A_d = SS[1,1] (diag),
    A_l = SS[0,1] (couples y-1), A_u = SS[2,1] (couples y+1).  Same
    numerically-stable scheme as BlockTridiagDirect (fill makes the
    upper factor block-PENTAdiagonal: R upper-triangular, C1 coupling
    y+1, E coupling y+2; Q per level transforms the rhs at solve
    time), with the column axis as a batch dimension."""
    A_l = SS[0, 1]                              # (NY, NX, 2, 2)
    A_d = SS[1, 1]
    A_u = SS[2, 1]
    NY, NX = A_d.shape[0], A_d.shape[1]
    dt = A_d.dtype
    zm = jnp.zeros((NX, 2, 2), dt)

    def qstep(carry, abc):
        Dc, Cc = carry                          # (NX, 2, 2) each
        By, Ay, Cy = abc
        M = jnp.concatenate([Dc, By], axis=-2)             # (NX, 4, 2)
        Q, R = jnp.linalg.qr(M, mode="complete")           # Q (NX,4,4)
        top = jnp.concatenate([Cc, zm], axis=-1)           # (NX, 2, 4)
        bot = jnp.concatenate([Ay, Cy], axis=-1)
        right = jnp.swapaxes(Q, -1, -2) @ jnp.concatenate(
            [top, bot], axis=-2)                           # (NX, 4, 4)
        out = (R[:, :2], right[:, :2, :2], right[:, :2, 2:], Q)
        return (right[:, 2:, :2], right[:, 2:, 2:]), out

    (Dl, _), (R, C1, E, Q) = jax.lax.scan(
        qstep, (A_d[0], A_u[0]), (A_l[1:], A_d[1:], A_u[1:]))
    Qf, Rf = jnp.linalg.qr(Dl, mode="complete")
    return (R, C1, E, Q, Qf, Rf)


def line_solve(fac, r):
    """Solve the y-line systems for every column: r (NY, NX, 2)."""
    R, C1, E, Q, Qf, Rf = fac
    NY, NX = r.shape[0], r.shape[1]
    dt = r.dtype

    def fwd(zc, inp):
        Qy, b_next = inp
        v = jnp.concatenate([zc, b_next], axis=-1)[..., None]  # (NX,4,1)
        zz = (jnp.swapaxes(Qy, -1, -2) @ v)[..., 0]            # (NX, 4)
        return zz[:, 2:], zz[:, :2]

    zl, Z = jax.lax.scan(fwd, r[0], (Q, r[1:]))
    zl = (jnp.swapaxes(Qf, -1, -2) @ zl[..., None])[..., 0]

    def bwd(carry, inp):
        x1, x2 = carry                                     # (NX, 2)
        Ry, C1y, Ey, zy = inp
        rhs = zy - (C1y @ x1[..., None])[..., 0] \
            - (Ey @ x2[..., None])[..., 0]
        x = jax.scipy.linalg.solve_triangular(Ry, rhs[..., None],
                                              lower=False)[..., 0]
        return (x, x1), x

    xl = jax.scipy.linalg.solve_triangular(Rf, zl[..., None],
                                           lower=False)[..., 0]
    (x0, _), X = jax.lax.scan(bwd, (xl, jnp.zeros((NX, 2), dt)),
                              (R, C1, E, Z), reverse=True)
    return jnp.concatenate([X, xl[None]], axis=0)          # (NY, NX, 2)


class StripLineMG:
    """x-semicoarsened multigrid with exact y-line smoothing, as a
    fixed linear preconditioner for lattice (T, p) systems.

    Parameters
    ----------
    NY, NX : lattice dimensions.
    offs   : DIA stencil offsets (from BlockNewtonKrylov.lattice).
    nu     : damped line-Jacobi sweeps per pre-/post-smooth (default 1).
    omega  : line-Jacobi damping (default 0.8 — smooths the x-coupled
             error the coarse grid cannot represent).
    """

    def __init__(self, NY, NX, offs, nu: int = 1, omega: float = 0.8):
        if max(abs(oy) for oy, _ in offs) > 1 \
                or max(abs(ox) for _, ox in offs) > 1:
            raise ValueError(
                "line-MG supports 3x3 stencils (order-1 strips) only")
        self.NY = int(NY)
        self.offs = list(offs)
        self.nu = int(nu)
        self.omega = float(omega)
        self.nxs = [int(NX)]
        while self.nxs[-1] > 1:
            self.nxs.append((self.nxs[-1] + 1) // 2)

    def setup(self, S, mask2_lat, n):
        """Build the level hierarchy from the equilibrated DIA stencil
        (jittable; runs once per Jacobian rebuild)."""
        SS = canonical_stencil(S, self.offs, self.NY, self.nxs[0],
                               mask2_lat, n)
        arrs = []
        for lvl, NX in enumerate(self.nxs):
            fac = line_factor(SS)
            arrs.append((SS, fac))
            if NX > 1:
                SS = semicoarsen_x(SS)
        return arrs

    # -- v-cycle ---------------------------------------------------------

    def _vcycle(self, arrs, lvl, r):
        SS, fac = arrs[lvl]
        if lvl == len(self.nxs) - 1:
            # single column: the line solve is the exact coarse solve
            return line_solve(fac, r)
        om = self.omega
        z = om * line_solve(fac, r)
        for _ in range(self.nu - 1):
            z = z + om * line_solve(fac, r - stencil_matvec(SS, z))
        rc = restrict_x(r - stencil_matvec(SS, z))
        z = z + prolong_x(self._vcycle(arrs, lvl + 1, rc),
                          self.nxs[lvl])
        for _ in range(self.nu):
            z = z + om * line_solve(fac, r - stencil_matvec(SS, z))
        return z

    def apply(self, arrs, r2n, mask=None):
        """Preconditioner application on the stacked lattice-layout
        vector (2n,) = [T(NY*NX); p(NY*NX)].

        ``mask`` (2n,) bool: essential rows pass through as exact
        identity.  The hierarchy's rows are sanitized to identity, but
        restriction/prolongation mix neighbor values into masked
        positions; clamping the OUTPUT restores the exact decoupling
        the equilibrated matvec relies on, so essential components of
        the GMRES iterate stay exactly at their pinned values."""
        NY, NX = self.NY, self.nxs[0]
        n = NY * NX
        r = jnp.stack([r2n[:n].reshape(NY, NX),
                       r2n[n:].reshape(NY, NX)], axis=-1)
        z = self._vcycle(arrs, 0, r)
        out = jnp.concatenate([z[..., 0].reshape(-1),
                               z[..., 1].reshape(-1)])
        if mask is not None:
            out = jnp.where(mask, r2n, out)
        return out
