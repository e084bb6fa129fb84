"""Geometric multigrid for the structured sum-factorized operators.

The replacement for the reference's algebraic-multigrid /
ILU-type PETSc preconditioner configurations (Input/petsc*.opts): on
tensor-product lattices every multigrid ingredient is a 1D-matrix axis
contraction —

- hierarchy: p-coarsening (order p -> 1 on the same mesh) followed by
  h-coarsening (mesh halving at order 1), every level a
  ``SumFactoredOperator`` (zero gather/scatter);
- transfer: prolongation = linear interpolation of the coarse nodal
  lattice onto the fine lattice, applied as three axis-wise matmuls
  (restriction is the transposed chain);
- smoother: Jacobi-scaled Chebyshev (matmul-only; no triangular solves);
- coarsest level: a high-degree Chebyshev sweep.

Everything is jittable and follows the repo's ``bind()`` convention: big
arrays travel as jit arguments, never as closure captures.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core import FESpace, make_cartesian_mesh_3d
from ..ops.assembly import SpaceOps
from ..ops.partial import StructuredGrid3D
from ..ops.sumfact import SumFactoredOperator
from .precond import chebyshev_smooth, power_iteration_lmax

HI = jax.lax.Precision.HIGHEST


def _interp_1d(xc: np.ndarray, xf: np.ndarray) -> np.ndarray:
    """(nf, nc) linear-interpolation matrix from coarse nodes xc to fine
    nodes xf (both ascending, same endpoints)."""
    nf, nc = len(xf), len(xc)
    P = np.zeros((nf, nc))
    j = np.clip(np.searchsorted(xc, xf, side="right") - 1, 0, nc - 2)
    t = (xf - xc[j]) / (xc[j + 1] - xc[j])
    P[np.arange(nf), j] = 1.0 - t
    P[np.arange(nf), j + 1] += t
    return P


def _lattice_diag(fes: FESpace, form, data, grid: StructuredGrid3D):
    """Operator diagonal permuted from entity numbering to the lattice."""
    out = np.zeros(grid.ndofs)
    out[grid.lattice_index(fes.node_positions)] = np.asarray(
        form.assemble_diagonal(data))
    return out


class GeometricMG:
    """Geometric interpolation multigrid for UNSTRUCTURED meshes — the
    production-PC analog of the reference's PETSc AMG option files for
    the 2D drivers (Input/petsc*.opts).  The hierarchy is p-coarsening
    (order -> 1 on the solve mesh) followed by the driver's own
    refinement chain (refined mesh -> loaded mesh); transfer operators
    are exact H1 interpolation stencils of each coarse space at the next
    finer space's node positions (``h1_sampling_stencil``), so nested
    refinement gives the standard P / P^T pair without any parent
    bookkeeping.  Smoothing is Jacobi-scaled Chebyshev (matmul-only).

    Levels are (FESpace, SpaceOps, BilinearForm data) fine -> coarse;
    every big array travels as a jit argument via ``bind()``.
    """

    def __init__(self, levels, smooth_degree: int = 3,
                 coarse_degree: int = 24):
        self.levels = levels
        self.smooth_degree = smooth_degree
        self.coarse_degree = coarse_degree

    @staticmethod
    def build(specs, make_form, quad_order=None, ess_dofs=None):
        """specs: list of (mesh, order) fine -> coarse (nested domains —
        every finer level's nodes must lie inside the coarser mesh).
        ``make_form(ops) -> BilinearForm`` defines the SPD PDE on every
        level.  ``ess_dofs(fes) -> index array`` selects each level's
        essential dofs (default: the full boundary).  The PC's pinned
        set must match the SYSTEM's essential dofs — a PC that pins
        dofs the system leaves free (e.g. full boundary vs x-only
        Dirichlet in the 3-Peclet driver) acts as identity there and
        can stall GMRES into a silently wrong iterate."""
        from ..core.fespace import FESpace as _FESpace
        from ..core.pointlocate import h1_sampling_stencil

        levels = []
        prev_fes = None
        for (mesh_l, order_l) in specs:
            fes = _FESpace(mesh_l, order_l)
            ops = SpaceOps(fes, quad_order=quad_order or max(2, 2 * order_l))
            form = make_form(ops)
            data = form.assemble()
            mask = np.zeros(fes.nscalar, bool)
            ess_l = (fes.boundary_dofs() if ess_dofs is None
                     else ess_dofs(fes))
            mask[np.asarray(ess_l)] = True
            diag = np.asarray(form.assemble_diagonal(data))
            diag = np.where(mask, 1.0, diag)
            lvl = {
                "form": form,
                "data": data,
                "n": fes.nscalar,
                "diag": jnp.asarray(diag),
                "mask": jnp.asarray(mask),
            }
            if prev_fes is not None:
                # interpolation of THIS (coarse) space at the previous
                # (fine) level's nodes: u_f = P u_c
                pd, pw = h1_sampling_stencil(fes,
                                             np.asarray(
                                                 prev_fes.node_positions))
                if not np.isfinite(pw).all():
                    raise ValueError(
                        "GeometricMG: fine nodes fall outside the coarse "
                        "mesh (non-nested hierarchy)")
                levels[-1]["Pd"] = jnp.asarray(pd)
                levels[-1]["Pw"] = jnp.asarray(pw)
            levels.append(lvl)
            prev_fes = fes

        # Chebyshev eigenvalue estimates of the Jacobi-scaled constrained
        # operators
        for lvl in levels:
            form, data = lvl["form"], lvl["data"]
            mask = lvl["mask"]
            dinv = 1.0 / lvl["diag"]

            def Aop(v, form=form, data=data, mask=mask, dinv=dinv):
                av = form.apply(data, jnp.where(mask, 0.0, v))
                return dinv * jnp.where(mask, v, av)

            lvl["lmax"] = float(power_iteration_lmax(
                jax.jit(Aop), lvl["n"], iters=20,
                dtype=lvl["diag"].dtype)) * 1.05
        return GeometricMG(levels)

    def bind(self):
        """(M(r, arrays), arrays): jittable V-cycle preconditioner."""
        nlev = len(self.levels)
        forms = [lvl["form"] for lvl in self.levels]
        meta = [{"lmax": lvl["lmax"], "n": lvl["n"]} for lvl in self.levels]
        arrays = []
        for lvl in self.levels:
            arrays.append((lvl["data"], lvl["diag"], lvl["mask"],
                           lvl.get("Pd", jnp.zeros((0, 1), jnp.int64)),
                           lvl.get("Pw", jnp.zeros((0, 1)))))
        smooth_degree = self.smooth_degree
        coarse_degree = self.coarse_degree

        def apply_level(k, v, arrs):
            data, diag, mask, _, _ = arrs[k]
            av = forms[k].apply(data, jnp.where(mask, 0.0, v))
            return jnp.where(mask, v, av)

        def chebyshev(k, r, arrs, degree):
            _, diag, mask, _, _ = arrs[k]
            dinv = 1.0 / diag

            def Aop(v):
                return dinv * apply_level(k, v, arrs)

            return chebyshev_smooth(Aop, dinv * r, meta[k]["lmax"], degree)

        def restrict(k, r, arrs):
            """fine k -> coarse k+1 via P^T (scatter of the stencil)."""
            _, _, _, Pd, Pw = arrs[k]
            nc = meta[k + 1]["n"]
            rc = jax.ops.segment_sum((Pw * r[:, None]).reshape(-1),
                                     Pd.reshape(-1), num_segments=nc)
            return jnp.where(arrs[k + 1][2], 0.0, rc)

        def prolong(k, e, arrs):
            _, _, _, Pd, Pw = arrs[k]
            ef = jnp.einsum("in,in->i", Pw, e[Pd])
            return jnp.where(arrs[k][2], 0.0, ef)

        def vcycle(k, r, arrs):
            if k == nlev - 1:
                return chebyshev(k, r, arrs, coarse_degree)
            z = chebyshev(k, r, arrs, smooth_degree)
            res = r - apply_level(k, z, arrs)
            ec = vcycle(k + 1, restrict(k, res, arrs), arrs)
            z = z + prolong(k, ec, arrs)
            res = r - apply_level(k, z, arrs)
            z = z + chebyshev(k, res, arrs, smooth_degree)
            return z

        def M(r, arrs):
            return vcycle(0, r, arrs)

        return M, tuple(arrays)


class StructuredMG:
    """V-cycle preconditioner over a list of structured-lattice levels.

    Levels are ordered fine -> coarse.  Each level dict carries:
    ``fn`` (bound sumfact apply), ``D`` (its operator data), ``diag``
    (lattice-numbered diagonal with 1.0 at essential dofs), ``mask``
    (bool essential-dof mask), ``lmax`` (top eigenvalue estimate of the
    Jacobi-scaled constrained operator), and — for every level but the
    coarsest — ``Px/Py/Pz``, the 1D prolongation matrices from the next
    coarser lattice, plus both lattice shapes.
    """

    def __init__(self, levels, smooth_degree: int = 3,
                 coarse_degree: int = 24):
        self.levels = levels
        self.smooth_degree = smooth_degree
        self.coarse_degree = coarse_degree

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(n, order, make_form, dtype=jnp.float32, quad_order=None,
              min_coarse: int = 2, essential_all_boundary: bool = True):
        """Build the level hierarchy for an (n, n, n) cartesian mesh at
        ``order``: p-coarsen to order 1, then h-coarsen while n is even.
        ``make_form(ops) -> BilinearForm`` defines the PDE on every level."""
        specs = [(n, order)]
        pl = order
        while pl > 1:
            pl = max(1, pl // 2)
            specs.append((n, pl))
        nn = n
        while nn % 2 == 0 and nn // 2 >= min_coarse:
            nn //= 2
            specs.append((nn, 1))

        levels = []
        prev = None
        for (nl, pl) in specs:
            mesh = make_cartesian_mesh_3d(nl, nl, nl)
            fes = FESpace(mesh, pl)
            ops = SpaceOps(fes, quad_order=quad_order or max(2, 2 * pl))
            form = make_form(ops)
            data = form.assemble()
            op = SumFactoredOperator(ops, data, nl, nl, nl, pl, dtype=dtype)
            grid = StructuredGrid3D(nl, nl, nl, pl)
            diag = _lattice_diag(fes, form, data, grid)
            mask = grid.boundary_mask() if essential_all_boundary \
                else np.zeros(grid.ndofs, bool)
            diag = np.where(mask, 1.0, diag)
            lvl = {
                "op": op,
                "shape": (op.NZ, op.NY, op.NX),
                "diag": jnp.asarray(diag, dtype),
                "mask": jnp.asarray(mask),
            }
            if prev is not None:
                # 1D nodes of this (coarse) level and the previous (fine)
                from ..core.reference_elements import gauss_lobatto_nodes

                def nodes_1d(nel, p):
                    base = gauss_lobatto_nodes(p)
                    xs = []
                    for e in range(nel):
                        seg = (e + base) / nel
                        xs.extend(seg[:-1] if e < nel - 1 else seg)
                    return np.asarray(xs)

                xf = nodes_1d(prev[0], prev[1])
                xc = nodes_1d(nl, pl)
                P = jnp.asarray(_interp_1d(xc, xf), dtype)
                levels[-1]["P1"] = P  # same in x, y, z (cubic lattice)
            levels.append(lvl)
            prev = (nl, pl)

        # eigenvalue estimates for the Chebyshev smoothers
        for lvl in levels:
            fn, D = lvl["op"].bind()
            mask = lvl["mask"]
            dinv = 1.0 / lvl["diag"]

            def Aop(v, fn=fn, D=D, mask=mask, dinv=dinv):
                av = fn(jnp.where(mask, 0.0, v), D)
                return dinv * jnp.where(mask, v, av)

            lvl["lmax"] = float(power_iteration_lmax(
                jax.jit(Aop), lvl["diag"].shape[0], iters=20,
                dtype=lvl["diag"].dtype)) * 1.05
        return StructuredMG(levels)

    # -- binding ------------------------------------------------------------

    def bind(self):
        """(M(r, arrays), arrays): a jittable V-cycle preconditioner with
        every level's operator data passed as jit arguments."""
        fns = []
        meta = []
        arrays = []
        for k, lvl in enumerate(self.levels):
            # the V-cycle spends ~8 level-0 applies per iteration in the
            # smoothers, so the FINE level takes its faster apply path
            fn, D = (lvl["op"].best_bind() if k == 0 else lvl["op"].bind())
            fns.append(fn)
            arrays.append((D, lvl["diag"], lvl["mask"],
                           lvl.get("P1", jnp.zeros(0))))
            meta.append({"shape": lvl["shape"], "lmax": lvl["lmax"]})
        nlev = len(self.levels)
        smooth_degree = self.smooth_degree
        coarse_degree = self.coarse_degree

        def apply_level(k, v, arrs):
            D, diag, mask, _ = arrs[k]
            av = fns[k](jnp.where(mask, 0.0, v), D)
            return jnp.where(mask, v, av)

        def chebyshev(k, r, arrs, degree):
            """z ~= A_k^{-1} r via Jacobi-scaled Chebyshev, z0 = 0."""
            D, diag, mask, _ = arrs[k]
            dinv = 1.0 / diag

            def Aop(v):
                return dinv * apply_level(k, v, arrs)

            return chebyshev_smooth(Aop, dinv * r, meta[k]["lmax"], degree)

        def restrict(k, r, arrs):
            """fine level k -> coarse level k+1 (P^T along each axis)."""
            P = arrs[k][3]  # (Nf, Nc)
            zf, yf, xf = meta[k]["shape"]
            zc, yc, xc = meta[k + 1]["shape"]
            r3 = r.reshape(zf, yf, xf)
            t = jnp.einsum("fc,zyf->zyc", P, r3, precision=HI)
            t = jnp.einsum("fc,zfx->zcx", P, t, precision=HI)
            t = jnp.einsum("fc,fyx->cyx", P, t, precision=HI)
            rc = t.reshape(-1)
            return jnp.where(arrs[k + 1][2], 0.0, rc)

        def prolong(k, e, arrs):
            """coarse level k+1 -> fine level k."""
            P = arrs[k][3]
            zc, yc, xc = meta[k + 1]["shape"]
            e3 = e.reshape(zc, yc, xc)
            t = jnp.einsum("fc,zyc->zyf", P, e3, precision=HI)
            t = jnp.einsum("fc,zcx->zfx", P, t, precision=HI)
            t = jnp.einsum("fc,cyx->fyx", P, t, precision=HI)
            ef = t.reshape(-1)
            return jnp.where(arrs[k][2], 0.0, ef)

        def vcycle(k, r, arrs):
            if k == nlev - 1:
                return chebyshev(k, r, arrs, coarse_degree)
            z = chebyshev(k, r, arrs, smooth_degree)
            res = r - apply_level(k, z, arrs)
            ec = vcycle(k + 1, restrict(k, res, arrs), arrs)
            z = z + prolong(k, ec, arrs)
            res = r - apply_level(k, z, arrs)
            z = z + chebyshev(k, res, arrs, smooth_degree)
            return z

        def M(r, arrs):
            return vcycle(0, r, arrs)

        return M, tuple(arrays)
