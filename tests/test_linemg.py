"""Line-MG preconditioner (solvers/linemg.py): correctness + h-robustness.

The h-robust replacement for the point-block PC on strip lattices
(VERDICT r4 #1): x-semicoarsened multigrid with exact y-line smoothing
inside the equilibrated block GMRES.  The real-Jacobian refinement
evidence comes from scripts/blocksolve_refinement.py; these tests pin correctness
against a dense oracle and iteration growth on PDE-structured systems.
"""

import numpy as np
import pytest


def _dense_from_blocks(eldofs, n, blocks, mask2):
    JTT, JTp, JpT, Jpp = blocks
    A = np.zeros((2 * n, 2 * n))
    for e, dofs in enumerate(np.asarray(eldofs)):
        for a, i in enumerate(dofs):
            for b, j in enumerate(dofs):
                A[i, j] += JTT[e, a, b]
                A[i, n + j] += JTp[e, a, b]
                A[n + i, j] += JpT[e, a, b]
                A[n + i, n + j] += Jpp[e, a, b]
    A[mask2, :] = 0.0
    A[:, mask2] = 0.0
    A[mask2, mask2] = 1.0
    return A


def _pde_blocks(fes, kappa_T=1.0e2, kappa_p=1.0e-6, coup=1.0e-3):
    """(T, p)-shaped element blocks from a real mass+diffusion operator
    (h-structured conditioning, unlike random blocks)."""
    from cmfem_tpu.ops import SpaceOps, BilinearForm

    ops = SpaceOps(fes, quad_order=3)
    diff = BilinearForm(ops).add_diffusion(1.0).add_mass(10.0)
    Ae = np.asarray(diff.element_matrices(diff.assemble()))
    mass = BilinearForm(ops).add_mass(1.0)
    Me = np.asarray(mass.element_matrices(mass.assemble()))
    return (kappa_T * Ae, coup * Me, -0.5 * coup * Me, kappa_p * Ae)


def test_linemg_matches_dense_oracle():
    """pc='linemg' must reproduce the dense BC-eliminated solve."""
    import jax.numpy as jnp

    from cmfem_tpu.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu.solvers import BlockNewtonKrylov
    from cmfem_tpu.solvers.blocksolve import strip_dof_lattice

    mesh = make_cartesian_mesh_2d(5, 7, sx=0.0025, sy=0.05)
    fes = FESpace(mesh, 1)
    n = fes.nscalar
    ed = np.asarray(fes.element_dofs)
    blocks = _pde_blocks(fes)
    ess = np.asarray(fes.boundary_dofs())
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    A = _dense_from_blocks(ed, n, blocks, mask2)
    rng = np.random.default_rng(3)
    b = np.where(mask2, 0.0, rng.standard_normal(2 * n))
    x_ref = np.linalg.solve(A, b)

    lat = strip_dof_lattice(fes.node_positions)
    bks = BlockNewtonKrylov(ed, n, ess, ess, restart=40, maxiter=5,
                            dof_lattice=lat, pc="linemg")
    jb = tuple(jnp.asarray(B) for B in blocks)
    res = bks.solve(bks.prepare(jb), jnp.asarray(b), rtol=1e-12)
    assert bool(res.converged)
    x = np.asarray(res.x)
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-8
    assert np.abs(x[mask2]).max() == 0.0


def test_linemg_h_robust_on_pde_system():
    """Inner-iteration counts must stay essentially flat under uniform
    refinement (the point-block PC measured ~2.7x growth per level on
    the real system, scripts/blocksolve_refinement.py)."""
    import jax.numpy as jnp

    from cmfem_tpu.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu.solvers import BlockNewtonKrylov
    from cmfem_tpu.solvers.blocksolve import strip_dof_lattice

    inners = []
    for nx, ny in ((6, 60), (12, 120), (24, 240)):
        mesh = make_cartesian_mesh_2d(nx, ny, sx=0.0025, sy=0.05)
        fes = FESpace(mesh, 1)
        n = fes.nscalar
        ed = np.asarray(fes.element_dofs)
        blocks = _pde_blocks(fes)
        ess = np.asarray(fes.boundary_dofs())
        lat = strip_dof_lattice(fes.node_positions)
        bks = BlockNewtonKrylov(ed, n, ess, ess, restart=60, maxiter=5,
                                dof_lattice=lat, pc="linemg")
        mask2 = np.zeros(2 * n, dtype=bool)
        mask2[ess] = True
        mask2[ess + n] = True
        rng = np.random.default_rng(4)
        b = np.where(mask2, 0.0, rng.standard_normal(2 * n))
        jb = tuple(jnp.asarray(B) for B in blocks)
        res = bks.solve(bks.prepare(jb), jnp.asarray(b), rtol=1e-10)
        assert bool(res.converged), (nx, ny)
        inners.append(int(res.inner_iters))
    assert max(inners) <= 40, inners
    for a, b_ in zip(inners, inners[1:]):
        assert b_ <= 1.5 * max(a, 8), inners


def test_linemg_requires_order1_lattice():
    """Order-2 stencils (25-point) exceed the 3x3 footprint; the
    constructor must refuse rather than silently mis-precondition."""
    from cmfem_tpu.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu.solvers import BlockNewtonKrylov
    from cmfem_tpu.solvers.blocksolve import strip_dof_lattice

    mesh = make_cartesian_mesh_2d(4, 6, sx=0.0025, sy=0.05)
    fes = FESpace(mesh, 2)
    lat = strip_dof_lattice(fes.node_positions)
    with pytest.raises(ValueError):
        BlockNewtonKrylov(np.asarray(fes.element_dofs), fes.nscalar,
                          np.zeros(0, np.int64), np.zeros(0, np.int64),
                          dof_lattice=lat, pc="linemg")
