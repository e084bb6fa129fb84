"""Element-sharded ablation Newton step (parallel/ablation_sharded.py) on
the 8-device virtual CPU mesh: the multichip analog of running the
reference ablation drivers under mpirun (SURVEY.md §2.4 / §3.4)."""

import numpy as np
import pytest

REF = "/root/reference/myapps/convection_diffusion"


@pytest.fixture(scope="module")
def small_problem():
    import jax.numpy as jnp

    from cmfem_tpu.core import FESpace, make_cartesian_mesh_2d
    from cmfem_tpu.ops import SpaceOps
    from cmfem_tpu.physics.tacot import TacotMaterial
    from cmfem_tpu.physics.ablation import AblationSystem, AblationState

    # small TACOT strip, heated top (attr 3 in the generator)
    mesh = make_cartesian_mesh_2d(3, 7, sx=0.0025, sy=0.05)
    mat = TacotMaterial.load_yaml(f"{REF}/Input/material_tacot_case1.yaml")
    fes = FESpace(mesh, 1)
    n = fes.nscalar
    ops = SpaceOps(fes, quad_order=4)
    sys_ = AblationSystem(ops, mat, top_attr=3)
    state = AblationState.initial(sys_.ne, sys_.nq, mat)
    ess = np.asarray(fes.boundary_dofs([3]))
    T = jnp.full(n, 300.0).at[jnp.asarray(ess)].set(1200.0)
    p = jnp.full(n, 101325.0)
    dt = 0.05
    T_old_q = ops.values_at_qp(jnp.full(n, 300.0))
    p_old_q = ops.values_at_qp(p)
    return sys_, fes, n, ess, T, p, T_old_q, p_old_q, state.extent, dt


def test_sharded_residual_matches_single_device(small_problem):
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.parallel import ShardedAblationNewton, make_device_mesh

    sys_, fes, n, ess, T, p, T_old_q, p_old_q, X_old, dt = small_problem
    dev_mesh = make_device_mesh(len(jax.devices()))
    sh = ShardedAblationNewton(sys_, dev_mesh, ess, ess)
    # ne=21 is NOT a multiple of 8 -> exercises the zero-weight padding
    assert sh.ne_pad % dev_mesh.devices.size == 0 and sh.ne_pad != sh.ne

    RT, Rp = sys_.residual(T, p, T_old_q, p_old_q, X_old, dt)
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    R_ref = np.where(mask2, 0.0,
                     np.concatenate([np.asarray(RT), np.asarray(Rp)]))

    R_sh = np.asarray(sh.residual(T, p, sh.pad_elem(T_old_q),
                                  sh.pad_elem(p_old_q), sh.pad_elem(X_old),
                                  dt))
    scale = np.abs(R_ref).max()
    assert np.abs(R_sh - R_ref).max() / scale < 1e-12


def test_sharded_newton_step_matches_single_device(small_problem):
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.parallel import ShardedAblationNewton, make_device_mesh
    from cmfem_tpu.solvers import BlockNewtonKrylov

    sys_, fes, n, ess, T, p, T_old_q, p_old_q, X_old, dt = small_problem
    dev_mesh = make_device_mesh(len(jax.devices()))
    sh = ShardedAblationNewton(sys_, dev_mesh, ess, ess, restart=200,
                               maxiter=10)

    # single-device oracle: same residual + equilibrated block GMRES
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess] = True
    mask2[ess + n] = True
    RT, Rp = sys_.residual(T, p, T_old_q, p_old_q, X_old, dt)
    R = jnp.where(jnp.asarray(mask2), 0.0, jnp.concatenate([RT, Rp]))
    blocks = sys_.element_jacobians(T, p, T_old_q, p_old_q, X_old, dt)
    bks = BlockNewtonKrylov(fes.element_dofs, n, ess, ess, restart=200,
                            maxiter=10)
    res_ref = bks.solve(bks.prepare(blocks), -R, rtol=1e-12)
    assert bool(res_ref.converged)
    dx_ref = np.asarray(res_ref.x)

    To_s, po_s, Xo_s = (sh.pad_elem(T_old_q), sh.pad_elem(p_old_q),
                        sh.pad_elem(X_old))
    T1, p1, Rnorm, cycles = sh.newton_step(T, p, To_s, po_s, Xo_s, dt,
                                           rtol=1e-12)
    dx_sh = np.concatenate([np.asarray(T1 - T), np.asarray(p1 - p)])
    num = np.linalg.norm(dx_sh - dx_ref)
    den = np.linalg.norm(dx_ref)
    assert num / den < 1e-6, num / den
    assert float(Rnorm) == pytest.approx(float(jnp.linalg.norm(R)),
                                         rel=1e-12)
    # essential dofs stay pinned
    assert np.abs(np.asarray(T1)[ess] - np.asarray(T)[ess]).max() == 0.0


def test_sharded_two_newton_iterations_reduce_residual(small_problem):
    import jax

    from cmfem_tpu.parallel import ShardedAblationNewton, make_device_mesh

    sys_, fes, n, ess, T, p, T_old_q, p_old_q, X_old, dt = small_problem
    dev_mesh = make_device_mesh(len(jax.devices()))
    sh = ShardedAblationNewton(sys_, dev_mesh, ess, ess, restart=200,
                               maxiter=10)
    To_s, po_s, Xo_s = (sh.pad_elem(T_old_q), sh.pad_elem(p_old_q),
                        sh.pad_elem(X_old))
    hist = []
    for _ in range(6):
        T, p, r, _ = sh.newton_step(T, p, To_s, po_s, Xo_s, dt, rtol=1e-12)
        hist.append(float(r))
    # distributed Newton converges on the coupled nonlinear system (an
    # early overshoot is normal for the undamped iteration — the drivers'
    # loop behaves identically)
    assert hist[-1] < 1e-6 * hist[0], hist


@pytest.fixture(scope="module")
def seb_problem(small_problem):
    """Add an SEB top boundary (case-2.1 style: p essential at top, T has
    the surface-energy-balance flux) to the small strip."""
    from cmfem_tpu.physics.bprime import BPrimeTable
    from cmfem_tpu.physics.seb import SurfaceFluxModel, BRANCH_CHEMISTRY_BLOWING
    from cmfem_tpu.physics.surface_bc import BoundaryState

    bprime = BPrimeTable.synthetic_tacot()
    model = SurfaceFluxModel(lam=0.5, q_rad=0.0)
    bc = BoundaryState(p_w=101325.0, rhoeUeCH=0.1, h_r=2.0e6, chemistryOn=1)
    return bprime, model, BRANCH_CHEMISTRY_BLOWING, bc


def test_sharded_seb_residual_and_step_match_single_device(small_problem,
                                                           seb_problem):
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.parallel import ShardedAblationNewton, make_device_mesh
    from cmfem_tpu.solvers import BlockNewtonKrylov

    sys_, fes, n, ess, T, p, T_old_q, p_old_q, X_old, dt = small_problem
    bprime, model, branch, bc = seb_problem
    # SEB mode: T is free at the top; only p is essential there
    ess_T = np.zeros(0, dtype=np.int64)
    dev_mesh = make_device_mesh(len(jax.devices()))
    sh = ShardedAblationNewton(sys_, dev_mesh, ess_T, ess, restart=200,
                               maxiter=10, seb=(branch, model, bprime))

    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess + n] = True
    RT, Rp = sys_.residual(T, p, T_old_q, p_old_q, X_old, dt)
    RT = RT + sys_.seb_face_residual(T, p, X_old, bc, branch, model, bprime)
    R_ref = np.where(mask2, 0.0,
                     np.concatenate([np.asarray(RT), np.asarray(Rp)]))

    To_s, po_s, Xo_s = (sh.pad_elem(T_old_q), sh.pad_elem(p_old_q),
                        sh.pad_elem(X_old))
    R_sh = np.asarray(sh.residual(T, p, To_s, po_s, Xo_s, dt, bc=bc))
    scale = np.abs(R_ref).max()
    assert np.abs(R_sh - R_ref).max() / scale < 1e-12

    # one Newton step vs the single-device block solver with face blocks
    blocks = sys_.element_jacobians(T, p, T_old_q, p_old_q, X_old, dt)
    face = sys_.seb_face_jacobians(T, p, X_old, bc, branch, model, bprime)
    bks = BlockNewtonKrylov(fes.element_dofs, n, ess_T, ess, restart=200,
                            maxiter=10)
    fac = bks.prepare(blocks, face=face, face_elem=sys_.trace.elem)
    res_ref = bks.solve(fac, -jnp.asarray(R_ref), rtol=1e-12)
    assert bool(res_ref.converged)
    dx_ref = np.asarray(res_ref.x)

    T1, p1, Rn, _ = sh.newton_step(T, p, To_s, po_s, Xo_s, dt, rtol=1e-12,
                                   bc=bc)
    dx_sh = np.concatenate([np.asarray(T1 - T), np.asarray(p1 - p)])
    rel = np.linalg.norm(dx_sh - dx_ref) / np.linalg.norm(dx_ref)
    assert rel < 1e-6, rel


def test_sharded_ale_gcl_residual_and_jacobian_match(small_problem,
                                                     seb_problem):
    """Case-2.2 ALE advective terms + GCL storage through the sharded
    path: residual and one Newton step must match the single-device
    system with the same wq/gcl inputs."""
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.parallel import ShardedAblationNewton, make_device_mesh
    from cmfem_tpu.solvers import BlockNewtonKrylov

    sys_, fes, n, ess, T, p, T_old_q, p_old_q, X_old, dt = small_problem
    bprime, model, branch, bc = seb_problem
    ess_T = np.zeros(0, dtype=np.int64)
    dev_mesh = make_device_mesh(len(jax.devices()))
    sh = ShardedAblationNewton(sys_, dev_mesh, ess_T, ess, restart=200,
                               maxiter=10, seb=(branch, model, bprime))

    ne, nq = sys_.ne, sys_.nq
    rng = np.random.default_rng(5)
    wq = jnp.asarray(1e-6 * rng.standard_normal((ne, nq, 2)))
    Jo = jnp.asarray(1.0 + 0.01 * rng.random((ne, nq)))
    Jn = jnp.asarray(1.0 + 0.01 * rng.random((ne, nq)))

    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess + n] = True
    RT, Rp = sys_.residual(T, p, T_old_q, p_old_q, X_old, dt, wq=wq,
                           gcl=(Jo, Jn))
    RT = RT + sys_.seb_face_residual(T, p, X_old, bc, branch, model, bprime)
    R_ref = np.where(mask2, 0.0,
                     np.concatenate([np.asarray(RT), np.asarray(Rp)]))

    To_s, po_s, Xo_s = (sh.pad_elem(T_old_q), sh.pad_elem(p_old_q),
                        sh.pad_elem(X_old))
    wq_s = sh.pad_elem(wq)
    gcl_s = (sh.pad_elem(Jo), sh.pad_elem(Jn))
    R_sh = np.asarray(sh.residual(T, p, To_s, po_s, Xo_s, dt, bc=bc,
                                  wq=wq_s, gcl=gcl_s))
    scale = np.abs(R_ref).max()
    assert np.abs(R_sh - R_ref).max() / scale < 1e-12

    blocks = sys_.element_jacobians(T, p, T_old_q, p_old_q, X_old, dt,
                                    wq=wq, gcl=(Jo, Jn))
    face = sys_.seb_face_jacobians(T, p, X_old, bc, branch, model, bprime)
    bks = BlockNewtonKrylov(fes.element_dofs, n, ess_T, ess, restart=200,
                            maxiter=10)
    fac = bks.prepare(blocks, face=face, face_elem=sys_.trace.elem)
    res_ref = bks.solve(fac, -jnp.asarray(R_ref), rtol=1e-12)
    assert bool(res_ref.converged)
    dx_ref = np.asarray(res_ref.x)

    T1, p1, _, _ = sh.newton_step(T, p, To_s, po_s, Xo_s, dt, rtol=1e-12,
                                  bc=bc, wq=wq_s, gcl=gcl_s)
    dx_sh = np.concatenate([np.asarray(T1 - T), np.asarray(p1 - p)])
    rel = np.linalg.norm(dx_sh - dx_ref) / np.linalg.norm(dx_ref)
    assert rel < 1e-6, rel


def test_update_geometry_reaches_jitted_kernels(small_problem, seb_problem):
    """Regression: update_geometry must affect the already-traced jitted
    residual/prepare kernels (advisor round-1 high finding — the factor
    arrays were baked in as trace-time constants, so the case-2.2 moving
    mesh ran every post-trace step with stale geometry)."""
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.parallel import ShardedAblationNewton, make_device_mesh

    sys_, fes, n, ess, T, p, T_old_q, p_old_q, X_old, dt = small_problem
    bprime, model, branch, bc = seb_problem
    ess_T = np.zeros(0, dtype=np.int64)
    dev_mesh = make_device_mesh(len(jax.devices()))
    sh = ShardedAblationNewton(sys_, dev_mesh, ess_T, ess, restart=200,
                               maxiter=10, seb=(branch, model, bprime))
    To_s, po_s, Xo_s = (sh.pad_elem(T_old_q), sh.pad_elem(p_old_q),
                        sh.pad_elem(X_old))
    mask2 = np.zeros(2 * n, dtype=bool)
    mask2[ess + n] = True

    # trace the kernels on the ORIGINAL geometry first
    R0 = np.asarray(sh.residual(T, p, To_s, po_s, Xo_s, dt, bc=bc))

    # move the mesh substantially (20% vertical compression: a large
    # recession) and refresh the sharded geometric factors
    vnew = np.asarray(sys_.ops.fes.mesh.vertices).copy()
    vnew[:, 1] *= 0.8
    sh.update_geometry(vnew)

    gf_new = sys_.ops.geometric_factors(jnp.asarray(vnew))
    RT, Rp = sys_.residual(T, p, T_old_q, p_old_q, X_old, dt, gf=gf_new)
    RT = RT + sys_.seb_face_residual(T, p, X_old, bc, branch, model,
                                     bprime, vertices=jnp.asarray(vnew))
    R_ref = np.where(mask2, 0.0,
                     np.concatenate([np.asarray(RT), np.asarray(Rp)]))

    R_sh = np.asarray(sh.residual(T, p, To_s, po_s, Xo_s, dt, bc=bc))
    scale = np.abs(R_ref).max()
    # the moved-geometry residual must match the single-device oracle ...
    assert np.abs(R_sh - R_ref).max() / scale < 1e-12
    # ... and must differ from the stale-geometry one
    assert np.abs(R_sh - R0).max() / scale > 1e-3

    # the prepare (AD Jacobian + equilibration) path must see it too:
    # a Newton step from the moved geometry matches the single-device
    # block solve on the moved geometry
    from cmfem_tpu.solvers import BlockNewtonKrylov

    blocks = sys_.element_jacobians(T, p, T_old_q, p_old_q, X_old, dt,
                                    gf=gf_new)
    face = sys_.seb_face_jacobians(T, p, X_old, bc, branch, model, bprime,
                                   vertices=jnp.asarray(vnew))
    bks = BlockNewtonKrylov(fes.element_dofs, n, ess_T, ess, restart=200,
                            maxiter=10)
    fac = bks.prepare(blocks, face=face, face_elem=sys_.trace.elem)
    res_ref = bks.solve(fac, -jnp.asarray(R_ref), rtol=1e-12)
    assert bool(res_ref.converged)
    dx_ref = np.asarray(res_ref.x)

    T1, p1, _, _ = sh.newton_step(T, p, To_s, po_s, Xo_s, dt, rtol=1e-12,
                                  bc=bc)
    dx_sh = np.concatenate([np.asarray(T1 - T), np.asarray(p1 - p)])
    rel = np.linalg.norm(dx_sh - dx_ref) / np.linalg.norm(dx_ref)
    assert rel < 1e-6, rel


@pytest.mark.slow
def test_case1_driver_sharded_matches_lu():
    """sharding_devices: 8 runs the case-1 driver's Newton steps
    element-sharded over the virtual device mesh (the mpirun -np N
    replacement) and reproduces the host-LU run."""
    import tempfile

    from cmfem_tpu.apps.ablation_case1 import run

    base = {
        "mesh_file": f"{REF}/Mesh/ablation_strip.msh",
        "material_file": f"{REF}/Input/material_tacot_case1.yaml",
        "order": 1, "dt": 0.05, "t_final": 0.1,
        "newton_print_level": 0, "save_paraview": False,
        "output_every": 100,
    }
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        out_lu = run({**base, "output_path": d1})
        out_sh = run({**base, "output_path": d2, "sharding_devices": 8})
    relT = (np.abs(out_lu["T"] - out_sh["T"]).max()
            / np.abs(out_lu["T"]).max())
    relp = (np.abs(out_lu["p"] - out_sh["p"]).max()
            / np.abs(out_lu["p"]).max())
    assert relT < 1e-6
    assert relp < 1e-8


@pytest.mark.slow
def test_case21_and_case22_drivers_sharded_match_lu():
    """sharding_devices: 8 on the SEB-coupled (2.1) and moving-mesh (2.2)
    drivers reproduces the host-LU runs, including per-branch sharded
    instances and per-step geometry refresh after recession."""
    import tempfile

    from cmfem_tpu.apps.ablation_case2_1 import run as run21
    from cmfem_tpu.apps.ablation_case2_2 import run as run22

    for runner, mat_file, bc_file in (
            (run21, "material_tacot_case2_1.yaml",
             "boundary_conditions_ablation_case2_1.dat"),
            (run22, "material_tacot_case2_2.yaml",
             "boundary_conditions_ablation_case2_2.dat")):
        base = {
            "mesh_file": f"{REF}/Mesh/ablation_strip.msh",
            "material_file": f"{REF}/Input/{mat_file}",
            "boundary_conditions_file": f"{REF}/Input/{bc_file}",
            "order": 1, "dt": 0.05, "t_final": 0.1,
            "newton_print_level": 0, "save_paraview": False,
            "output_every": 100,
        }
        with tempfile.TemporaryDirectory() as d1, \
                tempfile.TemporaryDirectory() as d2:
            out_lu = runner({**base, "output_path": d1})
            out_sh = runner({**base, "output_path": d2,
                             "sharding_devices": 8})
        relT = (np.abs(out_lu["T"] - out_sh["T"]).max()
                / np.abs(out_lu["T"]).max())
        relp = (np.abs(out_lu["p"] - out_sh["p"]).max()
                / np.abs(out_lu["p"]).max())
        assert relT < 1e-6, runner.__module__
        assert relp < 1e-8, runner.__module__


def test_sharded_padding_preserves_f32(small_problem):
    """Element/geometry padding must not promote f32 factors to f64: a
    dtype-less zeros pad would (x64 is globally on), silently turning
    an f32 device run into an f64 one."""
    import jax
    import jax.numpy as jnp

    from cmfem_tpu.parallel import ShardedAblationNewton, make_device_mesh

    sys_, fes, n, ess, T, p, T_old_q, p_old_q, X_old, dt = small_problem
    dev_mesh = make_device_mesh(len(jax.devices()))
    sh = ShardedAblationNewton(sys_, dev_mesh, ess, ess)
    assert sh.ne_pad != sh.ne  # the padding path is what we're testing

    class F32GF:
        wdetJ = np.asarray(sys_.ops.gf.wdetJ, dtype=np.float32)
        invJ = np.asarray(sys_.ops.gf.invJ, dtype=np.float32)

    orig = sys_.ops.geometric_factors
    try:
        sys_.ops.geometric_factors = lambda v: F32GF()
        sh.update_geometry(jnp.asarray(np.asarray(fes.mesh.vertices),
                                       jnp.float32))
    finally:
        sys_.ops.geometric_factors = orig
    assert sh.wdetJ.dtype == jnp.float32
    assert sh.invJ.dtype == jnp.float32
