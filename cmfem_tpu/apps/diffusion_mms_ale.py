"""SCL-preserving ALE backward-Euler diffusion MMS on a fixed reference mesh.

Mirrors /root/reference/myapps/convection_diffusion/diffusion_mms_ale.cpp
(Ivancic et al. Example 7.3): per step, on the REFERENCE mesh,

  LHS = Mass(J_{n+1}) + Diffusion((alpha dt / J) C C^T)
        + Convection(phi_hat, -1) + Mass(-div phi_hat)
  RHS = Mass(J_n) u_old + dt * (f(A(xhat)) J, psi)

with the analytic maps' closed-form time-integrated grid flux phi_hat;
physical-domain L2 error via the J-weighted norm; `ale_displacement` /
`ale_jacobian` output fields for ParaView Warp-By-Vector.  The identity
map is the A/B fixture reproducing the static diffusion_mms driver.

The whole per-step assembly+solve runs in one jit with (t_old, t_new)
traced.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .common import (
    parse_args, load_mesh_from_cfg, echo_config,
    ensure_outdir, num_steps,
)
from ..utils.compile_cache import enable_compile_cache
from ..utils.yamlcfg import load_yaml
from ..io import CsvWriter, VTUCollection
from ..motion.ale import AleMap


def exact_physical(x, t):
    dx = x[..., 0] - 0.5
    dy = x[..., 1] - 0.5
    q = 2.0 * dx * dx + 2.0 * dy * dy
    import jax.numpy as jnp

    return jnp.sin(t) * jnp.cos(q)


def forcing_physical(x, t, alpha):
    import jax.numpy as jnp

    dx = x[..., 0] - 0.5
    dy = x[..., 1] - 0.5
    r2 = dx * dx + dy * dy
    q = 2.0 * r2
    ut = jnp.cos(t) * jnp.cos(q)
    lap = jnp.sin(t) * (-16.0 * r2 * jnp.cos(q) - 8.0 * jnp.sin(q))
    return ut - alpha * lap


def run(cfg: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from ..core import FESpace
    from ..ops import SpaceOps, BilinearForm, EssentialBC, domain_lf
    from ..ops.assembly import weighted_l2_error
    from ..solvers import gmres, jacobi_preconditioner

    order = int(cfg.get("order", 1))
    alpha = float(cfg.get("alpha", 0.1))
    dt = float(cfg.get("dt", 0.05))
    t_final = float(cfg.get("t_final", 2.0))
    ale_map_name = cfg.get("ale_map", "accuracy_a")
    output_path = cfg.get("output_path", "ParaView/diffusion_mms_ale")
    save_paraview = bool(cfg.get("save_paraview", True))
    paraview_every = int(cfg.get("paraview_every", 1))
    lin_rtol = float(cfg.get("linear_rel_tol", 1e-10))
    lin_atol = float(cfg.get("linear_abs_tol", 0.0))
    lin_maxiter = int(cfg.get("linear_max_iter", 400))
    if alpha <= 0 or dt <= 0 or t_final < 0:
        raise ValueError("alpha and dt must be > 0, t_final >= 0")

    amap = AleMap(ale_map_name)
    print(f"ALE map: {amap.kind}")

    mesh = load_mesh_from_cfg(cfg)
    fes = FESpace(mesh, order)
    print(f"Scalar true dofs: {fes.nscalar}")
    ops = SpaceOps(fes)
    ess = fes.boundary_dofs()
    bc = EssentialBC(fes.nscalar, ess)
    ess_pts = jnp.asarray(fes.node_positions[np.asarray(ess)])

    def exact_ref(xhat, t):
        return exact_physical(amap.map_point(jnp.asarray(xhat), t), t)

    @jax.jit
    def step_fn(u, t_old, t_new):
        # RHS part 1: Mass(J_n) u_old
        m_old = BilinearForm(ops).add_mass(
            lambda x: amap.jacobian_det(x, t_old))
        rhs = m_old.apply(m_old.assemble(), u)

        # LHS operator data at t_new
        a = BilinearForm(ops)
        a.add_mass(lambda x: amap.jacobian_det(x, t_new))

        def metric(x):
            C = amap.cofactor(x, t_new)
            J = amap.jacobian_det(x, t_new)
            return (alpha * dt / J)[..., None, None] * \
                jnp.einsum("...ij,...kj->...ik", C, C)

        a.add_diffusion_matrix(metric)
        a.add_convection(lambda x: amap.integrated_grid_flux(x, t_old, t_new)[0],
                         alpha=-1.0)
        a.add_mass(lambda x: -amap.integrated_grid_flux(x, t_old, t_new)[1])
        data = a.assemble()

        # RHS part 2: dt * (f(A(xhat,t)) J, psi)
        rhs = rhs + dt * domain_lf(
            ops, lambda x: forcing_physical(amap.map_point(x, t_new), t_new,
                                            alpha) *
            amap.jacobian_det(x, t_new))

        u_bc = jnp.zeros(fes.nscalar).at[bc.ess_dofs].set(
            exact_ref(ess_pts, t_new))
        apply_A = lambda v: a.apply(data, v)
        B = bc.constrained_rhs(apply_A, rhs, u_bc)
        diag = jnp.where(bc.mask, 1.0, a.assemble_diagonal(data))
        # reference semantics (diffusion_mms_ale.cpp:695-700):
        # linear_max_iter caps TOTAL Krylov iterations, and the restart
        # length is min(400, max(50, linear_max_iter)); our gmres's
        # maxiter counts restart cycles, so derive it from the cap
        restart = min(400, max(50, lin_maxiter))
        cycles = max(1, -(-lin_maxiter // restart))
        res = gmres(bc.constrain_operator(apply_A), B, x0=u,
                    M=jacobi_preconditioner(diag), rtol=lin_rtol,
                    atol=lin_atol, restart=restart, maxiter=cycles)
        # usable = converged | stagnated-at-working-precision-floor (the
        # deck rtols target f64; see common.check_standalone_linear)
        return res.x, res.converged | res.stagnated, res.residual

    u = jnp.asarray(fes.interpolate(
        lambda x: np.asarray(exact_ref(jnp.asarray(x), 0.0))))

    ensure_outdir(output_path)
    # l2_norm is the J-weighted physical-domain solution norm
    # ||u_h||_{L2(Omega(t))} — the quantity the paper-style stability
    # figure tracks (plot_ale_validation_be.py:40-60 reads it per dt)
    csv = CsvWriter(os.path.join(output_path, "error_history.csv"),
                    ["step", "time", "l2_error", "linf_error", "l2_norm"])
    dc = VTUCollection("diffusion_mms_ale", fes, prefix_path=output_path) \
        if save_paraview else None

    def compute_and_save(step, t, force=False):
        ex = lambda x: np.asarray(exact_ref(jnp.asarray(x), t))
        Jw = lambda x: np.asarray(amap.jacobian_det(jnp.asarray(x), t))
        l2 = float(weighted_l2_error(ops, u, ex, Jw))
        l2n = float(weighted_l2_error(
            ops, u, lambda x: np.zeros(np.asarray(x).shape[:-1]), Jw))
        u_ex = fes.interpolate(ex)
        linf = float(np.max(np.abs(np.asarray(u) - u_ex)))
        csv.writerow([step, t, l2, linf, l2n])
        if step <= 3 or step % 20 == 0:
            print(f"step={step}  t={t:.4f}  L2_error={l2:.6e}  "
                  f"Linf_error={linf:.6e}")
        if dc is not None and (force or (paraview_every > 0
                                         and step % paraview_every == 0)):
            pts = fes.node_positions
            disp = np.asarray(amap.map_point(jnp.asarray(pts), t)) - pts
            dc.save(step, t, {
                "u": np.asarray(u), "u_exact": u_ex,
                "u_error": np.asarray(u) - u_ex,
                "ale_displacement": disp,
                "ale_jacobian": np.asarray(
                    amap.jacobian_det(jnp.asarray(pts), t)),
            })
        return l2, linf

    compute_and_save(0, 0.0, force=True)
    nsteps = num_steps(t_final, dt)
    print(f"Time steps: {nsteps}  dt={dt}  t_final={nsteps * dt}")

    t = 0.0
    last = (0.0, 0.0)
    for step in range(1, nsteps + 1):
        t_old = t
        t = t + dt
        u, converged, resid = step_fn(u, t_old, t)
        if not bool(converged):
            raise RuntimeError(f"Linear solver failed at step {step}: "
                               f"residual={float(resid)}")
        last = compute_and_save(step, t, force=(step == nsteps))

    csv.close()
    print(f"\nFinal L2 error at t={t}:  {last[0]}")
    return {"final_l2": last[0], "final_linf": last[1], "u": np.asarray(u),
            "fes": fes}


def main(argv=None):
    enable_compile_cache()
    args = parse_args("Input/input_diffusion_mms_ale.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
