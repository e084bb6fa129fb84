"""Transient nonlinear diffusion with backward Euler + full Newton.

Mirrors /root/reference/myapps/convection_diffusion/nonlinear_convection_diffusion_1D.cpp:
  m(u) (u - u_old)/dt - div(a(u) grad u) = 0,
  a(u) = a0 + a1 (u - u_ref), m(u) = m0 + m1 (u - u_ref),
Neumann flux from the series exact solution on x-boundaries, natural on y;
residual shifted by the assembled Neumann RHS (ShiftedResidualOperator,
:644-670).  The Jacobian-vector product comes from AD of the residual;
the linear solves are Jacobi-preconditioned GMRES (replacing
GMRES+BJacobi/ILU from Input/petsc_nonlinear.opts).

Outputs: error CSV (step,time,abs_l2,rel_l2,newton_iters,final_residual)
and Newton CSV (step,time,iter,residual,residual0,rel_residual,
update_norm,update0,rel_update,converged) matching the reference headers.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .common import (
    parse_args, load_mesh_from_cfg, echo_config,
    ensure_outdir, validate_square, x_boundary_attrs, num_steps,
)
from ..utils.compile_cache import enable_compile_cache
from ..utils.yamlcfg import load_yaml
from ..io import CsvWriter, VTUCollection
from ..physics.exact_solutions import NonlinearHeatParams, nonlinear_heat_exact


def run(cfg: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from ..core import FESpace
    from ..ops import SpaceOps, boundary_lf, l2_error, l2_norm_fn
    from ..ops.nonlinear import NonlinearForm
    from ..solvers import gmres, jacobi_preconditioner, newton_solve, NewtonConfig

    order = int(cfg.get("order", 1))
    dt = float(cfg.get("dt", 1.0e-3))
    t_final = float(cfg.get("t_final", 1.0e-1))
    a0 = float(cfg.get("a0", 10.0))
    a1 = float(cfg.get("a1", 0.09))
    m0 = float(cfg.get("m0", 8000.0 * 500.0))
    m1 = float(cfg.get("m1", 8000.0 * 4.5))
    u_ref = float(cfg.get("u_ref", 300.0))
    ep = NonlinearHeatParams(
        alpha=float(cfg.get("alpha", 2.5e-6)),
        kappa1=float(cfg.get("kappa1", 10.0)),
        kappa2=float(cfg.get("kappa2", 100.0)),
        T0=float(cfg.get("T0", 300.0)),
        T1=float(cfg.get("T1", 300.0)),
        T2=float(cfg.get("T2", 1300.0)),
        qbar=float(cfg.get("qbar", 7.5e5)),
        L=float(cfg.get("L", 1.0)),
        series_terms=int(cfg.get("series_terms", 400)),
    )
    newton_cfg = NewtonConfig(
        abs_tol=float(cfg.get("newton_abs_tol", 1e-10)),
        rel_tol=float(cfg.get("newton_rel_tol", 1e-8)),
        max_iter=int(cfg.get("newton_max_iter", 20)),
    )
    output_path = cfg.get("output_path", "ParaView")
    collection_name = cfg.get("collection_name", "nonlinear_convection_diffusion_1D")
    error_csv_name = cfg.get("error_csv", "error_history_nonlinear_1D.csv")
    newton_csv_name = cfg.get("newton_csv", "newton_history_nonlinear_1D.csv")
    save_paraview = bool(cfg.get("save_paraview", True))
    paraview_every = int(cfg.get("paraview_every", 1))
    if paraview_every < 1:
        raise ValueError("paraview_every must be >= 1")
    newton_print_level = int(cfg.get("newton_print_level", 1))

    if dt <= 0 or t_final < 0 or ep.series_terms <= 0 or ep.L <= 0:
        raise ValueError("invalid dt/t_final/series_terms/L")
    if abs(ep.kappa2 - ep.kappa1) <= 1e-14 or abs(ep.T2 - ep.T1) <= 1e-14:
        raise ValueError("kappa2!=kappa1 and T2!=T1 required")

    mesh = load_mesh_from_cfg(cfg)
    validate_square(mesh)
    fes = FESpace(mesh, order)
    print(f"Global true dofs: {fes.nscalar}")
    lo, hi = mesh.bounding_box()
    xmin, xmax = lo[0], hi[0]
    x_attrs = x_boundary_attrs(mesh)
    print(f"x-boundary attributes (Neumann exact flux): {x_attrs}")

    ops = SpaceOps(fes)

    def qp_residual(uq, gq, xq, u_old_q=None):
        m = m0 + m1 * (uq - u_ref)
        a = a0 + a1 * (uq - u_ref)
        r0 = m * (uq - u_old_q) / dt
        r1 = a[..., None] * gq
        return r0, r1

    nlf = NonlinearForm(ops, qp_residual)

    def exact_fn(x, t):
        return nonlinear_heat_exact(x[:, 0], t, ep)[0]

    def flux_fn(x, t):
        """a(u_exact) u_x n_x on the x-boundaries (ExactFluxXCoefficient)."""
        u, ux = nonlinear_heat_exact(x[:, 0], t, ep)
        a = a0 + a1 * (u - u_ref)
        nx = np.where(np.abs(x[:, 0] - xmin) <= 1e-8, -1.0,
                      np.where(np.abs(x[:, 0] - xmax) <= 1e-8, 1.0, 0.0))
        return a * ux * nx

    @jax.jit
    def residual(x, u_old_q, neumann):
        return nlf.residual(x, u_old_q=u_old_q) - neumann

    @jax.jit
    def lin_solve(x, rhs, u_old_q):
        R, jvp_fn = nlf.linearize(x, u_old_q=u_old_q)
        diag = nlf.jacobian_diagonal(x, u_old_q=u_old_q)
        M = jacobi_preconditioner(diag)
        res = gmres(jvp_fn, rhs, M=M,
                    rtol=float(cfg.get("linear_rtol", 1e-10)),
                    restart=int(cfg.get("linear_restart", 60)),
                    maxiter=int(cfg.get("linear_maxiter", 60)))
        return res.x

    u = jnp.asarray(fes.interpolate(lambda x: exact_fn(x, 0.0)))

    ensure_outdir(output_path)
    err_csv = CsvWriter(os.path.join(output_path, error_csv_name),
                        ["step", "time", "abs_l2", "rel_l2", "newton_iters",
                         "final_residual"])
    newton_csv = CsvWriter(os.path.join(output_path, newton_csv_name),
                           ["step", "time", "iter", "residual", "residual0",
                            "rel_residual", "update_norm", "update0",
                            "rel_update", "converged"])
    dc = VTUCollection(collection_name, fes, prefix_path=output_path) \
        if save_paraview else None

    nsteps = num_steps(t_final, dt)
    print(f"Time steps: {nsteps}, nominal final time: {nsteps * dt}")

    def write_step(step, t, iters, final_res):
        ex = lambda x: exact_fn(x, t)
        abs_l2 = float(l2_error(ops, u, ex))
        nrm = float(l2_norm_fn(ops, ex))
        rel = abs_l2 / nrm if nrm > 1e-14 else 0.0
        err_csv.writerow([step, t, abs_l2, rel, iters, final_res])
        if step <= 10 or step == nsteps or step % 25 == 0:
            print(f"step={step} t={t:g} newton_iters={iters} relL2={rel:.6e}")
        if dc is not None and (step % paraview_every == 0 or step == nsteps):
            dc.save(step, t, {"u": np.asarray(u),
                              "u_exact": fes.interpolate(ex)})
        return abs_l2, rel

    write_step(0, 0.0, 0, 0.0)
    last = None
    for step in range(1, nsteps + 1):
        t = step * dt
        u_old_q = ops.values_at_qp(u)
        neumann = boundary_lf(ops, lambda x: flux_fn(x, t), attr_marker=x_attrs)

        def log_it(info):
            newton_csv.writerow([step, t, info.iter, info.residual_norm,
                                 info.residual_norm0, info.relative_residual,
                                 info.update_norm, info.update_norm0,
                                 info.relative_update, int(info.converged)])
            if newton_print_level > 0 and not info.converged:
                print(f"NR iteration {info.iter}:\n"
                      f"|R|/|R0|= {info.relative_residual}\n"
                      f"|R|= {info.residual_norm}\n"
                      f"|du|/|du0|= {info.relative_update}\n"
                      f"|du|= {info.update_norm}")

        u, result = newton_solve(
            lambda x: residual(x, u_old_q, neumann),
            u,
            lambda x, rhs, _: lin_solve(x, rhs, u_old_q),
            config=newton_cfg,
            log_iteration=log_it,
        )
        if not result.converged:
            raise RuntimeError(
                f"Newton did not converge at step {step}, t={t}, "
                f"final residual={result.final_residual}")
        last = write_step(step, t, result.iterations, result.final_residual)

    err_csv.close()
    newton_csv.close()
    return {"final": last, "u": np.asarray(u), "fes": fes}


def main(argv=None):
    enable_compile_cache()
    args = parse_args("Input/input_nonlinear_1d.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
