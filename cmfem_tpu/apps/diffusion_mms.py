"""Static-mesh transient diffusion with manufactured solution.

Mirrors /root/reference/myapps/convection_diffusion/diffusion_mms.cpp:
  du/dt - alpha Lap u = f,  u = sin(t) cos(q), q = 2(x-1/2)^2 + 2(y-1/2)^2,
Dirichlet everywhere from the exact solution; LHS M + alpha gamma dt K
assembled once; per-step CSV (step,time,l2_error,linf_error) +
u/u_exact/error fields.

Stepping defaults to backward Euler (the reference's only integrator,
diffusion_mms.cpp:301-305); `time_integrator: sdirk2|sdirk3` switches to
the stiffly-accurate L-stable SDIRK schemes (solvers/timeint.py,
BASELINE.json config #4).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from .common import (
    parse_args, load_mesh_from_cfg, echo_config,
    ensure_outdir, num_steps, make_mg_preconditioner,
)
from ..utils.compile_cache import enable_compile_cache
from ..utils.yamlcfg import load_yaml
from ..io import CsvWriter, VTUCollection


def exact(x, t):
    dx = x[:, 0] - 0.5
    dy = x[:, 1] - 0.5
    q = 2.0 * dx * dx + 2.0 * dy * dy
    return np.sin(t) * np.cos(q)


def exact_dt(x, t):
    dx = x[:, 0] - 0.5
    dy = x[:, 1] - 0.5
    q = 2.0 * dx * dx + 2.0 * dy * dy
    return np.cos(t) * np.cos(q)


def make_forcing(alpha):
    def forcing(x, t):
        dx = x[:, 0] - 0.5
        dy = x[:, 1] - 0.5
        r2 = dx * dx + dy * dy
        q = 2.0 * r2
        ut = np.cos(t) * np.cos(q)
        lap = np.sin(t) * (-16.0 * r2 * np.cos(q) - 8.0 * np.sin(q))
        return ut - alpha * lap

    return forcing


def run(cfg: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from ..core import FESpace
    from ..ops import (
        SpaceOps, BilinearForm, EssentialBC, domain_lf, l2_error, linf_error,
    )
    from ..solvers import cg, jacobi_preconditioner

    from ..solvers import get_tableau, make_linear_dirk_step, stage_times

    order = int(cfg.get("order", 1))
    alpha = float(cfg.get("alpha", 1.0))
    dt = float(cfg.get("dt", 1.0e-2))
    t_final = float(cfg.get("t_final", 1.0))
    # time_integrator: be (reference semantics) | sdirk2 | sdirk3 —
    # BASELINE.json config #4 ("implicit Euler / SDIRK stepping")
    tab = get_tableau(cfg.get("time_integrator", "be"))
    output_path = cfg.get("output_path", "ParaView")
    save_paraview = bool(cfg.get("save_paraview", True))
    paraview_every = int(cfg.get("paraview_every", 10))
    if paraview_every < 1:
        raise ValueError("paraview_every must be >= 1")
    if alpha <= 0 or dt <= 0 or t_final < 0:
        raise ValueError("alpha and dt must be > 0, t_final >= 0.")

    mesh = load_mesh_from_cfg(cfg)
    fes = FESpace(mesh, order)
    print(f"Global true dofs: {fes.nscalar}")

    ops = SpaceOps(fes)
    mass = BilinearForm(ops).add_mass(1.0)
    mdata = mass.assemble()
    # all DIRK stages share one operator M + gamma*dt*K (gamma=1 for BE),
    # assembled once as a single fused form like the reference's BE LHS
    gdt = tab.gamma * dt
    lhs = BilinearForm(ops).add_mass(1.0).add_diffusion(alpha * gdt)
    ldata = lhs.assemble()
    forcing = make_forcing(alpha)

    ess = fes.boundary_dofs()
    bc = EssentialBC(fes.nscalar, ess)
    diag = jnp.where(bc.mask, 1.0, lhs.assemble_diagonal(ldata))
    ess_pts = fes.node_positions[np.asarray(ess)]

    rtol = float(cfg.get("solver_rtol", 1e-12))
    maxiter = int(cfg.get("solver_maxiter", 2000))

    # linear_solver: jacobi (default) | mg — geometric multigrid over the
    # driver's own refinement chain + p-coarsening, the production PC
    # analog of the reference's petsc*.opts AMG configurations
    solver = str(cfg.get("linear_solver", "jacobi")).lower()
    if solver == "mg":
        M = make_mg_preconditioner(
            cfg, order, lambda o: BilinearForm(o).add_mass(1.0)
            .add_diffusion(alpha * gdt))
    elif solver in ("jacobi", "cg"):
        M = jacobi_preconditioner(diag)
    else:
        raise ValueError(f"linear_solver must be 'jacobi' or 'mg', "
                         f"got {solver!r}")

    apply_A = lambda v: lhs.apply(ldata, v)
    apply_M = lambda v: mass.apply(mdata, v)
    solve = lambda op, B, x0: cg(op, B, x0=x0, M=M, rtol=rtol,
                                 maxiter=maxiter)
    step_fn = jax.jit(make_linear_dirk_step(tab, dt, apply_M, apply_A,
                                            bc, solve))

    u = jnp.asarray(fes.interpolate(lambda x: exact(x, 0.0)))

    ensure_outdir(output_path)
    csv = CsvWriter(os.path.join(output_path, "error_history.csv"),
                    ["step", "time", "l2_error", "linf_error"])
    dc = VTUCollection("diffusion_mms", fes, prefix_path=output_path) \
        if save_paraview else None

    nsteps = num_steps(t_final, dt)
    print(f"Time steps: {nsteps}, dt={dt}, t_final={nsteps * dt}")

    def compute_and_save(step, t):
        ex = lambda x: exact(x, t)
        l2 = float(l2_error(ops, u, ex))
        u_ex = fes.interpolate(ex)
        linf = float(np.max(np.abs(np.asarray(u) - u_ex)))
        csv.writerow([step, t, l2, linf])
        if step <= 5 or step % 50 == 0:
            print(f"step={step} t={t:g} L2_error={l2:.6e} Linf_error={linf:.6e}")
        if dc is not None and (step % paraview_every == 0 or step == nsteps):
            dc.save(step, t, {"u": np.asarray(u), "u_exact": u_ex,
                              "error": np.asarray(u) - u_ex})
        return l2, linf

    compute_and_save(0, 0.0)
    last = (0.0, 0.0)
    solve_iters = []
    for step in range(1, nsteps + 1):
        t = step * dt
        ts = stage_times(tab, t - dt, dt)
        f_stages = jnp.stack(
            [jnp.asarray(domain_lf(ops, lambda x: forcing(x, ti)))
             for ti in ts])
        g_stages = jnp.stack(
            [jnp.asarray(exact(ess_pts, ti)) for ti in ts])
        if tab.order > 1:
            # derivative-consistent stage BCs avoid RK order reduction
            gdot = jnp.stack(
                [jnp.asarray(exact_dt(ess_pts, ti)) for ti in ts])
            u, iters = step_fn(u, f_stages, g_stages, gdot)
        else:
            u, iters = step_fn(u, f_stages, g_stages)
        solve_iters.append(int(iters))
        last = compute_and_save(step, t)

    csv.close()
    print(f"\nFinal L2 error at t={nsteps * dt}: {last[0]}")
    return {"final_l2": last[0], "final_linf": last[1], "u": np.asarray(u),
            "fes": fes, "solve_iters": solve_iters}


def main(argv=None):
    enable_compile_cache()
    args = parse_args("Input/input_diffusion_mms.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
