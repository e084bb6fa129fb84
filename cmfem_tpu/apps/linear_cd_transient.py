"""Transient convection-diffusion with 3 uncoupled Peclet cases.

Mirrors /root/reference/myapps/convection_diffusion/linear_convection_diffusion_1D.cpp:
  dc/dt + beta . grad c - (1/Pe) Lap c = 0 on (0,1)^2, beta = (1,0),
implicit stepping; Dirichlet from the erfc-based analytic solution on
the x-boundaries, natural Neumann on y; per-step L2 errors for all
three Pe cases to one CSV (step,time,abs_l2_pe1,rel_l2_pe1,...).

The three solves per step run under one jit with the constant operators
assembled once (reference :391-400, :537-576).  Stepping defaults to
backward Euler (the reference's integrator); `time_integrator:
sdirk2|sdirk3` switches to the L-stable SDIRK schemes of
solvers/timeint.py (BASELINE.json config #4: "implicit Euler / SDIRK
stepping").  Stage Dirichlet data is imposed by value (g at the stage
times): the erfc solution is sqrt(t)-singular at t=0, so the
derivative-consistent stage BCs that recover full tableau order for
smooth data (see solvers/timeint.py) integrate an unbounded initial
boundary derivative here and lose accuracy, while value-mode SDIRK2
already cuts the per-step error ~80x vs BE at dt=0.01.
"""

from __future__ import annotations

import os
import sys
from functools import partial

import numpy as np
from scipy.special import erfc as _erfc

from .common import (
    parse_args, load_mesh_from_cfg, echo_config,
    ensure_outdir, validate_unit_square, x_boundary_attrs, num_steps,
    make_mg_preconditioner,
)
from ..utils.compile_cache import enable_compile_cache
from ..utils.yamlcfg import load_yaml
from ..io import CsvWriter, VTUCollection


def exp_times_erfc(a, b):
    """exp(a) * erfc(b) with the large-argument asymptotics of the
    reference (ExpTimesErfc, linear_convection_diffusion_1D.cpp:128-144)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    out = np.zeros(np.broadcast_shapes(a.shape, b.shape))
    big = b > 26.0
    # asymptotic branch
    with np.errstate(over="ignore", invalid="ignore"):
        inv_b = np.where(big, 1.0 / np.where(big, b, 1.0), 0.0)
        inv_b2 = inv_b * inv_b
        erfc_asym = inv_b / np.sqrt(np.pi) * (1.0 - 0.5 * inv_b2 + 0.75 * inv_b2**2)
        expo = a - b * b
        asym = np.where(expo < -745.0, 0.0,
                        np.where(expo > 709.0, np.inf, np.exp(np.clip(expo, -745, 709)) * erfc_asym))
        direct = np.where(a > 709.0, np.inf,
                          np.exp(np.clip(a, None, 709)) * _erfc(b))
    return np.where(big, asym, direct)


def exact_concentration(x, t, pe):
    """Analytic erfc solution (reference :146-166), uniform in y."""
    x = np.asarray(x, dtype=np.float64)
    if t <= 0.0:
        return np.zeros_like(x)
    diff = t / pe
    root = np.sqrt(diff)
    arg1 = (x - t) / (2.0 * root)
    arg2 = (x + t) / (2.0 * root)
    gauss = -((x - t) ** 2) / (4.0 * diff)
    term1 = 0.5 * _erfc(arg1)
    term2 = np.sqrt(t * pe / np.pi) * np.exp(gauss)
    term3 = 0.5 * (1.0 + pe * x + pe * t) * exp_times_erfc(pe * x, arg2)
    c = term1 + term2 - term3
    return np.where(np.isfinite(c), c, 0.0)


def exp_times_erfc_jax(a, b):
    """jit-friendly exp(a)*erfc(b) with the same b>26 asymptotics."""
    import jax.numpy as jnp
    from jax.scipy.special import erfc

    big = b > 26.0
    inv_b = 1.0 / jnp.where(big, b, 1.0)
    inv_b2 = inv_b * inv_b
    erfc_asym = inv_b / jnp.sqrt(jnp.pi) * (1.0 - 0.5 * inv_b2
                                            + 0.75 * inv_b2**2)
    asym = jnp.exp(jnp.clip(a - b * b, -745.0, 709.0)) * erfc_asym
    direct = jnp.exp(jnp.clip(a, max=709.0)) * erfc(b)
    return jnp.where(big, asym, direct)


def exact_concentration_jax(x, t, pe):
    """On-device erfc solution for the lax.scan stepping path (t > 0)."""
    import jax.numpy as jnp
    from jax.scipy.special import erfc

    diff = t / pe
    root = jnp.sqrt(diff)
    arg1 = (x - t) / (2.0 * root)
    arg2 = (x + t) / (2.0 * root)
    gauss = -((x - t) ** 2) / (4.0 * diff)
    c = (0.5 * erfc(arg1)
         + jnp.sqrt(t * pe / jnp.pi) * jnp.exp(gauss)
         - 0.5 * (1.0 + pe * x + pe * t) * exp_times_erfc_jax(pe * x, arg2))
    return jnp.where(jnp.isfinite(c), c, 0.0)


def run(cfg: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from ..core import FESpace
    from ..ops import (
        SpaceOps, BilinearForm, EssentialBC, l2_error, l2_norm_fn,
    )
    from ..solvers import (
        gmres, jacobi_preconditioner, get_tableau, make_linear_dirk_step,
        stage_times,
    )

    order = int(cfg.get("order", 1))
    dt = float(cfg.get("dt", 1.0e-3))
    tab = get_tableau(cfg.get("time_integrator", "be"))
    t_final = float(cfg.get("t_final", 1.0))
    peclet = [float(p) for p in cfg.get("peclet", [1.0, 10.0, 100.0])]
    if len(peclet) != 3:
        raise ValueError("YAML key peclet must be a sequence of exactly 3 values.")
    output_path = cfg.get("output_path", "ParaView")
    collection_name = cfg.get("collection_name", "convection_diffusion_3pe")
    error_csv = cfg.get("error_csv", "error_history.csv")
    save_paraview = bool(cfg.get("save_paraview", True))
    paraview_every = int(cfg.get("paraview_every", 50))
    if paraview_every < 1:
        raise ValueError("paraview_every must be >= 1")
    if dt <= 0 or t_final < 0 or any(p <= 0 for p in peclet):
        raise ValueError("dt must be > 0, t_final >= 0, peclet > 0.")

    mesh = load_mesh_from_cfg(cfg)
    validate_unit_square(mesh)
    fes = FESpace(mesh, order)
    print(f"Global true dofs: {fes.nscalar}")

    x_attrs = x_boundary_attrs(mesh)
    print(f"Dirichlet x-boundary attributes: {x_attrs}")
    ess = fes.boundary_dofs(x_attrs)
    bc = EssentialBC(fes.nscalar, ess)
    ess_x = fes.node_positions[np.asarray(ess)][:, 0]

    ops = SpaceOps(fes)
    mass = BilinearForm(ops).add_mass(1.0)
    mdata = mass.assemble()
    beta = np.array([1.0, 0.0])
    # every DIRK stage shares one operator M + gamma*dt*(C + K); for the
    # reference's BE (gamma=1) this is its once-assembled LHS (:391-400)
    gdt = tab.gamma * dt
    forms, datas, diags = [], [], []
    for pe in peclet:
        f = (BilinearForm(ops)
             .add_mass(1.0)
             .add_convection(beta, alpha=gdt)
             .add_diffusion(gdt / pe))
        d = f.assemble()
        forms.append(f)
        datas.append(d)
        diags.append(jnp.where(bc.mask, 1.0, f.assemble_diagonal(d)))

    rtol = float(cfg.get("solver_rtol", 1e-12))
    restart = int(cfg.get("solver_restart", 60))
    maxiter = int(cfg.get("solver_maxiter", 60))

    # linear_solver: jacobi (default) | mg — one geometric hierarchy per
    # Peclet operator (VERDICT r4 #7)
    use_mg = str(cfg.get("linear_solver", "jacobi")).lower() == "mg"

    dirk_steps = []
    for k in range(3):
        apply_A = lambda v, d=datas[k], f=forms[k]: f.apply(d, v)
        apply_M = lambda v: mass.apply(mdata, v)
        if use_mg:
            # the PC must pin the SAME dofs as the system: x-boundaries
            # only (attribute ids survive uniform refinement)
            M = make_mg_preconditioner(
                cfg, order, lambda o, pe=peclet[k]: BilinearForm(o)
                .add_mass(1.0)
                .add_convection(beta, alpha=gdt)
                .add_diffusion(gdt / pe),
                ess_dofs=lambda fes_l: fes_l.boundary_dofs(x_attrs))
        else:
            M = jacobi_preconditioner(diags[k])
        solve = lambda op, B, x0, M=M: gmres(op, B, x0=x0, M=M, rtol=rtol,
                                             restart=restart,
                                             maxiter=maxiter)
        dirk_steps.append(
            make_linear_dirk_step(tab, dt, apply_M, apply_A, bc, solve))

    @jax.jit
    def step_all(cs, bdr_stages):
        """cs: (3, n); bdr_stages: (3, s, ness) stage Dirichlet values."""
        outs = []
        for k in range(3):
            c, _ = dirk_steps[k](cs[k], None, bdr_stages[k])
            outs.append(c)
        return jnp.stack(outs)

    nsteps = num_steps(t_final, dt)
    print(f"Time steps: {nsteps}, nominal final time: {nsteps * dt}")

    ensure_outdir(output_path)
    csv = CsvWriter(os.path.join(output_path, error_csv),
                    ["step", "time",
                     "abs_l2_pe1", "rel_l2_pe1", "abs_l2_pe2", "rel_l2_pe2",
                     "abs_l2_pe3", "rel_l2_pe3"])
    dc = VTUCollection(collection_name, fes, prefix_path=output_path) \
        if save_paraview else None

    cs = jnp.zeros((3, fes.nscalar))

    def write_errors(step, t):
        row = [step, t]
        for k, pe in enumerate(peclet):
            ex = partial(lambda x, pe=pe, t=t: exact_concentration(x[:, 0], t, pe))
            abs_l2 = float(l2_error(ops, cs[k], ex))
            nrm = float(l2_norm_fn(ops, ex))
            rel = abs_l2 / nrm if nrm > 1e-14 else 0.0
            row += [abs_l2, rel]
        csv.writerow(row)
        if step <= 10 or step == nsteps or step % 50 == 0:
            print(f"step={step} t={t:g} relL2=[{row[3]:.3e}, {row[5]:.3e}, {row[7]:.3e}]")
        return row

    def save_fields(step, t):
        if dc is None or (step % paraview_every and step != nsteps):
            return
        fields = {}
        for k, pe in enumerate(peclet):
            fields[f"c_pe{k+1}"] = np.asarray(cs[k])
            fields[f"c_exact_pe{k+1}"] = fes.interpolate(
                lambda x: exact_concentration(x[:, 0], t, pe))
        dc.save(step, t, fields)

    write_errors(0, 0.0)
    save_fields(0, 0.0)

    last = None
    if bool(cfg.get("scan_stepping", False)) and nsteps > 0:
        # Fully-on-device time loop: one jitted lax.scan covers every
        # step INCLUDING the Dirichlet schedule and the per-step L2 errors
        # (the erfc solution evaluated with jax.scipy.special.erfc), so the
        # host touches the device once per run instead of once per step —
        # the device-resident form of the reference's stepping loop
        # (linear_convection_diffusion_1D.cpp:537-576).
        hi = SpaceOps(fes, max(2, 2 * order + 3))
        xq_x = jnp.asarray(hi.gf.xq[..., 0])
        wdetJ_hi = jnp.asarray(hi.gf.wdetJ)
        B_hi = jnp.asarray(hi.B)
        eldofs = jnp.asarray(hi.eldofs)
        ess_x_j = jnp.asarray(ess_x)

        def body(cs, i):
            t = (i + 1.0) * dt
            ts = [i * dt + ci * dt for ci in tab.c]
            bdr = jnp.stack(
                [jnp.stack([exact_concentration_jax(ess_x_j, ti, pe)
                            for ti in ts]) for pe in peclet])
            cs = step_all(cs, bdr)
            errs = []
            for k, pe in enumerate(peclet):
                uq = jnp.einsum("qn,en->eq", B_hi, cs[k][eldofs])
                ex = exact_concentration_jax(xq_x, t, pe)
                abs_l2 = jnp.sqrt(jnp.sum((uq - ex) ** 2 * wdetJ_hi))
                nrm = jnp.sqrt(jnp.sum(ex**2 * wdetJ_hi))
                errs += [abs_l2, jnp.where(nrm > 1e-14, abs_l2 / nrm, 0.0)]
            return cs, jnp.stack(errs)

        @jax.jit
        def run_all(cs):
            return jax.lax.scan(body, cs, jnp.arange(nsteps))

        cs, hist = run_all(cs)
        hist = np.asarray(hist)
        for step in range(1, nsteps + 1):
            row = [step, step * dt] + [float(v) for v in hist[step - 1]]
            csv.writerow(row)
            last = row
        save_fields(nsteps, nsteps * dt)
    else:
        for step in range(1, nsteps + 1):
            t = step * dt
            ts = stage_times(tab, t - dt, dt)
            bdr = jnp.stack(
                [jnp.stack([jnp.asarray(exact_concentration(ess_x, ti, pe))
                            for ti in ts]) for pe in peclet])
            cs = step_all(cs, bdr)
            last = write_errors(step, t)
            save_fields(step, t)

    csv.close()
    return {"final_errors": last, "c": np.asarray(cs), "fes": fes}


def main(argv=None):
    enable_compile_cache()
    args = parse_args("Input/input.yaml", argv)
    cfg = load_yaml(args.input)
    echo_config({k: v for k, v in cfg.items() if not k.startswith("_")})
    run(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
